from repro_torch.sharding.specs import (fed_round_specs, gather_levels,
                                        levels, psum_levels, shard_index)

__all__ = ["fed_round_specs", "gather_levels", "levels", "psum_levels",
           "shard_index"]
