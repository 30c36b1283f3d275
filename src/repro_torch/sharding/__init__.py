from repro_torch.sharding.specs import (P, MeshShape, MeshSplit, NamedSpec,
                                        Pick, Split, batch_pspecs,
                                        cache_pspecs, compute_layout,
                                        data_axes, fed_round_specs,
                                        gather_levels, levels, named,
                                        param_pspecs, place, psum_levels,
                                        shard_index, token_pspec)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "data_axes",
           "named", "token_pspec", "place", "P", "MeshShape", "NamedSpec",
           "fed_round_specs", "gather_levels", "levels", "psum_levels",
           "shard_index", "compute_layout", "MeshSplit", "Split", "Pick"]
