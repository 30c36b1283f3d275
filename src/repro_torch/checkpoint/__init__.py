from repro_torch.checkpoint.ckpt import (load_params, load_server_state,
                                        save_params, save_server_state)

__all__ = ["save_params", "load_params", "save_server_state",
           "load_server_state"]
