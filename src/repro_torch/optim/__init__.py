from repro_torch.optim.optimizers import (Optimizer, apply_mask, sgd,
                                          trainable_mask, value_and_grad)
from repro_torch.optim.proximal import proximal_grad

__all__ = ["Optimizer", "sgd", "trainable_mask", "apply_mask",
           "proximal_grad", "value_and_grad"]
