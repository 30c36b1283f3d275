from repro_torch.optim.optimizers import (Optimizer, adamw, apply_mask, sgd,
                                          trainable_mask, value_and_grad)
from repro_torch.optim.proximal import (control_variate_grad,
                                        proximal_grad, proximal_penalty)
from repro_torch.optim.schedules import constant, cosine, inverse_sqrt

__all__ = ["Optimizer", "sgd", "adamw", "trainable_mask", "apply_mask",
           "proximal_grad", "control_variate_grad", "constant", "cosine",
           "inverse_sqrt", "value_and_grad", "proximal_penalty"]
