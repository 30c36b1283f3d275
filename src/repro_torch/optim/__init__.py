from repro_torch.optim.optimizers import (Optimizer, apply_mask, sgd,
                                          trainable_mask, value_and_grad)
from repro_torch.optim.proximal import (control_variate_grad,
                                        proximal_grad, proximal_penalty)

__all__ = ["Optimizer", "sgd", "trainable_mask", "apply_mask",
           "proximal_grad", "value_and_grad", "control_variate_grad",
           "proximal_penalty"]
