"""Config dataclasses: the port's own copy of ``repro/types.py``.

Frozen dataclasses, so configs are hashable and compare by value. The
fields match the reference's exactly (the parity tests build both
packages' configs by name and compare them); the LM sub-configs and the
LM branch of ``reduced()`` come with the LM stack.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ARCH_FAMILIES = (
    "dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio", "resnet3d",
)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # one of ARCH_FAMILIES
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    sliding_window: int = 0
    global_every: int = 0
    global_layers: Tuple[int, ...] = ()
    rope_theta: float = 10_000.0
    moe: Optional[object] = None      # LM sub-configs: ROADMAP item 11
    ssm: Optional[object] = None
    prefix_len: int = 0
    num_classes: int = 0              # resnet3d: classifier width
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"
    num_encoder_layers: int = 0
    source: str = ""

    def __post_init__(self):
        if self.family not in ARCH_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "resnet3d":
            if self.head_dim == 0 and self.num_heads:
                object.__setattr__(self, "head_dim",
                                   self.d_model // self.num_heads)
            if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
                raise ValueError(
                    f"{self.name}: num_heads {self.num_heads} not divisible "
                    f"by num_kv_heads {self.num_kv_heads}")
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.name}: moe family requires MoEConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: {self.family} requires SSMConfig")

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (the reference's rule:
        resnet3d keeps its block counts, stem width 32, <= 16 classes).
        The signature is the reference's; the LM widths do not apply yet."""
        if self.family == "resnet3d":
            return dataclasses.replace(
                self, name=self.name + "-reduced",
                num_layers=2, d_model=32, num_classes=min(self.num_classes, 16))
        raise NotImplementedError(
            "reduced() of the LM families comes with the LM stack "
            "(ROADMAP Queue 1 item 11)")

    def param_count(self) -> int:
        if self.family != "resnet3d":
            raise NotImplementedError(
                "param_count of the LM families comes with the LM stack "
                "(ROADMAP Queue 1 item 11)")
        from repro_torch.models import resnet3d
        return resnet3d.param_count(self)


@dataclass(frozen=True)
class FedConfig:
    """Hyperparameters of the paper's Algorithm 1 (+ FedAvg baseline)."""
    num_clients: int = 4
    mixing_beta: float = 0.7          # β
    staleness_a: float = 0.5          # a in s(x) = (1+x)^{-a}
    prox_theta: float = 0.01          # θ, proximal regularization
    local_iters_min: int = 1          # H_min
    local_iters_max: int = 3          # H_max
    global_epochs: int = 80           # E
    lr: float = 1e-3                  # η
    momentum: float = 0.9
    weight_decay: float = 0.0
    max_staleness: int = 16           # K (Assumption 3)
    trainable: str = "all"            # "all" | "last_layer"
    compress_bits: int = 0            # 0 = off
    clients_per_round: int = 0        # 0 = whole population in flight
    seed: int = 0


@dataclass(frozen=True)
class DistillConfig:
    """Knowledge-distillation stage config (paper §III-B)."""
    alpha: float = 0.5                # L = α L_cls + (1-α) L_KD
    temperature: float = 1.0          # L_KD = Σ((s-t)/T)²
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-3
    batch_size: int = 128
    epochs: int = 200
    chain: Tuple[str, ...] = ()
