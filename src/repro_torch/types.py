"""Config dataclasses: the port's own copy of ``repro/types.py``.

Frozen dataclasses, so configs are hashable and compare by value. The
fields match the reference's exactly (the parity tests build both
packages' configs by name and compare them field by field).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ARCH_FAMILIES = (
    "dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio", "resnet3d",
)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False      # Llama-4 style always-on shared expert
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 128          # SSD chunk length
    d_conv: int = 4           # depthwise conv width


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.family in ("encdec", "audio")

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM / SWA-dominant)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def window_for_layer(self, layer: int) -> int:
        """Effective attention window for a layer. 0 = full attention."""
        if self.sliding_window == 0:
            return 0
        if self.global_layers and layer in self.global_layers:
            return 0
        if self.global_every and (layer + 1) % self.global_every == 0:
            return 0
        return self.sliding_window

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU tests (the reference's rule).

        resnet3d keeps its block counts, stem width 32, <= 16 classes. The
        LM families keep the head/kv ratio, the attention pattern kind and
        the MoE/SSM structure, shrinking every width: <= 4 experts,
        d_model <= 512, ``num_layers`` layers.
        """
        if self.family == "resnet3d":
            return dataclasses.replace(
                self, name=self.name + "-reduced",
                num_layers=2, d_model=32, num_classes=min(self.num_classes, 16))
        num_heads = max(2, min(4, self.num_heads)) if self.num_heads else 0
        kv = max(1, min(num_heads, self.num_kv_heads)) if num_heads else 0
        if num_heads and num_heads % kv:
            kv = 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(self.moe.top_k, min(4, self.moe.num_experts)))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, d_state=min(16, self.ssm.d_state), head_dim=32,
                chunk=32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            num_encoder_layers=min(self.num_encoder_layers, num_layers),
            d_model=min(d_model, 512),
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=(min(d_model, 512) // num_heads) if num_heads else 0,
            d_ff=2 * min(d_model, 512),
            vocab_size=vocab,
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            global_layers=tuple(g for g in self.global_layers
                                if g < num_layers),
            prefix_len=min(self.prefix_len, 8),
            moe=moe,
            ssm=ssm,
        )

    def param_count(self) -> int:
        """Approximate parameter count N (the reference's formula)."""
        if self.family == "resnet3d":
            from repro_torch.models import resnet3d
            return resnet3d.param_count(self)
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        q = self.num_heads * hd
        kvd = self.num_kv_heads * hd
        attn = d * q + 2 * d * kvd + q * d
        mlp = 3 * d * f
        if self.moe is not None and self.moe.num_experts:
            mlp = self.moe.num_experts * 3 * d * f + d * self.moe.num_experts
            if self.moe.shared_expert:
                mlp += 3 * d * f
        ssm = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            # in/out projections + B,C state projections (SSD, grouped B/C)
            ssm = d * 2 * di + di * d + di * 2 * self.ssm.d_state
        per_layer = 2 * d  # norms
        if self.family == "ssm":
            per_layer += ssm
        elif self.family == "hybrid":
            per_layer += attn + mlp + ssm
        else:
            per_layer += attn + mlp
        total_layers = self.num_layers + self.num_encoder_layers
        n = total_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            n += v * d
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts
        count); the reference's formula."""
        if self.moe is None or not self.moe.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.moe.num_experts - self.moe.top_k) * 3 * d * f
        return int(self.param_count() - self.num_layers * inactive)


@dataclass(frozen=True)
class ShapeConfig:
    """A workload shape: sequence length, global batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


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

    @property
    def imbalance_ratio(self) -> float:
        """λ = H_max / H_min (the convergence bound's imbalance ratio)."""
        return self.local_iters_max / max(1, self.local_iters_min)


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
