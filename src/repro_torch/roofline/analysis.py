"""Roofline terms of one counted step on the H100 (port of
``repro/roofline/analysis.py``).

    compute_s    = Σ_class flops_class / peak_class
    memory_s     = bytes_per_device / HBM bandwidth
    collective_s = collective_bytes_per_device / NVLink bandwidth

The reference reads its flops, bytes and collectives from the compiled
HLO of one device (``analyze_compiled``). PyTorch has no compiled program
to read, so ``analyze_step`` counts one eager call of the step instead
(``roofline/counter.py``), collectives included: there is no HLO text
and so no ``parse_collective_bytes``; the all-reduce ×2 rule lives in the
counter.

The reference prices every flop at one bf16 peak. The port runs its
products in f32 without TF32 (cuBLAS's default), cuDNN's convolutions in
TF32 (cuDNN's default), its hand kernels 2, 3, 5 and 6 in 3xTF32 (three
TF32 products a product) and everything else on the FMA pipes, so the
counter keeps each class of flops apart and ``compute_s`` prices each at
its own peak (``HW.peak``).

The analytic models below are each hand kernel's work, the one source of
it: the kernel wrappers record them into an active counter, and
``chip_smoke.py`` computes every kernel's bound from them. The four
decode models are the reference's, copied exactly; the others are the
port's, one for each kernel the reference gave none.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

# the flop classes a counter keeps apart, and what runs in each
PRECISIONS = {
    "f32": "f32 on the FMA pipes (elementwise ops, f32 products without "
           "TF32, the KD loss and SSD step kernels)",
    "tf32": "TF32 on the tensor cores (f32 products and convolutions with "
            "TF32 allowed)",
    "3xtf32": "3xTF32 on the tensor cores: three TF32 products a product "
              "(kernels 2, 3, 5, 6)",
    "bf16": "bf16 / fp16 on the tensor cores",
}


@dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM5 80GB: NVIDIA H100 Tensor Core GPU datasheet,
    SXM column, dense rates (no sparsity), at the 700 W power limit.

    hbm_bw      3.35e12 B/s   HBM3 bandwidth
    hbm_bytes   80e9 B        HBM3 capacity
    f32_flops   67e12 FLOP/s  FP32 (the FMA pipes, outside the tensor cores)
    tf32_flops  495e12        TF32 Tensor Core
    bf16_flops  989e12        BF16 / FP16 Tensor Core
    link_bw     450e9 B/s     NVLink 900 GB/s bidirectional, one direction
    """
    hbm_bw: float = 3.35e12
    hbm_bytes: float = 80e9
    f32_flops: float = 67e12
    tf32_flops: float = 495e12
    bf16_flops: float = 989e12
    link_bw: float = 450e9

    def peak(self, precision: str) -> float:
        """FLOP/s of one class of ``PRECISIONS``; 3xTF32 does a product's
        work at a third of the TF32 rate."""
        peaks = {"f32": self.f32_flops, "tf32": self.tf32_flops,
                 "3xtf32": self.tf32_flops / 3, "bf16": self.bf16_flops}
        if precision not in peaks:
            raise ValueError(f"unknown precision {precision!r}; known: "
                             f"{sorted(peaks)}")
        return peaks[precision]

    def bound_s(self, flops: dict, nbytes: float) -> tuple:
        """(seconds, "bytes" or "operations"): the least time for
        ``nbytes`` of HBM traffic and ``flops`` ({class: count}), the
        larger of the two."""
        bytes_s = nbytes / self.hbm_bw
        ops_s = sum(n / self.peak(p) for p, n in flops.items())
        return max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                     else "operations")


# ---------------------------------------------------------------------------
# Analytic decode-step byte models (the reference's, copied exactly)
# ---------------------------------------------------------------------------

def attend_decode_bytes(n_ctx: int, kv_heads: int, q_heads: int,
                        head_dim: int, *, dtype_bytes: int = 4,
                        fused: bool = True) -> int:
    """Modeled HBM bytes for ONE decode-attend step of one stream against
    an ``n_ctx``-position cache (a W-slot ring or the first ``k_ext``
    positions of a uniform cache — the model is the same).

    Fused path: one pass over K and V plus the q/out vectors. The einsum
    path additionally materializes the (q_heads, n_ctx) f32 scores and
    probabilities in HBM (one write + one read each)."""
    if n_ctx < 1:
        raise ValueError(f"n_ctx must be >= 1, got {n_ctx}")
    qo = 2 * q_heads * head_dim * dtype_bytes            # q read + out write
    cache = 2 * n_ctx * kv_heads * head_dim * dtype_bytes    # K + V, 1 pass
    total = qo + cache
    if not fused:
        total += 4 * q_heads * n_ctx * 4    # scores + probs, write + read
    return total


def attend_decode_flops(n_ctx: int, q_heads: int, head_dim: int) -> int:
    """MACs*2 for one decode-attend step: q·K plus p·V."""
    return 2 * 2 * q_heads * head_dim * n_ctx


def ssd_decode_bytes(heads: int, head_dim: int, d_state: int, *,
                     dtype_bytes: int = 4, fused: bool = True) -> int:
    """Modeled HBM bytes for ONE fused SSD decode step of one stream:
    the (H, P, N) recurrent state read + written once, plus the x/dt/B/C/y
    vectors. The einsum path additionally materializes the (H, P, N)
    ``dt·x⊗B`` update tensor in HBM (write + read) before the state
    addition."""
    state = 2 * heads * head_dim * d_state * dtype_bytes     # read + write
    io = (2 * heads * head_dim + 2 * d_state + 2 * heads) * dtype_bytes
    total = state + io
    if not fused:
        total += 2 * heads * head_dim * d_state * 4   # upd, write + read
    return total


def ssd_decode_flops(heads: int, head_dim: int, d_state: int) -> int:
    """One SSD decode step: state decay + rank-1 update + C readout."""
    return (3 * heads * head_dim * d_state
            + 2 * heads * head_dim * d_state)


# ---------------------------------------------------------------------------
# The port's kernels: work of one call, as ({class: flops}, bytes)
# ---------------------------------------------------------------------------

def kd_loss_cost(R: int, V: int, *, dtype_bytes: int = 4, lse: bool = True,
                 masked: bool = False) -> tuple:
    """Kernel 1, the KD loss forward over (R, V) logits: s and t read
    once, labels read, the loss written, the row logsumexp written when
    asked (``lse``; the KD step's call: 3 R words) and the row mask read
    when given; ~7 f32 operations an element (max, sub, exp, add,
    compare, sub-scale, fma)."""
    words = 2 + lse + masked
    return {"f32": 7 * R * V}, 2 * R * V * dtype_bytes + words * R * 4


def kd_loss_bwd_cost(R: int, V: int, *, dtype_bytes: int = 4,
                     need_dt: bool = False, masked: bool = False) -> tuple:
    """Kernel 1b, the KD loss backward: s and t read and ds written (dt
    too when the teacher needs a gradient), labels, the cotangent and the
    logsumexp read (the row mask too when given); ~8 f32 operations an
    element (sub, scale, sub, exp, compare, two multiply-adds,
    multiply)."""
    planes = 4 if need_dt else 3
    words = 3 + masked
    return {"f32": 8 * R * V}, planes * R * V * dtype_bytes + words * R * 4


def ring_visible(pos: Sequence[int], W: int, window: int) -> list:
    """Keys each row's query sees in a W-slot ring (slot s holding the
    latest position ≡ s mod W up to ``pos``): causal, in-window
    (``window`` 0: full) and written."""
    return [min(p + 1, W, window or W) for p in pos]


def extent_visible(pos: Sequence[int], k_ext: int, window: int) -> list:
    """Keys each row's query sees among the first ``k_ext`` positions of
    a uniform cache: positions ≤ ``pos`` and within ``window`` of it."""
    out = []
    for p in pos:
        lo = max(0, p - window + 1) if window else 0
        out.append(max(0, min(p, k_ext - 1) - lo + 1))
    return out


def decode_attend_cost(n_vis: Sequence[int], kv_heads: int, group: int,
                       head_dim: int, *, q_bytes: int = 4,
                       kv_bytes: int = 4) -> tuple:
    """Kernels 2 and 3, one batched decode attend, ``n_vis[b]`` keys seen
    by row b: the reference's per-stream model summed over the rows (K
    and V of the visible keys once, q read and the output written), plus
    the (B,) int32 positions the port's kernel reads; 3xTF32 products.
    With ``q_bytes == kv_bytes`` the bytes are
    Σ_b ``attend_decode_bytes(n_vis[b], ...)`` + 4 B."""
    B, n = len(n_vis), sum(n_vis)
    flops = sum(attend_decode_flops(k, kv_heads * group, head_dim)
                for k in n_vis)
    nbytes = (2 * n * kv_heads * head_dim * kv_bytes
              + 2 * B * kv_heads * group * head_dim * q_bytes + 4 * B)
    return {"3xtf32": flops}, nbytes


def ssd_step_cost(B: int, H: int, P: int, N: int, *, x_bytes: int = 4,
                  state_bytes: int = 4, y_bytes: int = 4) -> tuple:
    """Kernel 4, one batched SSD decode step: the (B, H, P, N) state read
    and written once, x read and y written, dt (B, H) and A (H,) read,
    B and C (B, N) read; ``ssd_decode_flops`` a row on the FMA pipes.
    A is read once for the batch, where the reference's per-stream model
    reads it (and dt) with every stream."""
    nbytes = (2 * B * H * P * N * state_bytes + B * H * P * (x_bytes
                                                             + y_bytes)
              + 4 * B * H + 4 * H + 2 * B * N * x_bytes)
    return {"f32": B * ssd_decode_flops(H, P, N)}, nbytes


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs of one head inside the causal band of
    ``window``: Σ_i min(i + 1, window)."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def swa_attention_cost(B: int, S: int, H: int, KV: int, D: int,
                       window: int, *, dtype_bytes: int = 4) -> tuple:
    """Kernel 5, causal sliding-window attention over q (B, S, H, D) and
    k, v (B, S, KV, D) (the folded entry: B = BH, H = KV = 1): q, k, v
    read and the output written once; 4 D operations per visible (query
    head, key) pair, the score's and p·V's multiply-adds, in 3xTF32."""
    nbytes = 2 * (B * S * H * D + B * S * KV * D) * dtype_bytes
    return {"3xtf32": 4 * D * B * H * visible_pairs(S, window)}, nbytes


def ssd_scan_cost(B: int, S: int, H: int, P: int, N: int, *,
                  dtype_bytes: int = 4, chunk: int = 64) -> tuple:
    """Kernel 6, the SSD chunk scan: x, dt, A, B, C read and y and the
    final state written once; per (b, h) and chunk of Q = min(``chunk``,
    S) rows (the kernels' own, ``kernels/ssd_scan.BLOCK_CHUNK``) the causal
    triangle's C·B and G·(x dt) products, Q(Q+1)(N + P), and the state's
    readout and update, 4 Q P N, in 3xTF32."""
    es = dtype_bytes
    nbytes = (2 * B * S * H * P * es + 4 * B * S * H + 4 * H
              + 2 * B * S * N * es + B * H * P * N * es)
    Q = min(chunk, S)
    per_chunk = Q * (Q + 1) * (N + P) + 4 * Q * P * N
    return {"3xtf32": per_chunk * B * H * -(-S // Q)}, nbytes


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collectives: dict
    peak_memory_bytes: float
    model_flops_global: float      # 6·N_active·D
    hw: HW = field(default_factory=HW)
    flops_by_class: dict = field(default_factory=dict)
    model_precision: str = "f32"   # the class the model's products run in
    measured_s: float | None = None
    loops: list = field(default_factory=list)
    kernels: dict = field(default_factory=dict)

    def _classes(self) -> dict:
        return self.flops_by_class or {self.model_precision:
                                       self.flops_per_device}

    @property
    def compute_s(self) -> float:
        return sum(n / self.hw.peak(p) for p, n in self._classes().items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Simple max-of-terms roofline step estimate."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat & redundancy waste)."""
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization: the model's flops over the measured
        step time (the roofline step time where none was measured) times
        the peak of ``model_precision`` on every chip."""
        t = self.step_time_s if self.measured_s is None else self.measured_s
        denom = t * self.hw.peak(self.model_precision) * self.chips
        return self.model_flops_global / denom if denom else 0.0

    @property
    def roofline_share(self) -> float | None:
        """``step_time_s`` over the measured time (None unmeasured)."""
        if not self.measured_s:
            return None
        return self.step_time_s / self.measured_s

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "flops_by_class": {p: {"flops": n, "precision": PRECISIONS[p],
                                   "peak_flops": self.hw.peak(p)}
                               for p, n in self._classes().items()},
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops_global": self.model_flops_global,
            "model_precision": self.model_precision,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s, "measured_s": self.measured_s,
            "roofline_share": self.roofline_share,
            "useful_flop_ratio": self.useful_flop_ratio, "mfu": self.mfu,
            "loops": self.loops, "kernels": self.kernels,
        }


def analyze_step(fn, *args, arch: str, shape: str, mesh_name: str,
                 chips: int, model_flops_global: float, hw: HW = HW(),
                 model_precision: str = "f32", loops=(), watch=(),
                 **kwargs):
    """Count one eager call ``fn(*args, **kwargs)`` (``counter.Counter``)
    and return ``(out, RooflineReport)``: the counterpart of
    ``analyze_compiled``, which reads a compiled program. ``loops`` are
    the (name, trip count) pairs the caller declares; ``watch`` are trees
    of tensors alive before the call (params, batch), counted in the peak
    memory."""
    from repro_torch.roofline.counter import Counter
    with Counter(loops=loops, watch=watch) as c:
        out = fn(*args, **kwargs)
    return out, c.report(arch=arch, shape=shape, mesh_name=mesh_name,
                         chips=chips, model_flops_global=model_flops_global,
                         hw=hw, model_precision=model_precision)
