"""Mamba2 SSD (state-space duality) blocks: chunked scan in torch ops
(port of ``repro/models/ssm.py``). Group count G=1 (B/C shared across
heads), as in Mamba2-130m.

Kernels: ``ssm_forward(kernel="cuda")`` runs the SSD core through the
chunk-scan kernel and ``ssm_decode_step(kernel="cuda")`` through the fused
SSD step (``kernels/ops.py``); ``"eager"`` is the torch oracle.

Both take their widths from the leaves they are given, so they run on the
whole mixer or, under tensor parallelism (``heads``, a
``sharding.SSMHeads``), on a rank's block of SSD heads: the rank's z, x
and dt columns of ``in_proj``, its x channels of the conv beside every B
and C channel, its heads of ``A_log`` / ``D`` / ``dt_bias``, its columns
of the gated norm and its rows of ``out_proj``. The output is then the
rank's partial sum of the block's output over ``"model"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.attention import check_kernel
from repro_torch.models.common import fan_in_init, rms_norm
from repro_torch.types import SSMConfig


def dims(d_model: int, ssm: SSMConfig):
    d_inner = ssm.expand * d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * ssm.d_state     # x, B, C go through the conv
    return d_inner, n_heads, conv_dim


def block_dims(p: dict):
    """(d_inner, n_heads, conv_dim) of the mixer leaves ``p``: the whole
    mixer's, or a rank's block of heads (``sharding.Pick``)."""
    return p["norm"].shape[-1], p["A_log"].shape[-1], p["conv_b"].shape[-1]


def gated_norm(y, z, scale, heads=None):
    """``rms_norm(y · silu(z), scale)`` over d_inner. Under ``heads`` y, z
    and ``scale`` are the rank's columns: each rank sums the squares of
    its own in f32, one all-reduce over ``"model"`` sums them
    (``heads.sum``), and the mean divides by the whole d_inner."""
    g = y * F.silu(z)
    if heads is None:
        return rms_norm(g, scale)
    dtype = g.dtype
    g = g.float()
    var = heads.sum(torch.sum(g * g, dim=-1, keepdim=True)) \
        / (g.shape[-1] * heads.M)
    return (g * torch.rsqrt(var + 1e-6) * (1.0 + scale.float())).to(dtype)


def init_ssm_params(gen: torch.Generator, d_model: int, ssm: SSMConfig,
                    num_layers: int, dtype=torch.float32) -> dict:
    init = fan_in_init()
    di, nh, conv_dim = dims(d_model, ssm)
    L = num_layers
    proj_out = 2 * di + 2 * ssm.d_state + nh      # z, x, B, C, dt
    dev = gen.device
    return {
        "in_proj": init(gen, (L, d_model, proj_out), dtype),
        "conv_w": init(gen, (L, ssm.d_conv, conv_dim), dtype),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=dev),
        "A_log": torch.zeros((L, nh), dtype=dtype, device=dev),  # A = -1
        "D": torch.ones((L, nh), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((L, nh), dtype=dtype, device=dev),
        "norm": torch.zeros((L, di), dtype=dtype, device=dev),
        "out_proj": init(gen, (L, di, d_model), dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., Q) -> (..., Q, Q) lower-tri cumulative sums sum_{j<i<=k}."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0=None):
    """SSD forward. Returns (y, final_state).

    xh: (B, S, H, P) inputs per head
    dt: (B, S, H)    positive step sizes (already softplus'ed)
    A:  (H,)         negative decay rates
    Bm, Cm: (B, S, N) state in/out projections (G=1, shared over heads)
    h0: optional initial state (B, H, P, N)
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # zero-pad to a chunk multiple: dt=0 rows are exact no-ops
        # (decay exp(0)=1, contribution dt·x⊗B = 0)
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S += pad
    nc = S // Q

    x = xh.reshape(Bsz, nc, Q, H, P)
    dt_c = dt.reshape(Bsz, nc, Q, H)
    B_c = Bm.reshape(Bsz, nc, Q, N)
    C_c = Cm.reshape(Bsz, nc, Q, N)

    dA = dt_c * A[None, None, None, :]                    # (b,c,q,h) negative
    cum = torch.cumsum(dA, dim=2)                         # within-chunk cumsum
    # a mixed-dtype einsum runs in the promoted dtype, as jnp.einsum does
    # (f32 for bf16 x and f32 dt); torch.einsum would refuse the mix
    ft = torch.promote_types(x.dtype, dt.dtype)

    # --- intra-chunk (quadratic within chunk) ---
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))        # (b,c,h,q,k)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)    # (b,c,q,k)
    xdt = x * dt_c[..., None]                             # fold dt into x
    y = torch.einsum("bchqk,bcqk,bckhp->bcqhp", L, scores.to(ft), xdt)

    # --- chunk states ---
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # (b,c,q,h)
    states = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                          dt_c * decay_states, B_c.to(ft), x.to(ft))
    chunk_decay = torch.exp(torch.sum(dA, dim=2))         # (b,c,h)

    # --- inter-chunk recurrence ---
    h = (h0 if h0 is not None
         else torch.zeros((Bsz, H, P, N), dtype=x.dtype, device=x.device))
    h = h.float()
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                  # state entering c
        h = h * chunk_decay[:, c].float()[..., None, None] \
            + states[:, c].float()
    h_prev = torch.stack(h_prev, dim=1)                   # (b,c,h,p,n)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", C_c.to(ft),
                           torch.exp(cum), h_prev.to(x.dtype).to(ft))
    y = (y + y_inter).reshape(Bsz, S, H, P)
    return y[:, :S_orig], h.to(x.dtype)


def _softplus_dt(dt, p):
    return F.softplus(dt.float() + p["dt_bias"].float())


def ssm_forward(p, x, ssm: SSMConfig, state=None, conv_state=None,
                seq_lens=None, kernel: str = "eager", heads=None):
    """Full Mamba2 block (minus residual). x: (B, S, d).

    Training/prefill path. Returns (out, (ssm_state, conv_state)).

    ``seq_lens`` (B,) int marks positions >= seq_lens[b] as right-padding
    (bucketed prefill): their dt is zeroed, an exact no-op on the state
    recurrence (decay exp(0)=1, contribution dt·x⊗B=0), and the returned
    conv_state is gathered from the window ending at each row's last real
    token instead of the padded end. Outputs at pad positions are
    garbage; real positions and both states equal those of the unpadded
    sequence.

    ``kernel="cuda"`` runs the SSD core through the chunk-scan kernel
    (``kernels.ops.ssd_scan``); it takes no initial ``state`` (scoring,
    not chunked prefill). The sequence is padded to the chunk with dt = 0
    rows, exact no-ops on the state, as the reference's
    ``kernel="pallas"`` does.

    ``heads`` (a ``sharding.SSMHeads``): ``p`` holds the rank's block of
    heads (module docstring) and ``out`` is its partial sum.
    """
    check_kernel(kernel)
    if kernel == "cuda" and state is not None:
        raise ValueError("kernel='cuda' does not take an initial state; use "
                         "kernel='eager' for chunked prefill")
    B, S, d = x.shape
    di, nh, conv_dim = block_dims(p)
    N = ssm.d_state

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim, nh], dim=-1)

    # causal depthwise conv over (x, B, C)
    pad = (torch.zeros((B, ssm.d_conv - 1, conv_dim), dtype=xbc.dtype,
                       device=x.device)
           if conv_state is None else conv_state.to(xbc.dtype))
    xbc_pad = torch.cat([pad, xbc], dim=1)
    if seq_lens is None:
        new_conv_state = xbc_pad[:, -(ssm.d_conv - 1):, :]
    else:
        # window ending at each row's last real token: xbc_pad index
        # d_conv-1+t holds input t, so the last d_conv-1 inputs of a row
        # of length P live at indices P..P+d_conv-2
        idx = (seq_lens.long()[:, None]
               + torch.arange(ssm.d_conv - 1, device=x.device)[None, :])
        new_conv_state = torch.gather(
            xbc_pad, 1, idx[:, :, None].expand(-1, -1, conv_dim))
    acc = torch.zeros_like(xbc)
    for i in range(ssm.d_conv):
        acc = acc + xbc_pad[:, i:i + S, :] \
            * p["conv_w"][i][None, None, :].to(acc.dtype)
    xbc = F.silu(acc + p["conv_b"][None, None, :].to(acc.dtype))

    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xh = xs.reshape(B, S, nh, ssm.head_dim)
    dt = _softplus_dt(dt, p)
    if seq_lens is not None:
        active = (torch.arange(S, device=x.device)[None, :]
                  < seq_lens.to(x.device)[:, None])
        dt = dt * active[..., None].to(dt.dtype)
    A = -torch.exp(p["A_log"].float())

    if kernel == "cuda":
        padn = -S % min(ssm.chunk, S)     # rows up to a multiple of the chunk

        def fit(t):     # (B, S, ...) -> (B, S + padn, ...), contiguous
            return F.pad(t, (0, 0) * (t.dim() - 2) + (0, padn)).contiguous()

        y, h_final = ops.ssd_scan(fit(xh), fit(dt), A, fit(Bm), fit(Cm),
                                  ssm.chunk)
        y = y[:, :S]
    else:
        y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk, h0=state)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, di)
    y = gated_norm(y, z, p["norm"], heads)
    out = torch.matmul(y, p["out_proj"].to(y.dtype))
    return out.to(x.dtype), (h_final, new_conv_state)


def ssm_decode_step(p, x, ssm: SSMConfig, state, conv_state,
                    kernel: str = "eager", heads=None):
    """One-token recurrent step. x: (B, 1, d). state: (B, H, P, N),
    conv_state: (B, d_conv-1, conv_dim). Returns (out, (state,
    conv_state)); the caller stores them.

    ``kernel="cuda"`` fuses the recurrence (decay + rank-1 update +
    readout) into ``kernels.ops.ssd_decode_step``: one read and one write
    of the state, the update tensor never materialised. It reads x, B and
    C as the views of the conv output they are, and updates ``state`` in
    place, as the decode attends write the KV cache: the state it returns
    is the caller's own tensor. The eager path returns a new state.

    ``heads`` (a ``sharding.SSMHeads``; eager only): ``p`` and ``state``
    hold the rank's block of heads, ``out`` is its partial sum, and
    ``conv_state`` holds every channel: the rank convolves its own, and
    the new row's x channels are gathered over ``"model"`` into the
    conv state returned, alike on every rank."""
    check_kernel(kernel)
    if heads is not None and kernel != "eager":
        raise ValueError("the decode on a rank's SSD heads (tensor "
                         "parallel) is eager, as the reference's mesh "
                         "serve step")
    B = x.shape[0]
    di, nh, conv_dim = block_dims(p)
    N = ssm.d_state

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim, nh], dim=-1)

    prev = conv_state.to(xbc.dtype)
    if heads is None:
        window = torch.cat([prev, xbc[:, None, :]], dim=1)
        new_conv_state = window[:, 1:, :]
    else:
        window = torch.cat([heads.own_conv(prev), xbc[:, None, :]], dim=1)
        new_conv_state = torch.cat(
            [prev[:, 1:, :], heads.whole_conv(xbc)[:, None, :]], dim=1)
    conv = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype))
    # einsum may leave (B, conv_dim) column-major; the sum is written
    # row-major, so x, B and C below are views with unit inner strides, as
    # the SSD step's kernel reads them
    conv_out = torch.add(conv, p["conv_b"].to(xbc.dtype),
                         out=torch.empty(conv.shape, dtype=conv.dtype,
                                         device=conv.device))
    xbc = F.silu(conv_out)

    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xh = xs.reshape(B, nh, ssm.head_dim)
    dt = _softplus_dt(dt, p)                                    # (B, H)
    A = -torch.exp(p["A_log"].float())
    if kernel == "cuda":
        y, state = ops.ssd_decode_step(xh, dt, A, Bm, Cm, state,
                                       state_out=state)
    else:
        dA = torch.exp(dt * A[None, :])                         # (B, H)
        # h <- dA * h + dt * x ⊗ B
        upd = torch.einsum("bh,bhp,bn->bhpn", dt.to(xh.dtype), xh, Bm)
        state = state * dA[..., None, None].to(state.dtype) + upd
        yt = torch.promote_types(state.dtype, Cm.dtype)
        y = torch.einsum("bhpn,bn->bhp", state.to(yt), Cm.to(yt))
    y = y + xh * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B, di)
    y = gated_norm(y, z, p["norm"], heads)
    out = torch.matmul(y, p["out_proj"].to(y.dtype))[:, None, :]
    return out.to(x.dtype), (state, new_conv_state)
