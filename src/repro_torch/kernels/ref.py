"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``). The CPU path and the on-card comparisons use
them; the kernels are held against them."""
from __future__ import annotations

import torch


def kd_loss_ref(student_logits, teacher_logits, labels, alpha: float,
                temperature: float = 1.0, valid=None):
    """Per-row fused KD loss: α·CE + (1-α)·Σ((s-t)/T)².

    student/teacher: (R, V); labels: (R,) int. Returns (R,) float32.
    Rows where ``valid`` == 0 return exactly 0.0 (select, not multiply, so
    garbage logits in masked rows cannot leak NaN/Inf).
    """
    s = student_logits.float()
    t = teacher_logits.float()
    lse = torch.logsumexp(s, dim=-1)
    gold = torch.gather(s, -1, labels.long()[:, None])[:, 0]
    d = (s - t) / temperature
    out = alpha * (lse - gold) + (1.0 - alpha) * torch.sum(d * d, dim=-1)
    if valid is None:
        return out
    return torch.where(valid.float() > 0.0, out, torch.zeros_like(out))


NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Scoring kernels: sliding-window attention and the SSD chunk scan
# ---------------------------------------------------------------------------

def swa_attention_ref(q, k, v, window: int, causal: bool = True):
    """Sliding-window attention. q, k, v: (BH, S, D); window > 0 = the
    keys each query may see (its own position included); causal=False
    sees |i - j| < window. f32 scores, softmax and p·V; returns q's
    dtype."""
    BH, S, D = q.shape
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (D ** -0.5)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    ok = ((qi - ki < window) & (qi - ki >= 0)) if causal \
        else ((qi - ki).abs() < window)
    s = s.masked_fill(~ok[None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def swa_attention_gqa_ref(q, k, v, window: int, causal: bool = True):
    """``swa_attention_ref`` in the model's layout, as the reference's
    ``gqa_attention(kernel="pallas")`` reaches its kernel: q (B, S, H, D),
    k and v (B, S, KV, D) repeated over the G = H // KV query heads, the
    heads folded into (B·H, S, D), attended and unfolded. Returns the
    (B, S, H, D) view of the folded result."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kg = torch.repeat_interleave(k, G, dim=2) if G > 1 else k
    vg = torch.repeat_interleave(v, G, dim=2) if G > 1 else v
    fold = lambda t: t.transpose(1, 2).reshape(B * H, S, D).contiguous()
    out = swa_attention_ref(fold(q), fold(kg), fold(vg), window, causal)
    return out.reshape(B, H, S, D).transpose(1, 2)


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int):
    """Mamba2 SSD: the model's chunked scan (``models.ssm.ssd_chunked``)
    run in f32 and rounded once to x's dtype, as the reference's Pallas
    scan computes it (its bf16 einsums would round C·Bᵀ and the carried
    state on the way). x: (B, S, H, P); dt: (B, S, H) softplus'ed; A:
    (H,); Bm, Cm: (B, S, N). Returns (y (B, S, H, P), final state
    (B, H, P, N)), both in x's dtype."""
    from repro_torch.models.ssm import ssd_chunked
    y, h = ssd_chunked(x.float(), dt.float(), A.float(), Bm.float(),
                       Cm.float(), chunk)
    return y.to(x.dtype), h.to(x.dtype)


# The sequential oracle the tests hold the chunked scans against.
# repro-lint: disable=R4
def ssd_sequential_ref(x, dt, A, Bm, Cm):
    """The O(S) recurrence, the independent ground truth for SSD:
    h_t = exp(dt_t A) h_{t-1} + dt_t · x_t ⊗ B_t;  y_t = C_t · h_t."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * A[None, :])                      # (B, H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], bf[:, t])
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)


# ---------------------------------------------------------------------------
# Decode kernels (serving): the one-token attends and the SSD step
# ---------------------------------------------------------------------------


def _window_bias(pos, window: int, k_pos):
    """(B, L) additive mask for one query per row at ``pos`` (B,): causal,
    in-window (window == 0 -> full) and unwritten (k_pos < 0) slots."""
    p = pos.long()[:, None]
    w_eff = window if window else 2 ** 30
    ok = (p >= k_pos) & (p - k_pos < w_eff) & (k_pos >= 0)
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    return torch.where(ok, zero, NEG_INF)


def _decode_attend(q, k, v, bias):
    """Shared one-token attend body (the reference's ``_decode_attend``):
    f32 scores, additive bias, max-subtract / divide-after-sum softmax,
    p cast to q's dtype, f32 p·V. q (B, KV, G, D); k, v (B, L, KV, D);
    bias (B, L). Returns q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), k.float()) * scale
    s = s + bias[:, None, None, :]
    m = torch.amax(s, dim=-1, keepdim=True)
    un = torch.exp(s - m)
    p = (un / torch.sum(un, dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bkgs,bskd->bkgd", p.float(), v.float()).to(q.dtype)


def ring_decode_attend_ref(q, k, v, pos, window: int):
    """One-token attend over a W-slot ring. q (B, KV, G, D); k, v
    (B, W, KV, D), slot s holding the latest position ≡ s (mod W); pos
    (B,) int; window int (0 = full). Returns (B, KV, G, D)."""
    W = k.shape[1]
    p = pos.long()[:, None]
    k_pos = p - (p - torch.arange(W, device=pos.device)) % W   # floor mod
    return _decode_attend(q, k, v, _window_bias(pos, window, k_pos))


def extent_decode_attend_ref(q, k, v, pos, window: int, k_ext: int):
    """One-token attend over the first ``k_ext`` positions of a
    (B, S_max, KV, D) cache, with each row's ``k_pos < pos + 1`` mask added
    to the window mask."""
    k_pos = torch.arange(k_ext, device=pos.device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=pos.device)
    bias = _window_bias(pos, window, k_pos) + torch.where(
        k_pos < pos.long()[:, None] + 1, zero, NEG_INF)
    return _decode_attend(q, k[:, :k_ext], v[:, :k_ext], bias)


def ssd_decode_step_ref(xh, dt, A, Bm, Cm, state):
    """One SSD token step: h' = h·exp(dt·A) + dt·x⊗B, y = h'·C.
    xh (B, H, P); dt (B, H) f32; A (H,) f32; Bm, Cm (B, N); state
    (B, H, P, N). Returns (y in the dtype of promote(state, C), h' in
    state's dtype). A row with dt = 0 leaves its state exactly as it was."""
    dA = torch.exp(dt * A[None, :])
    # dt·x, then ·B, each rounded in x's dtype: an explicit order (a
    # three-operand einsum leaves it to the library), the kernel's
    upd = (dt.to(xh.dtype)[..., None] * xh)[..., None] * Bm[:, None, None, :]
    h = state * dA[..., None, None].to(state.dtype) + upd
    # the readout accumulates in f32 and rounds once, as XLA's dot does
    # (cuBLAS would otherwise reduce a bf16 product in reduced precision)
    y = torch.einsum("bhpn,bn->bhp", h.float(), Cm.float())
    return (y.to(torch.promote_types(state.dtype, Cm.dtype)),
            h.to(state.dtype))
