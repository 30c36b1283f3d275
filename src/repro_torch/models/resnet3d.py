"""3-D ResNets (Hara et al.) — the paper's teacher/TA/student family.

Port of ``repro/models/resnet3d.py``. The public functions take NDHWC clips
as the reference does; inside, activations are NCDHW and conv weights are
stored OIDHW (``checkpoint/convert.py`` maps the reference's DHWIO).
Params are a flat dict keyed by the reference checkpoint paths
(``stem/w``, ``stages/2/0/w1``, ``fc/b`` ...).

BasicBlock with two 3x3x3 convs and a 1x1x1 projection on width changes;
GroupNorm(gcd(32, C)), scale only, in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.resnet3d import BLOCKS, CLIP_FRAMES, CLIP_SIZE
from repro_torch.types import ModelConfig

STAGE_WIDTHS = (1, 2, 4, 8)  # multiples of the stem width


def _blocks(cfg: ModelConfig):
    return BLOCKS[cfg.name.replace("-reduced", "")]


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's key and shape (conv weights OIDHW, fc (C, classes))."""
    w0 = cfg.d_model
    shapes = {"stem/w": (w0, 3, 3, 7, 7), "stem/gn": (w0,)}
    c_in = w0
    for si, nblk in enumerate(_blocks(cfg)):
        c_out = w0 * STAGE_WIDTHS[si]
        for bi in range(nblk):
            cin = c_in if bi == 0 else c_out
            pre = f"stages/{si}/{bi}/"
            shapes[pre + "w1"] = (c_out, cin, 3, 3, 3)
            shapes[pre + "gn1"] = (c_out,)
            shapes[pre + "w2"] = (c_out, c_out, 3, 3, 3)
            shapes[pre + "gn2"] = (c_out,)
            if cin != c_out:
                shapes[pre + "proj"] = (c_out, cin, 1, 1, 1)
        c_in = c_out
    shapes["fc/w"] = (c_in, cfg.num_classes)
    shapes["fc/b"] = (cfg.num_classes,)
    return shapes


def init_params(gen: torch.Generator, cfg: ModelConfig, device,
                dtype=torch.float32) -> dict:
    """GroupNorm scales 1, fc bias 0, weights ~ N(0, 1/fan_in), drawn from
    ``gen`` (a CPU generator, so one seed gives the same weights on every
    device). Not the reference's numbers: the parity tests convert
    JAX-initialised params instead."""
    p = {}
    for k, shape in param_shapes(cfg).items():
        leaf = k.rsplit("/", 1)[1]
        if leaf.startswith("gn"):
            v = torch.ones(shape)
        elif k == "fc/b":
            v = torch.zeros(shape)
        else:
            fan_in = math.prod(shape[1:]) if len(shape) == 5 else shape[0]
            v = torch.randn(shape, generator=gen) / math.sqrt(fan_in)
        p[k] = v.to(device=device, dtype=dtype)
    return p


def _group_norm(x, scale, groups: int = 32, eps: float = 1e-5):
    """Biased variance in f32, scale only. torch and the reference both
    group contiguous channels, so F.group_norm is the same function."""
    g = math.gcd(groups, x.shape[1])
    return F.group_norm(x.float(), g, weight=scale.float(),
                        eps=eps).to(x.dtype)


def same_pad(size: int, k: int, stride: int) -> tuple:
    """XLA ``padding="SAME"`` for one dimension: output ceil(size/stride),
    and an odd total pad puts the extra element on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv3d(x, w, stride: int = 1):
    pads = [same_pad(n, k, stride) for n, k in zip(x.shape[2:], w.shape[2:])]
    if all(lo == hi for lo, hi in pads):
        return F.conv3d(x, w, stride=stride,
                        padding=tuple(lo for lo, _ in pads))
    # F.pad lists the last dim first: (W_lo, W_hi, H_lo, H_hi, D_lo, D_hi)
    x = F.pad(x, [p for lo, hi in reversed(pads) for p in (lo, hi)])
    return F.conv3d(x, w, stride=stride)


def forward(params: dict, cfg: ModelConfig,
            clips: torch.Tensor) -> torch.Tensor:
    """clips: (B, T, H, W, 3) -> logits (B, num_classes)."""
    x = clips.permute(0, 4, 1, 2, 3).contiguous()
    x = _conv3d(x, params["stem/w"], stride=2)
    x = F.relu(_group_norm(x, params["stem/gn"]))
    for si, nblk in enumerate(_blocks(cfg)):
        for bi in range(nblk):
            pre = f"stages/{si}/{bi}/"
            stride = 2 if (si > 0 and bi == 0) else 1
            h = _conv3d(x, params[pre + "w1"], stride=stride)
            h = F.relu(_group_norm(h, params[pre + "gn1"]))
            h = _conv3d(h, params[pre + "w2"])
            h = _group_norm(h, params[pre + "gn2"])
            if pre + "proj" in params:
                sc = _conv3d(x, params[pre + "proj"], stride=stride)
            elif stride != 1:
                sc = x[:, :, ::stride, ::stride, ::stride]
            else:
                sc = x
            x = F.relu(h + sc)
    x = x.mean(dim=(2, 3, 4))                            # global avg pool
    return x @ params["fc/w"] + params["fc/b"]


def logits_fn(params: dict, cfg: ModelConfig, batch: dict, **_):
    return forward(params, cfg, batch["clips"])


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, **_) -> tuple:
    """batch: clips (B, T, H, W, 3), labels (B,)."""
    from repro_torch.models.common import cross_entropy
    ce = cross_entropy(forward(params, cfg, batch["clips"]), batch["labels"])
    return ce, {"ce": ce}


def param_count(cfg: ModelConfig) -> int:
    w0 = cfg.d_model
    n = 3 * 7 * 7 * 3 * w0
    c_in = w0
    for si, nblk in enumerate(_blocks(cfg)):
        c_out = w0 * STAGE_WIDTHS[si]
        for bi in range(nblk):
            cin = c_in if bi == 0 else c_out
            n += 27 * cin * c_out + 27 * c_out * c_out
            if cin != c_out:
                n += cin * c_out
        c_in = c_out
    return n + c_in * cfg.num_classes


def macs_per_clip(cfg: ModelConfig, frames: int = CLIP_FRAMES,
                  size: int = CLIP_SIZE) -> float:
    """Multiply-accumulates of one clip's forward pass (the reference's
    analytic count, kept equal to it)."""
    w0 = cfg.d_model
    t, hw = frames / 2, size / 2          # stem stride 2
    macs = (t * hw * hw) * 3 * 7 * 7 * 3 * w0
    c_in = w0
    for si, nblk in enumerate(_blocks(cfg)):
        c_out = w0 * STAGE_WIDTHS[si]
        if si > 0:
            t, hw = max(t / 2, 1), hw / 2
        vox = t * hw * hw
        for bi in range(nblk):
            cin = c_in if bi == 0 else c_out
            macs += vox * 27 * (cin * c_out + c_out * c_out)
            if cin != c_out:
                macs += vox * cin * c_out
        c_in = c_out
    return float(macs)


def input_shape(cfg: ModelConfig, batch: int):
    """NDHWC clip batch shape a config is built for: 4x16x16 for the
    reduced configs, the paper's 8x112x112 otherwise."""
    if "reduced" in cfg.name:
        return (batch, 4, 16, 16, 3)
    return (batch, CLIP_FRAMES, CLIP_SIZE, CLIP_SIZE, 3)
