"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. The CPU is used only when asked for by
    name; asking for ``cuda`` (explicitly or by default) on a machine
    without a GPU raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def params_device(params: dict) -> torch.device:
    """Device of a flat parameter dict (all leaves share one)."""
    return next(iter(params.values())).device


def batch_to(batch: dict, device) -> dict:
    """Numpy (or tensor) batch dict -> tensors on ``device``. Integer
    label arrays stay integer; clips keep their float dtype."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` start at one address: the same storage at
    the same offset. Unlike comparing ``data_ptr()``, it holds for
    tensors without memory (fake or meta: a dry run's), whose storages
    are told apart all the same."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())
