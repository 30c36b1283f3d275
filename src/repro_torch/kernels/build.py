"""Build the port's CUDA sources, load them with ctypes and launch them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` under
the repository root (listed in ``.gitignore``). The hash covers that source,
the shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded. Nothing is
compiled at import: the first ``load`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built on a machine "
            "with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the sources' shared headers
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is already built. Returns
    nvcc's output (the ptxas report), or "" when nothing was compiled;
    raises with that output if nvcc fails."""
    out = _lib_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build(name)
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


_DTENSOR: list = []


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel reads its operands' ``data_ptr``: a DTensor's is not the
    block it holds. Raise on one; the caller crosses to its rank-local
    tensor first (``torch.distributed.tensor.experimental.local_map``, or
    ``to_local`` / ``from_local`` with explicit placements)."""
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    for t in tensors:
        if isinstance(t, _DTENSOR[0]):
            raise TypeError(
                f"{name}: got a DTensor; a kernel takes rank-local tensors "
                "(cross with torch.distributed.tensor.experimental."
                "local_map, or to_local / from_local)")


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)``: a C entry called with ``device``'s current
    stream. The current device is switched only when it is another one
    (the switch costs a caller microseconds a launch); the stream is asked
    for by index, which skips the device's parsing."""
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    with torch.cuda.device(idx):
        return fn(*args, torch.cuda.current_stream(idx).cuda_stream)
