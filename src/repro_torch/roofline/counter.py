"""Count the flops, HBM bytes and collective bytes of one eager call: the
port's twin of ``repro/roofline/hlo.py::analyze_hlo``.

The reference walks the compiled HLO of one device. PyTorch runs eagerly,
so ``Counter`` is a ``TorchDispatchMode`` that sees every aten op of the
call, real, fake (``FakeTensorMode``: no storage, no compute) or on the
card, and applies ``hlo.py``'s rules to it:

- flops: products and convolutions by ``torch.utils.flop_counter``'s
  formulas (2·|out|·|contraction|, as ``hlo.py``'s ``_dot_flops`` and
  ``_conv_flops``), every other op 1 flop an output element; each flop
  in its class of ``analysis.PRECISIONS``, read from the op's dtype and
  the TF32 switches at the call;
- bytes: operand + output bytes of every op that is not free. The free
  ops (``hlo.py``'s ``_FREE_OPS``: parameters, bitcasts, reshapes) are
  here the views, ``detach`` and the allocations that write nothing. An
  op that writes one of its operands in place (``copy_`` into a slice,
  ``hlo.py``'s dynamic-update-slice rule) counts that operand once, as
  its write, at the size of the view it was given, not of the buffer;
- collectives: the ``_c10d_functional`` and ``c10d`` ops, output bytes by
  kind (``hlo.py``'s names), all-reduce doubled (the reduce-scatter and
  all-gather phases of a ring each move the buffer);
- loops: a Python loop simply runs under the mode, so its trip count
  multiplies by construction; ``loops`` keeps the (name, trip count)
  pairs the caller declares, as ``HloCost.loops`` keeps those it finds;
- the hand kernels launch through ``ctypes``, which dispatch cannot see:
  each wrapper (``repro_torch/kernels``) records its analytic work
  (``analysis.*_cost``) through ``kernel`` and runs with the counter
  paused, its plain version on the CPU included. A step counts the same
  on the card and on the CPU, whatever implements each kernel;
- peak memory: the bytes of the storages alive, those of ``watch`` (the
  inputs) and those the call made, at their high point.

A CUDA graph's replay runs outside dispatch and would count nothing, so
``GraphCache.call`` raises under an active counter: count an eager run.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.analysis import HW, RooflineReport

# the active counters, innermost last; the wrappers read it on every call
_STACK: list = []

_ATEN = torch.ops.aten
_FREE = {_ATEN.detach, _ATEN.alias, _ATEN.lift_fresh, _ATEN.empty,
         _ATEN.empty_like, _ATEN.empty_strided, _ATEN.new_empty,
         _ATEN.new_empty_strided, _ATEN._local_scalar_dense,
         _ATEN.resize_, _ATEN.set_}

COLLECTIVES = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "allgather_": "all-gather",
               "_allgather_base_": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_": "reduce-scatter",
               "_reduce_scatter_base_": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "alltoall_base_": "all-to-all",
               "broadcast": "broadcast", "broadcast_": "broadcast",
               "send": "collective-permute",
               "recv_": "collective-permute"}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d")


def counting() -> bool:
    """Whether a counter is active and not paused: a kernel wrapper then
    records its work through ``kernel``."""
    return len(_STACK) > 0 and not _STACK[-1].paused


def kernel(name: str, cost: tuple, fn, *args, **kwargs):
    """Record ``cost`` ((flops by class, bytes), ``analysis.*_cost``) as
    one launch of kernel ``name`` into the active counter, and return
    ``fn(*args, **kwargs)`` run with the counter paused."""
    c = _STACK[-1]
    c.add_kernel(name, *cost)
    c.paused = True
    try:
        return fn(*args, **kwargs)
    finally:
        c.paused = False


def _tensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    leaves, _ = tree_flatten(tree)
    return [x._local_tensor if isinstance(x, DTensor) else x
            for x in leaves if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _precision(func, args) -> str:
    """The class of an op's product flops: its first tensor's dtype and
    the TF32 switch of the library that runs it."""
    x = next(iter(_tensors(args)), None)
    if x is not None and x.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    conv = "conv" in func.__name__
    tf32 = (torch.backends.cudnn.allow_tf32 if conv
            else torch.backends.cuda.matmul.allow_tf32)
    return "tf32" if tf32 else "f32"


class Counter(TorchDispatchMode):
    """``with Counter() as c: fn(...)`` counts the call; ``c.report(...)``
    is its ``RooflineReport``. ``loops``: (name, trip count) pairs the
    caller declares; ``watch``: trees of tensors alive before the call,
    counted in the peak memory."""

    def __init__(self, loops=(), watch=()):
        super().__init__()
        self.flops: dict = {}
        self.bytes = 0.0
        self.collectives: dict = {}
        self.kernels: dict = {}
        self.loops = list(loops)
        self.ops = 0
        self.paused = False
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._finalizers: list = []
        for t in _tensors(list(watch)):
            self._track(t)

    def __enter__(self):
        _STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _STACK.remove(self)
        for f in self._finalizers:       # the peak is the call's alone
            f.detach()
        return super().__exit__(*exc)

    # -- bookkeeping ------------------------------------------------------

    def _add_flops(self, precision: str, n: float) -> None:
        self.flops[precision] = self.flops.get(precision, 0.0) + n

    def add_kernel(self, name: str, flops: dict, nbytes: float) -> None:
        """One launch of a hand kernel doing ``flops`` and moving
        ``nbytes``."""
        for p, n in flops.items():
            self._add_flops(p, n)
        self.bytes += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += sum(flops.values())
        k["bytes"] += nbytes

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as alive until it is freed."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if self.paused:
            return out
        self.ops += 1
        packet = func.overloadpacket
        ns = func.namespace
        if ns in _COLLECTIVE_NS:
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = sum(_nbytes(t) for t in (outs or _tensors(args)))
                mult = 2 if kind == "all-reduce" else 1
                self.collectives[kind] = self.collectives.get(kind, 0.0) \
                    + mult * n
                self.bytes += n + sum(_nbytes(t) for t in _tensors(args))
            return out
        if func.is_view or packet in _FREE:
            return out
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(packet)
        if formula is not None:
            self._add_flops(_precision(func, args),
                            formula(*args, **kwargs, out_val=out))
        else:
            self._add_flops("f32", sum(t.numel() for t in outs))
        ins = []
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                continue          # written in place: counted as an output
            ins += _tensors(args[i] if i < len(args)
                            else kwargs.get(a.name))
        self.bytes += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        return out

    # -- result -----------------------------------------------------------

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    def report(self, *, arch: str, shape: str, mesh_name: str, chips: int,
               model_flops_global: float, hw: HW = HW(),
               model_precision: str = "f32",
               measured_s: float | None = None) -> RooflineReport:
        return RooflineReport(
            arch=arch, shape=shape, mesh=mesh_name, chips=chips,
            flops_per_device=self.total_flops,
            bytes_per_device=float(self.bytes),
            collective_bytes=self.collective_bytes,
            collectives=dict(self.collectives),
            peak_memory_bytes=float(self.peak),
            model_flops_global=model_flops_global, hw=hw,
            flops_by_class=dict(self.flops),
            model_precision=model_precision, measured_s=measured_s,
            loops=list(self.loops), kernels=dict(self.kernels))
