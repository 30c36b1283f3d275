"""Program caches and the bucketing helpers of bounded-shape serving
(port of ``repro/core/compile_cache.py``).

The reference funnels serving's dynamic quantities into a small static
ladder of padded shapes so that XLA compiles a bounded number of
programs. The port keeps the ladder: its decode ticks run as one CUDA
graph a shape (``GraphCache``), its prefill and install eagerly, counted
by ``ShapeCache``, so that ``prefill_compiles`` / ``decode_compiles`` keep
their meaning: the number of distinct (entry point, argument shapes) the
serving loop ran. That is the reference's own fallback count (``JitCache``
records each call's argument signature for when jax's private cache size
is gone).

``GraphCache`` is the port's ``JitCache`` for the federated engines, the
KD epoch, serving's decode and the LM mesh steps: on CUDA tensors each
(entry point, argument signature) runs eagerly the first time, is
captured into a ``torch.cuda.CUDAGraph`` the second time and replayed
from then on; on CPU tensors the function runs eagerly. ``num_compiled`` and
``count(name)`` count the signatures either way. Arguments named
``inplace`` are the counterpart of ``JitCache``'s donated argnums: the
graph reads and writes them where they live (the decode's params and
cache), where every other array leaf is copied in.

``bucket_for(P) = next_pow2(clamp(P, min_bucket, max_len))`` (capped at
``max_len``) maps a prompt length to its padded prefill length;
``bucket_ladder`` lists every rung.
"""
from __future__ import annotations

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.roofline import counter


def _signature(args) -> tuple:
    """Shapes and dtypes of every tensor leaf (dicts, lists and tuples
    walked in order); other leaves by type."""
    out = []

    def walk(x):
        if isinstance(x, dict):
            for key in sorted(x):
                walk(x[key])
        elif isinstance(x, (list, tuple)):
            for item in x:
                walk(item)
        elif hasattr(x, "shape") and hasattr(x, "dtype"):
            out.append((tuple(x.shape), str(x.dtype)))
        else:
            out.append(((), type(x).__name__))

    walk(args)
    return tuple(out)


def _named(key, name) -> bool:
    """Whether an entry called ``key`` counts under ``name``: ``key`` is
    ``name``, or a tuple starting with it (``("decode", k_ext)``)."""
    return key == name or (isinstance(key, tuple) and bool(key)
                           and key[0] == name)


class ShapeCache:
    """Distinct argument signatures per entry point.

    ``call(name, fn, args)`` runs ``fn(*args)`` and records the args'
    signature under ``name`` (a string, or a tuple starting with one, e.g.
    ``("decode", k_ext)``). ``count(name)`` sums the signatures of every
    entry whose name is ``name`` or starts with it; ``num_compiled`` sums
    them all.
    """

    def __init__(self):
        self._seen: dict = {}

    def call(self, name, fn, args):
        self._seen.setdefault(name, set()).add(_signature(args))
        return fn(*args)

    @property
    def num_compiled(self) -> int:
        return sum(len(s) for s in self._seen.values())

    def count(self, name) -> int:
        return sum(len(s) for n, s in self._seen.items() if _named(n, name))


# ---------------------------------------------------------------------------
# CUDA graphs
# ---------------------------------------------------------------------------

def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensor and numpy leaves to ``leaves`` (dicts walked
    in their own order, which ``_unflatten`` keeps) and return its hashable
    spec: the structure with its keys, each array leaf as ``None``, every
    other leaf by value."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return ("l" if isinstance(tree, list) else "t",
                tuple(_flatten(x, leaves) for x in tree))
    if _is_array(tree):
        leaves.append(tree)
        return None
    return ("v", tree)


def _unflatten(spec, it):
    if spec is None:
        return next(it)
    kind, body = spec
    if kind == "d":
        return {k: _unflatten(v, it) for k, v in body}
    if kind == "v":
        return body
    items = [_unflatten(v, it) for v in body]
    return items if kind == "l" else tuple(items)


def _flatten_args(args, inplace) -> tuple:
    """``_flatten`` of the argument tuple: (spec, leaves, own), ``own[i]``
    True where leaf ``i`` lies in an argument position named in
    ``inplace``."""
    leaves: list = []
    own: list = []
    specs = []
    for i, a in enumerate(args):
        n = len(leaves)
        specs.append(_flatten(a, leaves))
        own += [i in inplace] * (len(leaves) - n)
    return ("t", tuple(specs)), leaves, own


def _cuda_device(leaves):
    """The device of the first CUDA tensor among ``leaves``, else None."""
    for x in leaves:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


def _leaf_key(x, own: bool, device) -> tuple:
    """A leaf's part of the signature: shape and dtype; an in-place leaf's
    address, strides and device too, so that another tensor there is
    another graph and never a read of memory the graph no longer owns (a
    fake tensor, a dry run's, has no address: it runs eagerly)."""
    if not own:
        return tuple(x.shape), str(x.dtype)
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"an in-place argument's leaves must be tensors, "
                        f"got {type(x).__name__}")
    if device is not None and x.device != device:
        raise ValueError(f"in-place leaf on {x.device}, the call runs on "
                         f"{device}")
    return (tuple(x.shape), str(x.dtype),
            None if is_fake(x) else x.data_ptr(), x.stride(), str(x.device))


class _Graph:
    """One captured call.

    It copies the arguments' array leaves into static device buffers,
    but for the in-place leaves (``own``), which it captures where they
    live, and captures ``fn`` on them; a capture that fails raises.
    ``replay`` copies new arguments into the buffers, replays, and clones
    the outputs out of the graph's memory (the next replay writes over
    them), so nothing it returns aliases the graph, but for an output
    that is an in-place leaf itself: that is handed back as the caller
    passed it. ``fn`` may write its in-place leaves; its other inputs it
    must only read.

    A kernel wrapper's ``launches`` count is bumped while its launch is
    captured: the capture is that launch, recorded once. A replay runs the
    captured kernels on the card without the wrappers, so it adds nothing
    to the counts; the profiler's device events count what a replay ran."""

    def __init__(self, fn, spec, leaves, own, device, pool):
        self.own = own
        self.buffers = [x if o else torch.as_tensor(x).to(device, copy=True)
                        for x, o in zip(leaves, self.own)]
        static = _unflatten(spec, iter(self.buffers))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            out = fn(*static)
        self.out_leaves: list = []
        self.out_spec = _flatten(out, self.out_leaves)
        at = {id(b): i for i, (b, o) in enumerate(zip(self.buffers, self.own))
              if o}
        # each output: the index of the in-place leaf it is, else None
        self.out_own = [at.get(id(t)) for t in self.out_leaves]

    def replay(self, leaves):
        for buf, x, o in zip(self.buffers, leaves, self.own):
            if o:
                continue
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(x)
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        return _unflatten(self.out_spec,
                          (t.clone() if i is None else leaves[i]
                           for t, i in zip(self.out_leaves, self.out_own)))


class GraphCache:
    """One CUDA graph per (entry point, argument signature), captured the
    second time the signature is called.

    ``call(name, fn, args, inplace=())`` runs ``fn(*args)``. ``name`` is
    a string or a tuple starting with one (``("decode", k_ext)``).
    ``args`` is a tuple of trees of dicts, lists and tuples whose leaves
    are tensors, numpy arrays (inputs: any values at the same shape and
    dtype replay one graph) and other values (baked into the graph: part
    of the signature). The leaves of the argument positions in
    ``inplace`` (the counterpart of ``JitCache``'s donated argnums) must be
    tensors: the graph reads them where they live and ``fn`` may write
    them in place; their address, shape, dtype and strides are part of
    the signature, so another tensor there is another graph. Every other
    leaf is copied into the graph's buffers and every output cloned out,
    but an output that is an in-place leaf, which comes back as the
    caller passed it.

    With no CUDA tensor among the leaves ``fn`` runs eagerly. On the card
    every call hands ``fn`` its array leaves as tensors on that device;
    the first call with a signature runs ``fn`` eagerly: the warm-up that
    lets cuDNN, cuBLAS and the caching allocator settle (and builds the
    kernels) before a capture, and all a signature called once ever pays.
    The second call captures it on that tensor's device (``_Graph``) and
    replays; later calls replay. The signature also holds the device and
    the cuDNN and cuBLAS switches read at capture (TF32, deterministic,
    benchmark). The graphs of one cache share one memory pool: each
    replay's outputs are copied out before the next call, and calls run
    in the stream order they are made.

    A graph keeps its in-place tensors alive (and its pool's memory held):
    their owner frees them by dropping the cache or calling ``clear``.

    Under an active ``roofline.counter.Counter`` a call raises: a replay
    runs outside dispatch and would count nothing. Count an eager run of
    ``fn`` instead.

    ``num_compiled`` counts the signatures, CPU ones included, and
    ``count(name)`` those of one entry point (``ShapeCache.count``'s
    meaning); ``num_captured`` and ``captures(name)`` count the graphs."""

    def __init__(self):
        self._seen: set = set()
        self._graphs: dict = {}
        self._pool = None

    def call(self, name, fn, args, inplace=()):
        if counter.counting():
            raise RuntimeError(
                f"GraphCache.call({name!r}) under a roofline counter: a "
                "replay runs outside dispatch and would count nothing; "
                "count an eager run of the function")
        spec, leaves, own = _flatten_args(args, inplace)
        device = _cuda_device(leaves)
        key = (name, spec,
               tuple(_leaf_key(x, o, device) for x, o in zip(leaves, own)),
               device,
               torch.backends.cudnn.allow_tf32,
               torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark,
               torch.backends.cuda.matmul.allow_tf32)
        first = key not in self._seen
        self._seen.add(key)
        if device is None:
            return fn(*args)
        if first:
            return fn(*_unflatten(spec, (
                x if o else torch.as_tensor(x).to(device)
                for x, o in zip(leaves, own))))
        graph = self._graphs.get(key)
        if graph is None:
            with torch.cuda.device(device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                graph = _Graph(fn, spec, leaves, own, device, self._pool)
            self._graphs[key] = graph
        return graph.replay(leaves)

    def clear(self) -> None:
        """Drop every graph, and with them their pool and the in-place
        tensors they hold; the counts stay, and a signature called again
        is captured again."""
        self._graphs.clear()
        self._pool = None

    @property
    def num_compiled(self) -> int:
        return len(self._seen)

    def count(self, name) -> int:
        """Signatures called under ``name`` (``_named``)."""
        return sum(_named(key[0], name) for key in self._seen)

    @property
    def num_captured(self) -> int:
        """CUDA graphs captured (one per CUDA signature called twice or
        more)."""
        return len(self._graphs)

    def captures(self, name) -> int:
        """Graphs held under ``name`` (``_named``)."""
        return sum(_named(key[0], name) for key in self._graphs)


# ---------------------------------------------------------------------------
# Prefill-length bucketing
# ---------------------------------------------------------------------------

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    if n < 1:
        raise ValueError(f"next_pow2 needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def bucket_for(P: int, min_bucket: int, max_len: int) -> int:
    """Padded prefill length for a prompt of length P:
    ``next_pow2(clamp(P, min_bucket, max_len))``, capped at ``max_len``
    (the cache's sequence capacity) when that is not itself a power of
    two.  P must fit the cache: P <= max_len."""
    if P < 1:
        raise ValueError(f"prompt length must be >= 1, got {P}")
    if P > max_len:
        raise ValueError(f"prompt length {P} exceeds max_len {max_len}")
    return min(next_pow2(max(min(P, max_len), min_bucket)), max_len)


def bucket_ladder(min_bucket: int, max_len: int) -> tuple:
    """Every bucket ``bucket_for`` can produce, ascending.  Its length is
    the bound on distinct prefill shapes: one per rung, however many
    distinct prompt lengths arrive."""
    ladder = []
    b = next_pow2(max(1, min_bucket))
    while b < max_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_len)
    return tuple(ladder)
