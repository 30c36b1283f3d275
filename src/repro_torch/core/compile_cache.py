"""Bucketing helpers and program-shape accounting for bounded-shape
serving (port of ``repro/core/compile_cache.py``).

The reference funnels serving's dynamic quantities into a small static
ladder of padded shapes so that XLA compiles a bounded number of
programs. The port runs eagerly and compiles nothing, but it keeps the
ladder and counts the distinct program shapes it runs, so that
``prefill_compiles`` / ``decode_compiles`` keep their meaning: the number
of distinct (entry point, argument shapes) the serving loop ran. That is
the reference's own fallback count (``JitCache`` records each call's
argument signature for when jax's private cache size is gone).

``bucket_for(P) = next_pow2(clamp(P, min_bucket, max_len))`` (capped at
``max_len``) maps a prompt length to its padded prefill length;
``bucket_ladder`` lists every rung.
"""
from __future__ import annotations


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
        return sum(len(s) for n, s in self._seen.items()
                   if n == name or (isinstance(n, tuple) and n
                                    and n[0] == name))


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
