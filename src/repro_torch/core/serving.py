"""Continuous-batching serving loop (port of ``repro/core/serving.py``).

A fixed pool of decode slots; each slot holds one request's KV/SSM state
and its own position. New requests are admitted the moment a slot frees
(iteration-level scheduling).

Prompts are padded into power-of-two prefill buckets
``bucket(P) = next_pow2(clamp(P, min_bucket, max_len))`` and every admit
tick prefills all newly admitted requests of a bucket as ONE batch of
fixed shape ``(max_slots, bucket)``, so a mixed-length stream runs at most
``len(buckets)`` prefill shapes. A per-row length vector masks the
padding: attention pads are causally invisible and overwritten by decode
before they could be attended, the SSM recurrence treats pad steps as
exact no-ops (dt=0), and logits gather at each row's last real token.
``min_bucket=0`` prefills each request alone at its exact length (the
parity oracle).

Decode runs per layer kind (``decode_mode="ring"``, the default): SWA
layers keep W-slot ring buffers, full-attention layers attend against the
first ``k_ext`` positions of their uniform cache, ``k_ext`` being the
largest active prefix bucketed on the same ladder. ``"uniform"`` keeps the
full-cache decode as the parity oracle. The reference ``vmap``s a
single-stream step over the slots; here the slots are one batch, and every
position is a per-row (B,) int32 tensor on the device. A decode tick makes
one host transfer each way: tokens and positions up in one copy, the
argmax tokens down.

Each decode tick is one call of the batcher's ``GraphCache``, one entry a
decode shape (``("decode", k_ext)`` in ring mode, ``"decode"`` in uniform
mode), with the params and the serving cache as in-place arguments: on
the card a shape's first tick runs eagerly, its second is captured into
a CUDA graph that reads the params and writes the cache where they live,
and later ticks replay it, ending in the argmax. On the CPU the same call
runs the tick eagerly. Prefill and install run eagerly, counted by a
``ShapeCache``: a stream admits a handful of groups against tens of
ticks, and a prefill graph's pool would hold a whole bucket's cache.

Ring-mode decode runs the attends and the SSM recurrence as the
hand-written CUDA kernels (``decode_kernel="cuda"``, the default; see
``kernels/ops.py``). ``"eager"`` is the plain torch path; uniform mode
always uses it. On CPU tensors the kernels' wrappers compute their plain
versions, so the CPU serves the same stream.
"""
from __future__ import annotations

import functools
import itertools
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.compile_cache import (GraphCache, ShapeCache,
                                            bucket_for, bucket_ladder)
from repro_torch.device import params_device
from repro_torch.models import lm, registry
from repro_torch.models.attention import KERNELS as DECODE_KERNELS
from repro_torch.types import ModelConfig

DECODE_MODES = ("ring", "uniform")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (P,) int32
    max_new: int
    eos_id: Optional[int] = None
    out: list = field(default_factory=list)
    slot: int = -1

    @property
    def done(self) -> bool:
        if len(self.out) >= self.max_new:
            return True
        return bool(self.out) and self.eos_id is not None \
            and self.out[-1] == self.eos_id


def _q_chunk(S: int) -> int:
    # q-chunking partitions query rows only (each row's softmax runs
    # against full K either way); power-of-two lengths chunk at 64, other
    # lengths run as one block
    return 64 if S % 64 == 0 else S


class ContinuousBatcher:
    """Fixed-slot continuous batching for the port's LM families.

    ``min_bucket`` > 0 (default) turns on bucketed prefill, and
    ``prefill_compiles`` (distinct prefill shapes) is bounded by
    ``len(self.buckets)``. ``decode_mode="ring"`` (default) decodes on
    per-layer-kind caches, ``decode_compiles`` bounded by
    ``max(1, len(self.decode_buckets))``. ``decode_kernel="cuda"``
    (default) runs the ring-mode decode through the CUDA kernels;
    ``"eager"`` is the torch oracle. The batcher serves on the device its
    params live on; ``dtype`` is the cache's dtype. Its decode graphs
    (``_graphs``) keep the params and the cache alive until the batcher
    is dropped or ``_graphs.clear()`` is called.
    """

    def __init__(self, params, cfg: ModelConfig, max_slots: int = 4,
                 max_len: int = 256, dtype=torch.float32,
                 min_bucket: int = 8, decode_mode: str = "ring",
                 decode_kernel: str = "cuda"):
        if cfg.is_encdec or cfg.family == "resnet3d":
            raise ValueError(f"{cfg.family}: not a decoder-only server")
        if cfg.prefix_len:
            raise ValueError(
                f"{cfg.name}: prefix-embedding (VLM/audio) serving needs "
                "per-request prefix tensors, which Request does not carry")
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode {decode_mode!r} not in "
                             f"{DECODE_MODES}")
        if decode_kernel not in DECODE_KERNELS:
            raise ValueError(f"decode_kernel {decode_kernel!r} not in "
                             f"{DECODE_KERNELS}")
        self.decode_kernel = decode_kernel if decode_mode == "ring" \
            else "eager"
        self.params, self.cfg = params, cfg
        self.device = params_device(params)
        self.max_slots, self.max_len = max_slots, max_len
        self.min_bucket = int(min_bucket)
        self.buckets = (bucket_ladder(self.min_bucket, max_len)
                        if self.min_bucket > 0 else ())
        self.decode_mode = decode_mode
        self.cache_dtype = dtype
        attn_free = cfg.family == "ssm"
        self._gl = () if attn_free else tuple(lm.global_layer_ids(cfg))
        self._wl = () if attn_free else tuple(lm.swa_layer_ids(cfg))
        if decode_mode == "ring":
            self.cache = registry.init_ring_cache(cfg, max_slots, max_len,
                                                  dtype, self.device)
            # full-attention layers run one decode shape per K-extent
            # rung; SWA/SSM-only models decode at a single shape
            self.decode_buckets = (bucket_ladder(max(self.min_bucket, 1),
                                                 max_len)
                                   if self._gl else ())
        else:
            self.cache = registry.init_cache(cfg, max_slots, max_len, dtype,
                                             self.device)
            self.decode_buckets = ()
        self.pos = np.zeros(max_slots, np.int32)        # next position
        self.last_tok = np.zeros(max_slots, np.int32)
        self.active: list[Optional[Request]] = [None] * max_slots
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        # {admit group size: count of prefill batches run with it}
        self.group_admits: dict = {}
        self.bucket_hist: dict = {}     # {bucket (or exact P): admits}
        self._rid = itertools.count()
        self._steps = 0
        self._shapes = ShapeCache()     # prefill and install
        self._graphs = GraphCache()     # the decode ticks

    # -- shape accounting ------------------------------------------------
    @property
    def prefill_compiles(self) -> int:
        """Distinct prefill shapes run. Bucketed admission bounds this by
        ``len(self.buckets)``; the per-request oracle runs one per
        distinct prompt length."""
        return self._shapes.count("prefill")

    @property
    def decode_compiles(self) -> int:
        """Distinct decode shapes run: one per K-extent rung a stream
        reached in ring mode, exactly one in uniform mode."""
        return self._graphs.count("decode")

    @property
    def num_compiled(self) -> int:
        return self._shapes.num_compiled + self._graphs.num_compiled

    # -- entry points (shape-counted) -------------------------------------
    def _prefill_fn(self, params, tokens, lengths):
        """(B, S) right-padded tokens + (B,) true lengths -> per-row
        last-real-token logits and a cache of sequence capacity S."""
        S = tokens.shape[1]
        cache = registry.init_cache(self.cfg, tokens.shape[0], S,
                                    self.cache_dtype, self.device)
        return registry.prefill(params, self.cfg, {"tokens": tokens}, cache,
                                lengths=lengths, q_chunk=_q_chunk(S))

    def _install_fn(self, full, group, slots, lengths):
        """Copy the first ``len(slots)`` rows of a group prefill cache into
        the server cache's slots, in place. K/V leaves carry the sequence
        axis at dim 2 ((L, B, S, kv, hd)); only their first ``bucket``
        positions are written, the rest of the slot is causally dead."""
        m = slots.shape[0]
        for key, f in full.items():
            g = group[key][:, :m].to(f.dtype)
            if g.shape[2:] != f.shape[2:]:
                f[:, slots, :g.shape[2]] = g
            else:
                f[:, slots] = g
        return full

    def _install_ring_fn(self, full, group, slots, lengths):
        """Copy a uniform group-prefill cache into the per-layer-kind
        server cache, in place.

        Full-attention layers copy their bucket prefix. SWA layers gather
        into ring layout per row (``lm.ring_source_positions``: the latest
        prompt position congruent to each slot mod W). Slots whose
        position would be negative (prompt shorter than W) are ZEROED, not
        left holding a clipped gather of position 0: decode masks them
        either way, but the cache state then does not depend on what was
        installed before."""
        m = slots.shape[0]
        for key in ("ssm_state", "conv_state"):
            if key in group:
                full[key][:, slots] = group[key][:, :m].to(full[key].dtype)
        if "k" in group:
            S_b = group["k"].shape[2]
            if self._gl:
                gi = torch.tensor(self._gl, device=self.device)
                for key in ("k", "v"):
                    full[key][:, slots, :S_b] = \
                        group[key][gi][:, :m].to(full[key].dtype)
            if self._wl:
                W = full["k_win"].shape[2]
                p = lm.ring_source_positions(lengths[:m] - 1, W)   # (m, W)
                take = p.clamp(0, S_b - 1)
                rows = torch.arange(m, device=self.device)[:, None]
                written = (p >= 0)[None, :, :, None, None]
                wi = torch.tensor(self._wl, device=self.device)
                for src, dst in (("k", "k_win"), ("v", "v_win")):
                    g = group[src][wi][:, :m][:, rows, take]  # (Lw, m, W, ..)
                    g = torch.where(written, g, torch.zeros((), dtype=g.dtype,
                                                            device=g.device))
                    full[dst][:, slots] = g.to(full[dst].dtype)
        return full

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new: int = 16, eos_id=None) -> int:
        """Queue one request. Rejects invalid requests here, with a
        ``ValueError``, so a bad submit never reaches ``_admit`` and the
        requests in flight keep serving."""
        prompt = np.asarray(prompt, np.int32)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new} "
                             "(prefill itself emits the first token)")
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"request too long: len(prompt)={prompt.size} + "
                f"max_new={max_new} exceeds max_len={self.max_len}")
        req = Request(next(self._rid), prompt, max_new, eos_id)
        self.queue.append(req)
        return req.rid

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _prefill_group(self, bucket: int, items):
        """One prefill for all (slot, request) pairs of a bucket, padded
        to the fixed (max_slots, bucket) shape with dummy rows so the
        group size never changes the shape."""
        m = len(items)
        tokens = np.zeros((self.max_slots, bucket), np.int32)
        lengths = np.ones((self.max_slots,), np.int32)
        for j, (_, req) in enumerate(items):
            P = len(req.prompt)
            tokens[j, :P] = req.prompt
            lengths[j] = P
        logits, gcache = self._shapes.call(
            "prefill", self._prefill_fn,
            (self.params, self._to_device(tokens), self._to_device(lengths)))
        self._install(gcache, items, logits, lengths[:m])
        self.group_admits[m] = self.group_admits.get(m, 0) + 1
        self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1

    def _prefill_one(self, slot: int, req: Request):
        """Parity oracle: exact-length, single-request prefill (one
        prefill shape per distinct prompt length)."""
        P = len(req.prompt)
        lengths = np.asarray([P], np.int32)
        logits, c1 = self._shapes.call(
            "prefill", self._prefill_fn,
            (self.params, self._to_device(req.prompt[None]),
             self._to_device(lengths)))
        self._install(c1, [(slot, req)], logits, lengths)
        self.group_admits[1] = self.group_admits.get(1, 0) + 1
        self.bucket_hist[P] = self.bucket_hist.get(P, 0) + 1

    def _install(self, gcache, items, logits, lengths):
        slots = np.asarray([s for s, _ in items], np.int64)
        install = (self._install_ring_fn if self.decode_mode == "ring"
                   else self._install_fn)
        self.cache = self._shapes.call(
            "install", install,
            (self.cache, gcache, self._to_device(slots),
             self._to_device(np.asarray(lengths, np.int64))))
        # argmax on the device, one transfer of B ints to the host
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        for j, (slot, req) in enumerate(items):
            req.slot = slot
            req.out.append(int(nxt[j]))
            self.pos[slot] = int(lengths[j]) + self.cfg.prefix_len
            self.last_tok[slot] = nxt[j]
            self.active[slot] = req

    def _admit(self):
        free = [s for s in range(self.max_slots) if self.active[s] is None]
        take = min(len(free), len(self.queue))
        if not take:
            return
        reqs = [self.queue.pop(0) for _ in range(take)]
        if not self.buckets:
            for slot, req in zip(free, reqs):
                self._prefill_one(slot, req)
            return
        groups: dict = {}
        for slot, req in zip(free, reqs):
            b = bucket_for(len(req.prompt), self.min_bucket, self.max_len)
            groups.setdefault(b, []).append((slot, req))
        for b in sorted(groups):
            self._prefill_group(b, groups[b])

    def _retire(self):
        for slot, req in enumerate(self.active):
            if req is not None and req.done:
                self.completed.append(req)
                self.active[slot] = None

    # ------------------------------------------------------------------
    def _decode_k_ext(self, mask) -> int:
        """K-extent for this tick's full-attention decode: the largest
        active slot's ``pos + 1`` bucketed on the pow-2 ladder, so the
        decode shapes are bounded by ``len(decode_buckets)`` and every
        active row's prefix fits (inactive rows are ``k_len``-masked)."""
        if not self.decode_buckets:
            return 0
        need = int(self.pos[mask].max()) + 1
        return bucket_for(need, max(self.min_bucket, 1), self.max_len)

    def step(self) -> int:
        """One scheduler iteration: retire, admit, batched decode.
        Returns the number of active slots that decoded."""
        self._retire()
        self._admit()
        # a request can complete at admit time (max_new=1, or eos on the
        # prefill token): retire it before decode or it would overshoot
        self._retire()
        mask = np.array([r is not None for r in self.active])
        if not mask.any():
            return 0
        # one transfer of B ints per tick
        nxt = self._decode(mask)[0].cpu().numpy()
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(nxt[slot]))
            self.pos[slot] += 1
            self.last_tok[slot] = nxt[slot]
        self._steps += 1
        return int(mask.sum())

    def _decode_entry(self, mask) -> tuple:
        """This tick's decode entry: its name and its function of
        (params, (2, B) tokens and positions, cache)."""
        if self.decode_mode == "ring":
            k_ext = self._decode_k_ext(mask)
            return ("decode", k_ext), functools.partial(self._tick, k_ext)
        return "decode", functools.partial(self._tick, None)

    def _decode(self, mask):
        """One decode tick of every slot at ``last_tok`` / ``pos`` through
        the decode graphs, the cache written in place. Returns the (B,)
        int32 argmax tokens and the (B, V) logits, on the device."""
        name, fn = self._decode_entry(mask)
        # tokens and positions go up in one copy
        tp = self._to_device(np.stack([self.last_tok, self.pos]))
        nxt, logits, self.cache = self._graphs.call(
            name, fn, (self.params, tp, self.cache), inplace=(0, 2))
        return nxt, logits

    def _tick(self, k_ext, params, tp, cache):
        """The decode of one tick, ring (``k_ext`` an int) or uniform
        (None), and its argmax: (tokens, logits, cache)."""
        if k_ext is None:
            logits, cache = registry.decode_step(params, self.cfg, tp[0],
                                                 cache, tp[1])
        else:
            logits, cache = registry.decode_step_grouped(
                params, self.cfg, tp[0], cache, tp[1], k_ext=k_ext,
                decode_kernel=self.decode_kernel)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    def pending(self) -> list:
        """Requests not yet completed: in-flight (slot order) + queued."""
        return [r for r in self.active if r is not None] + list(self.queue)

    def run(self, max_iters: int = 10_000) -> list:
        """Drive until queue + slots drain; returns completed requests.

        If ``max_iters`` runs out first, the leftover requests are not
        dropped: a ``RuntimeWarning`` reports how many are still queued /
        in flight, and they stay reachable via ``pending()`` (a later
        ``run()`` resumes them)."""
        for _ in range(max_iters):
            if not self.queue and all(r is None for r in self.active):
                break
            if self.step() == 0 and not self.queue:
                break
            self._retire()
        self._retire()
        left = self.pending()
        if left:
            n_flight = sum(r is not None for r in self.active)
            warnings.warn(
                f"run(max_iters={max_iters}) exhausted with "
                f"{len(left) - n_flight} queued + {n_flight} in-flight "
                "requests unfinished — they remain in pending() and a "
                "further run() resumes them", RuntimeWarning,
                stacklevel=2)
        return sorted(self.completed, key=lambda r: r.rid)


def generate_single(params, cfg: ModelConfig, prompt, max_new: int,
                    max_len: int = 256, dtype=torch.float32) -> list:
    """Reference single-request greedy generation (parity oracle): an
    exact-length prefill into a uniform cache, then uniform eager decode,
    on the device the params live on."""
    dev = params_device(params)
    prompt = np.asarray(prompt, np.int32)
    P = prompt.size
    cache = registry.init_cache(cfg, 1, max_len, dtype, dev)
    logits, cache = registry.prefill(
        params, cfg, {"tokens": torch.from_numpy(prompt[None]).to(dev)},
        cache, q_chunk=_q_chunk(P))
    out = [int(torch.argmax(logits, dim=-1)[0])]
    pos = P + cfg.prefix_len
    for _ in range(max_new - 1):
        token = torch.tensor([out[-1]], dtype=torch.int32, device=dev)
        logits, cache = registry.decode_step(params, cfg, token, cache, pos)
        out.append(int(torch.argmax(logits, dim=-1)[0]))
        pos += 1
    return out
