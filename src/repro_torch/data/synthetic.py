"""Synthetic datasets standing in for Kinetics / HMDB51 and for LM text.

A numpy copy of ``repro/data/synthetic.py``: each action class has a
latent motion program (direction, speed, width, texture) rendering clips
of a moving Gaussian blob over structured noise; the LM dataset is an
order-1 Markov chain over the config's vocabulary. Draws happen in the
reference's exact order, so both packages yield byte-identical batches
from one seed (pinned by ``tests/test_torch_data.py`` and
``tests/test_torch_lm_data.py``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticActionDataset:
    """Procedural video-clip classification."""
    num_classes: int
    samples_per_class: int
    frames: int = 4
    size: int = 16
    noise: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        C = self.num_classes
        self.dirs = rng.normal(size=(C, 2))
        self.dirs /= np.linalg.norm(self.dirs, axis=1, keepdims=True) + 1e-9
        self.speeds = rng.uniform(0.5, 2.5, size=(C,))
        self.widths = rng.uniform(1.5, 3.5, size=(C,))
        self.textures = rng.normal(size=(C, self.size, self.size, 3)) * 0.3

    def __len__(self):
        return self.num_classes * self.samples_per_class

    def render(self, cls: int, rng: np.random.Generator) -> np.ndarray:
        T, S = self.frames, self.size
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
        start = rng.uniform(S * 0.25, S * 0.75, size=(2,))
        clip = np.empty((T, S, S, 3), np.float32)
        d = self.dirs[cls] + rng.normal(scale=0.15, size=2)
        sp = self.speeds[cls] * rng.uniform(0.8, 1.2)
        w = self.widths[cls]
        for t in range(T):
            cx, cy = start + d * sp * t
            blob = np.exp(-(((xx - cx) % S) ** 2 + ((yy - cy) % S) ** 2)
                          / (2 * w * w))
            clip[t] = blob[..., None] + self.textures[cls]
        clip += rng.normal(scale=self.noise, size=clip.shape)
        return clip

    def batches(self, batch_size: int, steps: int, seed=0,
                indices: np.ndarray | None = None):
        """Yields dicts {clips (B, T, S, S, 3) f32, labels (B,) i32}.
        ``indices`` restricts to a client shard (see partition.py)."""
        rng = np.random.default_rng((self.seed, seed))
        n = len(self) if indices is None else len(indices)
        for _ in range(steps):
            if indices is None:
                labels = rng.integers(0, self.num_classes, size=batch_size)
            else:
                pick = rng.integers(0, n, size=batch_size)
                labels = (indices[pick] % self.num_classes).astype(np.int64)
            clips = np.stack([self.render(int(c), rng) for c in labels])
            yield {"clips": clips.astype(np.float32),
                   "labels": labels.astype(np.int32)}


@dataclass
class SyntheticLMDataset:
    """Order-1 Markov chain token stream with class-like modes.

    The transition matrix is V x V float64 on the host, as the
    reference's: 20 GB at mamba2-130m's vocabulary, so full-width LM
    batches come from ``registry.synth_batch`` instead (ROADMAP Queue 3).
    It has no ``__len__``: ``launch/train.py`` gives its clients no shard.
    """
    vocab: int
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        raw = rng.dirichlet(np.full(self.vocab, 0.05), size=self.vocab)
        self.T = raw / raw.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        out = np.empty((batch, self.seq_len + 1), np.int64)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for i in range(self.seq_len):
            probs = self.T[out[:, i]]
            cum = probs.cumsum(axis=1)
            u = rng.random((batch, 1))
            out[:, i + 1] = (u > cum).sum(axis=1)
        return out

    def batches(self, batch_size: int, steps: int, seed=0, indices=None):
        """Yields dicts {tokens (B, S) i32, labels (B, S) i32}, the labels
        the tokens shifted by one."""
        rng = np.random.default_rng((self.seed, seed))
        for _ in range(steps):
            toks = self.sample(rng, batch_size)
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}


def stack_batches(batches, limit: int | None = None):
    """Stack an iterable of dict batches into one dict with leading axis H
    (at most ``limit`` batches; None when the iterable is empty)."""
    out = list(itertools.islice(batches, limit))
    if not out:
        return None
    return {k: np.stack([b[k] for b in out]) for k in out[0]}


def make_dataset_for(cfg, *, small: bool = True, seed: int = 0):
    """Dataset stand-in appropriate for a model family.

    small=True  -> HMDB51-like (few samples, noisy; clients' fine-tune data)
    small=False -> Kinetics-like (many samples; server-side distillation)
    LM families -> the Markov token stream at the config's vocabulary,
    64 tokens a row.

    Like the reference, clips are always 4x16x16 whatever the config's
    input shape (ROADMAP Queue 3 records this quirk).
    """
    if cfg.family == "resnet3d":
        return SyntheticActionDataset(
            num_classes=min(cfg.num_classes, 16 if small else 32),
            samples_per_class=8 if small else 64,
            noise=0.5 if small else 0.3,
            seed=seed)
    return SyntheticLMDataset(vocab=cfg.vocab_size, seq_len=64, seed=seed)
