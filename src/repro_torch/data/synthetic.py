"""Synthetic action-clip dataset standing in for Kinetics / HMDB51.

A numpy copy of ``repro/data/synthetic.py``: each class has a latent
motion program (direction, speed, width, texture) rendering clips of a
moving Gaussian blob over structured noise. Draws happen in the reference's
exact order, so both packages yield byte-identical batches from one seed
(pinned by ``tests/test_torch_data.py``).
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


def stack_batches(batches, limit: int | None = None):
    """Stack an iterable of dict batches into one dict with leading axis H
    (at most ``limit`` batches; None when the iterable is empty)."""
    out = list(itertools.islice(batches, limit))
    if not out:
        return None
    return {k: np.stack([b[k] for b in out]) for k in out[0]}


def make_dataset_for(cfg, *, small: bool = True, seed: int = 0):
    """Dataset stand-in for a resnet3d config.

    small=True  -> HMDB51-like (few samples, noisy; clients' fine-tune data)
    small=False -> Kinetics-like (many samples; server-side distillation)

    Like the reference, clips are always 4x16x16 whatever the config's
    input shape (ROADMAP Queue 3 records this quirk).
    """
    if cfg.family != "resnet3d":
        raise NotImplementedError(
            "the LM dataset comes with the LM stack (ROADMAP Queue 1 item 11)")
    return SyntheticActionDataset(
        num_classes=min(cfg.num_classes, 16 if small else 32),
        samples_per_class=8 if small else 64,
        noise=0.5 if small else 0.3,
        seed=seed)
