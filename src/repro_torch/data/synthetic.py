"""Deterministic synthetic data: the port of the SKU feature stream and
the LM token stream (``lm_batch``) of the JAX package's
``data/synthetic.py``.

Each class has a unit prototype vector drawn around one of n/64 cluster
centres (so neighbouring classes are confusable); samples are noisy
prototypes. The prototypes are drawn on the experiment's device from a
``torch.Generator`` — at the paper's 1M-class width they are 2 GB, which is
not built on the host.

The draws cannot reproduce ``jax.random``'s bits: the same seed gives the
same distribution but other numbers. Tests that compare the two packages
inject the same numpy arrays into both instead of using this stream.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _generator(device, base: int, step: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((base * 1_000_003 + step) % (2**63))
    return g


class ClassificationStream:
    """SKU-like stream: n_classes unit prototypes in R^d, noisy samples."""

    def __init__(self, n_classes: int, d: int, *, seed: int = 0,
                 noise: float = 0.2, n_clusters: Optional[int] = None,
                 device="cpu"):
        self.n_classes = n_classes
        self.d = d
        self.noise = noise
        self.device = torch.device(device)
        g = _generator(self.device, seed)
        n_clusters = n_clusters or max(1, n_classes // 64)
        centers = torch.randn((n_clusters, d), generator=g, device=self.device)
        centers /= torch.linalg.vector_norm(centers, dim=-1, keepdim=True)
        assign = torch.randint(0, n_clusters, (n_classes,), generator=g,
                               device=self.device)
        protos = torch.randn((n_classes, d), generator=g, device=self.device)
        protos.mul_(1.5 / math.sqrt(d)).add_(centers[assign])
        protos /= torch.linalg.vector_norm(protos, dim=-1, keepdim=True)
        self.prototypes = protos

    def _sample(self, base: int, step: int, batch_size: int):
        g = _generator(self.device, base, step)
        labels = torch.randint(0, self.n_classes, (batch_size,), generator=g,
                               device=self.device)
        feats = self.prototypes[labels] + self.noise * torch.randn(
            (batch_size, self.d), generator=g, device=self.device)
        return feats, labels

    def batch(self, step: int, batch_size: int):
        """-> (features [b,d], labels [b]) for a given step (deterministic)."""
        return self._sample(9001, step, batch_size)

    def eval_batch(self, step: int, batch_size: int):
        return self._sample(77, step, batch_size)


def sku_feature_batch(step: int, batch_size: int,
                      stream: ClassificationStream):
    f, y = stream.batch(step, batch_size)
    return {"features": f, "labels": y}


def lm_batch(step: int, batch_size: int, seq_len: int, vocab: int,
             seed: int = 0, noise_p: float = 0.05, *, device="cpu"):
    """Learnable synthetic LM stream: per-sequence affine recurrence
    t_{i+1} = (a*t_i + c) mod vocab with occasional resets/noise.
    Returns {"tokens": [b,s], "labels": [b,s]} int64 (labels = next token).
    Drawn on the CPU from a ``torch.Generator`` and moved to ``device``, so
    a card and the CPU see the same prompts."""
    g = _generator("cpu", seed + 31337, step)
    a = torch.randint(1, 8, (batch_size,), generator=g) * 2 + 1
    c = torch.randint(0, vocab, (batch_size,), generator=g)
    t = torch.randint(0, vocab, (batch_size,), generator=g)
    seq = [t]
    for _ in range(seq_len):
        t = (t * a + c) % vocab
        seq.append(t)
    tokens = torch.stack(seq, dim=1)                        # [b, s+1]
    noise = torch.rand(tokens.shape, generator=g) < noise_p
    rnd = torch.randint(0, vocab, tokens.shape, generator=g)
    tokens = torch.where(noise, rnd, tokens).to(device)
    return {"tokens": tokens[:, :seq_len],
            "labels": tokens[:, 1:seq_len + 1]}
