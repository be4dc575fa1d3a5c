"""Deterministic synthetic data: the port of the SKU feature stream, the
SKU image batch of the cnn trunk (``sku_image_batch``) and the LM token
stream (``lm_batch``) of the JAX package's ``data/synthetic.py``.

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


def class_pattern(labels, hw: int):
    """The per-class low-frequency pattern of ``sku_image_batch``: labels
    [b] -> [b, hw, hw, 3] fp32 on the labels' device."""
    lin = torch.linspace(0, 1, hw, device=labels.device)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    lab = labels.float()[:, None, None]
    two_pi = 2 * math.pi
    return torch.stack([
        torch.sin(two_pi * ((lab % 7 + 1) * xx[None] + (lab % 3) * 0.2)),
        torch.cos(two_pi * ((lab % 5 + 1) * yy[None])),
        torch.sin(two_pi * ((lab % 11 + 1) * (xx + yy)[None] * 0.5)),
    ], dim=-1)


def sku_image_batch(step: int, batch_size: int, n_classes: int,
                    hw: int = 32, seed: int = 0, noise: float = 0.3, *,
                    device="cpu"):
    """Class-coded image batch for the CNN trunk: a per-class low-frequency
    pattern + noise, drawn on ``device``. {"images": [b, hw, hw, 3] fp32,
    "labels": [b] int64}."""
    g = _generator(device, seed + 4242, step)
    labels = torch.randint(0, n_classes, (batch_size,), generator=g,
                           device=device)
    base = class_pattern(labels, hw)
    imgs = base + noise * torch.randn(base.shape, generator=g, device=device)
    return {"images": imgs, "labels": labels}


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


def frame_batch(step: int, batch_size: int, enc_seq: int, d_model: int,
                seed: int = 0, *, device="cpu"):
    """The encoder-decoder family's stubbed frontend output: standard
    normal frame embeddings [b, enc_seq, d_model] fp32, drawn on ``device``
    from a generator seeded by (seed, step). (The JAX package draws them
    from ``jax.random.normal(PRNGKey(step))``, which torch cannot
    reproduce; tests inject the JAX frames through ``data_fn``.)"""
    g = _generator(device, seed + 9001, step)
    return torch.randn((batch_size, enc_seq, d_model), generator=g,
                       device=device)
