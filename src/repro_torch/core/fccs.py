"""Fast continuous convergence strategy, FCCS (paper §3.4): a copy of the
JAX package's ``core/fccs.py`` (pure Python, no JAX in it).

Global policy:
  * learning rate: linear warm-up to eta0 over T_warm, then CONSTANT;
    decay is replaced by batch growth (Smith et al. '17);
  * batch size: B0 until T_ini, then a continuous cosine ramp from B^1_min
    to B^1_max (= 64·B^1_min in the paper's experiments).

On the cosine sign: the paper's printed f(t) starts at B_max and falls to
B_min, contradicting its prose ("batch size increases quickly") and
Fig. 7. The increasing ramp (1 - cos)/2 is the default; the printed form
is ``decreasing=True``.

Local policy = LARS (``repro_torch.optim``). Batch growth is realised with
gradient accumulation: n(t) = ceil(B_t / B_hw) micro-steps per update.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import FCCSConfig


def learning_rate(t: int, cfg: FCCSConfig) -> float:
    if t < cfg.t_warm:
        return cfg.eta0 * (t + 1) / cfg.t_warm
    return cfg.eta0


def batch_size(t: int, cfg: FCCSConfig, *, decreasing: bool = False) -> int:
    if t < cfg.t_ini:
        return cfg.b0
    if t >= cfg.t_final:
        return cfg.b_min if decreasing else cfg.b_max
    phase = math.pi * (t - cfg.t_ini) / (cfg.t_final - cfg.t_ini)
    c = math.cos(phase)
    if decreasing:  # paper's printed formula
        f = cfg.b_min + 0.5 * (cfg.b_max - cfg.b_min) * (1 + c)
    else:           # paper's described/plotted behavior
        f = cfg.b_min + 0.5 * (cfg.b_max - cfg.b_min) * (1 - c)
    return int(f)


def accum_steps(t: int, cfg: FCCSConfig, hw_batch: int) -> int:
    """Gradient-accumulation factor n(t) realising B_t on a fixed device
    batch (paper: 'the actual batch size can be considered as n × b')."""
    return max(1, -(-batch_size(t, cfg) // hw_batch))


def piecewise_decay_lr(t: int, *, eta0: float, steps_per_epoch: int,
                       decay_epochs: int = 5, factor: float = 0.1) -> float:
    """Baseline: decay by 10x every `decay_epochs` epochs (paper §4.3)."""
    epoch = t // max(steps_per_epoch, 1)
    return eta0 * (factor ** (epoch // decay_epochs))


def schedule_summary(cfg: FCCSConfig, total_steps: int, hw_batch: int,
                     every: int = 1):
    """(t, lr, B_t, n_accum) table, as the Fig. 6/7 benchmark reads it."""
    rows = []
    for t in range(0, total_steps, every):
        rows.append((t, learning_rate(t, cfg), batch_size(t, cfg),
                     accum_steps(t, cfg, hw_batch)))
    return rows
