"""Synthetic serving traces: bursty arrivals x Zipfian query mix.

A copy of the JAX package's module of the same name; only the query pool
is drawn by the port's data stream.

The load-replay benchmark needs traffic shaped like production, not like a
fixed-size eval batch. Two generators compose here:

  * **Arrival process** — a two-state Markov-modulated Poisson process:
    exponentially-distributed OFF periods at ``base_rate`` qps alternate
    with ON bursts at ``base_rate + burst_rate`` qps (the on/off burst
    model used for e-commerce / cluster traffic). Inter-arrivals within a
    state are exponential.
  * **Query mix** — query ids drawn Zipf(``zipf_s``) from a finite pool of
    ``pool`` distinct queries, so a skewed head of hot queries repeats —
    exactly the structure the engine's score cache exploits.

Everything is seeded and pure numpy: the same ``TraceConfig`` always
yields the same trace, so cached-vs-uncached replay runs see identical
traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TraceConfig:
    duration: float = 2.0          # virtual seconds of traffic
    base_rate: float = 100.0       # qps in the OFF (quiet) state
    burst_rate: float = 400.0      # ADDITIONAL qps while a burst is on
    mean_on: float = 0.10          # mean burst length (s, exponential)
    mean_off: float = 0.30         # mean quiet gap (s, exponential)
    zipf_s: float = 1.1            # query-popularity exponent (>0)
    pool: int = 256                # distinct queries in the mix
    seed: int = 0

    @property
    def expected_rate(self) -> float:
        """Long-run mean arrival rate (qps) of the on/off process."""
        on, off = self.mean_on, self.mean_off
        if on + off <= 0:
            return self.base_rate
        duty = on / (on + off)
        return self.base_rate + duty * self.burst_rate


def zipf_probs(pool: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 0..pool-1 (rank 0 hottest)."""
    p = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** s
    return p / p.sum()


def generate_trace(cfg: TraceConfig) -> Tuple[np.ndarray, np.ndarray]:
    """-> (times [n] float64 ascending, qids [n] int32 in [0, pool))."""
    rng = np.random.default_rng(cfg.seed)
    times = []
    t, t_state_end, on = 0.0, 0.0, True  # first state drawn below
    on = bool(rng.integers(0, 2))
    t_state_end = t + rng.exponential(cfg.mean_on if on else cfg.mean_off)
    while t < cfg.duration:
        rate = cfg.base_rate + (cfg.burst_rate if on else 0.0)
        if rate <= 0:
            t = t_state_end
        else:
            dt = rng.exponential(1.0 / rate)
            if t + dt >= t_state_end:
                t = t_state_end          # state flips before next arrival
            else:
                t += dt
                if t < cfg.duration:
                    times.append(t)
                continue
        on = not on
        t_state_end = t + rng.exponential(cfg.mean_on if on else cfg.mean_off)
    times = np.asarray(times, np.float64)
    qids = rng.choice(cfg.pool, size=times.shape[0],
                      p=zipf_probs(cfg.pool, cfg.zipf_s)).astype(np.int32)
    return times, qids


def make_query_pool(n_classes: int, d: int, pool: int, *, seed: int = 0,
                    noise: float = 0.2, device="cpu") -> np.ndarray:
    """[pool, d] float32 query embeddings: noisy samples of the synthetic
    SKU prototypes (``repro_torch.data.synthetic``, drawn on ``device``),
    so replayed queries look like the features the trained head actually
    retrieves against."""
    import torch

    from repro_torch.data.synthetic import ClassificationStream
    stream = ClassificationStream(n_classes, d, seed=seed, device=device)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, n_classes, size=pool)
    protos = stream.prototypes[torch.from_numpy(labels).to(
        stream.device)].cpu().numpy()
    q = protos + noise * rng.standard_normal((pool, d))
    return q.astype(np.float32)


class VirtualClock:
    """Monotone replay clock: ``now()`` plugs into the engine, the replay
    loop advances it to each trace arrival time."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    __call__ = now

    def advance(self, dt: float):
        if dt < 0:
            raise ValueError(f"cannot rewind the clock (dt={dt})")
        self.t += dt

    def advance_to(self, t: float):
        self.t = max(self.t, float(t))
