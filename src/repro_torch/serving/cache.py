"""LRU hot-query score cache for head-of-distribution serving traffic.

Retail query streams are heavily skewed (the same motivation the dynamic
class-selection and CMS-softmax lines exploit at train time — PAPERS.md):
a small head of distinct queries accounts for most requests. Caching their
retrieval results turns that skew directly into served QPS.

Keys are the query EMBEDDING bytes (optionally quantized to ``quantize``
decimals so float jitter from an upstream encoder still matches); an
optional ``cosine_threshold`` additionally accepts near-duplicate vector
queries — a linear scan over the cached (normalized) keys, intended for
the few-thousand-entry caches a head-of-distribution working set needs.

The cache stores whatever the engine computed for the query — ``(ids,
scores)`` for top-k retrieval, a scalar class id for greedy — and must be
dropped when the served weights move: ``invalidate()`` is the hook the
``ServingEngine`` wires to its weight-version check (and that a trainer's
head-refresh cadence can call directly).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np


class _Entry:
    __slots__ = ("value", "unit")

    def __init__(self, value: Any, unit: Optional[np.ndarray]):
        self.value = value
        self.unit = unit            # normalized flat query (cosine probing)


class ScoreCache:
    def __init__(self, capacity: int = 1024, *,
                 cosine_threshold: Optional[float] = None,
                 quantize: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if cosine_threshold is not None and not 0.0 < cosine_threshold <= 1.0:
            raise ValueError(
                f"cosine_threshold must be in (0, 1], got {cosine_threshold}")
        self.capacity = capacity
        self.cosine_threshold = cosine_threshold
        self.quantize = quantize
        self._od: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.hits = 0
        self.exact_hits = 0
        self.cosine_hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._od)

    def _key(self, query: np.ndarray) -> Tuple:
        q = np.asarray(query, np.float32)
        if self.quantize is not None:
            q = np.round(q, self.quantize)
        return (q.shape, q.tobytes())

    @staticmethod
    def _unit(query: np.ndarray) -> Optional[np.ndarray]:
        q = np.asarray(query, np.float32).reshape(-1)
        n = float(np.linalg.norm(q))
        return q / n if n > 0 else None

    def get(self, query: np.ndarray):
        """-> (value, kind) on a hit (kind: "exact" | "cosine"), else None.
        A hit refreshes the entry's LRU position."""
        key = self._key(query)
        entry = self._od.get(key)
        if entry is not None:
            self._od.move_to_end(key)
            self.hits += 1
            self.exact_hits += 1
            return entry.value, "exact"
        if self.cosine_threshold is not None and self._od:
            unit = self._unit(query)
            if unit is not None:
                best_key, best_cos = None, -1.0
                for k, e in self._od.items():
                    if e.unit is None or e.unit.shape != unit.shape:
                        continue
                    c = float(e.unit @ unit)
                    if c > best_cos:
                        best_key, best_cos = k, c
                if best_key is not None and best_cos >= self.cosine_threshold:
                    self._od.move_to_end(best_key)
                    self.hits += 1
                    self.cosine_hits += 1
                    return self._od[best_key].value, "cosine"
        self.misses += 1
        return None

    def put(self, query: np.ndarray, value: Any):
        key = self._key(query)
        unit = (self._unit(query) if self.cosine_threshold is not None
                else None)
        self._od[key] = _Entry(value, unit)
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)     # evict least-recently used

    def invalidate(self):
        """Drop every entry — the served weights changed, cached scores are
        stale. Counters survive (hit-rate is a per-run statistic)."""
        if self._od:
            self.invalidations += 1
        self._od.clear()

    clear = invalidate

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._od), "capacity": self.capacity,
            "hits": self.hits, "exact_hits": self.exact_hits,
            "cosine_hits": self.cosine_hits, "misses": self.misses,
            "hit_rate": self.hit_rate, "invalidations": self.invalidations,
        }
