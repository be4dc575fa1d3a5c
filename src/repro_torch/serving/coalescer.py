"""Request coalescing: single async queries -> fixed-shape micro-batches.

Serving traffic arrives one query at a time; the accelerator wants big,
*fixed-shape* batches. The ``Coalescer`` bridges the two:

  * queries queue in submission order (a monotone sequence number breaks
    ties, so replaying the same submissions always packs the same batches
    — even when the caller's timestamps arrive out of order);
  * a batch is cut as soon as ``max_batch`` queries are waiting, or when
    the OLDEST waiting query has aged past ``max_wait`` seconds — the
    flush deadline that bounds tail latency during lulls;
  * every cut batch is padded up to a power-of-two bucket (floor
    ``min_bucket``, cap ``max_batch``), so the engine compiles at most
    ``log2(max_batch / min_bucket) + 1`` distinct step shapes.

``min_bucket`` defaults to 2 because on the CPU backend a 1-row matmul
(matvec) takes a different accumulation path from the batched gemm; from
2 rows up, every bucket scores each row bitwise-identically, which is what
makes the engine's results exactly equal to per-query serving
(tests/test_serving.py).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional


def bucket_for(n: int, min_bucket: int = 2, max_batch: int = 64) -> int:
    """Smallest power-of-two bucket >= n (floored at min_bucket, capped at
    max_batch). ``max_batch`` itself need not be a power of two — a full
    batch runs at exactly ``max_batch`` rows."""
    if n >= max_batch:
        return max_batch
    b = max(1, min_bucket)
    while b < n:
        b <<= 1
    return min(b, max_batch)


@dataclass
class Request:
    """One in-flight query and its lifecycle timestamps (all in the
    engine's clock domain; ``latency`` is submit -> completion)."""
    rid: int
    query: Any                    # np.ndarray feature / image
    t_submit: float
    seq: int = 0
    # filled at completion
    t_flush: float = 0.0          # batch cut from the queue
    t_start: float = 0.0          # service start (>= t_flush under load)
    t_done: float = 0.0
    cached: bool = False
    bucket: int = 0               # padded batch shape it rode in (0: cached)
    batch_n: int = 0              # real queries in that batch
    ids: Any = None               # [k] int32 (or scalar for greedy)
    scores: Any = None            # [k] float32 or None (greedy)

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class MicroBatch:
    requests: List[Request]
    bucket: int
    t_flush: float

    @property
    def occupancy(self) -> float:
        return len(self.requests) / self.bucket


class Coalescer:
    def __init__(self, *, max_batch: int = 64, max_wait: float = 0.002,
                 min_bucket: int = 2):
        if max_batch < 1:
            raise ValueError(f"max_batch must be positive, got {max_batch}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.min_bucket = max(1, min_bucket)
        self._queue: List[Request] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._queue)

    def put(self, req: Request) -> Request:
        req.seq = next(self._seq)
        self._queue.append(req)
        return req

    def _cut(self, n: int, now: float) -> MicroBatch:
        reqs, self._queue = self._queue[:n], self._queue[n:]
        mb = MicroBatch(reqs, bucket_for(n, self.min_bucket, self.max_batch),
                        now)
        for r in reqs:
            r.t_flush = now
            r.bucket = mb.bucket
            r.batch_n = n
        return mb

    def _sort(self):
        # timsort is stable and near-O(n) on the almost-sorted queue; the
        # (t_submit, seq) key makes packing deterministic under
        # out-of-order timestamps from a virtual clock
        self._queue.sort(key=lambda r: (r.t_submit, r.seq))

    def ready(self, now: float) -> List[MicroBatch]:
        """Batches due at ``now``: full ``max_batch`` cuts first, then one
        deadline flush if the oldest survivor has waited >= max_wait."""
        self._sort()
        out = []
        while len(self._queue) >= self.max_batch:
            out.append(self._cut(self.max_batch, now))
        # NB: compare against t_submit + max_wait — the exact expression
        # oldest_deadline() returns — not (now - t_submit) >= max_wait:
        # the two differ by a float rounding, and a replay clock advanced
        # exactly to the deadline must always trigger the cut
        if self._queue and now >= self._queue[0].t_submit + self.max_wait:
            out.append(self._cut(len(self._queue), now))
        return out

    def flush(self, now: float) -> List[MicroBatch]:
        """Drain everything regardless of age (shutdown / end of replay)."""
        self._sort()
        out = []
        while self._queue:
            out.append(self._cut(min(len(self._queue), self.max_batch), now))
        return out

    def oldest_deadline(self, default: Optional[float] = None
                        ) -> Optional[float]:
        """Absolute time the next deadline flush comes due (None if idle)."""
        if not self._queue:
            return default
        return min(r.t_submit for r in self._queue) + self.max_wait
