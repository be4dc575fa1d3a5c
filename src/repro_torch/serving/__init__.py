"""``repro_torch.serving`` — the batched, cached, trace-driven serving tier
(the port of the JAX package's ``repro.serving``):

  * ``Coalescer`` — packs single queries into power-of-two padded
    micro-batches with a max-wait flush deadline.
  * ``ServingEngine`` — ``submit()/poll()/drain()`` over the paper system's
    batched greedy / top-k serve steps, with an optional ``ScoreCache``.
  * ``IVFIndex`` — sublinear top-k: a k-means coarse quantizer fit over
    each member's class shard; serving probes ``nprobe`` centroids and
    reranks only their member rows (``for_experiment(..., index="ivf")``),
    refit when the served weights' version moves.
  * ``trace`` — bursty Zipfian synthetic traces + ``VirtualClock`` replay.
"""
from repro_torch.serving.cache import ScoreCache
from repro_torch.serving.coalescer import (Coalescer, MicroBatch, Request,
                                           bucket_for)
from repro_torch.serving.engine import (ServingEngine, latency_stats,
                                        replay_trace)
from repro_torch.serving.index import IVFIndex
from repro_torch.serving.trace import (TraceConfig, VirtualClock,
                                       generate_trace, make_query_pool)

__all__ = [
    "Coalescer", "IVFIndex", "MicroBatch", "Request", "ScoreCache",
    "ServingEngine", "TraceConfig", "VirtualClock", "bucket_for",
    "generate_trace", "latency_stats", "make_query_pool", "replay_trace",
]
