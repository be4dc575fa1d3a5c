"""``ServingEngine`` — batched multi-query retrieval behind submit/drain.

The port of the JAX package's engine. One engine wraps one served model (a
paper-system ``Experiment``, or the zoo's classifying backbone features
against its class matrix) and turns the per-head batched top-k / greedy steps into a serving loop:

    engine = ServingEngine.for_experiment(exp, top_k=5,
                                          cache=ScoreCache(1024))
    rid = engine.submit(query)          # single [D] embedding (or image)
    done = engine.poll()                # run any due micro-batches
    done += engine.drain()              # flush everything (shutdown)

* ``submit`` first consults the optional ``ScoreCache`` (invalidated
  automatically when the served weights' version moves — a weight refresh
  must not serve stale scores); on a miss the query joins the
  ``Coalescer`` queue.
* ``poll``/``drain`` cut due micro-batches (power-of-two padded, so the
  step sees a handful of shapes), execute them through the experiment's batched serve step, and
  deliver completed ``Request``s with per-request timestamps.
* Service is modeled as a single serial executor: a batch starts at
  ``max(flush time, previous batch's completion)`` and its measured
  wall-clock compute is charged from there — with the real clock this is
  just what happens; under a replay ``VirtualClock`` it makes queueing
  delay during bursts show up in p99 exactly as a busy server would.

The engine itself is transport-agnostic: it only needs a ``step_fn`` that
scores a padded query batch. ``for_experiment`` builds that step for the
paper (hybrid) system and the zoo (``train.gspmd``'s feature steps): the
exact scan, or with ``index="ivf"`` the IVF index's probe and rerank.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.cache import ScoreCache
from repro_torch.serving.coalescer import Coalescer, Request, bucket_for
from repro_torch.telemetry import NULL_TRACER


def latency_stats(requests: Sequence[Request]) -> dict:
    """p50/p95/p99/mean/max request latency (ms) over completed requests."""
    if not requests:
        return {"n": 0, "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                "mean_ms": 0.0, "max_ms": 0.0}
    lat = np.asarray([r.latency for r in requests], np.float64) * 1e3
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return {"n": int(lat.size), "p50_ms": float(p50), "p95_ms": float(p95),
            "p99_ms": float(p99), "mean_ms": float(lat.mean()),
            "max_ms": float(lat.max())}


class ServingEngine:
    """See module docstring. ``step_fn(queries [bucket, ...], n_valid)``
    returns ``(ids, scores)`` — ids ``[bucket, k]`` / scores ``[bucket,
    k]`` for top-k engines, ids ``[bucket]`` / scores ``None`` for greedy
    — with padded rows already masked (-1 / -inf)."""

    def __init__(self, step_fn: Callable[[np.ndarray, int], tuple], *,
                 top_k: Optional[int] = None, max_batch: int = 64,
                 max_wait_ms: float = 2.0, cache: Optional[ScoreCache] = None,
                 clock: Callable[[], float] = time.monotonic,
                 version_fn: Optional[Callable[[], Any]] = None,
                 min_bucket: int = 2, telemetry=None):
        self.step_fn = step_fn
        self.telemetry = telemetry or NULL_TRACER
        self.top_k = top_k
        self.cache = cache
        self.clock = clock
        self.version_fn = version_fn
        self.coalescer = Coalescer(max_batch=max_batch,
                                   max_wait=max_wait_ms * 1e-3,
                                   min_bucket=min_bucket)
        self._rid = 0
        self._version = version_fn() if version_fn else None
        self._done: List[Request] = []
        self._server_free_at = -np.inf
        # aggregate stats
        self.n_submitted = 0
        self.n_batches = 0
        self.occupancies: List[float] = []
        self.compute_s = 0.0

    # -- submission --------------------------------------------------------

    def _check_version(self):
        """Weight-refresh invalidation: a new served-weights version drops
        every cached score before the next lookup can hit it."""
        if self.version_fn is None:
            return
        v = self.version_fn()
        if v != self._version:
            self._version = v
            if self.cache is not None:
                self.cache.invalidate()

    def submit(self, query, *, now: Optional[float] = None) -> int:
        """Enqueue one query; returns its request id. Cache hits complete
        immediately (delivered by the next ``poll``/``drain``)."""
        now = self.clock() if now is None else now
        q = np.asarray(query, np.float32)
        rid = self._rid
        self._rid += 1
        self.n_submitted += 1
        tr = self.telemetry or NULL_TRACER
        tr.count("serve.submitted")
        req = Request(rid=rid, query=q, t_submit=now)
        if self.cache is not None:
            self._check_version()
            t0 = time.perf_counter_ns()
            hit = self.cache.get(q)
            lookup_ns = time.perf_counter_ns() - t0
            if hit is not None:
                (ids, scores), _kind = hit
                req.ids, req.scores = ids, scores
                req.cached = True
                # a cache hit is served in the measured lookup time, not
                # zero — sub-ms latencies must survive into the percentiles
                req.t_flush = req.t_start = now
                req.t_done = now + lookup_ns * 1e-9
                self._done.append(req)
                tr.count("serve.cache_hits")
                tr.add_span("serve.cache_hit", t0, lookup_ns)
                return rid
            tr.count("serve.cache_misses")
        self.coalescer.put(req)
        return rid

    # -- execution ---------------------------------------------------------

    def _pad(self, queries: List[np.ndarray], bucket: int) -> np.ndarray:
        q = np.stack(queries).astype(np.float32)
        if q.shape[0] < bucket:
            pad = np.zeros((bucket - q.shape[0],) + q.shape[1:], np.float32)
            q = np.concatenate([q, pad], axis=0)
        return q

    def _run_batch(self, mb) -> List[Request]:
        tr = self.telemetry or NULL_TRACER
        n = len(mb.requests)
        with tr.span("serve.flush"):
            padded = self._pad([r.query for r in mb.requests], mb.bucket)
        t0 = time.perf_counter_ns()
        ids, scores = self.step_fn(padded, n)   # host arrays: device work done
        dt_ns = time.perf_counter_ns() - t0
        dt = dt_ns * 1e-9
        self.n_batches += 1
        self.occupancies.append(mb.occupancy)
        self.compute_s += dt
        tr.add_span("serve.compute", t0, dt_ns)
        tr.count("serve.batches")
        tr.gauge("serve.occupancy", mb.occupancy)
        if self.cache is not None:
            tr.gauge("serve.cache_hit_rate", self.cache.hit_rate)
        t_start = max(mb.t_flush, self._server_free_at)
        t_done = t_start + dt
        self._server_free_at = t_done
        # queue wait on the engine clock: submit -> modeled batch start
        tr.count("serve.queue_wait_s",
                 sum(t_start - r.t_submit for r in mb.requests))
        ids = np.asarray(ids)
        scores = None if scores is None else np.asarray(scores)
        for i, r in enumerate(mb.requests):
            r.ids = ids[i].copy()
            r.scores = None if scores is None else scores[i].copy()
            r.t_start, r.t_done = t_start, t_done
            if self.cache is not None:
                self.cache.put(r.query, (r.ids, r.scores))
        return list(mb.requests)

    def _deliver(self, batches) -> List[Request]:
        done = self._done
        self._done = []
        for mb in batches:
            done.extend(self._run_batch(mb))
        return done

    def poll(self, now: Optional[float] = None) -> List[Request]:
        """Run micro-batches due at ``now`` (full buckets, expired
        deadlines); returns every request completed since the last call."""
        now = self.clock() if now is None else now
        return self._deliver(self.coalescer.ready(now))

    def drain(self, now: Optional[float] = None) -> List[Request]:
        """Flush the queue regardless of deadlines and return everything
        completed since the last poll (shutdown / end of replay)."""
        now = self.clock() if now is None else now
        return self._deliver(self.coalescer.flush(now))

    def warmup(self, example_query, buckets: Optional[Sequence[int]] = None):
        """Run the step once for every padding bucket so the first real
        request pays no first-call cost (kernel build, allocator growth)."""
        q = np.asarray(example_query, np.float32)
        if buckets is None:
            buckets, b = [], 0
            while True:
                nb = bucket_for(b + 1, self.coalescer.min_bucket,
                                self.coalescer.max_batch)
                if buckets and nb == buckets[-1]:
                    break
                buckets.append(nb)
                b = nb
        for bucket in buckets:
            self.step_fn(np.zeros((bucket,) + q.shape, np.float32), 0)

    def stats(self) -> dict:
        out = {
            "n_submitted": self.n_submitted,
            "n_batches": self.n_batches,
            "mean_batch_occupancy": (float(np.mean(self.occupancies))
                                     if self.occupancies else 0.0),
            "compute_s": self.compute_s,
            "cache_hit_rate": (self.cache.hit_rate
                               if self.cache is not None else 0.0),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    # -- construction over an Experiment ------------------------------------

    @staticmethod
    def for_experiment(exp, *, top_k: Optional[int] = None,
                       max_batch: int = 64, max_wait_ms: float = 2.0,
                       cache: Optional[ScoreCache] = None,
                       clock: Callable[[], float] = time.monotonic,
                       min_bucket: int = 2, index: Optional[str] = None,
                       nprobe: Optional[int] = None,
                       telemetry=None) -> "ServingEngine":
        """Build an engine over a paper or zoo ``Experiment``. Queries are
        single feature embeddings ``[D]`` (the ``feats`` trunk, and the
        zoo's backbone features) or images ``[H, W, 3]`` (the cnn trunk);
        ``top_k=None`` serves greedy class ids, ``top_k=k`` serves ``(ids
        [k], scores [k])`` per request.

        ``index="ivf"`` routes the top-k path through the experiment's
        ``IVFIndex`` (fit lazily, refit when ``weights_version`` moves):
        each shard probes ``nprobe`` centroids (default: the index's own)
        and reranks only their member rows."""
        if index not in (None, "none", "ivf"):
            raise ValueError(f"unknown serving index {index!r}; "
                             f"expected 'none' or 'ivf'")
        use_ivf = index == "ivf"
        if use_ivf and top_k is None:
            raise ValueError("index='ivf' serves top-k retrieval; "
                             "pass top_k=...")
        if hasattr(exp, "trainer"):                     # paper system
            step_fn = (_paper_ivf_step_fn(exp, top_k, nprobe) if use_ivf
                       else _paper_step_fn(exp, top_k))
        elif hasattr(exp, "head_state"):                # zoo system
            step_fn = (_zoo_ivf_step_fn(exp, top_k, nprobe) if use_ivf
                       else _zoo_step_fn(exp, top_k))
        else:
            raise TypeError(
                f"not a paper/zoo Experiment: {type(exp).__name__}")
        # the probe moves on every weight load as well as every train step
        # (weights_version is (loads, step)), so cached scores never outlive
        # the weights that produced them
        version_fn = lambda: exp.weights_version        # noqa: E731
        return ServingEngine(step_fn, top_k=top_k, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, cache=cache,
                             clock=clock, version_fn=version_fn,
                             min_bucket=min_bucket, telemetry=telemetry)


def replay_trace(engine: ServingEngine, clock, times, qids,
                 pool: np.ndarray) -> List[Request]:
    """Drive an engine with a generated trace under a ``VirtualClock``.

    Arrivals are replayed in trace order; between arrivals the clock also
    stops at any pending coalescer deadline so lull-tail flushes happen at
    their true due time (not lazily at the next arrival). Returns every
    completed request (one per trace event)."""
    done: List[Request] = []

    def run_due_before(t):
        while True:
            dl = engine.coalescer.oldest_deadline()
            if dl is None or dl >= t:
                return
            clock.advance_to(dl)
            done.extend(engine.poll())

    for t, qid in zip(times, qids):
        run_due_before(float(t))
        clock.advance_to(float(t))
        engine.submit(pool[int(qid)])
        done.extend(engine.poll())
    end = engine.coalescer.oldest_deadline()
    if end is not None:
        clock.advance_to(end)
    done.extend(engine.drain())
    return done


def _paper_step_fn(exp, top_k):
    import torch

    from repro_torch.train import hybrid

    head = exp.head
    if top_k is not None:
        step = hybrid.make_batched_topk_serve_step(
            exp.model_cfg, exp.head_cfg, top_k, head=head)
    else:
        step = hybrid.make_batched_serve_step(exp.model_cfg, exp.head_cfg,
                                              head=head)

    def run(queries: np.ndarray, n_valid: int):
        q = torch.from_numpy(queries).to(exp.device)
        return _host(step(exp.state, q, n_valid), top_k)

    return run


def _paper_ivf_step_fn(exp, top_k, nprobe):
    import torch

    from repro_torch.train import hybrid

    built = {}           # (n_clusters, cap, nprobe) -> step

    def ensure():
        # exp.ivf_index() refits when weights_version moves; the step is
        # rebuilt only when the index's geometry (or the effective probe
        # width) changes
        idx = exp.ivf_index()
        np_eff = idx.resolve_nprobe(nprobe)
        key = (idx.n_clusters, idx.cap, np_eff)
        if key not in built:
            built.clear()
            built[key] = hybrid.make_batched_ivf_topk_serve_step(
                exp.model_cfg, exp.head_cfg, top_k, nprobe=np_eff,
                head=exp.head)
        return idx, built[key]

    def run(queries: np.ndarray, n_valid: int):
        idx, step = ensure()
        q = torch.from_numpy(queries).to(exp.device)
        return _host(step(exp.state, idx.centroids, idx.members, q,
                          n_valid), top_k)

    return run


def _host(out, top_k):
    """A step's result as the engine's (ids, scores) host arrays."""
    if top_k is not None:
        vals, gids = out
        return gids.cpu().numpy(), vals.cpu().numpy()
    return out.cpu().numpy(), None


def _zoo_step_fn(exp, top_k):
    import torch

    from repro_torch.train import gspmd

    step = gspmd.make_feature_serve_step(exp.model_cfg, exp.head_cfg,
                                         top_k=top_k, head=exp.head,
                                         specs=exp.specs)

    def run(queries: np.ndarray, n_valid: int):
        q = torch.from_numpy(queries).to(exp.device)
        return _host(step(exp.params, exp.head_state.params,
                          exp.head_state.aux, q, n_valid), top_k)

    return run


def _zoo_ivf_step_fn(exp, top_k, nprobe):
    import torch

    from repro_torch.train import gspmd

    built = {}           # (n_clusters, cap, nprobe) -> step

    def ensure():
        idx = exp.ivf_index()
        np_eff = idx.resolve_nprobe(nprobe)
        key = (idx.n_clusters, idx.cap, np_eff)
        if key not in built:
            built.clear()
            built[key] = gspmd.make_feature_ivf_serve_step(
                exp.model_cfg, exp.head_cfg, top_k, nprobe=np_eff,
                head=exp.head, specs=exp.specs)
        return idx, built[key]

    def run(queries: np.ndarray, n_valid: int):
        idx, step = ensure()
        q = torch.from_numpy(queries).to(exp.device)
        return _host(step(exp.params, exp.head_state.params,
                          exp.head_state.aux, idx.centroids, idx.members, q,
                          n_valid), top_k)

    return run
