"""The port's serving slice against the JAX package, on the CPU.

* the sharded serve bodies (``core.sharded_softmax``) on rings of 1 and 2:
  the port on ``repro_torch.dist.spawn_ring`` gloo ranks, JAX under
  ``shard_map`` on ``hybrid.make_hybrid_mesh(1|2)``, both backends, with
  and without vocab padding;
* the facade: a JAX ``PaperExperiment`` per backend and ring size, its
  class matrix carried into the port by ``interop.paper_state_from_numpy``,
  then greedy ids and top-5 ids and scores on explicit inputs and through
  the serving engine (5 queries -> bucket 8, so padding rows are masked);
* the launcher in-process, and the JAX package's serving-tier and tracer
  cases run against the port's copies of the coalescer, cache, trace,
  engine and tracer.

The inputs are made from a seed with numpy; one ring is spawned per ring
size for the whole module. Tolerances: scores ``rtol=atol=1e-5``, ids
exact.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro_torch.serving as port_serving
from repro.api import Experiment as JaxExperiment
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.core import sharded_softmax as jss
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.launch import serve as port_launcher
from tests.torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
RINGS = (1, 2)
BACKENDS = (("ref", "ref"), ("pallas", "kernel"))    # (JAX name, port name)

# serve bodies: b queries of which the first NQ are real, top-K, stage-1
# chunks of CHUNK columns so every shard is cut into several
B, D, K, NQ, CHUNK = 8, 16, 5, 5, 128
BODY_CASES = {"dense": (600, 0), "padded": (640, 600)}   # (rows, n_valid)
# facade: the paper system at a small width
CLASSES, FEAT, TOPK = 512, 32, 5

def _body_inputs(case):
    v, n_valid = BODY_CASES[case]
    rng = np.random.default_rng(v)
    f = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((v, D)).astype(np.float32)
    if n_valid:
        w[n_valid:] = 3.0          # poison rows: they win unless masked
    return f, w, n_valid


def _facade_inputs():
    rng = np.random.default_rng(5)
    inputs = rng.standard_normal((8, FEAT)).astype(np.float32)
    queries = rng.standard_normal((5, FEAT)).astype(np.float32)
    return inputs, queries


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_bodies(case, n):
    f, w, n_valid = _body_inputs(case)
    mesh = jhybrid.make_hybrid_mesh(n)
    ax = jhybrid.AXIS

    def run(body, out_specs):
        fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(ax, None)),
                           out_specs=out_specs, check_vma=False)
        with jax.set_mesh(mesh):
            return jax.device_get(jax.jit(fn)(f, w))

    out = {"argmax": run(lambda f, w: jss.serve_argmax_local(
        f, w, model_axis=ax, n_valid=n_valid)[0], P())}
    out["logits_ids"], out["logits"] = run(
        lambda f, w: jss.serve_logits_local(f, w, model_axis=ax,
                                            n_valid=n_valid),
        (P(), P(None, ax)))
    for jb, tb in BACKENDS:
        out[f"topk_{tb}"] = run(lambda f, w: jss.serve_topk_local(
            f, w, K, model_axis=ax, n_valid=n_valid, backend=jb,
            chunk=CHUNK), (P(), P()))
        out[f"batched_{tb}"] = run(lambda f, w: jss.serve_topk_batched_local(
            f, w, K, NQ, model_axis=ax, n_valid=n_valid, backend=jb,
            chunk=CHUNK), (P(), P()))
    return out


def _jax_facade(jax_backend, n):
    """A JAX PaperExperiment on a ring of n, its class matrix, and its
    results on the facade inputs."""
    inputs, queries = _facade_inputs()
    head = JaxHeadConfig(softmax_impl="full", backend=jax_backend)
    exp = JaxExperiment.from_config(
        system="paper", classes=CLASSES, feat_dim=FEAT, batch=8, head=head,
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0)
    out = {"greedy": np.asarray(exp.serve({"features": inputs}))}
    out["topk_ids"], out["topk_scores"] = (np.asarray(a) for a in exp.serve(
        {"features": inputs}, top_k=TOPK, return_scores=True))
    for key, k in (("engine_greedy", None), ("engine_topk", TOPK)):
        eng = exp.serving_engine(top_k=k, max_batch=8)
        for q in queries:
            eng.submit(q)
        done = sorted(eng.drain(), key=lambda r: r.rid)
        out[key] = np.stack([np.asarray(r.ids) for r in done])
        if k is not None:
            out[key + "_scores"] = np.stack([np.asarray(r.scores)
                                             for r in done])
    return (dataclasses.asdict(head), np.asarray(exp.state.head_params),
            out)


@functools.lru_cache(maxsize=None)
def jax_results():
    """Every JAX result the module compares with, keyed by ring size."""
    res = {}
    for n in RINGS:
        res[n] = {"bodies": {c: _jax_bodies(c, n) for c in BODY_CASES},
                  "facade": {tb: _jax_facade(jb, n) for jb, tb in BACKENDS}}
    return res


# ---------------------------------------------------------------------------
# the port's side: one ring per ring size runs every case
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_results():
    jr = jax_results()
    inputs, queries = _facade_inputs()
    res = {}
    for n in RINGS:
        cases = [("collectives", (), {})]
        cases += [("serve_bodies", _body_inputs(c)[:2],
                   dict(k=K, n_queries=NQ, n_valid=_body_inputs(c)[2],
                        chunk=CHUNK)) for c in BODY_CASES]
        cases += [("paper_serve", (jr[n]["facade"][tb][0],
                                   jr[n]["facade"][tb][1], inputs, queries),
                   dict(top_k=TOPK)) for _, tb in BACKENDS]
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        res[n] = {"ranks": per_rank,
                  "collectives": [r[0] for r in per_rank],
                  "bodies": dict(zip(BODY_CASES, per_rank[0][1:3])),
                  "facade": {tb: per_rank[0][3 + i]
                             for i, (_, tb) in enumerate(BACKENDS)}}
    return res


def _assert_same(port, ref, what):
    if isinstance(ref, tuple):
        for i, (a, b) in enumerate(zip(port, ref)):
            _assert_same(a, b, f"{what}[{i}]")
        return
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    if np.issubdtype(ref.dtype, np.floating):
        np.testing.assert_allclose(port, ref, err_msg=what, **TOL)
    else:
        np.testing.assert_array_equal(port, ref, err_msg=what)


@pytest.mark.parametrize("n", RINGS)
def test_ring_collectives(port_results, n):
    """The ring's collectives: rank order, max/min/sum, gathers; the
    identity on a ring of one."""
    outs = port_results[n]["collectives"]
    ranks = np.arange(n, dtype=np.float32)
    x = np.stack([ranks, 10 - ranks], axis=1)           # [n, 2]
    for r, o in enumerate(outs):
        assert (o["rank"], o["world_size"], o["axis_index"]) == (r, n, r)
        np.testing.assert_array_equal(o["pmax"], x.max(0))
        np.testing.assert_array_equal(o["pmin"], x.min(0))
        np.testing.assert_array_equal(o["psum"], x.sum(0))
        np.testing.assert_array_equal(o["gather_tiled"], x)
        np.testing.assert_array_equal(o["gather_stacked"], x.T)


def test_a_failing_ring_member_raises_in_the_caller():
    """A worker that raises reports its traceback to the caller, which
    raises it, instead of leaving the caller waiting on the ring."""
    with pytest.raises(RuntimeError, match="KeyError: 'no_such_worker'"):
        dist.spawn_ring(testing.run_all, 2, [("no_such_worker", (), {})])


BODIES = ["argmax", "logits_ids", "logits", "topk_ref", "topk_kernel",
          "batched_ref", "batched_kernel"]


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("case", list(BODY_CASES))
@pytest.mark.parametrize("body", BODIES)
def test_serve_body_matches_jax(port_results, n, case, body):
    """Each sharded serve body equals its shard_map counterpart: argmax
    and top-k ids exactly, scores to fp32 tolerance; padded classes never
    win; padding rows of the batched body come back (-inf, -1); every ring
    member holds the same answer."""
    port = port_results[n]["bodies"][case][body]
    _assert_same(port, jax_results()[n]["bodies"][case][body],
                 f"{body} {case} P={n}")
    _, _, n_valid = _body_inputs(case)
    if body.startswith("batched"):
        vals, gids = port
        assert np.all(vals[NQ:] == -np.inf) and np.all(gids[NQ:] == -1)
        assert np.all(gids[:NQ] >= 0)
    if n_valid and body in ("argmax", "logits_ids"):
        assert np.all(port < n_valid)
    for r in range(1, n):
        other = port_results[n]["ranks"][r][1 + list(BODY_CASES).index(case)]
        if body != "logits":
            _assert_same(other[body], port, f"{body} rank {r}")


FACADE = ["greedy", "topk_ids", "topk_scores", "engine_greedy",
          "engine_topk", "engine_topk_scores"]


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("backend", [tb for _, tb in BACKENDS])
@pytest.mark.parametrize("what", FACADE)
def test_paper_serve_matches_jax(port_results, n, backend, what):
    """The port's Experiment, given the JAX experiment's class matrix,
    serves the same greedy ids and top-5 ids and scores, on explicit
    inputs and through the engine (5 queries padded to bucket 8)."""
    port = port_results[n]["facade"][backend]
    _assert_same(port[what], jax_results()[n]["facade"][backend][2][what],
                 f"{what} {backend} P={n}")
    if what.startswith("engine"):
        assert port["engine_greedy_buckets"] == [8]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_on_the_cpu(tmp_path, capsys):
    base = ["--system", "paper", "--device", "cpu", "--classes", "512",
            "--feat-dim", "32", "--batch", "8"]
    assert port_launcher.main(base + ["--topk", "5"]) == 0
    assert "top-5 retrieval over 512 classes" in capsys.readouterr().out
    assert port_launcher.main(base) == 0
    metrics = tmp_path / "replay.jsonl"
    assert port_launcher.main(base + ["--topk", "5", "--replay", "0.2",
                                      "--cache", "16", "--metrics-out",
                                      str(metrics)]) == 0
    assert "replayed" in capsys.readouterr().out
    row = metrics.read_text().splitlines()[-1]
    assert '"p99_ms"' in row and '"qps"' in row


@pytest.mark.parametrize("argv", [
    ["--batch", "0"],
    ["--topk", "-1"],
    ["--classes", "512", "--topk", "513"],
    ["--cache", "-2"],
    ["--max-wait-ms", "-1"],
    # the zoo's retrieval is ported; --nprobe still wants --index ivf
    ["--system", "zoo", "--topk", "5", "--nprobe", "2"],
    ["--index", "ivf"],
    ["--backend", "pallas"],
])
def test_launcher_rejects_bad_and_unported_args(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_launcher.main(argv)
    assert e.value.code == 2                   # argparse error, before torch
    err = capsys.readouterr().err
    if "zoo" in argv:
        assert "--nprobe only applies with --index ivf" in err
    if "ivf" in argv:
        assert "pass --topk" in err


# ---------------------------------------------------------------------------
# the serving tier: the JAX package's own cases against the port's copies
# ---------------------------------------------------------------------------


SERVING_CASES = [
    "test_bucket_for_pow2_floor_cap",
    "test_coalescer_full_batch_cuts_immediately",
    "test_coalescer_deadline_flush_and_occupancy",
    "test_coalescer_cuts_exactly_at_its_reported_deadline",
    "test_coalescer_deterministic_under_out_of_order_submits",
    "test_cache_exact_hit_and_lru_eviction",
    "test_cache_cosine_threshold_hits",
    "test_cache_invalidate_drops_entries_keeps_counters",
    "test_trace_reproducible_ascending_and_rate_sane",
    "test_trace_zipf_mix_is_skewed",
    "test_query_pool_shape_and_clock",
    "test_engine_pads_to_bucket_and_masks",
    "test_engine_serial_server_latency_model",
    "test_engine_cache_hits_and_version_invalidation",
]


@pytest.mark.parametrize("name", SERVING_CASES)
def test_serving_tier_case_on_the_port(name, monkeypatch):
    """Run one of ``tests/test_serving.py``'s cases with every serving
    name it uses rebound to the port's copy."""
    import tests.test_serving as jt
    for attr in ("Coalescer", "Request", "ScoreCache", "ServingEngine",
                 "TraceConfig", "VirtualClock", "bucket_for",
                 "generate_trace", "latency_stats", "make_query_pool"):
        monkeypatch.setattr(jt, attr, getattr(port_serving, attr))
    getattr(jt, name)()


TELEMETRY_CASES = [
    "test_span_nesting_and_determinism_under_fake_clock",
    "test_span_stats_and_counters",
    "test_null_tracer_is_zero_alloc_no_op",
    "test_chrome_trace_round_trip",
    "test_metrics_sink_appends_across_reopens",
]


@pytest.mark.parametrize("name", TELEMETRY_CASES)
def test_telemetry_case_on_the_port(name, monkeypatch, tmp_path):
    """Run one of ``tests/test_telemetry.py``'s tracer cases against the
    port's tracer, which the engine and the launcher record into."""
    import inspect

    import repro_torch.telemetry as port_telemetry
    import tests.test_telemetry as jt
    from repro_torch.telemetry import tracer as port_tracer
    for attr in ("NULL_TRACER", "MetricsSink", "Tracer"):
        monkeypatch.setattr(jt, attr, getattr(port_telemetry, attr))
    monkeypatch.setattr(jt, "_NullSpan", port_tracer._NullSpan)
    case = getattr(jt, name)
    case(*([tmp_path] if inspect.signature(case).parameters else []))


def test_peak_memory_falls_back_to_the_host():
    from repro_torch.telemetry import Tracer
    peaks = Tracer().record_peak_memory()
    if torch.cuda.is_available():
        assert set(peaks) == {str(i) for i in range(torch.cuda.device_count())}
    else:
        assert peaks["host_rss"] > 0
