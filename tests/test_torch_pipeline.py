"""The paper step's §3.3.1 pipeline and its in-place accumulation, on the
CPU.

* The two schedules of ``hybrid.make_value_and_grad`` / ``make_train_step``
  (``overlap=False``: the micro-batches in turn; ``overlap=True``: Fig.
  4(b)'s pipeline) give the same bits (``resilience.tree_compare``) in
  the loss, the metrics, every gradient leaf and the state after two
  steps, for n_micro 1, 2 and 4, the full and knn heads on the ``feats``
  trunk and the reduced ResNet with DGC, on gloo rings of 1, 2 and 4
  (``testing.pipeline_schedules``), and charge the same collectives.
* The pipelined schedule itself, read off ``dist.record_async``: gather(i
  + 1) starts before head(i) runs (within each pair of micro-batches for
  the trunk whose activations wait for their backward), compute runs
  between every collective's start and its wait, no more than two of the
  micro-batches' collectives are in flight, no more than two
  micro-batches' FE activations are live.
* The overlapped step against the JAX package's hybrid trainer at two
  micro-batches a step, rings of 2 and 4, within ``TRAJ_TOL``.
* The in-place accumulation: its buffers keep their storage over the
  micro-batches and equal the JAX ``microbatched_value_and_grad`` bit for
  bit; the dry run's member peak at two micro-batches is one fp32
  gradient tree below the whole-tree accumulation's.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Experiment as JaxExperiment
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import pipeline as jpipe
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.core import pipeline as tpipe
from repro_torch.launch import dryrun
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.roofline.counter import WorkCounter
from repro_torch.train import hybrid
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
# (trunk, head, n_micro, dgc)
CASES = [("feats", "full", 1, False), ("feats", "full", 2, False),
         ("feats", "full", 4, False), ("feats", "knn", 2, False),
         ("feats", "knn", 4, False), ("cnn", "full", 1, True),
         ("cnn", "full", 2, True), ("cnn", "full", 4, True)]
SIZES = dict(classes=64, batch=32, feat_dim=16, hw=16)

# the JAX comparison: two micro-batches every step (b0 = b_max = 2 x hw)
CLASSES, FEAT, HW_BATCH, STEPS = 128, 16, 16, 3
FCCS = dict(eta0=0.4, t_warm=2, b0=2 * HW_BATCH, b_min=2 * HW_BATCH,
            b_max=2 * HW_BATCH, t_ini=2, t_final=6)
TRAIN = dict(optimizer="lars")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)


def _data_fn(t, b):
    return testing.numpy_batch(t, b, classes=CLASSES, dim=FEAT)


def _eval_inputs():
    return _data_fn(10**6, 4 * HW_BATCH)


def _jax_fit(n):
    exp = JaxExperiment.from_config(
        system="paper", classes=CLASSES, feat_dim=FEAT, batch=HW_BATCH,
        head=JaxHeadConfig(softmax_impl="full", backend="ref"),
        train=JaxTrainConfig(**TRAIN, fccs=JaxFCCSConfig(**FCCS)),
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0, data_fn=_data_fn)
    w0 = np.array(exp.state.head_params)
    mu0 = np.array(exp.state.opt_state.mu[1])
    hist = exp.fit(STEPS, use_fccs_batch=True)
    return {"w0": w0, "mu0": mu0, "history": [dict(r) for r in hist],
            "w": np.array(exp.state.head_params),
            "eval": exp.evaluate(_eval_inputs())}


def _port_ring(n, jax_fit=None):
    cases = [("pipeline_schedules", (CASES,), SIZES)]
    if jax_fit is not None:
        cases.append(("paper_fit", (
            {"softmax_impl": "full", "backend": "ref"}, TRAIN, FCCS,
            jax_fit["w0"], jax_fit["mu0"]),
            dict(steps=STEPS, batch=HW_BATCH, eval_inputs=_eval_inputs())))
    return dist.spawn_ring(testing.run_all, n, cases)


@functools.lru_cache(maxsize=None)
def _results():
    """By ring size: the JAX fit (rings of 2 and 4) and the port's ring,
    which runs ``pipeline_schedules`` and, where there is a JAX fit,
    ``paper_fit`` from its initial state. Each ring starts as soon as
    what it needs is made, and runs while this process makes the next."""
    jax_fits = {}
    with concurrent.futures.ThreadPoolExecutor(len(RINGS)) as pool:
        port = {1: pool.submit(_port_ring, 1)}
        for n in (4, 2):
            jax_fits[n] = _jax_fit(n)
            port[n] = pool.submit(_port_ring, n, jax_fits[n])
        return jax_fits, {n: f.result() for n, f in port.items()}


@pytest.fixture(scope="module")
def results(one_thread):
    return _results()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("n", RINGS)
def test_schedules_are_bit_equal(results, n, case):
    """Loss, metrics, every gradient leaf and the state after two steps of
    the overlapped schedule have the in-turn one's bits, on
    every member; the losses are finite."""
    i = CASES.index(case)
    for r, member in enumerate(results[1][n]):
        out = member[0][i]
        assert out["unequal"] == [], f"member {r}: {out['unequal']}"
        assert np.all(np.isfinite(out["losses"]))
    if case[0] == "cnn":
        assert out["n_grad_leaves"] > 1         # the trunk's and W


@pytest.mark.parametrize("n", RINGS)
def test_overlap_charges_the_same_collectives(results, n):
    """``count_collectives`` counts the same kinds, bytes and calls for
    both schedules, case by case, on every member."""
    for member in results[1][n]:
        for case, out in zip(CASES, member[0]):
            turn, overlap = out["counts"]
            assert turn == overlap, case
            if n > 1:
                assert turn["all-gather"]["count"] == 2 * case[2]
                assert ("reduce-scatter" in turn) == (case[0] == "cnn")


def _check_schedule(log, n_micro: int, trunk: str):
    heads = [i for i, e in enumerate(log) if e == ("head",)]
    assert len(heads) == n_micro
    # gather(i+1) before head(i): for every i where the features carry no
    # gradient, within each pair (i, i+1) where FE activations wait for
    # their backward
    for i in range(0, n_micro - 1, 1 if trunk == "feats" else 2):
        assert log.index(("start", "all-gather", i + 1)) < heads[i]
    # compute between every start and its wait: an FE forward, a head, or
    # the FE backward that follows another micro-batch's reduce-scatter
    compute = [e == ("fe",) or e == ("head",) or e[:2] == ("wait",
                                                           "reduce-scatter")
               for e in log]
    in_flight, live, most, most_live = {}, 0, 0, 0
    for k, e in enumerate(log):
        if e == ("fe",):
            live += 1
        elif e[0] == "start":
            in_flight.setdefault(e[1:], k)
        elif e[0] == "wait" and e[1:] in in_flight:
            start = in_flight.pop(e[1:])
            if n_micro > 1:
                assert any(compute[start + 1:k]), (e, log)
            if e[1] == "reduce-scatter":
                live -= 1                 # the FE backward that follows
        most, most_live = max(most, len(in_flight)), max(most_live, live)
    assert not in_flight
    assert most == min(2, n_micro)
    if trunk == "cnn":
        assert live == 0 and most_live == min(2, n_micro)


@pytest.mark.parametrize("n", RINGS)
def test_pipelined_schedule(results, n):
    """The order of the pipelined schedule's starts and waits: gather(i+1)
    is issued before head(i) runs (within each pair of micro-batches where
    the trunk's activations wait for their backward), compute runs
    between every collective's start and its wait, at most two of the
    micro-batches' collectives (a gather's features and labels are one)
    are in flight and at most two FE activations live, and every start is
    waited."""
    for case, out in zip(CASES, results[1][n][0][0]):
        _check_schedule(out["schedule"], case[2], case[0])


@pytest.mark.parametrize("n", [n for n in RINGS if n > 1])
def test_overlapped_step_matches_jax(results, n):
    """Three LARS steps of two micro-batches each, overlapped, from the
    JAX experiment's initial state on the same numpy batches: loss, lr,
    batch, accuracy, the final class matrix and the evaluation within
    ``TRAJ_TOL`` of the JAX hybrid trainer's."""
    ref = results[0][n]
    port = results[1][n][0][1]
    assert [r["batch"] for r in port["history"]] == \
        [r["batch"] for r in ref["history"]] == [2 * HW_BATCH] * STEPS
    for key in ("lr", "loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    np.testing.assert_allclose(port["w"], ref["w"], **TRAJ_TOL)
    assert not np.allclose(port["w"], ref["w0"])
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)


# ---------------------------------------------------------------------------
# the in-place accumulation
# ---------------------------------------------------------------------------


def _dyadic(rng, shape):
    """Values k / 8, |k| <= 8: their products and sums are exact in fp32,
    so only the accumulation rounds."""
    return (rng.integers(-8, 9, shape) / 8).astype(np.float32)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulation_in_place_matches_jax(n_micro, monkeypatch):
    """On a ring of one: the accumulator's buffers keep their storage over
    the micro-batches and are the gradients returned; loss, metric and
    the gradients (an fp32 and a bf16 leaf) equal the JAX
    ``microbatched_value_and_grad``'s bit for bit. At the micro-batch
    counts the trainer takes (powers of two) ``g / n`` is exact; at others
    XLA multiplies by a rounded reciprocal instead of dividing, so the
    JAX package's own bits follow another rounding there."""
    rng = np.random.default_rng(n_micro)
    w = {"a": _dyadic(rng, (4, 5)), "b": _dyadic(rng, (3,))}
    x = {"x": _dyadic(rng, (n_micro, 4, 5)), "z": _dyadic(rng, (n_micro, 3))}

    def loss_of(lib, p, m):
        a = p["a"] * p["a"] * m["x"][0]
        b = p["b"].astype(jnp.float32) if lib is jnp else p["b"].float()
        loss = a.sum() + (b * m["z"][0]).sum()
        return loss, {"m": a.max()}

    (jl, jm), jg = jpipe.microbatched_value_and_grad(
        lambda p, m: loss_of(jnp, p, m),
        {"a": jnp.asarray(w["a"]), "b": jnp.asarray(w["b"], jnp.bfloat16)},
        {k: jnp.asarray(v) for k, v in x.items()}, n_micro)
    ptrs = []
    add = tpipe.GradAccumulator.add_grads

    def recording_add(self, grads, start=0):
        add(self, grads, start)
        ptrs.append([a.data_ptr() for a in self.leaves])

    monkeypatch.setattr(tpipe.GradAccumulator, "add_grads", recording_add)
    (tl, tm), tg = tpipe.microbatched_value_and_grad(
        lambda p, m: loss_of(torch, p, m),
        {"a": torch.from_numpy(w["a"]),
         "b": torch.from_numpy(w["b"]).bfloat16()},
        {k: torch.from_numpy(v) for k, v in x.items()}, n_micro)
    assert len(ptrs) == n_micro and all(p == ptrs[0] for p in ptrs)
    assert [t.data_ptr() for t in tree_leaves(tg)] == ptrs[0]
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm["m"].numpy(), np.asarray(jm["m"]))
    for k in ("a", "b"):
        assert tg[k].dtype == torch.float32
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))


def _whole_tree_accumulation(loss_fn, params, inputs, n_micro,
                             metric_names=None):
    """The accumulation before it was in place: each micro-batch a new
    fp32 tree ``a + g / n`` beside the old one and the micro-batch's
    gradients, which stay alive until the next micro-batch's replace
    them."""
    acc_g, acc_l, acc_m = None, None, None
    for micro in tpipe.split_microbatches(inputs, n_micro):
        (loss, metrics), grads = tpipe._value_and_grad(loss_fn, params,
                                                       micro)
        if acc_g is None:
            acc_g = tree_map(lambda g: torch.zeros(
                g.shape, dtype=torch.float32, device=g.device), grads)
            acc_m = {k: torch.zeros((), device=loss.device)
                     for k in metric_names or metrics}
            acc_l = torch.zeros((), device=loss.device)
        acc_g = tree_map(lambda a, g: a + g.float() / n_micro, acc_g, grads)
        acc_m = {k: acc_m[k] + metrics[k] / n_micro for k in acc_m}
        acc_l = acc_l + loss / n_micro
    return (acc_l, acc_m), acc_g


def test_dryrun_peak_holds_one_gradient_tree_fewer(monkeypatch):
    """The dry run of one member of the paper step at 2**20 classes x 64
    (its W gradient 268 MB) and two micro-batches peaks one fp32 gradient
    tree below the whole-tree accumulation's (in turn, through the same
    step), give or take a batch's gathered features and labels, which the
    pipeline holds as a leaf of their own; at one micro-batch nothing
    accumulates and the two are alike within those. The zoo's
    accumulation (``microbatched_value_and_grad`` on meta tensors, four
    leaves alike) peaks exactly one gradient tree below the whole-tree
    one."""
    kw = dict(classes=1 << 20, feat_dim=64, batch=64, backend="kernel")
    tree = (1 << 20) * 64 * 4
    peaks = {}
    for old in (False, True):
        if old:
            monkeypatch.setattr(
                hybrid, "pipelined_value_and_grad",
                lambda fe_fn, head_fn, params, x, n, names:
                _whole_tree_accumulation(
                    lambda p, m: head_fn(
                        p[1], dist.all_gather(fe_fn(p[0], m), dim=0),
                        dist.all_gather(m["labels"], dim=0)),
                    params, x, n, names))
        for n_micro in (1, 2):
            rec = dryrun.lower_paper_one(n_micro=n_micro, **kw)
            peaks[old, n_micro] = rec["memory"]["peak_bytes"]
    feats = 64 * (64 + 1) * 4        # a batch's features and labels
    assert abs(peaks[True, 1] - peaks[False, 1]) <= feats
    drop = peaks[True, 2] - peaks[False, 2]
    assert tree - feats <= drop <= tree

    params = {f"w{i}": torch.empty((1 << 14, 256), device="meta")
              for i in range(4)}
    x = {"x": torch.empty((8, 256), device="meta")}

    def loss_fn(p, m):
        return sum((m["x"] @ w[:256]).sum() for w in p.values()), {}

    zoo = {}
    for name, fn in (("in place", tpipe.microbatched_value_and_grad),
                     ("whole tree", _whole_tree_accumulation)):
        with WorkCounter(track_memory=True) as wc:
            wc.hold(params, x)
            fn(loss_fn, params, x, 2)
        zoo[name] = wc.peak
    zoo_tree = sum(t.numel() * 4 for t in params.values())
    assert zoo["whole tree"] - zoo["in place"] == zoo_tree
