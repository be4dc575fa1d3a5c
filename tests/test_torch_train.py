"""The port's training slice against the JAX package, on the CPU.

* ``full_softmax_local``: loss, metrics and head gradient on both backends
  (``ref`` dense logits; ``kernel`` through ``ops.ce_shard_stats`` and its
  backward) at rings of 1, 2 and 4: the port on ``repro_torch.dist``
  gloo ranks, JAX under ``shard_map`` on ``hybrid.make_hybrid_mesh(n)``,
  with raw and cosine logits and padded vocab. This pins ROADMAP.md C.1:
  the head gradient grows with the ring size, as psum's transpose sums
  one replicated cotangent per member.
* the ring collectives' gradients; the optimizers; the FCCS tables.
* the milestone: an 8-step ``PaperExperiment.fit`` with FCCS batch growth
  (micro-batch counts 1, 1, 1, 2, 4, 4, 4, 4) and LARS, from the JAX
  experiment's initial class matrix and moment carried by ``interop``, on
  the same numpy batches, at rings of 1, 2 and 4 on both backends: loss,
  accuracy, lr, batch and the final class matrix within ``rtol=1e-4``.
* the train launcher on the CPU, and what is not ported saying so.

The Pallas kernels run in interpret mode, as the JAX package's own tests
run them. One ring per ring size is spawned for the whole module.
"""
import concurrent.futures
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.api import Experiment as JaxExperiment
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import fccs as jfccs
from repro.core import sharded_softmax as jss
from repro.optim import optimizers as jopt
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as port_base
from repro_torch.core import fccs as tfccs
from repro_torch.core import pipeline as tpipe
from repro_torch.core import sharded_softmax as tss
from repro_torch.launch import train as port_launcher
from repro_torch.optim import optimizers as topt
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
BACKENDS = (("ref", "ref"), ("pallas", "kernel"))    # (JAX name, port name)

# loss bodies: b gathered rows against V classes of width D
LB, LD, LV = 16, 32, 512
BODY_CASES = {"raw": (0.0, 0), "cosine": (16.0, 0), "padded": (16.0, 500)}

# the milestone: 8 steps of LARS with FCCS batch growth on 512 classes
CLASSES, FEAT, HW_BATCH, STEPS = 512, 32, 16, 8
FCCS = dict(eta0=0.4, t_warm=2, b0=16, b_min=16, b_max=64, t_ini=2,
            t_final=6)
TRAIN = dict(optimizer="lars")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)


def _body_inputs(case):
    _, n_valid = BODY_CASES[case]
    rng = np.random.default_rng(7 + n_valid)
    f = rng.standard_normal((LB, LD)).astype(np.float32)
    w = (0.3 * rng.standard_normal((LV, LD))).astype(np.float32)
    y = rng.integers(0, n_valid or LV, LB).astype(np.int32)
    y[:4] = f[:4].argmax(1)          # a few rows the raw logits get right
    w[y[:4]] += 2.0 * f[:4] / np.linalg.norm(f[:4], axis=1, keepdims=True)
    return f, y, w


def _eval_inputs():
    return testing.numpy_batch(10**6, 4 * HW_BATCH, classes=CLASSES,
                               dim=FEAT)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_body(case, jb, n):
    cosine_scale, n_valid = BODY_CASES[case]
    f, y, w = _body_inputs(case)
    mesh = jhybrid.make_hybrid_mesh(n)
    ax = jhybrid.AXIS

    def body(f, y, w):
        def loss(w_):
            return jss.full_softmax_local(
                f, y, w_, model_axis=ax, batch_axes=(),
                global_batch=f.shape[0], cosine_scale=cosine_scale,
                n_valid=n_valid, backend=jb, block_v=128)
        (l, metrics), g = jax.value_and_grad(loss, has_aux=True)(w)
        return l, metrics, g

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(), P(ax, None)),
                       out_specs=(P(), {"accuracy": P(), "logz": P()},
                                  P(ax, None)), check_vma=False)
    with jax.set_mesh(mesh):
        loss, metrics, g = jax.device_get(jax.jit(fn)(f, y, w))
    return {"loss": loss, **metrics, "grad": g}


def _jax_fit(jb, n):
    """The JAX experiment on a ring of n: its initial class matrix and
    moment, then the same 8 steps on ``numpy_batch`` data."""
    head = JaxHeadConfig(softmax_impl="full", backend=jb)
    exp = JaxExperiment.from_config(
        system="paper", classes=CLASSES, feat_dim=FEAT, batch=HW_BATCH,
        head=head, train=JaxTrainConfig(**TRAIN, fccs=JaxFCCSConfig(**FCCS)),
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0,
        data_fn=functools.partial(testing.numpy_batch, classes=CLASSES,
                                  dim=FEAT))
    w0 = np.array(exp.state.head_params)
    mu0 = np.array(exp.state.opt_state.mu[1])
    hist = exp.fit(STEPS, use_fccs_batch=True)
    return {"head_cfg": dataclasses.asdict(head), "w0": w0, "mu0": mu0,
            "history": [dict(r) for r in hist],
            "w": np.array(exp.state.head_params),
            "eval": exp.evaluate(_eval_inputs())}


def _jax_ring(n):
    return {"bodies": {(c, tb): _jax_body(c, jb, n)
                       for c in BODY_CASES for jb, tb in BACKENDS},
            "fit": {tb: _jax_fit(jb, n) for jb, tb in BACKENDS}}


# ---------------------------------------------------------------------------
# the port's side: one ring per ring size runs every case
# ---------------------------------------------------------------------------


def _port_ring(n, jr):
    body_keys = [(c, tb) for c in BODY_CASES for _, tb in BACKENDS]
    cases = [("collective_grads", (), {})]
    cases += [("loss_body", _body_inputs(c),
               dict(cosine_scale=BODY_CASES[c][0],
                    n_valid=BODY_CASES[c][1], backend=tb))
              for c, tb in body_keys]
    fits = [tb for _, tb in BACKENDS]
    cases += [("paper_fit", (jr["fit"][tb]["head_cfg"], TRAIN, FCCS,
                             jr["fit"][tb]["w0"], jr["fit"][tb]["mu0"]),
               dict(steps=STEPS, batch=HW_BATCH,
                    eval_inputs=_eval_inputs()))
              for tb in fits]
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    first = per_rank[0]
    return {"ranks": per_rank,
            "grads": [r[0] for r in per_rank],
            "bodies": dict(zip(body_keys, first[1:1 + len(body_keys)])),
            "fit": dict(zip(fits, first[1 + len(body_keys):]))}


@functools.lru_cache(maxsize=None)
def _results():
    """(JAX results, port results) by ring size. Each spawned ring starts
    as soon as its JAX reference is made, and runs while this process
    makes the next one; the ring of one (in this process) comes last."""
    jr, port = {}, {}
    with concurrent.futures.ThreadPoolExecutor(len(RINGS)) as pool:
        for n in sorted(RINGS, reverse=True):
            jr[n] = _jax_ring(n)
            port[n] = pool.submit(_port_ring, n, jr[n])
        return jr, {n: f.result() for n, f in port.items()}


def jax_results():
    return _results()[0]


@pytest.fixture(scope="module")
def port_results():
    return _results()[1]


@pytest.mark.parametrize("n", RINGS)
def test_collective_gradients(port_results, n):
    """psum's backward sums the cotangent over the ring and all_gather's
    reduce-scatters it; pmax and pmin carry no gradient. For
    L = sum(psum(x^2)) + sum(all_gather((r+1) x)^2) on every member,
    dL/dx_r = 2 n x_r (1 + (r+1)^2)."""
    for r, o in enumerate(port_results[n]["grads"]):
        x = np.array([1.0 + r, 2.0], dtype=np.float32)
        np.testing.assert_allclose(o["grad"], 2 * n * x * (1 + (r + 1) ** 2),
                                   rtol=1e-6)
        assert not o["pmax_requires_grad"] and not o["pmin_requires_grad"]


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("backend", [tb for _, tb in BACKENDS])
@pytest.mark.parametrize("case", list(BODY_CASES))
def test_full_softmax_local_matches_jax(port_results, n, backend, case):
    """Loss, accuracy, logz and the head gradient of one member's body
    equal the shard_map body's, on every member; the gradient at a ring of
    n is n times the ring-of-one gradient (C.1, kept as in the
    reference)."""
    port = port_results[n]["bodies"][(case, backend)]
    ref = jax_results()[n]["bodies"][(case, backend)]
    for k in ("loss", "accuracy", "logz", "grad"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{k} {case} {backend} P={n}")
    one = jax_results()[1]["bodies"][(case, backend)]["grad"]
    np.testing.assert_allclose(port["grad"], n * one, rtol=1e-5, atol=1e-6)
    if BODY_CASES[case][1]:
        assert np.all(port["grad"][BODY_CASES[case][1]:] == 0)
    for r in range(1, n):
        other = port_results[n]["ranks"][r][
            1 + list(port_results[n]["bodies"]).index((case, backend))]
        np.testing.assert_array_equal(other["loss"], port["loss"])


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("backend", [tb for _, tb in BACKENDS])
def test_fit_trajectory_matches_jax(port_results, n, backend):
    """The milestone: 8 FCCS steps (micro-batch counts 1, 1, 1, 2, 4, 4,
    4, 4) from the same initial state on the same batches give the JAX
    experiment's loss, accuracy, lr and batch at every step, its final
    class matrix and its evaluation accuracy, within rtol 1e-4."""
    port = port_results[n]["fit"][backend]
    ref = jax_results()[n]["fit"][backend]
    assert [r["batch"] for r in port["history"]] == \
        [r["batch"] for r in ref["history"]] == \
        [16, 16, 16, 32, 64, 64, 64, 64]
    for key in ("lr", "loss", "acc"):
        np.testing.assert_allclose(
            [r[key] for r in port["history"]],
            [r[key] for r in ref["history"]], err_msg=key, **TRAJ_TOL)
    np.testing.assert_allclose(port["w"], ref["w"], **TRAJ_TOL)
    assert not np.allclose(port["w"], ref["w0"])
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    # weights_version moves on every step (and the one load counts once)
    assert port["versions"] == [(1, t) for t in [0, *range(STEPS), STEPS]]


# ---------------------------------------------------------------------------
# optimizers, FCCS, micro-batching
# ---------------------------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return ({"a": rng.standard_normal((3, 4)).astype(np.float32)},
            rng.standard_normal((6, 4)).astype(np.float32))


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, weight_decay=1e-4)),
    ("sgd", dict(momentum=0.9, weight_decay=0.0, nesterov=True)),
    ("lars", dict(momentum=0.9, weight_decay=1e-4)),
    ("adam", dict(weight_decay=1e-3)),
])
def test_optimizer_updates_match_jax(name, kw):
    """Two updates of each optimizer on a (fe dict, head) tree: updates,
    moments and step equal the JAX package's to fp32 rounding."""
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = topt.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for g, lr in ((g1, 0.5), (g2, 0.1)):
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, lr)
        tu, ts = to.update(topt.tree_map(torch.from_numpy, g), ts, tp, lr)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    for a, b in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for a, b in zip(jax.tree.leaves(js.mu), topt.tree_leaves(ts.mu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert ts.step == int(js.step) == 2
    assert (ts.nu is None) == (js.nu is None)


def test_make_optimizer_by_name():
    for name in ("sgd", "lars", "adam"):
        cfg = port_base.TrainConfig(optimizer=name)
        assert isinstance(topt.make_optimizer(cfg), topt.Optimizer)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(port_base.TrainConfig(optimizer="nope"))


FCCS_CASES = [dict(), dict(eta0=0.4, t_warm=2, b0=16, b_min=16, b_max=64,
                           t_ini=2, t_final=6),
              dict(eta0=1.0, t_warm=5, b0=32, b_min=64, b_max=4096, t_ini=3,
                   t_final=40)]


@pytest.mark.parametrize("cfg", FCCS_CASES)
def test_fccs_tables_match_jax(cfg):
    """lr, batch (both signs of the cosine), accumulation steps and the
    piecewise-decay baseline equal the JAX package's at every step."""
    jc, tc = JaxFCCSConfig(**cfg), port_base.FCCSConfig(**cfg)
    total = max(60, tc.t_final + 10)
    for hw in (16, 256):
        assert tfccs.schedule_summary(tc, total, hw, every=3) == \
            jfccs.schedule_summary(jc, total, hw, every=3)
    for t in range(total):
        for dec in (False, True):
            assert tfccs.batch_size(t, tc, decreasing=dec) == \
                jfccs.batch_size(t, jc, decreasing=dec)
        assert tfccs.piecewise_decay_lr(t, eta0=0.4, steps_per_epoch=7) == \
            jfccs.piecewise_decay_lr(t, eta0=0.4, steps_per_epoch=7)


def test_microbatches_average_to_the_full_batch():
    """Accumulating g/n over n micro-batches of a mean loss gives the
    full-batch gradient; loss and metrics are averaged; a batch that does
    not split raises."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3,)).astype(np.float32))

    def loss_fn(params, inp):
        (wp,) = params
        out = (inp["x"] @ wp) ** 2
        return out.mean(), {"m": out.max()}

    (l1, m1), (g1,) = tpipe.microbatched_value_and_grad(
        loss_fn, (w,), {"x": x}, 1)
    (l4, m4), (g4,) = tpipe.microbatched_value_and_grad(
        loss_fn, (w,), {"x": x}, 4)
    torch.testing.assert_close(l4, l1)
    torch.testing.assert_close(g4, g1)
    torch.testing.assert_close(
        m4["m"], torch.stack([((x[i:i + 2] @ w) ** 2).max()
                              for i in range(0, 8, 2)]).mean())
    assert not w.requires_grad
    with pytest.raises(ValueError, match="does not split"):
        tpipe.split_microbatches({"x": x}, 3)


def test_ce_ref_matches_jax():
    f, y, w = _body_inputs("raw")
    for cs, ls in ((0.0, 0.0), (16.0, 0.1)):
        jl, jm = jss.ce_ref(jnp.asarray(f), jnp.asarray(y), jnp.asarray(w),
                            cosine_scale=cs, label_smoothing=ls)
        tl, tm = tss.ce_ref(torch.from_numpy(f), torch.from_numpy(y),
                            torch.from_numpy(w), cosine_scale=cs,
                            label_smoothing=ls)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        for k in ("accuracy", "logz"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# the facade and the launcher
# ---------------------------------------------------------------------------


def test_fit_on_the_cpu_moves_weights_and_version():
    exp = Experiment.from_config(
        system="paper", classes=128, feat_dim=16, batch=8, device="cpu",
        log_every=0, train=port_base.TrainConfig(optimizer="sgd"))
    w0 = exp.state.w_head.clone()
    v0 = exp.weights_version
    hist = exp.fit(3, use_fccs_batch=False)
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert exp.weights_version == (v0[0], 3)
    assert not torch.equal(exp.state.w_head, w0)
    assert 0.0 <= exp.evaluate() <= 1.0


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    metrics, trace = tmp_path / "m.jsonl", tmp_path / "t.json"
    rc = port_launcher.main([
        "--device", "cpu", "--classes", "512", "--feat-dim", "32",
        "--steps", "8", "--batch", "32", "--fccs", "--metrics-out",
        str(metrics), "--trace-out", str(trace)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final eval accuracy" in out and "8 train.step spans" in out
    rows = metrics.read_text().splitlines()
    assert len(rows) == 8 and '"batch": 256' in rows[-1]


@pytest.mark.parametrize("extra", [["--trunk", "cnn"], ["--dgc"],
                                   ["--trunk", "cnn", "--dgc"],
                                   ["--trunk", "cnn", "--dgc", "--backend",
                                    "ref"]])
def test_train_launcher_cnn_and_dgc_on_the_cpu(extra, tmp_path, capsys):
    """The reduced ResNet trunk and DGC through the launcher: exit 0, a
    printed accuracy in [0, 1], a metrics row a step."""
    metrics = tmp_path / "m.jsonl"
    rc = port_launcher.main([
        "--device", "cpu", "--classes", "64", "--feat-dim", "16",
        "--steps", "3", "--batch", "8", "--fccs", "--optimizer", "lars",
        "--metrics-out", str(metrics)] + extra)
    assert rc == 0
    out = capsys.readouterr().out
    acc = [line for line in out.splitlines() if "final eval accuracy" in line]
    assert acc and 0.0 <= float(acc[-1].split()[-1]) <= 1.0
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(rows) == 3


@pytest.mark.parametrize("argv,queue", [
    # the zoo's moe and encdec families and the chameleon config are
    # ported: these cases (their ids kept from when they were refusals
    # naming ROADMAP.md A.9, and before that A.7) train one step
    pytest.param(["--system", "zoo", "--arch", "qwen3_moe_30b_a3b"], "train",
                 id="argv0-A.9"),
    pytest.param(["--system", "zoo", "--arch", "kimi_k2_1t_a32b"], "train",
                 id="argv1-A.7"),
    pytest.param(["--system", "zoo", "--arch", "whisper_tiny"], "train",
                 id="argv2-A.7"),
    (["--backend", "pallas"], None),
    (["--steps", "0"], None),
])
def test_train_launcher_rejects_unported_args(argv, queue, capsys):
    if queue == "train":
        rc = port_launcher.main(argv + [
            "--reduced", "--device", "cpu", "--steps", "1", "--batch", "2",
            "--seq", "8", "--lr", "0.5"])
        assert rc == 0
        assert "[zoo] final next-token accuracy" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as e:
        port_launcher.main(argv)
    assert e.value.code == 2
    if queue:
        assert f"ROADMAP.md queue {queue}" in capsys.readouterr().err
