"""The selective, MACH, sampled and CSoft heads through the port's paper
trainer against the JAX package's, on the CPU.

* an 8-step FCCS trajectory per head (micro-batch counts 1, 1, 1, 2, 4, 4,
  4, 4; LARS) against the JAX ``PaperTrainer`` at rings of 1, 2 and 4,
  from the JAX run's initial head params, moment and aux state carried by
  ``interop`` (the LSH tables, the sketch hashes), on the ``kernel``
  backend against JAX's ``pallas`` one in interpret mode: loss, accuracy,
  lr and batch at every step, the final head params and the evaluation
  accuracy within ``rtol=1e-4`` (the head's own metrics, which the JAX
  history rows do not carry, held to their values). The selective
  tables are not rebuilt within the run; the sampled head's negatives are
  the JAX package's draws, injected by their salt;
* the selective head's ``refresh``: its tables are the member build through
  its own hyperplanes (seeded 41, the same on every member);
* both launchers with each of the four heads on the CPU; top-k and the IVF
  index refuse the sketch heads with the JAX package's reason.

One ring per ring size is spawned for the module.
"""
import concurrent.futures
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.api import Experiment as JaxExperiment
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.api import Experiment
from repro_torch.configs.base import HeadConfig
from repro_torch.core import baselines as tbl
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from tests.test_torch_heads import _jax_draw
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)

# the trajectory: 8 LARS steps with FCCS batch growth on 512 classes
CLASSES, FEAT, HW_BATCH, STEPS = 512, 32, 16, 8
FCCS = dict(eta0=0.4, t_warm=2, b0=16, b_min=16, b_max=64, t_ini=2,
            t_final=6)
N_MICRO = (1, 1, 1, 2, 4, 4, 4, 4)
TRAIN = dict(optimizer="lars")
HEADS = {
    "selective": dict(softmax_impl="selective", active_frac=0.1,
                      rebuild_every=100),
    "mach": dict(softmax_impl="mach", mach_b=32, mach_r=4),
    "sampled": dict(softmax_impl="sampled", sampled_n=CLASSES // 4),
    "csoft": dict(softmax_impl="csoft", csoft_b=32, csoft_r=4),
}
OWN_METRICS = {"selective": ("active_frac", "label_recall"), "mach": (),
               "sampled": ("sample_frac",), "csoft": ()}


def _eval_inputs():
    return testing.numpy_batch(10**6, 4 * HW_BATCH, classes=CLASSES,
                               dim=FEAT)


def _jax_experiment(n, head):
    """The JAX experiment with ``head`` on a ring of n, and its initial
    head params, moment and aux."""
    hcfg = JaxHeadConfig(backend="pallas", **HEADS[head])
    exp = JaxExperiment.from_config(
        system="paper", classes=CLASSES, feat_dim=FEAT, batch=HW_BATCH,
        head=hcfg, train=JaxTrainConfig(**TRAIN, fccs=JaxFCCSConfig(**FCCS)),
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0,
        data_fn=functools.partial(testing.numpy_batch, classes=CLASSES,
                                  dim=FEAT))
    return exp, {"head_cfg": dataclasses.asdict(hcfg),
                 "w0": np.array(exp.state.head_params),
                 "mu0": np.array(exp.state.opt_state.mu[1]),
                 "aux0": [np.array(a) for a in exp.state.head_aux]}


def _jax_fit(exp, start):
    """The same 8 steps on ``numpy_batch`` data."""
    hist = exp.fit(STEPS, use_fccs_batch=True)
    return {**start, "history": [dict(r) for r in hist],
            "w": np.array(exp.state.head_params),
            "eval": exp.evaluate(_eval_inputs())}


def _sampled_draws(n):
    """The JAX package's sampled draw of every member for every
    micro-batch of the run, keyed by its salt: the labels each micro-batch
    gathers over the ring are the ones the port's micro-batching gives
    (each member's rows, cut into n_micro slices, gathered in rank
    order)."""
    draws = {}
    for t, n_micro in enumerate(N_MICRO):
        labels = testing.numpy_batch(t, HW_BATCH * n_micro, classes=CLASSES,
                                     dim=FEAT)["labels"]
        local = labels.reshape(n, n_micro, -1)       # [member, micro, rows]
        for i in range(n_micro):
            y_all = local[:, i].reshape(-1)
            salt = tbl.sampled_salt(torch.from_numpy(y_all), t)
            draws[salt] = [_jax_draw(y_all, t, p, n, v_loc=CLASSES // n,
                                     n_samples=HEADS["sampled"]["sampled_n"],
                                     distribution="uniform")
                           for p in range(n)]
    return draws


def _selective_w():
    return np.random.default_rng(3).standard_normal(
        (CLASSES, FEAT)).astype(np.float32)


def _port_rings(starts):
    """Every port case, one ring per ring size: a fit from each JAX start,
    then the selective refresh."""
    res = {}
    for n in RINGS:
        cases = []
        for head in HEADS:
            st = starts[(n, head)]
            kw = dict(steps=STEPS, batch=HW_BATCH, eval_inputs=_eval_inputs(),
                      head_aux=st["aux0"], classes=CLASSES)
            if head == "sampled":
                kw["draws"] = _sampled_draws(n)
            cases.append(("paper_fit", (st["head_cfg"], TRAIN, FCCS, st["w0"],
                                        st["mu0"]), kw))
        cases.append(("selective_refresh", (_selective_w(),
                                            HEADS["selective"]), {}))
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        for i, head in enumerate(HEADS):
            res[(n, head)] = [r[i] for r in per_rank]
        res[(n, "refresh")] = [r[len(HEADS)] for r in per_rank]
    return res


@pytest.fixture(scope="module")
def results():
    """(JAX fits, port results). The JAX experiments are made first; the
    port's rings, which need only their initial state, then run in their
    own processes while this one runs the JAX fits."""
    exps = {(n, head): _jax_experiment(n, head) for n in RINGS
            for head in HEADS}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_rings, {k: st for k, (_, st) in exps.items()})
        jax_fits = {k: _jax_fit(exp, st) for k, (exp, st) in exps.items()}
        return jax_fits, port.result()


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("head", list(HEADS))
def test_fit_trajectory_matches_jax(results, n, head):
    """8 FCCS steps on the kernel backend from the JAX run's initial state:
    loss, accuracy, lr and batch at every step, the final head params and
    the evaluation accuracy equal the JAX
    PaperTrainer's (rtol 1e-4); every member ends with the same history.
    Selective selects every label (label_recall 1), and the sampled head's
    draws are a quarter of the classes. (The JAX history rows carry no
    head metrics beyond accuracy.)"""
    ref, port_all = results[0][(n, head)], results[1][(n, head)]
    port = port_all[0]
    assert [r["batch"] for r in port["history"]] == \
        [r["batch"] for r in ref["history"]] == \
        [HW_BATCH * k for k in N_MICRO]
    for key in ("lr", "loss", "acc"):
        np.testing.assert_allclose(
            [r[key] for r in port["history"]],
            [r[key] for r in ref["history"]], err_msg=key, **TRAJ_TOL)
    np.testing.assert_allclose(port["w"], ref["w"], **TRAJ_TOL)
    assert port["w"].shape == ref["w0"].shape
    assert not np.allclose(port["w"], ref["w0"])
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    for member in port_all[1:]:
        assert member["history"] == port["history"]
    for key in OWN_METRICS[head]:
        assert all(0.0 < r[key] <= 1.0 for r in port["history"]), key
    if head == "sampled":
        assert all(r["sample_frac"] == 0.25 for r in port["history"])
    if head == "selective":
        assert all(r["label_recall"] == 1.0 for r in port["history"])
        # the tables as loaded: no rebuild within the run
        for r, member in enumerate(port_all):
            np.testing.assert_array_equal(member["aux"][0], ref["aux0"][0])
            for a, b in zip(member["aux"][1:], ref["aux0"][1:]):
                np.testing.assert_array_equal(a, b[r])


@pytest.mark.parametrize("n", RINGS)
def test_selective_refresh_is_the_member_build(results, n):
    """``refresh`` hashes each member's own rows through hyperplanes drawn
    from a generator seeded 41: the same planes on every member, and the
    tables ``build_sharded_lsh_tables`` makes from them (held to the JAX
    package's build on the same planes by ``test_torch_heads.py``)."""
    out = results[1][(n, "refresh")]
    g = torch.Generator().manual_seed(41)
    planes = torch.randn((4, FEAT, 8), generator=g).numpy()
    v_loc = CLASSES // n
    for member in out:
        np.testing.assert_array_equal(member["planes"], planes)
        np.testing.assert_array_equal(member["offsets"], member["rebuilt"][0])
        np.testing.assert_array_equal(member["classes"], member["rebuilt"][1])
        assert member["offsets"].shape == (4, 257)
        assert member["classes"].shape == (4, v_loc)
        assert np.all(np.sort(member["classes"], axis=1)
                      == np.arange(v_loc))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

NEW_HEADS = ("selective", "mach", "sampled", "csoft")


@pytest.mark.parametrize("head", NEW_HEADS)
def test_train_launcher_head_on_the_cpu(head, tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    lr = ["--lr", "0.3"] if head in ("mach", "csoft") else []
    rc = train_launcher.main([
        "--device", "cpu", "--head", head, "--classes", "512",
        "--feat-dim", "32", "--steps", "4", "--batch", "32", "--fccs",
        "--metrics-out", str(metrics)] + lr)
    assert rc == 0
    assert "final eval accuracy" in capsys.readouterr().out
    rows = metrics.read_text().splitlines()
    assert len(rows) == 4
    for key in OWN_METRICS[head]:
        assert f'"{key}"' in rows[-1]
    if head == "sampled":           # max(64, classes // 4) of 512
        assert '"sample_frac": 0.25' in rows[-1]


@pytest.mark.parametrize("head", NEW_HEADS)
def test_serve_launcher_head_on_the_cpu(head, capsys):
    base = ["--system", "paper", "--device", "cpu", "--classes", "512",
            "--feat-dim", "32", "--batch", "8", "--head", head]
    assert serve_launcher.main(base) == 0
    out = capsys.readouterr().out
    assert f"{head}-head retrieval over 512 classes" in out
    preds = eval(out.split("first predictions:")[1].strip())
    assert len(preds) == 8 and all(0 <= p < 512 for p in preds)
    if head in ("mach", "csoft"):
        for extra in (["--topk", "5"], ["--topk", "5", "--index", "ivf"]):
            with pytest.raises(NotImplementedError,
                               match="full/knn/selective/sampled"):
                serve_launcher.main(base + extra)
    else:
        assert serve_launcher.main(base + ["--topk", "5"]) == 0
        assert f"{head}-head top-5 retrieval" in capsys.readouterr().out


def test_sketch_heads_refuse_class_matrix_retrieval():
    """``serve(top_k=...)`` and the IVF index need the [V, D] class
    matrix, which mach and csoft do not train: both refuse with the JAX
    package's reason; greedy serving and evaluate run."""
    for impl in ("mach", "csoft"):
        exp = Experiment.from_config(
            system="paper", classes=64, feat_dim=8, batch=8, device="cpu",
            head=HeadConfig(softmax_impl=impl, mach_b=16, csoft_b=16))
        assert exp.serve(batch=4).shape == (4,)
        assert 0.0 <= exp.evaluate() <= 1.0
        with pytest.raises(NotImplementedError,
                           match="full/knn/selective/sampled"):
            exp.serve(batch=4, top_k=3)
        with pytest.raises(NotImplementedError,
                           match="full/knn/selective/sampled"):
            exp.ivf_index()


def test_interop_takes_sketch_params_and_replicated_aux():
    """``paper_state_from_numpy`` cuts an [R, B, D] sketch and its moments
    along the bucket axis, keeps a replicated aux entry whole and a sharded
    one's row, and refuses what it cannot place."""
    from repro_torch import interop
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 8, 4)).astype(np.float32)
    mu = rng.standard_normal((3, 8, 4)).astype(np.float32)
    hashes = rng.integers(0, 8, (3, 20)).astype(np.int32)
    sharded = rng.integers(0, 9, (2, 5)).astype(np.int32)
    for rank in range(2):
        st = interop.paper_state_from_numpy(
            {}, w, opt_state={"step": 0, "mu": ({}, mu), "nu": None},
            head_aux=(hashes, sharded), aux_spec=("replicated", "sharded"),
            rank=rank, world_size=2, device="cpu")
        blk = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_array_equal(st.head_params.numpy(), w[:, blk])
        np.testing.assert_array_equal(st.opt_state.mu[1].numpy(), mu[:, blk])
        np.testing.assert_array_equal(st.head_aux[0].numpy(), hashes)
        np.testing.assert_array_equal(st.head_aux[1].numpy(), sharded[rank])
    with pytest.raises(ValueError, match="aux_spec"):
        interop.paper_state_from_numpy({}, w, head_aux=(hashes,),
                                       aux_spec=(), device="cpu")
    with pytest.raises(ValueError, match="not 'sharded' or 'replicated'"):
        interop.paper_state_from_numpy({}, w, head_aux=(hashes,),
                                       aux_spec=("whole",), device="cpu")
    with pytest.raises(ValueError, match=r"\[R, B, D\] sketch"):
        interop.paper_state_from_numpy({}, w[None], device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        interop.paper_state_from_numpy({}, w, rank=0, world_size=3,
                                       device="cpu")
