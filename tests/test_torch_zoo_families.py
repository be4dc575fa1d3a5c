"""The zoo's ssm (mamba2-370M) and hybrid (hymba-1.5B) families in the port
against the JAX package, on the CPU, at their ``reduced()`` configs in
fp32.

* configs: both, full and reduced, field for field;
* the backbone's hidden states and stacked caches (the ssm family's
  ``ssm_state`` / ``conv_state``; the hybrid's K/V beside them) within
  1e-5, on both backends; prefill -> decode through the caches (hymba's
  prompt longer than its window of 32, so its slots rotate) within 5e-4
  of the full forward (``tests/test_decode.py``'s bound) and 1e-5 of the
  JAX package's own decode; the fresh decode state's shapes and slots;
* ``ZooExperiment.serve``'s greedy tokens EXACTLY equal to the JAX
  ``ZooExperiment.serve`` at rings of 1 and 2, on both backends, from the
  JAX experiment's params and prompts;
* ``fit(3)`` from the JAX experiment's params on its batches, on both
  backends: the losses, accuracies, final params and bucket weights of
  every step within rtol 1e-4 / atol 1e-6 of the JAX zoo's (rebuilt on a
  (1, n) mesh: the port's ring has no data axis), evaluate equal; the
  full and knn heads at rings of 1 and 2 (hymba at 8 tokens a row, where
  the JAX gradient is finite); every member ends bit-equal;
* ``interop`` carries the params (``ssm.*``, ``fuse_attn``, ``fuse_ssm``
  stacked on [L]) and the SGD moments both ways;
* every head trains a step, evaluates, and (the W-heads) serves top-k on
  each family.

The JAX runs go to processes of their own, one for each fit reference and
one for each family's serve, which also runs the JAX backbone and decode
on the same params (seed 0) that the backbone, decode and interop tests
take (XLA's compiles are this file's time).
"""
import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import ZooExperiment as JaxZooExperiment
from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import decoder as jdec
from repro.models import lm as jlm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import dist, interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.models import decoder as tdec
from repro_torch.models import lm as tlm
from tests.test_torch_zoo_train import jax_zoo_on_ring
from tests.torch_threads import one_thread  # noqa: F401

ARCHS = ["mamba2_370m", "hymba_1_5b"]
BACKENDS = ("ref", "kernel")
TOL = 1e-5             # fp32: the same arithmetic, sums in another order
DECODE_TOL = 5e-4      # tests/test_decode.py's bound on decode vs forward
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
BATCH, STEPS, LR = 4, 3, 0.1
# tokens a row: mamba2 a chunk of 16 and a padded one; hymba 8, within one
# chunk: at 24 the JAX gradient of the stream's second batch is NaN (the
# trap of ``ssm.py:96-98``, tests/test_torch_ssm.py) and no oracle is left
SEQS = {"mamba2_370m": 24, "hymba_1_5b": 8}
SERVE = dict(batch=4, prompt_len=40, gen=6)   # 40 > hymba's window of 32
SERVE_RINGS = (1, 2)
HEADS = {
    "full": dict(softmax_impl="full"),
    # no fillers: the JAX package draws them from jax.random (ROADMAP C.3)
    "knn": dict(softmax_impl="knn", knn_k=4, knn_kprime=8, rebuild_every=2,
                knn_pad_random=False),
}
# (ring, head): the full and knn heads at rings of 1 and 2; the full head
# scores every class, so its JAX run at n_model 1 is the reference at
# every ring (knn picks its classes per shard)
CASES = [(1, "full"), (1, "knn"), (2, "full"), (2, "knn")]
RING_FREE = ("full",)


def _np(t):
    return t.detach().cpu().numpy()


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _cfgs(arch):
    return (dataclasses.replace(jbase.get_model_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tbase.get_model_config(arch, reduced=True),
                                dtype="float32"))


def _model(runs, arch):
    """(jax cfg, port cfg, the JAX serve experiment's params as a host
    tree, the same params in the port) at fp32."""
    jcfg, tcfg = _cfgs(arch)
    tree = runs[1][arch][0]
    return jcfg, tcfg, tree, interop.zoo_params_from_numpy(tree, tcfg,
                                                           device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs, backbones, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_package(arch, reduced):
    assert (dataclasses.asdict(tbase.get_model_config(arch, reduced))
            == dataclasses.asdict(jbase.get_model_config(arch, reduced)))


def _jax_backbone(arch, params):
    """The JAX backbone's hidden states and caches of 37 tokens, with the
    decode window of 40 (hymba: 32 slots, rotated), in fp32."""
    jcfg = _cfgs(arch)[0]
    window = jlm.decode_window(jcfg, 40)
    hj, _, cj = jax.jit(lambda p, t: jlm.backbone(
        p, jcfg, {"tokens": t}, want_cache=True, cache_window=window))(
        params, jnp.asarray(_tokens(2, 37)))
    return window, np.asarray(hj), _host(cj)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_and_caches_match(runs, arch, backend):
    _, tcfg, _, tparams = _model(runs, arch)
    window, hj, cj = runs[1][arch][3]
    assert tlm.decode_window(tcfg, 40) == window
    with torch.no_grad():
        ht, aux, ct = tlm.backbone(tparams, tcfg,
                                   {"tokens": torch.tensor(_tokens(2, 37))},
                                   want_cache=True, cache_window=window,
                                   backend=backend)
    np.testing.assert_allclose(_np(ht), hj, atol=TOL, rtol=0)
    assert float(aux) == 0.0
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        np.testing.assert_allclose(_np(ct[k]), cj[k], atol=TOL, rtol=0,
                                   err_msg=k)
    assert ct["ssm_state"].dtype == torch.float32


N_PRE, N_STEPS = 36, 4      # 36 prefill tokens: past hymba's window of 32


def _jax_decode(arch, params):
    """The JAX package's full forward of N_PRE + N_STEPS tokens, and its
    prefill of N_PRE then N_STEPS decode steps, in fp32: (tokens, window,
    full hidden, decode hiddens, final caches, final slots)."""
    jcfg = _cfgs(arch)[0]
    s = N_PRE + N_STEPS
    toks = _tokens(2, s, seed=5)
    window = jlm.decode_window(jcfg, s)

    @jax.jit
    def prefill(p, t):
        return (jlm.backbone(p, jcfg, {"tokens": t})[0],
                jlm.backbone(p, jcfg, {"tokens": t[:, :N_PRE]},
                             want_cache=True, cache_window=window)[2])
    step = jax.jit(lambda p, t, c, sl: jlm.decode(
        p, jcfg, {"token": t}, c, sl, window=window))
    h_full, caches = prefill(params, jnp.asarray(toks))
    slots = jdec.init_cache_slots(jcfg, window,
                                  prefill_positions=jnp.arange(N_PRE))
    first_slots = np.asarray(slots["pos_slots"])
    jh = []
    for i in range(N_STEPS):
        tok = toks[:, N_PRE + i:N_PRE + i + 1]
        h, caches, slots = step(params, jnp.asarray(tok), caches, slots)
        jh.append(np.asarray(h[:, 0]))
    return (toks, window, np.asarray(h_full), jh, _host(caches),
            first_slots, int(slots["pos"]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(runs, arch, backend):
    """36 tokens of prefill (past hymba's window of 32: its K/V slots
    rotate), then 4 decode steps through the in-place caches: each within
    DECODE_TOL of the full forward and TOL of the JAX decode, the caches
    at the end within TOL."""
    _, tcfg, _, tparams = _model(runs, arch)
    toks, window, h_full, jh, caches, slots0, pos = runs[1][arch][4]
    with torch.no_grad():
        _, _, tcaches = tlm.backbone(tparams, tcfg, {"tokens": torch.tensor(
            toks[:, :N_PRE])}, want_cache=True, cache_window=window,
            backend=backend)
        tslots = tdec.init_cache_slots(tcfg, window,
                                       prefill_positions=torch.arange(N_PRE))
        np.testing.assert_array_equal(_np(tslots["pos_slots"]), slots0)
        for i in range(N_STEPS):
            tok = torch.tensor(toks[:, N_PRE + i:N_PRE + i + 1])
            t, tcaches, tslots = tlm.decode(tparams, tcfg, {"token": tok},
                                            tcaches, tslots, window=window,
                                            backend=backend)
            th = _np(t[:, 0])
            assert np.max(np.abs(th - h_full[:, N_PRE + i])) < DECODE_TOL
            np.testing.assert_allclose(th, jh[i], atol=TOL, rtol=0)
    assert int(tslots["pos"]) == pos
    for k in caches:
        np.testing.assert_allclose(_np(tcaches[k]), caches[k], atol=TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    caches, slots, window = jlm.init_decode_state(jcfg, 3, 40)
    tcaches, tslots, twindow = tlm.init_decode_state(tcfg, 3, 40,
                                                     device="cpu")
    assert twindow == window == (1 if arch == "mamba2_370m" else 32)
    assert sorted(tcaches) == sorted(caches)
    for k in caches:
        assert tuple(tcaches[k].shape) == caches[k].shape, k
        assert not tcaches[k].any()
    assert tcaches["ssm_state"].dtype == torch.float32
    np.testing.assert_array_equal(_np(tslots["pos_slots"]),
                                  np.asarray(slots["pos_slots"]))


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_params_and_moments_both_ways(runs, arch):
    """The JAX params (blocks stacked on [L]: ``ssm.*``, and hymba's
    ``fuse_attn`` / ``fuse_ssm``) and SGD moments over (params, head
    params) become the port's per-layer trees and back, bit for bit."""
    _, tcfg, tree, tparams = _model(runs, arch)
    blocks = tree["blocks"]
    assert "ssm" in blocks and blocks["ssm"]["A_log"].shape[0] == 2
    if arch == "hymba_1_5b":
        assert blocks["fuse_attn"].shape == (2, 128)
    back = interop.zoo_params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert "fuse_ssm" in tparams.blocks[1] or arch == "mamba2_370m"
    opt = jax_make_optimizer(jbase.TrainConfig(optimizer="sgd")).init(
        (tree, ()))
    opt = opt._replace(step=opt.step + 3, mu=jax.tree.map(
        lambda a: a * 0.5 + 1.0, opt.mu))
    host = {"step": int(opt.step), "mu": _host(opt.mu), "nu": None}
    topt = interop.zoo_opt_state_from_numpy(host, tcfg, device="cpu")
    assert topt.step == 3 and topt.nu is None and topt.mu[1] == ()
    exp = Experiment.from_config(system="zoo", arch=arch, reduced=True,
                                 device="cpu", log_every=0)
    exp.load_params(tparams)
    exp.load_opt_state(topt)
    again = interop.zoo_opt_state_to_numpy(exp.opt_state)
    assert again["step"] == 3
    for a, b in zip(jax.tree.leaves(again["mu"]),
                    jax.tree.leaves(host["mu"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the JAX runs: serving and fit(3)
# ---------------------------------------------------------------------------


def _jax_zoo(arch, n, head):
    """The JAX ZooExperiment of ``arch`` with ``head`` on a (1, n) mesh."""
    return jax_zoo_on_ring(
        n, arch=arch, reduced=True, batch=BATCH, seq=SEQS[arch],
        head=jbase.HeadConfig(**HEADS[head]),
        train=jbase.TrainConfig(optimizer="sgd"))


def _batches(arch):
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    return [_host(fn(t, BATCH, SEQS[arch], 512)) for t in range(STEPS)]


def _jax_fit(task):
    """The JAX run (arch, n, head): its start params, history, final
    params and evaluation on the first batch."""
    arch, n, head = task
    exp = _jax_zoo(arch, n, head)
    batches = _batches(arch)
    exp._batch = lambda t: batches[t]
    start = {"params": _host(exp.params)}
    hist = exp.fit(STEPS, lr=LR)
    return task, {"start": start, "history": [dict(r) for r in hist],
                  "params": _host(exp.params),
                  "eval": exp.evaluate(batches[0]),
                  "head_params": (None if exp.head.params_are_class_weights
                                  else _host(exp.head_state.params))}


def _jax_serve(arch):
    """The JAX ZooExperiment.serve of ``arch`` on its default mesh at
    n_model 1: its params, prompts and tokens (greedy tokens are the
    argmax over every class, the same at every ring); and on its params in
    fp32, the backbone with its caches (``_jax_backbone``) and the decode
    (``_jax_decode``)."""
    exp = JaxZooExperiment(arch=arch, reduced=True, n_model=1,
                           batch=SERVE["batch"], log_every=0)
    toks = exp.serve(**SERVE)
    prompts = np.asarray(jax_lm_batch(0, SERVE["batch"],
                                      SERVE["prompt_len"], 512)["tokens"])
    return arch, (_host(exp.params), prompts, np.asarray(toks),
                  _jax_backbone(arch, exp.params),
                  _jax_decode(arch, exp.params))


def _ref_task(arch, case):
    n, head = case
    return (arch, 1 if head in RING_FREE else n, head)


def _start(arch):
    """The JAX experiments' params (seed 0, vocab 512 at every ring: the
    same for every head and ring) and the serve's prompts, made here so
    the port's rings need not wait for the JAX runs; the tests hold the
    runs' own starts to them."""
    jcfg = _cfgs(arch)[0]
    # op by op, as the experiment makes them (jit moves A_log by an ulp)
    params = _host(jlm.init_model(jax.random.PRNGKey(0), jcfg))
    prompts = np.asarray(jax_lm_batch(0, SERVE["batch"],
                                      SERVE["prompt_len"], 512)["tokens"])
    return params, prompts


def _port_ring(n, starts):
    """Every port case of the ring of n: each family's fit on both
    backends from the JAX runs' start, and its serve of the JAX prompts.
    {key: members}."""
    cases, keys = [], []
    for arch in ARCHS:
        batches = _batches(arch)
        params, prompts = starts[arch]
        for ring, head in CASES:
            if ring != n:
                continue
            for backend in BACKENDS:
                kw = dict(arch=arch, batch=BATCH, seq=SEQS[arch],
                          steps=STEPS, lr=LR,
                          batches=batches, eval_inputs=batches[0])
                cases.append(("zoo_fit", (params,
                                          dict(HEADS[head], backend=backend),
                                          {"optimizer": "sgd"}), kw))
                keys.append(("fit", arch, ring, head, backend))
        if n in SERVE_RINGS:
            for backend in BACKENDS:
                cases.append(("zoo_serve", (params,),
                              dict(arch=arch, prompts=prompts,
                                   gen=SERVE["gen"], backend=backend)))
                keys.append(("serve", arch, n, backend))
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    return {key: [r[i] for r in per_rank] for i, key in enumerate(keys)}


def _runs():
    """The JAX runs in eight processes of their own, compiling on one
    thread each without LLVM's costly passes, and meanwhile the port's
    rings, each in its own processes."""
    # the slowest first: hymba's steps compile the longest
    fit_tasks = sorted({_ref_task(a, c) for a in ARCHS for c in CASES},
                       key=lambda t: (t[0] != "hymba_1_5b", -t[1], t))
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    procs = concurrent.futures.ProcessPoolExecutor(
        len(fit_tasks) + len(ARCHS), mp_context=ctx)
    try:
        fits = procs.map(_jax_fit, fit_tasks)
        serves = procs.map(_jax_serve, ARCHS)
    finally:
        os.environ["XLA_FLAGS"] = flags
    # while the JAX processes start
    starts = {arch: _start(arch) for arch in ARCHS}
    rings = sorted({c[0] for c in CASES})
    with concurrent.futures.ThreadPoolExecutor(len(rings)) as pool:
        port = [pool.submit(_port_ring, n, starts) for n in rings]
        port = {k: v for f in port for k, v in f.result().items()}
    refs, serves = dict(fits), dict(serves)
    procs.shutdown(wait=False)
    return refs, serves, port, starts


@pytest.fixture(scope="module", autouse=True)
def started():
    """``_runs`` in a thread from the module's start, so the JAX
    processes work while the tests that need them not run."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_runs)
    yield fut
    pool.shutdown()


@pytest.fixture(scope="module")
def runs(started):
    return started.result()


@pytest.mark.parametrize("n", SERVE_RINGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_the_jax_package(runs, arch, n):
    """The JAX experiment's params and prompts: the greedy tokens on both
    backends, on every member, exactly the JAX ZooExperiment.serve's."""
    tree, prompts, want = runs[1][arch][:3]
    assert want.shape == (SERVE["batch"], SERVE["gen"])
    # the port served the params and prompts made beside the JAX run
    params, port_prompts = runs[3][arch]
    np.testing.assert_array_equal(port_prompts, prompts)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    for backend in BACKENDS:
        for got in runs[2][("serve", arch, n, backend)]:
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"ring{c[0]}-{c[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_fit_matches_the_jax_zoo(runs, arch, case, backend):
    """fit(3) from the JAX run's start: every step's loss and accuracy,
    the final params and bucket weights within TRAJ_TOL, evaluate equal;
    every member ends with bit-equal params and history."""
    ref = runs[0][_ref_task(arch, case)]
    members = runs[2][("fit", arch) + case + (backend,)]
    # the port started from the JAX run's own params
    for a, b in zip(jax.tree.leaves(runs[3][arch][0]),
                    jax.tree.leaves(ref["start"]["params"])):
        np.testing.assert_array_equal(a, b)
    port = members[0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    assert np.isfinite([r["loss"] for r in port["history"]]).all()
    got, want = jax.tree.leaves(port["params"]), jax.tree.leaves(
        ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    if ref["head_params"] is not None:
        np.testing.assert_allclose(port["head_params"], ref["head_params"],
                                   **TRAJ_TOL)
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    for other in members[1:]:
        assert other["history"] == port["history"]
        for a, b in zip(jax.tree.leaves(other["params"]), got):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the experiment surface on the new families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_head_trains_evaluates_and_serves(arch):
    """Each of the six heads: one step on finite losses, evaluate in [0,
    1]; the W-heads retrieve top-k (exact and IVF) and serve tokens."""
    for head in ("full", "knn", "selective", "mach", "sampled", "csoft"):
        exp = Experiment.from_config(
            system="zoo", arch=arch, reduced=True, batch=2, seq=8,
            device="cpu", log_every=0,
            head=tbase.HeadConfig(softmax_impl=head, knn_k=4, knn_kprime=8,
                                  mach_b=32, mach_r=2, csoft_b=32,
                                  csoft_r=2, sampled_n=64))
        hist = exp.fit(1, lr=0.5)
        assert np.isfinite(hist[0]["loss"]), head
        assert 0.0 <= exp.evaluate() <= 1.0
        if exp.head.params_are_class_weights:
            ids = exp.serve(top_k=5, batch=3)
            assert ids.shape == (3, 5) and ((0 <= ids) & (ids < 512)).all()
            assert exp.serve(top_k=5, batch=3, index="ivf").shape == (3, 5)
            toks = exp.serve(prompt_len=5, gen=3, batch=2)
            assert toks.shape == (2, 3)
