"""The zoo's encoder-decoder family (whisper-tiny) in the port against the
JAX package, on the CPU, at its ``reduced()`` config in fp32, on frames
made with numpy and given to both packages (the JAX experiment draws its
own from ``jax.random``, which torch cannot reproduce).

* configs: full and reduced, field for field;
* ``layers.sinusoid_positions`` within 1e-5 (at whisper-tiny's 1,500
  frames within one fp32 step of a frequency times the position) and the
  cross-attention source ``kv={"x": enc_out}`` of ``apply_attention``
  (with and without qk-norm) within 1e-5;
* the backbone's hidden states and caches (the decoder's K/V and the
  cross K/V) within 1e-5 on both backends (the kernel backend's encoder
  self-attention non-causal through the flash kernel's plain version);
  ``build_cross_cache``; a prefill of 12 tokens, then 4 ``lm.decode``
  steps through the cross caches within 5e-4 of the full forward and
  1e-5 of the JAX decode; the fresh decode state;
* ``fit(3)`` with the numpy frames injected through ``data_fn``, on both
  backends: losses, accuracies, final params within rtol 1e-4 / atol 1e-6
  of the JAX zoo's (rebuilt on a (1, n) mesh), the full and knn heads at
  rings of 1 and 2; every member ends bit-equal;
* ``interop`` carries the params (``encdec.enc_blocks`` and
  ``dec_blocks``, each stacked on its own [L]) and the SGD moments both
  ways; a JAX zoo checkpoint restores in the port bit for bit and the
  port's restores in the JAX package bit for bit, the payloads
  byte-equal;
* every head trains a step, evaluates and (the W-heads) retrieves top-k;
  ``serve(prompt_len=...)`` raises, as the JAX package's does.

The JAX runs go to three processes of their own (one does the checkpoint,
the full-head fit and the decode references), compiling on one thread
each without LLVM's costly passes, while the port's rings run.
"""
import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import decoder as jdec
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch import dist, interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.models import decoder as tdec
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from tests.test_torch_zoo_checkpoint import _payload
from tests.test_torch_zoo_moe import jax_ckpt_restore, jax_ckpt_save
from tests.test_torch_zoo_train import jax_zoo_on_ring
from tests.torch_threads import one_thread  # noqa: F401

ARCH = "whisper_tiny"
BACKENDS = ("ref", "kernel")
TOL = 1e-5
DECODE_TOL = 5e-4      # tests/test_decode.py's bound on decode vs forward
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
BATCH, SEQ, STEPS, LR = 4, 8, 3, 0.1
HEADS = {
    "full": dict(softmax_impl="full"),
    # no fillers: the JAX package draws them from jax.random
    "knn": dict(softmax_impl="knn", knn_k=4, knn_kprime=8, rebuild_every=2,
                knn_pad_random=False),
}
CASES = [(1, "full"), (1, "knn"), (2, "full"), (2, "knn")]
RING_FREE = ("full",)
CKPT_RING, CKPT_STEPS = 2, 2
N_PRE, N_STEPS = 12, 4


def _np(t):
    return t.detach().cpu().numpy()


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _cfgs():
    return (dataclasses.replace(jbase.get_model_config(ARCH, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tbase.get_model_config(ARCH, reduced=True),
                                dtype="float32"))


def _frames(b, seed):
    jcfg = _cfgs()[0]
    return np.random.default_rng(seed).standard_normal(
        (b, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)


def _batches():
    """The JAX package's lm_batch tokens with numpy frames."""
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    return [dict(_host(fn(t, BATCH, SEQ, 512)), frames=_frames(BATCH, 100 + t))
            for t in range(STEPS)]


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_jax_package(reduced):
    assert (dataclasses.asdict(tbase.get_model_config(ARCH, reduced))
            == dataclasses.asdict(jbase.get_model_config(ARCH, reduced)))


@pytest.mark.parametrize("length,dim", [(64, 128), (1500, 384), (7, 9)])
def test_sinusoid_positions_match(length, dim):
    """Within TOL, or at long lengths one fp32 step of a frequency (XLA's
    exp and torch's may round it apart) times the largest position."""
    want = np.asarray(jlayers.sinusoid_positions(length, dim))
    got = _np(tlayers.sinusoid_positions(length, dim))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=max(TOL, length * 2.0 ** -23),
                               rtol=0)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches(qk_norm):
    """``apply_attention(kv={"x": enc_out})``: K and V projected from the
    encoder's output, qk-norm on k when asked, no rope (the config's
    theta set to show it is not applied), on both backends."""
    jcfg, tcfg = (dataclasses.replace(c, qk_norm=qk_norm, rope_theta=1e4)
                  for c in _cfgs())
    p = _host(jlayers.init_attention(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    enc = rng.standard_normal((2, 64, 128)).astype(np.float32)
    pos, epos = np.arange(3, 8), np.arange(64)
    want, none = jlayers.apply_attention(
        jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
        positions=jnp.asarray(pos), kv={"x": jnp.asarray(enc)},
        kv_positions=jnp.asarray(epos), causal=False)
    assert none is None
    tp = tlayers.ParamDict(**jax.tree.map(torch.tensor, p))
    for backend in BACKENDS:
        got, kv = tlayers.apply_attention(
            tp, tcfg, torch.tensor(x), positions=torch.tensor(pos),
            kv={"x": torch.tensor(enc)}, kv_positions=torch.tensor(epos),
            causal=False, backend=backend)
        assert kv is None
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# backbone, caches, decode
# ---------------------------------------------------------------------------


def _jax_refs(params):
    """On the JAX params, fp32: the full forward of N_PRE + N_STEPS tokens,
    the prefill of N_PRE (its caches), the cross caches from
    ``build_cross_cache``, then N_STEPS decode steps with the self K/V
    padded to the window (``tests/test_decode.py``'s recipe)."""
    jcfg = _cfgs()[0]
    s = N_PRE + N_STEPS
    toks = np.random.default_rng(5).integers(0, 512, (2, s)).astype(np.int32)
    frames = _frames(2, 6)
    window = jlm.decode_window(jcfg, s)

    @jax.jit
    def prefill(p, t, fr):
        h = jlm.backbone(p, jcfg, {"tokens": t, "frames": fr})[0]
        _, _, c = jlm.backbone(p, jcfg, {"tokens": t[:, :N_PRE],
                                         "frames": fr}, want_cache=True)
        enc = jencdec.encode(p["encdec"], jcfg, fr)
        return h, c, jencdec.build_cross_cache(p["encdec"], jcfg, enc)
    step = jax.jit(lambda p, t, c, sl: jlm.decode(
        p, jcfg, {"token": t}, c, sl, window=window))
    h_full, caches, cross = prefill(params, jnp.asarray(toks),
                                    jnp.asarray(frames))
    out = {"tokens": toks, "frames": frames, "window": window,
           "h_full": np.asarray(h_full), "prefill_caches": _host(caches),
           "cross": _host(cross), "steps": []}
    pad = ((0, 0), (0, 0), (0, window - N_PRE), (0, 0), (0, 0))
    caches = dict(caches, k=jnp.pad(caches["k"], pad),
                  v=jnp.pad(caches["v"], pad))
    slots = jdec.init_cache_slots(jcfg, window,
                                  prefill_positions=jnp.arange(N_PRE))
    for i in range(N_STEPS):
        tok = toks[:, N_PRE + i:N_PRE + i + 1]
        h, caches, slots = step(params, jnp.asarray(tok), caches, slots)
        out["steps"].append(np.asarray(h[:, 0]))
    out["caches"] = _host(caches)
    return out


def _model(runs):
    jcfg, tcfg = _cfgs()
    tree = runs["starts"]
    return jcfg, tcfg, tree, interop.zoo_params_from_numpy(tree, tcfg,
                                                           device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_backbone_and_caches_match(runs, backend):
    _, tcfg, _, tparams = _model(runs)
    ref = runs["refs"]
    toks, fr = torch.tensor(ref["tokens"]), torch.tensor(ref["frames"])
    with torch.no_grad():
        ht, aux, _ = tlm.backbone(tparams, tcfg, {"tokens": toks,
                                                  "frames": fr},
                                  backend=backend)
        _, _, ct = tlm.backbone(tparams, tcfg, {"tokens": toks[:, :N_PRE],
                                                "frames": fr},
                                want_cache=True, backend=backend)
        enc = tencdec.encode(tparams.encdec, tcfg, fr, backend=backend)
        ck, cv = tencdec.build_cross_cache(tparams.encdec, tcfg, enc)
    np.testing.assert_allclose(_np(ht), ref["h_full"], atol=TOL, rtol=0)
    assert float(aux) == 0.0
    cj = ref["prefill_caches"]
    assert sorted(ct) == sorted(cj) == ["cross_k", "cross_v", "k", "v"]
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        np.testing.assert_allclose(_np(ct[k]), cj[k], atol=TOL, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(_np(ck), ref["cross"][0], atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(cv), ref["cross"][1], atol=TOL, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_step_continues_the_prefill(runs, backend):
    """The prefill's self K/V padded to the window and the cross caches
    from ``build_cross_cache``, then 4 ``lm.decode`` steps: each within
    DECODE_TOL of the full forward and TOL of the JAX decode, the caches
    at the end within TOL."""
    _, tcfg, _, tparams = _model(runs)
    ref = runs["refs"]
    toks, window = ref["tokens"], ref["window"]
    fr = torch.tensor(ref["frames"])
    with torch.no_grad():
        _, _, c = tlm.backbone(tparams, tcfg, {"tokens": torch.tensor(
            toks[:, :N_PRE]), "frames": fr}, want_cache=True,
            backend=backend)
        caches, _, w = tlm.init_decode_state(tcfg, 2, window, device="cpu")
        assert w == window
        caches["k"][:, :, :N_PRE] = c["k"]
        caches["v"][:, :, :N_PRE] = c["v"]
        enc = tencdec.encode(tparams.encdec, tcfg, fr, backend=backend)
        caches["cross_k"], caches["cross_v"] = tencdec.build_cross_cache(
            tparams.encdec, tcfg, enc)
        slots = tdec.init_cache_slots(tcfg, window,
                                      prefill_positions=torch.arange(N_PRE))
        for i in range(N_STEPS):
            tok = torch.tensor(toks[:, N_PRE + i:N_PRE + i + 1])
            h, caches, slots = tlm.decode(tparams, tcfg, {"token": tok},
                                          caches, slots, window=window,
                                          backend=backend)
            th = _np(h[:, 0])
            assert np.max(np.abs(th - ref["h_full"][:, N_PRE + i])) \
                < DECODE_TOL
            np.testing.assert_allclose(th, ref["steps"][i], atol=TOL, rtol=0)
    assert int(slots["pos"]) == N_PRE + N_STEPS
    for k, want in ref["caches"].items():
        np.testing.assert_allclose(_np(caches[k]), want, atol=TOL, rtol=0,
                                   err_msg=k)


def test_init_decode_state_matches():
    jcfg, tcfg = _cfgs()
    caches, slots, window = jlm.init_decode_state(jcfg, 3, 40)
    tc, ts, tw = tlm.init_decode_state(tcfg, 3, 40, device="cpu")
    assert tw == window == 40
    assert sorted(tc) == sorted(caches)
    for k in caches:
        assert tuple(tc[k].shape) == caches[k].shape and not tc[k].any()
    np.testing.assert_array_equal(_np(ts["pos_slots"]),
                                  np.asarray(slots["pos_slots"]))


def test_interop_carries_params_and_moments_both_ways(runs):
    """The JAX params (``encdec.enc_blocks`` / ``dec_blocks`` stacked on
    their own [L], ``dec_pos``, the tied table) and the SGD moments become
    the port's per-layer trees and back, bit for bit."""
    jcfg, tcfg, tree, tparams = _model(runs)
    assert sorted(tree) == ["embed", "encdec"]
    assert tree["encdec"]["enc_blocks"]["attn"]["wq"].shape[0] == \
        jcfg.n_enc_layers
    assert len(tparams.encdec.dec_blocks) == jcfg.n_layers
    back = interop.zoo_params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    opt = jax_make_optimizer(jbase.TrainConfig(optimizer="sgd")).init(
        (tree, ()))
    opt = opt._replace(step=opt.step + 3, mu=jax.tree.map(
        lambda a: a * 0.5 + 1.0, opt.mu))
    host = {"step": int(opt.step), "mu": _host(opt.mu), "nu": None}
    topt = interop.zoo_opt_state_from_numpy(host, tcfg, device="cpu")
    exp = Experiment.from_config(system="zoo", arch=ARCH, reduced=True,
                                 device="cpu", log_every=0)
    exp.load_params(tparams)
    exp.load_opt_state(topt)
    again = interop.zoo_opt_state_to_numpy(exp.opt_state)
    assert again["step"] == 3
    for a, b in zip(jax.tree.leaves(again["mu"]),
                    jax.tree.leaves(host["mu"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the JAX runs
# ---------------------------------------------------------------------------


def _jax_fit(task):
    """The JAX run (n, head) on the injected batches: its start params,
    history, final params and evaluation; the full head's process also
    makes the decode references on its start params."""
    n, head = task
    exp = jax_zoo_on_ring(
        n, arch=ARCH, reduced=True, batch=BATCH, seq=SEQ,
        head=jbase.HeadConfig(**HEADS[head]),
        train=jbase.TrainConfig(optimizer="sgd"))
    batches = _batches()
    exp._batch = lambda t: batches[t]
    out = {"start": _host(exp.params)}
    if task == (1, "full"):
        out["refs"] = _jax_refs(exp.params)
    hist = exp.fit(STEPS, lr=LR)
    out.update(history=[dict(r) for r in hist], params=_host(exp.params),
               eval=exp.evaluate(batches[0]))
    return out


def _ck_spec():
    return {"arch": ARCH, "head": dict(softmax_impl="full", backend="ref"),
            "batch": BATCH, "seq": SEQ, "ckpt_every": CKPT_STEPS}


def _ref_task(case):
    n, head = case
    return (1 if head in RING_FREE else n, head)


def _port_ring(n, start, saved, root):
    batches = _batches()
    cases, keys = [], []
    for ring, head in CASES:
        if ring != n:
            continue
        for backend in BACKENDS:
            cases.append(("zoo_fit", (start,
                                      dict(HEADS[head], backend=backend),
                                      {"optimizer": "sgd"}),
                          dict(arch=ARCH, batch=BATCH, seq=SEQ, steps=STEPS,
                               lr=LR, batches=batches,
                               eval_inputs=batches[0])))
            keys.append(("fit", ring, head, backend))
    if n == CKPT_RING:
        cases.append(("zoo_ckpt_from_jax", (_ck_spec(), saved[0],
                                            os.path.join(root, "port"),
                                            saved[1]), {}))
        keys.append(("ckpt",))
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    return {key: [r[i] for r in per_rank] for i, key in enumerate(keys)}


def _runs(root):
    tasks = sorted({_ref_task(c) for c in CASES}, key=lambda t: (-t[0], t))
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    pools = {t: concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
             for t in tasks}
    own = pools[(1, "full")]
    try:
        saving = own.submit(jax_ckpt_save, _ck_spec(), CKPT_RING,
                            os.path.join(root, "jax"), ARCH)
        fits = {t: pools[t].submit(_jax_fit, t) for t in tasks}
    finally:
        os.environ["XLA_FLAGS"] = flags
    jcfg = _cfgs()[0]
    start = _host(jlm.init_model(jax.random.PRNGKey(0), jcfg))
    saved = saving.result()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = [pool.submit(_port_ring, n, start, saved, root)
                for n in (1, 2)]
        port = {k: v for f in port for k, v in f.result().items()}
    back = own.submit(jax_ckpt_restore, ARCH, os.path.join(root, "port"),
                      saved[1])
    fits = {t: f.result() for t, f in fits.items()}
    out = {"fits": fits, "port": port, "starts": start, "saved": saved,
           "refs": fits[(1, "full")]["refs"], "back": back.result(),
           "root": root}
    for p in pools.values():
        p.shutdown(wait=False)
    return out


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoo_encdec"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_runs, root)
    yield fut
    pool.shutdown()


@pytest.fixture(scope="module")
def runs(started):
    return started.result()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"ring{c[0]}-{c[1]}")
def test_fit_matches_the_jax_zoo(runs, case, backend):
    """fit(3) on the injected frames from the JAX run's start: every
    step's loss and accuracy and the final params within TRAJ_TOL,
    evaluate equal; every member ends with bit-equal params and
    history."""
    ref = runs["fits"][_ref_task(case)]
    for a, b in zip(jax.tree.leaves(runs["starts"]),
                    jax.tree.leaves(ref["start"])):
        np.testing.assert_array_equal(a, b)
    members = runs["port"][("fit",) + case + (backend,)]
    port = members[0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    got, want = jax.tree.leaves(port["params"]), jax.tree.leaves(
        ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    for other in members[1:]:
        assert other["history"] == port["history"]
        for a, b in zip(jax.tree.leaves(other["params"]), got):
            np.testing.assert_array_equal(a, b)


def test_zoo_checkpoint_crosses_both_ways(runs):
    for member in runs["port"][("ckpt",)]:
        assert member["step"] == CKPT_STEPS and member["t"] == CKPT_STEPS
        assert member["cmp"]["bitwise"], member["cmp"]["mismatches"]
    step, cmp = runs["back"]
    assert step == CKPT_STEPS and cmp["bitwise"], cmp["mismatches"]
    assert _payload(os.path.join(runs["root"], "port"),
                    CKPT_STEPS) == _payload(runs["saved"][0], CKPT_STEPS)


# ---------------------------------------------------------------------------
# the experiment surface
# ---------------------------------------------------------------------------


def test_every_head_trains_evaluates_and_retrieves():
    """Each of the six heads: one step on a finite loss over the port's
    own frames, evaluate in [0, 1]; the W-heads retrieve top-k exactly
    and through the IVF index; token serving refuses."""
    for head in ("full", "knn", "selective", "mach", "sampled", "csoft"):
        exp = Experiment.from_config(
            system="zoo", arch=ARCH, reduced=True, batch=2, seq=8,
            device="cpu", log_every=0,
            head=tbase.HeadConfig(softmax_impl=head, knn_k=4, knn_kprime=8,
                                  mach_b=32, mach_r=2, csoft_b=32,
                                  csoft_r=2, sampled_n=64))
        batch = exp._batch(0)
        assert tuple(batch["frames"].shape) == (2, 64, 128)
        hist = exp.fit(1, lr=0.5)
        assert np.isfinite(hist[0]["loss"]), head
        assert 0.0 <= exp.evaluate() <= 1.0
        if exp.head.params_are_class_weights:
            ids = exp.serve(top_k=5, batch=3)
            assert ids.shape == (3, 5) and ((0 <= ids) & (ids < 512)).all()
            assert exp.serve(top_k=5, batch=3, index="ivf").shape == (3, 5)
        with pytest.raises(NotImplementedError, match="decoder-only"):
            exp.serve(prompt_len=5, gen=3, batch=2)
