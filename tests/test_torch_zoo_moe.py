"""The zoo's moe family (qwen3-moe-30B-A3B, kimi-K2 with its shared
experts) and the vlm config (chameleon-34B) in the port against the JAX
package, on the CPU, at their ``reduced()`` configs in fp32.

* configs: all three, full and reduced, field for field;
* ``models.moe.apply_moe`` against the JAX ``apply_moe`` and
  ``moe_ref_dense``: outputs, the router loss and the input's gradient
  within 1e-5, each param's gradient within 1e-5 of its max (at least
  1), with a capacity factor small enough that tokens are dropped (the
  same pairs dropped as the JAX dispatch keeps), the decode group (s = 1,
  b > 1: one group) and kimi's shared experts; two runs bit-equal; with
  no drops, the dense oracle; qwen3-moe's router at its full width, with
  and without drops;
* the backbone's hidden states, router loss and caches within 1e-5 on
  both backends; prefill -> decode within 5e-4 of the full forward and
  1e-5 of the JAX decode; the fresh decode state;
* ``ZooExperiment.serve``'s greedy tokens EXACTLY the JAX zoo's for
  qwen3-moe and chameleon at rings of 1 and 2, on both backends;
* ``fit(3)`` from the JAX run's params on its batches, on both backends:
  losses, accuracies and final params within rtol 1e-4 / atol 1e-6 of the
  JAX zoo's (rebuilt on a (1, n) mesh) at rings of 1 and 2, qwen3-moe
  with the full and knn heads, kimi-K2 and chameleon the full; every
  member ends bit-equal; one batch's gradient (the
  router loss entering once) the JAX zoo's at rings of 1 and 2;
* ``interop`` carries the params (the experts stacked [L, E, D, F],
  kimi's ``shared``) and SGD moments both ways; a JAX zoo checkpoint of
  each arch restores in the port bit for bit, the port's save restores
  in the JAX package bit for bit, and the payloads are byte-equal;
* every head trains a step, evaluates and (the W-heads) retrieves and
  serves on each arch.

The JAX runs go to five processes of their own (one an arch for its
checkpoint, full-head fit, serve, backbone and decode; one for each other
qwen3-moe fit), compiling on one thread each without LLVM's costly
passes, while the port's rings run.
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
from repro.api.heads import HeadState as JaxHeadState
from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import decoder as jdec
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import make_optimizer as jax_make_optimizer
from repro.resilience import tree_compare as jax_tree_compare
from repro.train import gspmd as jgspmd
from repro_torch import dist, interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.models import decoder as tdec
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ParamDict
from tests.test_torch_zoo_checkpoint import _payload
from tests.test_torch_zoo_train import jax_zoo_on_ring
from tests.torch_threads import one_thread  # noqa: F401

ARCHS = ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "chameleon_34b"]
SERVED = ("qwen3_moe_30b_a3b", "chameleon_34b")
BACKENDS = ("ref", "kernel")
TOL = 1e-5
DECODE_TOL = 5e-4      # tests/test_decode.py's bound on decode vs forward
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
BATCH, SEQ, STEPS, LR = 4, 8, 3, 0.1
SERVE = dict(batch=4, prompt_len=12, gen=6)
SERVE_RINGS = (1, 2)
HEADS = {
    "full": dict(softmax_impl="full"),
    # no fillers: the JAX package draws them from jax.random
    "knn": dict(softmax_impl="knn", knn_k=4, knn_kprime=8, rebuild_every=2,
                knn_pad_random=False),
}
# (ring, head) by arch; the full head scores every class, so its JAX run
# at n_model 1 is the reference at every ring (knn picks its classes per
# shard). kimi-K2 (the shared experts) and chameleon-34B (the dense stack
# with qk-norm) train the full head; qwen3-moe both heads
CASES = {"qwen3_moe_30b_a3b": [(1, "full"), (1, "knn"), (2, "full"),
                               (2, "knn")],
         "kimi_k2_1t_a32b": [(1, "full"), (2, "full")],
         "chameleon_34b": [(1, "full"), (2, "full")]}
RING_FREE = ("full",)
GRAD_ARCH, GRAD_RINGS = "qwen3_moe_30b_a3b", (1, 2)
# the zoo checkpoint crossings: each arch on one ring
CKPT_RING = {"qwen3_moe_30b_a3b": 2, "kimi_k2_1t_a32b": 1,
             "chameleon_34b": 2}
CKPT_STEPS = 2


def _np(t):
    return t.detach().cpu().numpy()


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _cfgs(arch):
    return (dataclasses.replace(jbase.get_model_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tbase.get_model_config(arch, reduced=True),
                                dtype="float32"))


def _plain(tree, fn):
    """A ``ParamDict`` tree as plain dicts of ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: _plain(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configs and the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_package(arch, reduced):
    assert (dataclasses.asdict(tbase.get_model_config(arch, reduced))
            == dataclasses.asdict(jbase.get_model_config(arch, reduced)))


# (arch, [b, s], capacity factor): 0.5 at 64 tokens a row gives a cap of
# 24 for 32 pairs an expert on average, so the dispatch drops; 24 decode
# tokens (s = 1) are ONE group of cap 8 for 12 pairs an expert on average;
# kimi's shared experts at the reduced config's factor of 8, which drops
# nothing
MOE_CASES = {
    "drops": ("qwen3_moe_30b_a3b", (2, 64), 0.5),
    "decode-group": ("qwen3_moe_30b_a3b", (24, 1), 0.5),
    "kimi-shared": ("kimi_k2_1t_a32b", (2, 16), None),
}


def _moe_params(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = _host(jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, jp


def _jax_kept(jp, jcfg, x, cf):
    """The (token, expert) pairs the JAX dispatch keeps, as a count."""
    m = jcfg.moe
    b, s, d = x.shape
    if s == 1 and b > 1:
        x = x.reshape(1, b, d)
        b, s = 1, b
    cap = jmoe.capacity_for(s, jcfg, cf)

    @jax.jit
    def kept(x, router):
        _, top_i = jax.lax.top_k(jax.nn.softmax(x @ router, axis=-1),
                                 m.top_k)
        return jax.vmap(lambda xg, ti: jmoe._dispatch_group(
            xg, ti, None, cap, m.n_experts, m.top_k)[1][2])(x, top_i).sum()
    return int(kept(x, jp["router"])), b * s * m.top_k


def _port_kept(tp, tcfg, x, cf):
    """The (token, expert) pairs the port's dispatch keeps, as a count,
    and the pairs routed."""
    m = tcfg.moe
    b, s, d = x.shape
    if s == 1 and b > 1:
        x = x.reshape(1, b, d)
        b, s = 1, b
    with torch.no_grad():
        top_i = tmoe.routing(tp, tcfg, x)[2]
        keep = tmoe._dispatch_group(x, top_i, tmoe.capacity_for(s, tcfg, cf),
                                    m.n_experts, m.top_k)[1][1]
    return int(keep.sum()), b * s * m.top_k


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_apply_moe_matches_the_jax_package(case):
    """Outputs, the router loss and the gradients of (out . cot + aux)
    with respect to every param and the input, against the JAX
    ``apply_moe`` on the same arrays; the pairs dropped past capacity are
    the JAX dispatch's; two runs (and their gradients) are bit-equal."""
    arch, (b, s), cf = MOE_CASES[case]
    jcfg, tcfg, jp = _moe_params(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, jcfg, xx, capacity_factor=cf)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(x))
    kept, routed = _jax_kept(jp, jcfg, jnp.asarray(x), cf)

    def port():
        tp = ParamDict(**jax.tree.map(
            lambda a: torch.tensor(a).requires_grad_(), jp))
        tx = torch.tensor(x).requires_grad_()
        out, aux = tmoe.apply_moe(tp, tcfg, tx, capacity_factor=cf)
        ((out * torch.tensor(cot)).sum() + aux).backward()
        grads = _plain(tp, lambda t: _np(t.grad))
        return _np(out), float(aux.detach()), grads, _np(tx.grad), tp

    out, aux, gp, gx, tp = port()
    np.testing.assert_allclose(out, np.asarray(jout), atol=TOL, rtol=0)
    assert aux == pytest.approx(float(jaux), rel=1e-6)
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=TOL, rtol=0)
    # each param's gradient within TOL of its own scale (the router's sums
    # 128 tokens' terms near 20 in another order)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(gp),
                            jax.tree.leaves(_host(jgp))):
        np.testing.assert_allclose(g, w, atol=TOL * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    assert _port_kept(tp, tcfg, torch.tensor(x), cf) == (kept, routed)
    assert (kept < routed) == (cf is not None)
    again = port()
    np.testing.assert_array_equal(again[0], out)
    np.testing.assert_array_equal(again[3], gx)
    for a, b_ in zip(jax.tree.leaves(again[2]), jax.tree.leaves(gp)):
        np.testing.assert_array_equal(a, b_)


@pytest.mark.parametrize("rows", ["iid", "prefix-mean"])
def test_apply_moe_drops_at_full_width(rows):
    """qwen3-moe's router at its published width (D 2,048, 128 experts,
    top-8, factor 1.25: cap 48 for a row of 512 tokens; the experts cut to
    d_ff 8, which the dispatch does not see), on one row of random tokens
    (``iid``) and on one whose tokens share their prefix's mean beside
    embeddings of 0.02, as layer 0's attention at init makes them
    (``prefix-mean``, RMS-normed): the port keeps the JAX dispatch's pairs,
    and its output and router loss are the JAX ``apply_moe``'s."""
    jcfg = jbase.get_model_config("qwen3_moe_30b_a3b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             d_ff=8))
    tcfg = tbase.get_model_config("qwen3_moe_30b_a3b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             d_ff=8))
    jp = _host(jmoe.init_moe(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(9)
    s, d = 512, jcfg.d_model
    x = rng.standard_normal((1, s, d))
    if rows == "prefix-mean":
        x = (np.cumsum(x, axis=1) / np.arange(1, s + 1)[None, :, None]
             + 0.02 * rng.standard_normal((1, s, d)))
        x = x / np.sqrt((x * x).mean(axis=-1, keepdims=True))
    x = x.astype(np.float32)
    jout, jaux = jax.jit(lambda p, xx: jmoe.apply_moe(p, jcfg, xx))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    kept, routed = _jax_kept(jp, jcfg, jnp.asarray(x), None)
    tp = ParamDict(**jax.tree.map(torch.tensor, jp))
    with torch.no_grad():
        out, aux = tmoe.apply_moe(tp, tcfg, torch.tensor(x))
    assert _port_kept(tp, tcfg, torch.tensor(x), None) == (kept, routed)
    if rows == "prefix-mean":
        assert kept < routed
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=TOL, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"])
def test_apply_moe_without_drops_is_the_dense_oracle(arch):
    """With no pair dropped, the dispatched MoE is ``moe_ref_dense``, the
    port's and the JAX package's."""
    jcfg, tcfg, jp = _moe_params(arch)
    x = np.random.default_rng(8).standard_normal(
        (3, 10, jcfg.d_model)).astype(np.float32)
    tp = ParamDict(**jax.tree.map(torch.tensor, jp))
    with torch.no_grad():
        out, _ = tmoe.apply_moe(tp, tcfg, torch.tensor(x))
        dense = tmoe.moe_ref_dense(tp, tcfg, torch.tensor(x))
    want = np.asarray(jmoe.moe_ref_dense(jax.tree.map(jnp.asarray, jp), jcfg,
                                         jnp.asarray(x)))
    np.testing.assert_allclose(_np(dense), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(out), want, atol=TOL, rtol=0)
    for n in (1, 7, 64, 1000):
        assert tmoe.capacity_for(n, tcfg, 0.3) == jmoe.capacity_for(
            n, jcfg, 0.3)


# ---------------------------------------------------------------------------
# backbones, caches, decode
# ---------------------------------------------------------------------------


def _model(runs, arch):
    jcfg, tcfg = _cfgs(arch)
    tree = runs["serve"][arch]["params"]
    return jcfg, tcfg, tree, interop.zoo_params_from_numpy(tree, tcfg,
                                                           device="cpu")


N_PRE, N_STEPS = 12, 4


def _jax_decode(jcfg, params):
    """The JAX package's full forward of N_PRE + N_STEPS tokens (hidden
    states and router loss), its prefill of N_PRE (the caches), then
    N_STEPS decode steps, in fp32."""
    s = N_PRE + N_STEPS
    toks = _tokens(2, s, seed=5)
    window = jlm.decode_window(jcfg, s)

    @jax.jit
    def prefill(p, t):
        h, aux, _ = jlm.backbone(p, jcfg, {"tokens": t})
        return h, aux, jlm.backbone(p, jcfg, {"tokens": t[:, :N_PRE]},
                                    want_cache=True, cache_window=window)[2]
    step = jax.jit(lambda p, t, c, sl: jlm.decode(
        p, jcfg, {"token": t}, c, sl, window=window))
    h_full, aux, caches = prefill(params, jnp.asarray(toks))
    out = {"tokens": toks, "window": window, "h_full": np.asarray(h_full),
           "aux": float(aux), "prefill_caches": _host(caches), "steps": []}
    slots = jdec.init_cache_slots(jcfg, window,
                                  prefill_positions=jnp.arange(N_PRE))
    for i in range(N_STEPS):
        tok = toks[:, N_PRE + i:N_PRE + i + 1]
        h, caches, slots = step(params, jnp.asarray(tok), caches, slots)
        out["steps"].append(np.asarray(h[:, 0]))
    out["caches"] = _host(caches)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_and_caches_match(runs, arch, backend):
    """The full forward's hidden states and router loss, and the
    prefill's caches (12 tokens in a window of 16), within TOL."""
    _, tcfg, _, tparams = _model(runs, arch)
    ref = runs["serve"][arch]["decode"]
    toks = torch.tensor(ref["tokens"])
    with torch.no_grad():
        ht, aux, _ = tlm.backbone(tparams, tcfg, {"tokens": toks},
                                  backend=backend)
        _, _, ct = tlm.backbone(tparams, tcfg, {"tokens": toks[:, :N_PRE]},
                                want_cache=True, cache_window=ref["window"],
                                backend=backend)
    np.testing.assert_allclose(_np(ht), ref["h_full"], atol=TOL, rtol=0)
    assert float(aux) == pytest.approx(ref["aux"], rel=1e-6, abs=1e-9)
    assert (ref["aux"] > 0) == (tcfg.family == "moe")
    cj = ref["prefill_caches"]
    assert sorted(ct) == sorted(cj) == ["k", "v"]
    for k in cj:
        assert tuple(ct[k].shape) == cj[k].shape, k
        np.testing.assert_allclose(_np(ct[k]), cj[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(runs, arch, backend):
    """12 tokens of prefill, then 4 decode steps (the moe layer's decode
    group: the batch's tokens, one group) through the in-place caches:
    each within DECODE_TOL of the full forward and TOL of the JAX
    decode, the caches at the end within TOL."""
    _, tcfg, _, tparams = _model(runs, arch)
    ref = runs["serve"][arch]["decode"]
    toks, window = ref["tokens"], ref["window"]
    with torch.no_grad():
        _, _, tc = tlm.backbone(tparams, tcfg, {"tokens": torch.tensor(
            toks[:, :N_PRE])}, want_cache=True, cache_window=window,
            backend=backend)
        slots = tdec.init_cache_slots(tcfg, window,
                                      prefill_positions=torch.arange(N_PRE))
        for i in range(N_STEPS):
            tok = torch.tensor(toks[:, N_PRE + i:N_PRE + i + 1])
            h, tc, slots = tlm.decode(tparams, tcfg, {"token": tok}, tc,
                                      slots, window=window, backend=backend)
            th = _np(h[:, 0])
            assert np.max(np.abs(th - ref["h_full"][:, N_PRE + i])) \
                < DECODE_TOL
            np.testing.assert_allclose(th, ref["steps"][i], atol=TOL, rtol=0)
    for k, want in ref["caches"].items():
        np.testing.assert_allclose(_np(tc[k]), want, atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_decode_state_matches(arch):
    jcfg, tcfg = _cfgs(arch)
    caches, slots, window = jlm.init_decode_state(jcfg, 3, 40)
    tc, ts, tw = tlm.init_decode_state(tcfg, 3, 40, device="cpu")
    assert tw == window == 40
    assert sorted(tc) == sorted(caches)
    for k in caches:
        assert tuple(tc[k].shape) == caches[k].shape and not tc[k].any()
    np.testing.assert_array_equal(_np(ts["pos_slots"]),
                                  np.asarray(slots["pos_slots"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_params_and_moments_both_ways(runs, arch):
    """The JAX params (the experts stacked [L, E, D, F], kimi's
    ``shared``) and SGD moments become the port's per-layer trees and
    back, bit for bit."""
    jcfg, tcfg, tree, tparams = _model(runs, arch)
    blocks = tree["blocks"]
    if jcfg.family == "moe":
        m = jcfg.moe
        assert blocks["moe"]["wi_gate"].shape == (2, m.n_experts, 128,
                                                  m.d_ff)
        assert ("shared" in blocks["moe"]) == (m.n_shared_experts > 0)
        assert ("shared" in tparams.blocks[1].moe) == (
            m.n_shared_experts > 0)
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
# the JAX runs
# ---------------------------------------------------------------------------


def _jax_zoo(arch, n, head):
    return jax_zoo_on_ring(
        n, arch=arch, reduced=True, batch=BATCH, seq=SEQ,
        head=jbase.HeadConfig(**HEADS[head]),
        train=jbase.TrainConfig(optimizer="sgd"))


def _batches():
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    return [_host(fn(t, BATCH, SEQ, 512)) for t in range(STEPS)]


def _jax_fit(task):
    """The JAX run (arch, n, head): its start params, history, final
    params and evaluation; for the gradient case, one batch's loss and
    gradient through ``make_head_loss_fn`` first (the router losses
    included)."""
    arch, n, head = task
    exp = _jax_zoo(arch, n, head)
    batches = _batches()
    exp._batch = lambda t: batches[t]
    out = {"start": _host(exp.params)}
    if (arch, n, head) == (GRAD_ARCH, 1, "full"):
        with jax.set_mesh(exp.mesh):
            loss_fn = jgspmd.make_head_loss_fn(
                exp.model_cfg, exp.head_cfg, exp.par, exp.mesh,
                global_tokens=BATCH * SEQ, head=exp.head)
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p: loss_fn(p, (), (), batches[0]),
                has_aux=True))(exp.params)
        out["grads"] = {"loss": float(loss), "grads": _host(grads)}
    hist = exp.fit(STEPS, lr=LR)
    out.update(history=[dict(r) for r in hist], params=_host(exp.params),
               eval=exp.evaluate(batches[0]))
    return task, out


_EXPS: dict = {}       # this process's JAX checkpoint experiments, by key


def jax_ckpt_save(spec, n, jdir, key):
    """A JAX experiment of ``spec`` (``arch``, ``head`` fields, ``batch``,
    ``seq``, ``ckpt_every``) on a (1, n) mesh saves under ``jdir`` at
    cursor ``ckpt_every``: the init's params, moments an affine map of
    them (every leaf its own values), no step compiled. The experiment
    stays in this process under ``key`` for ``jax_ckpt_restore``.
    Returns the directory and the snapshot as host arrays."""
    steps = spec["ckpt_every"]
    exp = jax_zoo_on_ring(
        n, arch=spec["arch"], reduced=True, batch=spec["batch"],
        seq=spec["seq"], head=jbase.HeadConfig(**spec["head"]),
        train=jbase.TrainConfig(optimizer="sgd"), ckpt_dir=jdir,
        ckpt_every=steps)
    with jax.set_mesh(exp.mesh):
        exp.opt_state = exp.opt_state._replace(
            step=exp.opt_state.step + steps, mu=jax.tree.map(
                lambda a: 0.5 * a + 0.25,
                (exp.params, exp.head_state.params)))
    exp._t = steps
    exp.save_checkpoint()
    _EXPS[key] = exp
    return jdir, _host(exp._snapshot())


def jax_ckpt_restore(key, pdir, snap):
    """The JAX package's restore of the port's file under ``pdir`` into the
    experiment saved under ``key`` (its state wiped first), against
    ``snap``: (restored step, ``tree_compare``)."""
    exp = _EXPS.pop(key)
    with jax.set_mesh(exp.mesh):
        exp.params = jax.tree.map(jnp.zeros_like, exp.params)
        exp.head_state = JaxHeadState(
            exp.head_state.params, jax.tree.map(jnp.zeros_like,
                                                exp.head_state.aux))
        exp.opt_state = jax.tree.map(jnp.zeros_like, exp.opt_state)
    exp._t = 0
    exp.ckpt_dir = pdir
    step = exp.restore()
    return step, jax_tree_compare(_host(exp._snapshot()), snap)


def _ck_spec(arch):
    return {"arch": arch, "head": dict(softmax_impl="full", backend="ref"),
            "batch": BATCH, "seq": SEQ, "ckpt_every": CKPT_STEPS}


def _jax_serve(arch):
    """The JAX ``ZooExperiment.serve`` of ``arch`` at n_model 1 (the
    served archs), and on its params the backbone and the decode."""
    jcfg = _cfgs(arch)[0]
    exp = JaxZooExperiment(arch=arch, reduced=True, n_model=1,
                           batch=SERVE["batch"], log_every=0)
    out = {"params": _host(exp.params),
           "decode": _jax_decode(jcfg, exp.params)}
    if arch in SERVED:
        out["tokens"] = np.asarray(exp.serve(**SERVE))
        out["prompts"] = np.asarray(jax_lm_batch(
            0, SERVE["batch"], SERVE["prompt_len"], 512)["tokens"])
    return arch, out


def _ref_task(arch, case):
    n, head = case
    return (arch, 1 if head in RING_FREE else n, head)


def _start(arch):
    """The JAX experiments' params (seed 0, vocab 512 at every ring), made
    op by op as the experiment makes them."""
    jcfg = _cfgs(arch)[0]
    return _host(jlm.init_model(jax.random.PRNGKey(0), jcfg))


def _ring_cases(n, starts, saved, root):
    """The port's cases on the ring of n, as (key, case) pairs: the fits
    on both backends, the serves and the gradient, or with ``saved`` the
    checkpoint crossings alone."""
    batches = _batches()
    pairs = []
    for arch in ARCHS:
        if saved is not None:
            if CKPT_RING[arch] == n:
                jdir, snap = saved[arch]
                pairs.append((("ckpt", arch), (
                    "zoo_ckpt_from_jax", (_ck_spec(arch), jdir,
                                          os.path.join(root, f"port_{arch}"),
                                          snap), {})))
            continue
        for ring, head in CASES[arch]:
            if ring != n:
                continue
            for backend in BACKENDS:
                pairs.append((("fit", arch, ring, head, backend), (
                    "zoo_fit", (starts[arch],
                                dict(HEADS[head], backend=backend),
                                {"optimizer": "sgd"}),
                    dict(arch=arch, batch=BATCH, seq=SEQ, steps=STEPS,
                         lr=LR, batches=batches, eval_inputs=batches[0]))))
        if n in SERVE_RINGS and arch in SERVED:
            prompts = np.asarray(jax_lm_batch(
                0, SERVE["batch"], SERVE["prompt_len"], 512)["tokens"])
            for backend in BACKENDS:
                pairs.append((("serve", arch, n, backend), (
                    "zoo_serve", (starts[arch],),
                    dict(arch=arch, prompts=prompts, gen=SERVE["gen"],
                         backend=backend))))
    if saved is None and n in GRAD_RINGS:
        pairs.append((("grads", n), (
            "zoo_grads", (starts[GRAD_ARCH], {"softmax_impl": "full"}),
            dict(arch=GRAD_ARCH, inputs=batches[0]))))
    return pairs


def _port_ring(n, pairs):
    """The cases ``pairs`` on one ring of n. {key: members}."""
    per_rank = dist.spawn_ring(testing.run_all, n,
                               [case for _, case in pairs])
    return {key: [r[i] for r in per_rank] for i, (key, _) in enumerate(pairs)}


def _runs(root):
    """The JAX runs in processes of their own, one an arch (its checkpoint
    save, its full-head fit, its serve, then the restore of the port's
    file) and one for each other qwen3-moe fit (which also serve
    qwen3-moe), while the port's rings run here."""
    fit_tasks = sorted({_ref_task(a, c) for a in ARCHS for c in CASES[a]},
                       key=lambda t: (-t[1], t))
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    own = {a: concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
           for a in ARCHS}
    others = [t for t in fit_tasks if t[1:] != (1, "full")]
    procs = concurrent.futures.ProcessPoolExecutor(len(others),
                                                   mp_context=ctx)
    try:
        saves = {a: own[a].submit(jax_ckpt_save, _ck_spec(a), CKPT_RING[a],
                                  os.path.join(root, f"jax_{a}"), a)
                 for a in ARCHS}
        fits = {t: (own[t[0]] if t not in others else procs).submit(
            _jax_fit, t) for t in fit_tasks}
        # qwen3-moe's own process has the longest queue: its serve goes
        # to the first free process of the other fits
        serves = {a: (procs if a == GRAD_ARCH else own[a]).submit(
            _jax_serve, a) for a in ARCHS}
    finally:
        os.environ["XLA_FLAGS"] = flags
    starts = {arch: _start(arch) for arch in ARCHS}
    rings = sorted({c[0] for a in ARCHS for c in CASES[a]})
    with concurrent.futures.ThreadPoolExecutor(2 * len(rings)) as pool:
        # the rings of more than one member split their cases over two
        # rings; the checkpoint crossings wait for the JAX saves
        jobs = []
        for n in rings:
            pairs = _ring_cases(n, starts, None, root)
            parts = [pairs] if n == 1 else [pairs[0::2], pairs[1::2]]
            jobs += [pool.submit(_port_ring, n, part) for part in parts]
        saved = {a: f.result() for a, f in saves.items()}
        jobs += [pool.submit(_port_ring, n, _ring_cases(n, starts, saved,
                                                        root))
                 for n in sorted(set(CKPT_RING.values()))]
        port = {k: v for f in jobs for k, v in f.result().items()}
    backs = {a: own[a].submit(jax_ckpt_restore, a,
                              os.path.join(root, f"port_{a}"), saved[a][1])
             for a in ARCHS}
    out = {"fits": {t: f.result()[1] for t, f in fits.items()},
           "port": port, "starts": starts, "saved": saved,
           "serve": {a: f.result()[1] for a, f in serves.items()},
           "back": {a: f.result() for a, f in backs.items()}, "root": root}
    procs.shutdown(wait=False)
    for p in own.values():
        p.shutdown(wait=False)
    return out


@pytest.fixture(scope="module", autouse=True)
def started(one_thread, tmp_path_factory):
    """``_runs`` in a thread from the module's start, so the JAX
    processes work while the tests that need none run."""
    root = str(tmp_path_factory.mktemp("zoo_moe"))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_runs, root)
    yield fut
    pool.shutdown()


@pytest.fixture(scope="module")
def runs(started):
    return started.result()


@pytest.mark.parametrize("n", SERVE_RINGS)
@pytest.mark.parametrize("arch", SERVED)
def test_serve_tokens_equal_the_jax_package(runs, arch, n):
    """The greedy tokens on both backends, on every member, exactly the
    JAX ZooExperiment.serve's (the moe decode through one group a step)."""
    ref = runs["serve"][arch]
    want = ref["tokens"]
    assert want.shape == (SERVE["batch"], SERVE["gen"])
    for a, b in zip(jax.tree.leaves(runs["starts"][arch]),
                    jax.tree.leaves(ref["params"])):
        np.testing.assert_array_equal(a, b)
    for backend in BACKENDS:
        for got in runs["port"][("serve", arch, n, backend)]:
            np.testing.assert_array_equal(got, want, err_msg=backend)


def _fit_cases():
    return [(a, c) for a in ARCHS for c in CASES[a]]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch,case", _fit_cases(),
                         ids=lambda v: (f"ring{v[0]}-{v[1]}"
                                        if isinstance(v, tuple) else v))
def test_fit_matches_the_jax_zoo(runs, arch, case, backend):
    """fit(3) from the JAX run's start: every step's loss and accuracy and
    the final params within TRAJ_TOL, evaluate equal; every member ends
    with bit-equal params and history."""
    ref = runs["fits"][_ref_task(arch, case)]
    members = runs["port"][("fit", arch) + case + (backend,)]
    for a, b in zip(jax.tree.leaves(runs["starts"][arch]),
                    jax.tree.leaves(ref["start"])):
        np.testing.assert_array_equal(a, b)
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


@pytest.mark.parametrize("n", GRAD_RINGS)
def test_router_loss_gradient_is_the_jax_zoos(runs, n):
    """One batch's loss and gradient through ``make_head_loss_fn`` (the
    head's loss plus the layers' router losses) at rings of 1 and 2
    against the JAX zoo's, leaf for leaf on every member; the router
    loss's own share of the router's gradient is well above the
    tolerance, so a router loss counted once a member would show."""
    ref = runs["fits"][(GRAD_ARCH, 1, "full")]["grads"]
    want = jax.tree.leaves(ref["grads"])
    for member in runs["port"][("grads", n)]:
        assert member["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        got = jax.tree.leaves(member["grads"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-7)
    # the router loss alone, differentiated with respect to the routers
    _, tcfg = _cfgs(GRAD_ARCH)
    params = interop.zoo_params_from_numpy(runs["starts"][GRAD_ARCH], tcfg,
                                           device="cpu")
    routers = [p.moe.router.requires_grad_() for p in params.blocks]
    tokens = torch.tensor(np.asarray(_batches()[0]["tokens"]))
    _, aux, _ = tlm.backbone(params, tcfg, {"tokens": tokens})
    share = torch.autograd.grad(aux, routers)
    full = ref["grads"]["blocks"]["moe"]["router"]
    for layer, g in enumerate(share):
        top = np.abs(full[layer]).max()
        assert float(g.abs().max()) > 1e-3 * top


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_zoo_checkpoint_crosses_both_ways(runs, arch):
    """The JAX save restores in the port (its GLOBAL snapshot the JAX
    package's bit for bit, at the cursor), the port's save restores in
    the JAX package bit for bit, and the decompressed payloads are
    byte-equal."""
    for member in runs["port"][("ckpt", arch)]:
        assert member["step"] == CKPT_STEPS and member["t"] == CKPT_STEPS
        assert member["cmp"]["bitwise"], member["cmp"]["mismatches"]
    step, cmp = runs["back"][arch]
    assert step == CKPT_STEPS and cmp["bitwise"], cmp["mismatches"]
    assert _payload(os.path.join(runs["root"], f"port_{arch}"),
                    CKPT_STEPS) == _payload(runs["saved"][arch][0],
                                            CKPT_STEPS)


# ---------------------------------------------------------------------------
# the experiment surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_every_head_trains_evaluates_and_serves(arch):
    """Each of the six heads: one step on a finite loss, evaluate in [0,
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
