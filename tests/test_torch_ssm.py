"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``, on the CPU, in fp32.

The same inputs, made from a seed with numpy (and the JAX package's own
``init_ssm`` params, carried over as numpy arrays), go through both, at
the SSM shapes of ``mamba2_370m.reduced()`` and ``hymba_1_5b.reduced()``:

* ``rms_norm`` (layers) and ``init_ssm``'s deterministic leaves;
* ``ssd_chunked`` with and without ``init_state``, ``apply_ssm`` at a
  length that is not a chunk multiple (the pad-to-chunk path),
  ``_conv_tail_from_prefill`` at a prompt shorter than K - 1, and
  ``apply_ssm_step`` chained after a prefill: within rtol 1e-5, atol 1e-6;
* the gradient of ``apply_ssm`` with respect to its params and input
  against ``jax.grad``: within rtol 1e-4, and atol 1e-5 of each leaf's
  own max |grad| (a leaf's small entries are sums of large terms that
  cancel; the port reads ~1e-6 of the max);
* the NaN trap of the JAX package's ``ssd_chunked`` (``ssm.py:96-98``
  takes exp(cums_i - cums_j) of every pair and masks after): on b 1, s
  256, h 4, p 8, n 16, A = -linspace(1, 16, 4), dt = softplus(N(0,1) +
  dt_bias), the JAX gradient has 256 NaN entries at chunk 64 and 512 at
  chunk 256, the port's (masked before the exp) is finite and equals the
  JAX gradient at chunk 16 to rtol 1e-4, and the losses agree;
* the chunked scan equals the token-by-token recurrence at chunk 64
  (rtol 1e-4, atol 1e-5: sums of 64 to 256 decayed terms in another
  order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import base as tbase
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import ParamDict
from tests.torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)        # fp32, sums in another order
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # gradients: atol of each leaf's max
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)   # chunked scan vs recurrence
ARCHS = ["mamba2_370m", "hymba_1_5b"]

def _cfgs(arch):
    return (dataclasses.replace(jbase.get_model_config(arch, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tbase.get_model_config(arch, reduced=True),
                                dtype="float32"))


def _params(arch, seed=0):
    """(jax cfg, port cfg, JAX ``init_ssm`` params, the same as a port
    ``ParamDict``), with ``conv_b`` and ``D`` made non-trivial."""
    jcfg, tcfg = _cfgs(arch)
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(seed),
                                               jcfg))
    rng = np.random.default_rng(seed)
    p = dict(p, conv_b=rng.standard_normal(p["conv_b"].shape).astype(
        np.float32) * 0.1, D=(1.0 + rng.standard_normal(p["D"].shape)
                              .astype(np.float32) * 0.1))
    tp = ParamDict(**{k: torch.tensor(v) for k, v in p.items()})
    return jcfg, tcfg, p, tp


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got)
                               else got, np.asarray(want), err_msg=what,
                               **tol)


def _scan_inputs(cfg, b, s, seed=2):
    """ssd_chunked's inputs at ``cfg``'s SSM shapes: x, dt (post-softplus,
    at the init's dt_bias range), A, B, C."""
    _, h, _ = tssm.ssm_dims(cfg)
    sc = cfg.ssm
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, sc.head_dim)).astype(np.float32)
    bias = np.log(np.expm1(np.linspace(1e-3, 0.1, h))).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(
        rng.standard_normal((b, s, h)).astype(np.float32) + bias))
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm = rng.standard_normal((b, s, sc.n_groups, sc.d_state)).astype(
        np.float32)
    cm = rng.standard_normal((b, s, sc.n_groups, sc.d_state)).astype(
        np.float32)
    return x, dt, a, bm, cm


def test_rms_norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(
        np.float32) * 3
    _close(tlayers.rms_norm(torch.tensor(x)), jlayers.rms_norm(x))
    # its own eps, not cfg.norm_eps
    _close(tlayers.rms_norm(torch.tensor(x * 1e-4)),
           jlayers.rms_norm(x * 1e-4))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_ssm_matches_jax(arch):
    """The shapes of every leaf; the deterministic ones (dt_bias, A_log,
    D, conv_b, norm_scale) equal to the JAX package's within 1e-6."""
    jcfg, tcfg = _cfgs(arch)
    want = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(0),
                                                  jcfg))
    gen = torch.Generator().manual_seed(0)
    got = tssm.init_ssm(gen, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32
    for k in ("dt_bias", "A_log", "D", "conv_b", "norm_scale"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert tssm.ssm_dims(tcfg) == jssm.ssm_dims(jcfg)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_ssd_chunked_matches_jax(arch, with_state):
    jcfg, tcfg = _cfgs(arch)
    x, dt, a, bm, cm = _scan_inputs(tcfg, 2, 4 * tcfg.ssm.chunk)
    _, h, _ = tssm.ssm_dims(tcfg)
    s0 = (np.random.default_rng(3).standard_normal(
        (2, h, tcfg.ssm.d_state, tcfg.ssm.head_dim)).astype(np.float32)
          if with_state else None)
    yj, sj = jax.jit(functools.partial(jssm.ssd_chunked,
                                       chunk=jcfg.ssm.chunk))(
        x, dt, a, bm, cm, init_state=s0)
    yt, st = tssm.ssd_chunked(*map(torch.tensor, (x, dt, a, bm, cm)),
                              tcfg.ssm.chunk,
                              init_state=None if s0 is None
                              else torch.tensor(s0))
    _close(yt, yj, what="y")
    _close(st, sj, what="final state")
    assert yt.dtype == st.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_matches_jax_off_the_chunk_grid(arch):
    """37 tokens at chunk 16: the pad-to-chunk path (padded steps have dt
    = 0), the output, the final state and the conv tail."""
    jcfg, tcfg, p, tp = _params(arch)
    x = _x(tcfg, 2, 37)
    # op by op: jit's fusions move y by ~1.6e-6 absolute, past atol 1e-6
    yj, cj = jssm.apply_ssm(p, jcfg, x)
    yt, ct = tssm.apply_ssm(tp, tcfg, torch.tensor(x))
    _close(yt, yj, what="y")
    assert sorted(ct) == sorted(cj) == ["conv_state", "ssm_state"]
    for k in cj:
        _close(ct[k], cj[k], what=k)
    assert ct["ssm_state"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_tail_of_a_short_prompt(arch):
    """A 2-token prompt, shorter than d_conv - 1 = 3: the tail is
    left-padded with zeros, as the JAX package pads it."""
    jcfg, tcfg, p, tp = _params(arch)
    x = _x(tcfg, 3, 2)
    want = jssm._conv_tail_from_prefill(p, jcfg, x)
    got = tssm._conv_tail_from_prefill(tp, tcfg, torch.tensor(x))
    assert tuple(got.shape) == want.shape
    assert got.shape[1] == tcfg.ssm.d_conv - 1
    assert not got[:, 0].any()
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_step_chained_after_a_prefill(arch):
    """Prefill 21 tokens, then three decode steps through the carried
    cache, in both packages; the steps also continue the prefill: the
    last step's output equals the full forward's at that position within
    5e-4 (``tests/test_decode.py``'s bound)."""
    jcfg, tcfg, p, tp = _params(arch)
    x = _x(tcfg, 2, 24)
    _, cj = jax.jit(lambda pp, xx: jssm.apply_ssm(pp, jcfg, xx))(
        p, x[:, :21])
    step = jax.jit(lambda pp, xx, c: jssm.apply_ssm_step(pp, jcfg, xx, c))
    _, ct = tssm.apply_ssm(tp, tcfg, torch.tensor(x[:, :21]))
    init = tssm.init_ssm_cache(tcfg, 2, torch.float32, device="cpu")
    want_init = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    for k in init:
        assert tuple(init[k].shape) == want_init[k].shape
        assert not init[k].any()
    for i in range(21, 24):
        yj, cj = step(p, x[:, i:i + 1], cj)
        yt, ct = tssm.apply_ssm_step(tp, tcfg, torch.tensor(x[:, i:i + 1]),
                                     ct)
        _close(yt, yj, what=f"y at {i}")
        for k in cj:
            _close(ct[k], cj[k], what=f"{k} at {i}")
    full, _ = tssm.apply_ssm(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(yt[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=0, atol=5e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_gradient_matches_jax(arch):
    """d sum(apply_ssm(p, x)^2) with respect to every param and to x, at
    37 tokens (the padded path), against ``jax.grad``."""
    jcfg, tcfg, p, tp = _params(arch)
    x = _x(tcfg, 2, 37)

    def jloss(params, xx):
        return jnp.sum(jssm.apply_ssm(params, jcfg, xx)[0] ** 2)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    leaves = ParamDict(**{k: v.clone().requires_grad_(True)
                          for k, v in tp.items()})
    xt = torch.tensor(x, requires_grad=True)
    (tssm.apply_ssm(leaves, tcfg, xt)[0] ** 2).sum().backward()
    for k, got, want in [(k, leaves[k].grad, gp[k]) for k in gp] + [
            ("x", xt.grad, gx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(want).max(),
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _probe(chunk):
    """The NaN trap's inputs: raw dt N(0, 1) before softplus(raw +
    dt_bias), and d sum(y^2) / d raw in both packages."""
    b, s, h, p, n = 1, 256, 4, 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    a = -np.linspace(1, 16, h).astype(np.float32)
    bias = np.log(np.expm1(np.linspace(1e-3, 0.1, h))).astype(np.float32)
    raw = rng.standard_normal((b, s, h)).astype(np.float32)

    def jloss(r):
        dt = jax.nn.softplus(r + bias)
        return jnp.sum(jssm.ssd_chunked(x, dt, a, bm, cm, chunk)[0] ** 2)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(raw)
    rt = torch.tensor(raw, requires_grad=True)
    dt = tssm._softplus(rt + torch.tensor(bias))
    lt = (tssm.ssd_chunked(torch.tensor(x), dt, torch.tensor(a),
                           torch.tensor(bm), torch.tensor(cm), chunk)[0]
          ** 2).sum()
    lt.backward()
    return float(lj), np.asarray(gj), float(lt.detach()), rt.grad.numpy()


@pytest.mark.parametrize("chunk,n_nan", [(64, 256), (256, 512)])
def test_ssd_gradient_is_finite_where_the_references_is_nan(chunk, n_nan):
    """The JAX package's gradient has NaN at chunk >= 64 (0 * inf in
    exp's VJP above the diagonal); the port's is finite, equals the JAX
    gradient at chunk 16 (finite there) to rtol 1e-4, and the losses
    agree to 1e-6 relative."""
    l16, g16, _, _ = _probe(16)
    assert np.isfinite(g16).all()
    lj, gj, lt, gt = _probe(chunk)
    assert int(np.isnan(gj).sum()) == n_nan
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, g16, rtol=1e-4,
                               atol=1e-4 * np.abs(g16).max())
    assert lt == pytest.approx(lj, rel=1e-6)
    assert lt == pytest.approx(l16, rel=1e-6)


def test_ssd_gradient_at_chunk_16_equals_the_references():
    """Where the JAX gradient is finite the port's is the same."""
    _, g16, lt, gt = _probe(16)
    np.testing.assert_allclose(gt, g16, rtol=1e-4,
                               atol=1e-5 * np.abs(g16).max())


def test_chunked_scan_equals_the_recurrence():
    """ssd_chunked at chunk 64 against the token-by-token recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t, from a
    non-zero initial state, over 256 tokens; the final states agree too."""
    cfg = _cfgs("mamba2_370m")[1]
    x, dt, a, bm, cm = map(torch.tensor, _scan_inputs(cfg, 2, 256))
    _, h, _ = tssm.ssm_dims(cfg)
    s0 = torch.randn((2, h, cfg.ssm.d_state, cfg.ssm.head_dim),
                     generator=torch.Generator().manual_seed(0))
    y, final = tssm.ssd_chunked(x, dt, a, bm, cm, 64, init_state=s0)
    state, ys = s0, []
    for t in range(x.shape[1]):
        bh = bm[:, t].repeat_interleave(h // cfg.ssm.n_groups, dim=1)
        ch = cm[:, t].repeat_interleave(h // cfg.ssm.n_groups, dim=1)
        decay = torch.exp(dt[:, t] * a)
        state = decay[:, :, None, None] * state + torch.einsum(
            "bhn,bh,bhp->bhnp", bh, dt[:, t], x[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", ch, state))
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), state.numpy(), **SCAN_TOL)
