"""The port's kernel modules against the JAX package's Pallas kernels.

The same inputs, made from a seed with numpy, go through the Pallas kernel
(interpret mode on the CPU, as the JAX package's own tests run it) and
through the port's wrapper, which takes its plain PyTorch version for CPU
tensors. The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against the same plain versions.

Tolerances: fp32 statistics and scores ``rtol=atol=1e-5`` (the two sum in
another order); ids and argmax columns exact (ties go to the lowest
column on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ce_softmax as jce
from repro.kernels import ops as jops
from repro.kernels import topk_dc as jdc
from repro_torch import testing
from repro_torch.kernels import build
from repro_torch.kernels import ce_softmax as tce
from repro_torch.kernels import ops as tops
from repro_torch.kernels import topk_dc as tdc
from tests.torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

def _ce_problem(seed, b, d, v):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, d)).astype(np.float32)
    w = (0.1 * rng.standard_normal((v, d))).astype(np.float32)
    y = rng.integers(0, v, b).astype(np.int32)
    return f, w, y


def _both_ce(f, w, y, limit, scale, block_v):
    j = jce.ce_forward(jnp.asarray(f), jnp.asarray(w), jnp.asarray(y),
                       limit=limit, scale=scale, block_v=block_v)
    t = tce.ce_forward(torch.from_numpy(f), torch.from_numpy(w),
                       torch.from_numpy(y), limit=limit, scale=scale)
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def _assert_stats_equal(j, t):
    for name, a, b in zip(("m", "z", "corr"), j[:3], t[:3]):
        np.testing.assert_allclose(b, a, err_msg=name, **TOL)
    assert t[3].dtype == np.int32
    np.testing.assert_array_equal(t[3], j[3], err_msg="amax")


# ---------------------------------------------------------------------------
# ce_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,d,v,bv", [(8, 16, 100, 32), (24, 32, 1000, 256)])
@pytest.mark.parametrize("case", ["dense", "limit", "labels", "all_masked"])
def test_ce_forward_matches_pallas(b, d, v, bv, case):
    """(m, z, corr, amax) of the plain version equal the Pallas kernel's:
    with every column live, with columns >= limit masked (vocab padding)
    and a scale, with labels off the shard (-1, >= V) or on a masked
    column (corr -inf), and on a shard whose limit is 0 (all masked: m
    -inf, z 0, amax -1)."""
    f, w, y = _ce_problem(b * v, b, d, v)
    limit, scale = None, 1.0
    if case == "limit":
        limit, scale = 70, 4.0
    elif case == "labels":
        y[:3] = [-1, v + 5, v - 1]
        limit = v - 10
    elif case == "all_masked":
        limit = 0
    j, t = _both_ce(f, w, y, limit, scale, bv)
    _assert_stats_equal(j, t)
    if case == "all_masked":
        assert np.all(t[0] == -np.inf) and np.all(t[1] == 0)
        assert np.all(t[3] == -1)
    if case == "labels":
        assert t[2][0] == 0 and t[2][1] == 0 and t[2][2] == -np.inf


def test_ce_forward_ties_pick_the_lowest_column():
    """Integer-valued inputs make every score exact; duplicated class rows
    then tie exactly, and amax must be the lowest tied column, as the TPU
    kernel's first-max-then-strict-greater rule gives."""
    rng = np.random.default_rng(11)
    b, d, v = 16, 8, 300
    f = rng.integers(-2, 3, (b, d)).astype(np.float32)
    w = rng.integers(-2, 3, (v, d)).astype(np.float32)
    w[200:260] = w[5]
    w[130] = w[5]
    y = rng.integers(0, v, b).astype(np.int32)
    j, t = _both_ce(f, w, y, None, 1.0, 64)
    _assert_stats_equal(j, t)
    s = f @ w.T
    np.testing.assert_array_equal(t[3], np.argmax(s, axis=1))


def test_ce_shard_stats_matches_and_is_forward_only():
    """``ops.ce_shard_stats`` equals the JAX custom_vjp forward and
    backward: the stats, and the gradients of f and W through a
    log-partition completion (m and amax carry none). The name dates from
    when the port's op had no backward; it is kept so that the test's
    record carries on."""
    f, w, y = _ce_problem(3, 8, 16, 100)
    gz_w = np.random.default_rng(4).standard_normal(8).astype(np.float32)

    def jloss(f_, w_):
        m, z, corr, _ = jops.ce_shard_stats(
            f_, w_, jnp.asarray(y), jnp.asarray(90, jnp.int32), 2.0, 32)
        return jnp.sum((jnp.log(z) + m - corr) * gz_w), (m, z, corr)

    (_, j), jg = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(f), jnp.asarray(w))
    ft = torch.from_numpy(f).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    t = tops.ce_shard_stats(ft, wt, torch.from_numpy(y), 90, 2.0)
    assert not t[0].requires_grad and not t[3].requires_grad
    ((torch.log(t[1]) + t[0] - t[2]) * torch.from_numpy(gz_w)).sum().backward()
    _assert_stats_equal([np.asarray(a) for a in j] + [t[3].numpy()],
                        [a.detach().numpy() for a in t])
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg[1]), **TOL)


def test_ce_shard_stats_grads_through_completion():
    """``tests/test_kernels.py``'s grad check of the JAX custom_vjp through
    a log/psum-style completion with vocab padding, on the port: the same
    loss and gradients as the JAX package on the same inputs."""
    rng = np.random.default_rng(12)
    b, d, v, n_valid = 8, 16, 96, 80
    f = rng.standard_normal((b, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    y = rng.integers(0, n_valid, b).astype(np.int32)

    def jloss(f_, w_):
        m, z, corr, _ = jops.ce_shard_stats(
            f_, w_, jnp.asarray(y), jnp.asarray(n_valid, jnp.int32), 2.0, 32)
        return jnp.mean(jnp.log(z) + m - corr)

    jl, jg = jax.value_and_grad(jloss, (0, 1))(jnp.asarray(f), jnp.asarray(w))
    ft = torch.from_numpy(f).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    m, z, corr, _ = tops.ce_shard_stats(ft, wt, torch.from_numpy(y), n_valid,
                                        2.0)
    tl = (torch.log(z) + m - corr).mean()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg[0]), atol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg[1]), atol=1e-6)
    assert np.all(wt.grad.numpy()[n_valid:] == 0)


def test_fused_ce_and_stats_match_jax():
    f, w, y = _ce_problem(5, 8, 16, 100)
    y[0] = -1                                  # a row not owned here
    jl, jg = jax.value_and_grad(
        lambda w_: jops.fused_ce(jnp.asarray(f), w_, jnp.asarray(y), 4.0, 32)
    )(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    tl = tops.fused_ce(torch.from_numpy(f), wt, torch.from_numpy(y), 4.0)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg), **TOL)
    js = jops.fused_ce_stats(jnp.asarray(f), jnp.asarray(w), jnp.asarray(y),
                             scale=4.0, block_v=32)
    ts = tops.fused_ce_stats(torch.from_numpy(f), torch.from_numpy(w),
                             torch.from_numpy(y), scale=4.0)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# ---------------------------------------------------------------------------
# ce_backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,d,v,bv", [(8, 16, 100, 32), (24, 32, 1000, 256)])
@pytest.mark.parametrize("case", ["dense", "limit", "labels", "all_masked"])
def test_ce_backward_matches_pallas(b, d, v, bv, case):
    """(df, dW) of the plain version equal the Pallas kernel's on the
    forward's own row max, over the cases of the forward test: every
    column live, columns >= limit masked with a scale, labels off the
    shard and on a masked column (the one-hot is not masked), and a shard
    whose limit is 0 (m = -inf: only the one-hot term remains)."""
    f, w, y = _ce_problem(b * v + 1, b, d, v)
    rng = np.random.default_rng(b + v)
    gz = rng.standard_normal(b).astype(np.float32)
    gc = rng.standard_normal(b).astype(np.float32)
    limit, scale = None, 1.0
    if case == "limit":
        limit, scale = 70, 4.0
    elif case == "labels":
        y[:3] = [-1, v + 5, v - 1]
        limit = v - 10
    elif case == "all_masked":
        limit = 0
    m = np.array(jce.ce_forward(jnp.asarray(f), jnp.asarray(w),
                                  jnp.asarray(y), limit=limit, scale=scale,
                                  block_v=bv)[0])
    jdf, jdw = jce.ce_backward(jnp.asarray(f), jnp.asarray(w), jnp.asarray(y),
                               jnp.asarray(m), jnp.asarray(gz),
                               jnp.asarray(gc), limit=limit, block_v=bv,
                               scale=scale)
    tdf, tdw = tce.ce_backward(*(torch.from_numpy(a)
                                 for a in (f, w, y, m, gz, gc)),
                               limit=limit, scale=scale)
    assert tdw.shape == (v, d) and tdf.shape == (b, d)
    np.testing.assert_allclose(tdf.numpy(), np.asarray(jdf), **TOL)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), **TOL)
    if case == "all_masked":
        assert np.all(m == -np.inf)
        hit = np.zeros((b, v), np.float32)
        hit[np.arange(b), y] = gc
        np.testing.assert_allclose(tdw.numpy(), hit.T @ f, **TOL)


def test_ce_backward_rejects_what_the_kernel_does_not_take():
    f, w, y = (torch.from_numpy(a) for a in _ce_problem(0, 4, 8, 16))
    m = gz = gc = torch.zeros(4)
    with pytest.raises(TypeError, match="float32"):
        tce.ce_backward(f.double(), w, y, m, gz, gc)
    with pytest.raises(ValueError, match="shapes"):
        tce.ce_backward(f, w[:, :4], y, m, gz, gc)
    with pytest.raises(ValueError, match="shapes"):
        tce.ce_backward(f, w, y, m[:2], gz, gc)
    with pytest.raises(ValueError, match="not on cpu"):
        tce.ce_backward(f, w, y, m, gz.to("meta"), gc)


def test_ce_forward_rejects_what_the_kernel_does_not_take():
    f, w, y = (torch.from_numpy(a) for a in _ce_problem(0, 4, 8, 16))
    with pytest.raises(TypeError, match="float32"):
        tce.ce_forward(f.double(), w, y)
    with pytest.raises(ValueError, match="shapes"):
        tce.ce_forward(f[:, :4], w, y)
    with pytest.raises(ValueError, match="shapes"):
        tce.ce_forward(f, w, y[:2])
    # labels elsewhere than f would hand the kernel a foreign pointer
    with pytest.raises(ValueError, match="y on meta"):
        tce.ce_forward(f, w, y.to("meta"))


# ---------------------------------------------------------------------------
# the CE kernels' precision on the card: 3xTF32 products against the gates
# ---------------------------------------------------------------------------


def test_tf32_round_is_round_to_nearest_ties_away():
    """The emulation's TF32 rounding keeps 10 mantissa bits, rounds to the
    nearest and sends ties away from zero (the card's cvt.rna)."""
    x = torch.tensor([1.0, 1 + 2 ** -12, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11), 3.14159265, 0.0, float("-inf")])
    want = [1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 3.140625,
            0.0, float("-inf")]
    assert testing.tf32_round(x).tolist() == want


def _gated_ce(passes):
    """The training shapes cut to size (unit rows, scale 16, the loss's
    cotangents and the softmax term alone) through the card's CE gates,
    with the products of both functions emulated in ``passes``xTF32."""
    rng = np.random.default_rng(17)
    b, v, d, scale = 64, 4096, 512, 16.0
    f, w = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)), dim=1)
        for s in ((b, d), (v, d)))
    y = torch.from_numpy(rng.integers(0, v, b).astype(np.int32))
    ref = tce.ce_forward_plain(f, w, y, v, scale)
    gates = {"forward": testing.ce_forward_gate(
        testing.ce_forward_tf32(f, w, y, v, scale, passes), ref, f, w, v,
        scale)}
    gz = 1.0 / (b * ref[1])
    for term, gc in (("loss", torch.full_like(gz, -1.0 / b)),
                     ("softmax term", torch.zeros_like(gz))):
        plain = tce.ce_backward_plain(f, w, y, ref[0], gz, gc, v, scale)
        emu = testing.ce_backward_tf32(f, w, y, ref[0], gz, gc, v, scale,
                                       passes)
        gates[f"backward, {term}"] = testing.ce_backward_gate(*emu, *plain, y)
    return gates


def test_3xtf32_products_meet_the_card_gates():
    """The kernels' 3xTF32 products (lo.hi + hi.lo + hi.hi) pass the gates
    that chip_smoke.py holds the CE kernels to, every part with room."""
    for name, gate in _gated_ce(3).items():
        assert gate["ok"], (name, gate)
    fwd = _gated_ce(3)["forward"]
    assert fwd["m_corr_err"] < testing.CE_ATOL / 10
    assert fwd["z_rel_err"] < testing.CE_Z_RTOL / 10


def test_1xtf32_products_break_the_card_gates():
    """Plain TF32 products fail both the forward's and the backward's gate,
    so the gates tell the design from a kernel that dropped the lo terms."""
    gates = _gated_ce(1)
    assert not gates["forward"]["ok"]
    assert {"m", "corr"} <= set(gates["forward"]["failed"])
    for term in ("loss", "softmax term"):
        assert not gates[f"backward, {term}"]["ok"], gates


def _learnt_batch_gates(passes):
    """A batch the model has learnt (raw logits, scale 1: a third of the
    rows hold their label's row, so p at the label is 1 to fp32), the
    loss's cotangents: the products emulated in ``passes``xTF32 against
    the plain version, through ``ce_backward_gate`` and through
    ``ce_backward_floor_gate`` with the plain version in fp64."""
    rng = np.random.default_rng(23)
    b, v, d = 512, 4000, 256
    w = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32)
                         * 0.05)
    y = torch.from_numpy(rng.integers(0, v, b).astype(np.int32))
    f = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    learnt = torch.from_numpy(rng.random(b) < 0.3)
    wy = w[y[learnt].long()]
    f[learnt] = f[learnt] * 0.1 + 24.0 * wy / (wy * wy).sum(1, keepdim=True)
    m, z, _, _ = tce.ce_forward_plain(f, w, y, v, 1.0)
    gz, gc = 1.0 / (b * z), torch.full_like(z, -1.0 / b)
    p_label = torch.exp((f * w[y.long()]).sum(1) - m) / z
    assert float(p_label.max()) > 1 - 1e-6
    plain = tce.ce_backward_plain(f, w, y, m, gz, gc, v, 1.0)
    plain64 = tce.ce_backward_plain(f.double(), w.double(), y, m.double(),
                                    gz.double(), gc.double(), v, 1.0)
    emu = testing.ce_backward_tf32(f, w, y, m, gz, gc, v, 1.0, passes)
    return (testing.ce_backward_gate(*emu, *plain, y),
            testing.ce_backward_floor_gate(*emu, *plain, *plain64, y))


def test_floor_gate_holds_a_learnt_batch():
    """On a learnt batch the relative gate rejects even 3xTF32 products
    (fp32 rounding of p - 1 reaches CE_BWD_TOL of the label rows' max),
    while the floor of CE_OWN_ROUNDING times the plain version's own
    rounding passes them with room and still rejects 1xTF32 products."""
    rel3, floor3 = _learnt_batch_gates(3)
    assert not rel3["ok"] and "dW label rows" in rel3["failed"], rel3
    assert floor3["ok"], floor3
    for err, rel, own in floor3["parts"].values():
        assert rel <= testing.CE_BWD_TOL or \
            err <= testing.CE_OWN_ROUNDING / 2 * own
    rel1, floor1 = _learnt_batch_gates(1)
    assert not rel1["ok"] and not floor1["ok"], floor1
    assert set(floor1["failed"]) == {"df", "dW label rows", "dW other rows"}


# ---------------------------------------------------------------------------
# stage1_topk / topk_rows / topk_dc
# ---------------------------------------------------------------------------


def _topk_problem(seed, rows, n, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    if ties:
        x = np.round(x * 4) / 4                 # many exact ties
        x[1] = -np.inf                          # a row with nothing
        x[2, 3:] = -np.inf                      # a row short of k
    return x


@pytest.mark.parametrize("n,k,chunk", [(100, 5, 512), (3000, 7, 512),
                                       (5000, 16, 2048), (300, 32, 64),
                                       (9000, 5, 4096)])
def test_stage1_plain_matches_pallas(n, k, chunk):
    """Per-chunk (values, in-chunk ids) of the plain version equal the
    Pallas kernel's on the -inf-padded [M, chunk] view, ids exactly: ties
    to the lowest index, and (-inf, 0) once a chunk runs out."""
    x = _topk_problem(n + k, 4, n)
    c = min(chunk, n)
    pad = (-n) % c
    xc = np.pad(x, ((0, 0), (0, pad)), constant_values=-np.inf)
    xc = xc.reshape(-1, c)
    jv, ji = jdc.stage1_topk(jnp.asarray(xc), min(k, c))
    tv, ti = tdc.stage1_topk_plain(torch.from_numpy(xc), min(k, c))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the wrapper's own chunking (ragged tail masked, no padded copy)
    # gives the same per-chunk result as the padded view
    wv, wi = tdc.stage1_topk(torch.from_numpy(x), min(k, c), chunk=c)
    np.testing.assert_array_equal(wv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,k,chunk", [(100, 5, 512), (3000, 7, 512),
                                       (5000, 16, 2048)])
@pytest.mark.parametrize("ties", [True, False])
def test_topk_rows_matches_jax(n, k, chunk, ties):
    """Row-wise top-k through stage 1 and the stable stage-2 merge equals
    ``repro.kernels.ops.topk_rows`` (stage 2 ``lax.top_k``) exactly."""
    x = _topk_problem(n * k, 4, n, ties)
    jv, ji = jops.topk_rows(jnp.asarray(x), k, chunk=chunk)
    tv, ti = tops.topk_rows(torch.from_numpy(x), k, chunk=chunk)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("n,k", [(1000, 8), (10000, 16)])
def test_topk_dc_matches_jax(n, k):
    x = _topk_problem(n, 1, n, ties=False)[0]
    jv, ji = jops.topk_dc(jnp.asarray(x), k, chunk=512)
    tv, ti = tops.topk_dc(torch.from_numpy(x), k, chunk=512)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_stable_keeps_the_lowest_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0] * 5])
    vals, pos = tops.topk_stable(x, 3)
    assert pos.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert vals.tolist() == [[3.0, 3.0, 3.0], [0.0, 0.0, 0.0]]


def test_stage1_topk_rejects_bad_arguments():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="chunk"):
        tdc.stage1_topk(x, 9)
    with pytest.raises(TypeError, match="float32"):
        tdc.stage1_topk(x.double(), 2)
    # the CUDA kernel takes any k up to the chunk, and any chunk whose
    # keys, counters and sort buffer fit a block's shared memory
    assert tdc.cuda_smem_bytes(2048, 5) == 16_416       # csrc's note
    assert tdc.cuda_smem_bytes(2048, 1048) == 24_608
    for chunk, k in ((2048, 5), (2048, 2048), (4096, 2048), (10_000, 33),
                     (16_384, 16_384), (50_000, 5)):
        tdc.check_cuda_chunk(chunk, k)
    for chunk, k in ((20_000, 20_000), (60_000, 5)):
        with pytest.raises(ValueError, match="shared memory"):
            tdc.check_cuda_chunk(chunk, k)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build says where it looked instead of failing
    somewhere inside ctypes."""
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
