"""The port's KNN-softmax slice against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX package
and through the port:

* ``sparse_ce``: the plain forward and backward against the Pallas kernels
  in interpret mode (``block_a`` 8 and 128, ragged active sets, repeated
  ids, a repeated label column, labels off the shard, ``mask_hits`` both
  ways, non-zero bias), and ``ops.sparse_ce_stats``' gradients through a
  completion against the JAX ``custom_vjp``;
* ``dist_topk``: the plain version against ``repro.kernels.ops.dist_topk``
  over (nq, nk, d) sweeps, k' > nk, ``col_offset`` and exact ties;
* the graph: the ring build at rings of 1, 2 and 4 gloo processes equals
  ``knn_graph_ref`` row for row, in order; ``compress_graph`` gives the JAX
  package's arrays;
* ``select_active`` without fillers and with the JAX package's fillers
  injected;
* ``knn_softmax_local``'s loss, metrics and W / f gradients against the
  shard_map body at rings 1, 2 and 4 on both backends;
* an 8-step FCCS trajectory with the knn head (graph rebuilt every 3
  steps) against the JAX ``PaperTrainer`` at rings 1, 2 and 4, from the
  JAX run's initial weights, moment and graph (``interop``);
* both launchers with ``--head knn`` on the CPU.

Tolerances: kernel bodies ``rtol=atol=1e-5`` (fp32 sums in another
order); ids, masks and graphs exact; trajectories ``rtol=1e-4`` as in
``test_torch_train.py``. One ring per ring size is spawned for the module.
"""
import concurrent.futures
import dataclasses
import functools

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
from repro.core import knn_graph as jkg
from repro.core import knn_softmax as jks
from repro.kernels import ops as jops
from repro.kernels import sparse_ce as jsp
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.core import knn_graph as tkg
from repro_torch.core import knn_softmax as tks
from repro_torch.kernels import knn_dist_topk as tdk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sparse_ce as tsp
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
BACKENDS = (("ref", "ref"), ("pallas", "kernel"))    # (JAX name, port name)
TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)

# the graph and loss bodies: N classes of width D, a batch of B
N, D, B, K, KPRIME = 64, 32, 16, 8, 16

# the trajectory: 8 LARS steps with FCCS batch growth on 512 classes
CLASSES, FEAT, HW_BATCH, STEPS = 512, 32, 16, 8
FCCS = dict(eta0=0.4, t_warm=2, b0=16, b_min=16, b_max=64, t_ini=2,
            t_final=6)
TRAIN = dict(optimizer="lars")
KNN_HEAD = dict(softmax_impl="knn", knn_k=8, knn_kprime=16, active_frac=0.1,
                rebuild_every=3, knn_pad_random=False)


def _problem():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.integers(0, N, B).astype(np.int32)
    return f, y, w


def _graph(n):
    """The exact graph of the problem's W, compressed for a ring of n."""
    w = _problem()[2]
    g = np.asarray(jkg.knn_graph_ref(jnp.asarray(w), K))
    return tuple(np.array(a) for a in jkg.compress_graph(g, n))


def _m_local(n):
    return max(8, (N // n) // 2)


def _jax_fillers(y, m_local, v_loc):
    """``select_active``'s pad draw, as the JAX package makes it."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)
    key = jax.random.fold_in(key, jnp.sum(jnp.asarray(y)) % (1 << 30))
    return np.array(jax.random.randint(key, (m_local,), 0, v_loc,
                                       jnp.int32))


def _eval_inputs():
    return testing.numpy_batch(10**6, 4 * HW_BATCH, classes=CLASSES,
                               dim=FEAT)


# ---------------------------------------------------------------------------
# sparse_ce
# ---------------------------------------------------------------------------


# name: (A, block_a, mask_hits, bias scale)
SPARSE_CASES = {"block8": (13, 8, False, 0.0),
                "block128_ragged_bias": (200, 128, False, 0.5),
                "mask_hits_bias": (13, 8, True, 0.5),
                "mask_hits_block128": (200, 128, True, 0.0)}


def _sparse_problem(a, bias_scale, seed):
    """A shard of 40 classes at offset 20 of 80: some labels off it, the
    on-shard labels in the active set (the first one twice), ids repeated,
    one id out of range (clipped), some columns invalid."""
    rng = np.random.default_rng(seed)
    b, d, v, v0 = 12, 16, 40, 20
    f = rng.standard_normal((b, d)).astype(np.float32)
    w = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    y = rng.integers(0, 80, b).astype(np.int32)
    y[:3] = [v0 + 1, v0 + 5, v0 + 30]
    ids = rng.integers(0, v, a).astype(np.int32)
    ids[:3] = y[:3] - v0
    ids[3] = ids[0]                           # the label column twice
    ids[a // 2:a // 2 + 3] = ids[4:7]         # repeated (filler collisions)
    ids[-1] = v + 9                           # clipped into [0, V)
    gids = (v0 + np.clip(ids, 0, v - 1)).astype(np.int32)
    valid = (rng.random(a) > 0.2).astype(np.int32)
    valid[:4] = 1
    bias = (bias_scale * rng.standard_normal(a)).astype(np.float32)
    gz = rng.standard_normal(b).astype(np.float32)
    gc = rng.standard_normal(b).astype(np.float32)
    return f, w, ids, gids, bias, valid, y, gz, gc


@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_ce_matches_pallas(case):
    """(m, z, corr, amax) of the plain forward and (df, dW) of the plain
    backward, from the forward's hit column, equal the Pallas kernels'
    (their compact dW added into the shard by id); the hit column is the
    first valid label column (-1 with ``mask_hits``)."""
    a, block_a, mask_hits, bias_scale = SPARSE_CASES[case]
    f, w, ids, gids, bias, valid, y, gz, gc = _sparse_problem(
        a, bias_scale, a + block_a)
    j = [np.asarray(t) for t in jsp.sparse_ce_forward(
        *(jnp.asarray(x) for x in (f, w, ids, gids, bias, valid, y)),
        block_a=block_a, scale=2.0, mask_hits=mask_hits)]
    tin = [torch.from_numpy(x) for x in (f, w, ids, gids, bias, valid, y)]
    t = [x.numpy() for x in tsp.sparse_ce_forward(*tin, scale=2.0,
                                                  mask_hits=mask_hits)]
    for name, x, r in zip(("m", "z", "corr"), t[:3], j[:3]):
        np.testing.assert_allclose(x, r, err_msg=name, **TOL)
    np.testing.assert_array_equal(t[3], j[3])
    hit = (gids[None, :] == y[:, None]) & (valid[None, :] > 0)
    want = np.where(hit.any(1), hit.argmax(1), -1)
    np.testing.assert_array_equal(t[4], -1 if mask_hits else want)
    assert mask_hits or (t[4] == 0).any()     # the twice-listed label column

    m = np.array(j[0])
    jdf, jdwa = jsp.sparse_ce_backward(
        *(jnp.asarray(x) for x in (f, w, ids, gids, bias, valid, y, m, gz,
                                   gc)),
        block_a=block_a, scale=2.0, mask_hits=mask_hits)
    jdw = np.zeros_like(w)
    np.add.at(jdw, np.clip(ids, 0, w.shape[0] - 1), np.asarray(jdwa))
    tdf, tdw = tsp.sparse_ce_backward(
        *tin, *(torch.from_numpy(x) for x in (m, gz, gc, t[4])), scale=2.0,
        mask_hits=mask_hits)
    np.testing.assert_allclose(tdf.numpy(), np.asarray(jdf), **TOL)
    np.testing.assert_allclose(tdw.numpy(), jdw, **TOL)


@pytest.mark.parametrize("mask_hits", [False, True])
def test_sparse_ce_stats_grads_match_jax(mask_hits):
    """``ops.sparse_ce_stats`` (autograd Function) equals the JAX
    custom_vjp: the stats, and the gradients of f and W through a
    log-partition completion; m and amax carry none."""
    f, w, ids, gids, bias, valid, y, gz_w, _ = _sparse_problem(30, 0.3, 5)

    def jloss(f_, w_):
        m, z, corr, _ = jops.sparse_ce_stats(
            f_, w_, *(jnp.asarray(x) for x in (ids, gids, bias, valid, y)),
            4.0, 8, mask_hits)
        return jnp.sum((jnp.log(z) + m - corr) * gz_w), (m, z, corr)

    (_, j), jg = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(f), jnp.asarray(w))
    ft = torch.from_numpy(f).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    m, z, corr, amax = tops.sparse_ce_stats(
        ft, wt, *(torch.from_numpy(x) for x in (ids, gids, bias, valid, y)),
        4.0, mask_hits)
    assert not m.requires_grad and not amax.requires_grad
    ((torch.log(z) + m - corr) * torch.from_numpy(gz_w)).sum().backward()
    for x, r in zip((m, z, corr), j):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(r), **TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(jg[0]), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jg[1]), **TOL)


def test_sparse_ce_rejects_what_the_kernel_does_not_take():
    f, w, ids, gids, bias, valid, y, gz, gc = (
        torch.from_numpy(x) for x in _sparse_problem(13, 0.0, 1))
    with pytest.raises(TypeError, match="float32"):
        tsp.sparse_ce_forward(f.double(), w, ids, gids, bias, valid, y)
    with pytest.raises(ValueError, match="shapes"):
        tsp.sparse_ce_forward(f, w, ids, gids[:3], bias, valid, y)
    with pytest.raises(ValueError, match="y on meta"):
        tsp.sparse_ce_forward(f, w, ids, gids, bias, valid, y.to("meta"))
    with pytest.raises(ValueError, match="shapes"):
        tsp.sparse_ce_backward(f, w, ids, gids, bias, valid, y, gz[:2], gz,
                               gc, y)


# ---------------------------------------------------------------------------
# the sparse CE kernels' gates, and their precision on the card: 3xTF32
# products against the gates
# ---------------------------------------------------------------------------


def _gate_problem(seed=18):
    """The knn training shapes cut to size: B = 64, A = 4,096 of V = 8,192,
    D = 512, unit rows, the rows' labels first in the active set, 100
    duplicated filler rows, a bias."""
    rng = np.random.default_rng(seed)
    b, v, d, a = 64, 8192, 512, 4096
    f, w = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)), dim=1)
        for s in ((b, d), (v, d)))
    y = rng.integers(0, v, b).astype(np.int32)
    lab = np.unique(y)
    fill = rng.integers(0, v, a - lab.size).astype(np.int32)
    fill[-100:] = fill[:100]
    ids = torch.from_numpy(np.concatenate([lab, fill]).astype(np.int32))
    bias = torch.from_numpy((0.5 * rng.standard_normal(a)).astype(np.float32))
    valid = torch.ones(a, dtype=torch.int32)
    return f, w, ids, ids.clone(), bias, valid, torch.from_numpy(y)


def _gated_sparse(passes, mask_hits=False):
    """The cut-down training shapes at scale 16 through the card's sparse
    gates, the products of both functions emulated in ``passes``xTF32: the
    forward, then the backward with the loss's cotangents and with the
    softmax term alone."""
    f, w, ids, gids, bias, valid, y = _gate_problem()
    cols = (f, w, ids, gids, bias, valid, y)
    ref = tsp.sparse_ce_forward_plain(*cols, 16.0, mask_hits)
    gates = {"forward": testing.sparse_ce_forward_gate(
        testing.sparse_ce_forward_tf32(*cols, 16.0, mask_hits, passes), ref,
        *cols, 16.0, mask_hits)}
    m, z, hit = ref[0], ref[1], ref[4]
    gz = 1.0 / (f.shape[0] * z)
    for term, gc in (("loss", torch.full_like(gz, -1.0 / f.shape[0])),
                     ("softmax term", torch.zeros_like(gz))):
        rows = (m, gz, gc, hit, 16.0, mask_hits)
        plain = tsp.sparse_ce_backward_plain(*cols, *rows)
        emu = testing.sparse_ce_backward_tf32(*cols, *rows, passes)
        gates[f"backward, {term}"] = testing.sparse_ce_backward_gate(
            *emu, *plain, ids, gids, y)
    return gates


@pytest.mark.parametrize("mask_hits", [False, True])
def test_sparse_3xtf32_products_meet_the_card_gates(mask_hits):
    """The kernels' 3xTF32 products (lo.hi + hi.lo + hi.hi) pass the gates
    that chip_smoke.py holds the sparse CE kernels to, every part with
    room."""
    gates = _gated_sparse(3, mask_hits)
    for name, gate in gates.items():
        assert gate["ok"], (name, gate)
        for part, (_, rel) in gate.get("parts", {}).items():
            assert rel < testing.CE_BWD_TOL / 2, (name, part, rel)
    assert gates["forward"]["m_corr_err"] < testing.CE_ATOL / 10
    assert gates["forward"]["z_rel_err"] < testing.CE_Z_RTOL / 10


@pytest.mark.parametrize("mask_hits", [False, True])
def test_sparse_1xtf32_products_break_the_card_gates(mask_hits):
    """Plain TF32 products fail the forward's gate and both backward terms'
    gates, so the gates tell the design from a kernel that dropped the lo
    terms."""
    gates = _gated_sparse(1, mask_hits)
    want = {"m"} if mask_hits else {"m", "corr"}   # corr = 0 when masked
    assert want <= set(gates["forward"]["failed"]), gates["forward"]
    for term in ("loss", "softmax term"):
        assert not gates[f"backward, {term}"]["ok"], gates


def _sparse_gate_inputs(mask_hits):
    """A small sparse problem through the plain versions: the inputs, the
    forward's outputs and the backward's."""
    f, w, ids, gids, bias, valid, y, gz, gc = (
        torch.from_numpy(x) for x in _sparse_problem(30, 0.5, 3))
    ids = ids.clamp(0, w.shape[0] - 1)
    cols = (f, w, ids, gids, bias, valid, y)
    fwd = tsp.sparse_ce_forward_plain(*cols, 2.0, mask_hits)
    bwd = tsp.sparse_ce_backward_plain(*cols, fwd[0], gz, gc, fwd[4], 2.0,
                                       mask_hits)
    return cols, fwd, bwd


@pytest.mark.parametrize("mask_hits", [False, True])
def test_sparse_gates_pass_the_plain_versions(mask_hits):
    """The plain versions against themselves: every gate passes with no
    error, and a row with nothing kept (m = -inf) compares equal."""
    cols, fwd, bwd = _sparse_gate_inputs(mask_hits)
    gate = testing.sparse_ce_forward_gate(fwd, fwd, *cols, 2.0, mask_hits)
    assert gate["ok"] and gate["m_corr_err"] == gate["z_rel_err"] == 0.0
    gate = testing.sparse_ce_backward_gate(*bwd, *bwd, cols[2], cols[3],
                                           cols[6])
    assert gate["ok"], gate
    assert all(e == 0.0 for e, _ in gate["parts"].values())
    assert {"df", "dW label rows", "dW other active rows"} <= set(
        gate["parts"])


@pytest.mark.parametrize("fault", ["m", "corr", "z", "hit", "amax"])
def test_sparse_forward_gate_rejects(fault):
    """Each output of the forward off by more than its tolerance fails the
    gate under its own name: m and corr by 2e-4, z by 2e-4 relative, one
    row's hit column, one row's amax where its best two scores lie apart."""
    cols, fwd, _ = _sparse_gate_inputs(False)
    out = [t.clone() for t in fwd]
    k = ("m", "z", "corr", "amax", "hit").index(fault)
    row = int(torch.nonzero(fwd[4] >= 0)[0, 0])       # a row with a hit
    if fault in ("m", "corr"):
        out[k][row] += 2e-4
    elif fault == "z":
        out[k][row] *= 1 + 2e-4
    else:
        out[k][row] = out[k][row] + 1
    gate = testing.sparse_ce_forward_gate(out, fwd, *cols, 2.0, False)
    assert gate["failed"] == [fault], gate


@pytest.mark.parametrize("fault", ["df", "dW label rows",
                                   "dW other active rows",
                                   "dW rows off the active set", "nan"])
def test_sparse_backward_gate_rejects(fault):
    """Each part of the backward off by 3e-5 of its own max|plain| fails
    the gate under its own name, as do a moved row off the active set and
    a non-finite value."""
    (_, _, ids, gids, _, _, y), _, (pdf, pdw) = _sparse_gate_inputs(False)
    df, dw = pdf.clone(), pdw.clone()
    act = torch.zeros(dw.shape[0], dtype=torch.bool)
    act[ids.long()] = True
    lab = torch.zeros_like(act)
    lab[ids[torch.isin(gids, y)].long()] = True
    if fault == "df":
        df[0, 0] += 3e-5 * float(pdf.abs().max())
    elif fault == "nan":
        df[0, 0] = float("nan")
    else:
        rows = {"dW label rows": lab, "dW other active rows": act & ~lab,
                "dW rows off the active set": ~act}[fault]
        r = int(torch.nonzero(rows)[0, 0])
        dw[r, 0] += 3e-5 * float(pdw[rows].abs().max() or 1.0)
    gate = testing.sparse_ce_backward_gate(df, dw, pdf, pdw, ids, gids, y)
    assert gate["failed"] == ["df" if fault == "nan" else fault], gate


# ---------------------------------------------------------------------------
# dist_topk
# ---------------------------------------------------------------------------


# name: (nq, nk, d, k', col_offset, block)
TOPK_CASES = {"square": (64, 64, 32, 16, 0, 128),
              "wide": (40, 200, 16, 8, 0, 32),
              "ragged_offset": (130, 70, 32, 16, 100, 32),
              "kprime_over_nk": (30, 20, 16, 32, 0, 128),
              "ties": (48, 96, 16, 12, 7, 32),
              "deep_1024": (40, 96, 1024, 32, 0, 32),     # the zoo's knn
              "deep_2048": (24, 70, 2048, 16, 5, 32)}     # heads (A.9.2)


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_dist_topk_matches_pallas(case):
    """(vals, ids) of the plain version equal the Pallas kernel's on the
    same bf16 inputs: values to fp32 rounding, ids exactly (ties to the
    lowest column), (-inf, -1) past nk, ids shifted by col_offset."""
    nq, nk, d, kp, off, blk = TOPK_CASES[case]
    rng = np.random.default_rng(nq * nk + d)
    if case == "ties":   # integer values: exact scores, duplicated rows tie
        q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
        k = rng.integers(-2, 3, (nk, d)).astype(np.float32)
        k[60:70] = k[3]
        k[20] = k[3]
        k[30:40] = q[:10]
    else:
        q = rng.standard_normal((nq, d)).astype(np.float32)
        k = rng.standard_normal((nk, d)).astype(np.float32)
    jv, ji = jops.dist_topk(jnp.asarray(q).astype(jnp.bfloat16),
                            jnp.asarray(k).astype(jnp.bfloat16), kp,
                            block_q=blk, block_n=blk, col_offset=off)
    tv, ti = tops.dist_topk(torch.from_numpy(q).to(torch.bfloat16),
                            torch.from_numpy(k).to(torch.bfloat16), kp,
                            col_offset=off)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    if kp > nk:
        assert np.all(ti.numpy()[:, nk:] == -1)
        assert np.all(tv.numpy()[:, nk:] == -np.inf)


def test_dist_topk_rejects_bad_arguments():
    q = torch.zeros((4, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        tdk.dist_topk(q.float(), q, 2)
    with pytest.raises(ValueError, match="shapes"):
        tdk.dist_topk(q, q[:, :4], 2)
    with pytest.raises(ValueError, match="positive"):
        tdk.dist_topk(q, q, 0)


# ---------------------------------------------------------------------------
# graph compression, selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", RINGS)
def test_compress_graph_matches_jax(n):
    w = _problem()[2]
    g = np.asarray(jkg.knn_graph_ref(jnp.asarray(w), K))
    j, t = jkg.compress_graph(g, n), tkg.compress_graph(g, n)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, np.asarray(a))
        assert b.dtype == np.int32
    assert tkg.graph_storage_bytes(t) == jkg.graph_storage_bytes(j)
    np.testing.assert_array_equal(
        tkg.knn_graph_ref(torch.from_numpy(w), K).numpy(), g)


@pytest.mark.parametrize("pad_random", [False, True])
@pytest.mark.parametrize("m_local", [6, 40])
@pytest.mark.parametrize("use_ranks", [True, False])
def test_select_active_matches_jax(pad_random, m_local, use_ranks):
    """Algorithm 1 on each of 4 shards: the active ids and mask equal the
    JAX package's exactly, truncated (m_local below the candidates) and
    padded, without fillers and with the JAX package's fillers
    injected."""
    _, y, _ = _problem()
    offsets, neighbors, ranks = _graph(4)
    v_loc = N // 4
    fill = _jax_fillers(y, m_local, v_loc)
    for p in range(4):
        r = ranks[p] if use_ranks else None
        jid, jmask = jks.select_active(
            jnp.asarray(y), jnp.asarray(offsets[p]), jnp.asarray(neighbors[p]),
            v_loc=v_loc, m_local=m_local, k_cap=K, pad_random=pad_random,
            ranks=None if r is None else jnp.asarray(r))
        tid, tmask = tks.select_active(
            torch.from_numpy(y), torch.from_numpy(offsets[p]),
            torch.from_numpy(neighbors[p]), v_loc=v_loc, m_local=m_local,
            k_cap=K, pad_random=pad_random,
            ranks=None if r is None else torch.from_numpy(r),
            fillers=torch.from_numpy(fill))
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_port_fillers_are_deterministic_and_in_range():
    """The port's own pad draw: in [0, v_loc), the same for the same labels
    (a recomputation selects the same classes), different for others."""
    y = torch.from_numpy(_problem()[1])
    a = tks.filler_ids(4096, 1000, y)
    assert a.dtype == torch.int32 and int(a.min()) >= 0 and int(a.max()) < 1000
    assert torch.equal(a, tks.filler_ids(4096, 1000, y.flip(0)))
    assert not torch.equal(a, tks.filler_ids(4096, 1000, y + 1))
    assert not torch.equal(a, tks.filler_ids(4096, 1000, y, salt=1))
    assert len(torch.unique(a)) > 900          # spread over the shard


def test_knn_softmax_ref_matches_jax():
    f, y, w = _problem()
    g = np.array(jkg.knn_graph_ref(jnp.asarray(w), K))
    jl = jks.knn_softmax_ref(jnp.asarray(f), jnp.asarray(y), jnp.asarray(w),
                             jnp.asarray(g), m=40)
    tl = tks.knn_softmax_ref(torch.from_numpy(f), torch.from_numpy(y),
                             torch.from_numpy(w), torch.from_numpy(g), m=40)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


# ---------------------------------------------------------------------------
# the JAX side of the ring tests
# ---------------------------------------------------------------------------

KSPEC = {"accuracy": P(), "logz": P(), "active_frac": P(),
         "label_recall": P()}
BODY_CASES = [(tb, pad) for _, tb in BACKENDS for pad in (False, True)]


def _jax_body(n, jb, pad_random):
    f, y, w = _problem()
    graph = _graph(n)
    mesh = jhybrid.make_hybrid_mesh(n)
    ax = jhybrid.AXIS

    def body(f, y, w, off, nb, rk):
        def loss(w_, f_):
            return jks.knn_softmax_local(
                f_, y, w_, off, nb, rk, model_axis=ax, batch_axes=(),
                global_batch=B, m_local=_m_local(n), k_cap=K,
                cosine_scale=16.0, pad_random=pad_random, backend=jb,
                block_a=8)
        (l, metrics), (gw, gf) = jax.value_and_grad(
            loss, (0, 1), has_aux=True)(w, f)
        return l, metrics, gw, gf[None]

    fn = jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P(), P(ax, None), P(ax, None),
                                   P(ax, None), P(ax, None)),
        out_specs=(P(), dict(KSPEC), P(ax, None), P(ax, None, None)),
        check_vma=False)
    with jax.set_mesh(mesh):
        loss, metrics, gw, gf = jax.device_get(jax.jit(fn)(f, y, w, *graph))
    return {"loss": loss, **metrics, "grad": gw, "grad_f": gf}


def _jax_fit(n):
    """The JAX experiment with the knn head on a ring of n: its initial
    class matrix, moment and graph, then the same 8 steps on
    ``numpy_batch`` data."""
    head = JaxHeadConfig(backend="pallas", **KNN_HEAD)
    exp = JaxExperiment.from_config(
        system="paper", classes=CLASSES, feat_dim=FEAT, batch=HW_BATCH,
        head=head, train=JaxTrainConfig(**TRAIN, fccs=JaxFCCSConfig(**FCCS)),
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0,
        data_fn=functools.partial(testing.numpy_batch, classes=CLASSES,
                                  dim=FEAT))
    start = {"head_cfg": dataclasses.asdict(head),
             "w0": np.array(exp.state.head_params),
             "mu0": np.array(exp.state.opt_state.mu[1]),
             "aux0": [np.array(a) for a in exp.state.head_aux]}
    hist = exp.fit(STEPS, use_fccs_batch=True)
    return {**start, "history": [dict(r) for r in hist],
            "w": np.array(exp.state.head_params),
            "aux": [np.array(a) for a in exp.state.head_aux],
            "eval": exp.evaluate(_eval_inputs())}


def _jax_ring(n):
    return {"bodies": {(tb, pad): _jax_body(n, jb, pad)
                       for jb, tb in BACKENDS for pad in (False, True)},
            "fit": _jax_fit(n)}


# ---------------------------------------------------------------------------
# the port's side: one ring per ring size runs every case
# ---------------------------------------------------------------------------


def _port_ring(n, jr):
    f, y, w = _problem()
    graph = _graph(n)
    fill = np.stack([_jax_fillers(y, _m_local(n), N // n)] * n)
    cases = [("ring_shift", (), {}),
             ("knn_graph_build", (w,), dict(k=K, kprime=KPRIME))]
    cases += [("knn_loss_body", (f, y, w, graph),
               dict(m_local=_m_local(n), k_cap=K, backend=tb,
                    pad_random=pad, fillers=fill if pad else None))
              for tb, pad in BODY_CASES]
    fit = jr["fit"]
    cases += [("paper_fit", (fit["head_cfg"], TRAIN, FCCS, fit["w0"],
                             fit["mu0"]),
               dict(steps=STEPS, batch=HW_BATCH,
                    eval_inputs=_eval_inputs(), head_aux=fit["aux0"]))]
    per_rank = dist.spawn_ring(testing.run_all, n, cases)
    first = per_rank[0]
    return {"ranks": per_rank, "shift": [r[0] for r in per_rank],
            "graph": [r[1] for r in per_rank],
            "bodies": dict(zip(BODY_CASES, first[2:2 + len(BODY_CASES)])),
            "fit": [r[-1] for r in per_rank]}


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
def test_ring_shift_and_pmean(port_results, n):
    """``ppermute`` sends to rank + shift (JAX's perm [(i, i + 1)]), so
    member r holds what r - shift sent; bf16 travels as it is."""
    for r, o in enumerate(port_results[n]["shift"]):
        assert np.all(o["shift1"] == (r - 1) % n)
        assert np.all(o["shift2"] == (r - 2) % n)
        assert o["pmean"] == pytest.approx((n - 1) / 2)


@pytest.mark.parametrize("n", RINGS)
def test_ring_graph_build_is_exact(port_results, n):
    """The bf16 ring build with its fp32 re-rank equals the exact fp32
    graph row for row, in order (self first), on every member."""
    w = _problem()[2]
    ref = np.asarray(jkg.knn_graph_ref(jnp.asarray(w), K))
    assert np.all(ref[:, 0] == np.arange(N))
    for g in port_results[n]["graph"]:
        np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("backend,pad", BODY_CASES)
def test_knn_softmax_local_matches_jax(port_results, n, backend, pad):
    """Loss, accuracy, logz, active_frac, label_recall and the W and f
    gradients of each member's body equal the shard_map body's, with and
    without (injected) fillers; label_recall is 1 (the lossless
    inclusion) and only active rows of W get a gradient."""
    port = port_results[n]["bodies"][(backend, pad)]
    ref = jax_results()[n]["bodies"][(backend, pad)]
    for k in ("loss", "accuracy", "logz", "active_frac", "label_recall",
              "grad", "grad_f"):
        np.testing.assert_allclose(port[k], ref[k], err_msg=f"{k} P={n}",
                                   **TOL)
    assert port["label_recall"] == 1.0
    touched = int((np.abs(port["grad"]).sum(1) > 0).sum())
    assert 0 < touched <= _m_local(n) * n
    for r in range(1, n):
        other = port_results[n]["ranks"][r][
            2 + BODY_CASES.index((backend, pad))]
        np.testing.assert_array_equal(other["loss"], port["loss"])


def test_knn_softmax_local_bf16_features_keep_fp32_products():
    """bf16 features (the zoo trainer's) through the ``ref`` body: the
    logits are fp32 sums of the exact products of the bf16 operands, as
    the JAX package's ``preferred_element_type=float32`` makes them, so
    the loss and logz are fp32 and within 1e-5 of JAX's on a ring of one.
    Logits rounded to bf16 move the loss by ~1e-2 here."""
    f, y, w = _problem()
    jf = jnp.asarray(f, jnp.bfloat16)
    graph = _graph(1)
    mesh = jhybrid.make_hybrid_mesh(1)
    ax = jhybrid.AXIS

    def body(f_, y_, w_, off, nb, rk):
        return jks.knn_softmax_local(
            f_, y_, w_, off, nb, rk, model_axis=ax, batch_axes=(),
            global_batch=B, m_local=_m_local(1), k_cap=K, cosine_scale=16.0,
            pad_random=False, backend="ref")

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(), P(), P(ax, None), P(ax, None),
                                 P(ax, None), P(ax, None)),
                       out_specs=(P(), dict(KSPEC)), check_vma=False)
    with jax.set_mesh(mesh):
        jl, jm = jax.device_get(jax.jit(fn)(jf, y, w, *graph))
    tf = torch.from_numpy(np.array(jf.astype(jnp.float32))).bfloat16()
    aux = [torch.from_numpy(np.ascontiguousarray(a[0])) for a in graph]
    tl, tm = tks.knn_softmax_local(
        tf, torch.from_numpy(y), torch.from_numpy(w), *aux, global_batch=B,
        m_local=_m_local(1), k_cap=K, pad_random=False, backend="ref")
    assert tl.dtype == torch.float32 and tm["logz"].dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm["logz"].numpy(), np.asarray(jm["logz"]),
                               atol=1e-5, rtol=0)
    assert float(tm["label_recall"]) == 1.0


@pytest.mark.parametrize("n", RINGS)
def test_knn_fit_trajectory_matches_jax(port_results, n):
    """8 FCCS steps (micro-batch counts 1, 1, 1, 2, 4, 4, 4, 4) with the
    knn head on the kernel backend, its graph rebuilt after steps 3 and
    6, from the JAX run's initial state and graph: loss, accuracy, lr and
    batch at every step, the final class matrix and graph, and the
    evaluation accuracy equal the JAX PaperTrainer's (rtol 1e-4); every
    step selects every label (label_recall 1)."""
    ref = jax_results()[n]["fit"]
    port = port_results[n]["fit"][0]
    assert [r["batch"] for r in port["history"]] == \
        [r["batch"] for r in ref["history"]] == \
        [16, 16, 16, 32, 64, 64, 64, 64]
    for key in ("lr", "loss", "acc"):
        np.testing.assert_allclose(
            [r[key] for r in port["history"]],
            [r[key] for r in ref["history"]], err_msg=key, **TRAJ_TOL)
    assert all(r["label_recall"] == 1.0 for r in port["history"])
    np.testing.assert_allclose(port["w"], ref["w"], **TRAJ_TOL)
    assert not np.allclose(port["w"], ref["w0"])
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    # the rebuilt graph: each member's CSR row equals the JAX shard's
    for r, member in enumerate(port_results[n]["fit"]):
        for a, b in zip(member["aux"], ref["aux"]):
            np.testing.assert_array_equal(a, b[r])
    assert not all(np.array_equal(a, b)
                   for a, b in zip(ref["aux"], ref["aux0"]))


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def test_train_launcher_knn_on_the_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    rc = train_launcher.main([
        "--device", "cpu", "--head", "knn", "--classes", "512",
        "--feat-dim", "32", "--steps", "4", "--batch", "32", "--fccs",
        "--metrics-out", str(metrics)])
    assert rc == 0
    assert "final eval accuracy" in capsys.readouterr().out
    rows = metrics.read_text().splitlines()
    assert len(rows) == 4 and '"label_recall": 1.0' in rows[-1]
    assert train_launcher.main([
        "--device", "cpu", "--knn", "--classes", "256", "--feat-dim", "16",
        "--steps", "2", "--batch", "16"]) == 0


def test_serve_launcher_knn_on_the_cpu(capsys):
    base = ["--system", "paper", "--device", "cpu", "--classes", "512",
            "--feat-dim", "32", "--batch", "8", "--head", "knn"]
    assert serve_launcher.main(base + ["--topk", "5"]) == 0
    assert "knn-head top-5 retrieval over 512 classes" in \
        capsys.readouterr().out
    assert serve_launcher.main(base) == 0
    assert "knn-head retrieval" in capsys.readouterr().out
