"""The port's selective, MACH, sampled and CSoft bodies against the JAX
package's, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX package
(its shard_map bodies on a mesh of 1, 2 and 4 host devices; the ``pallas``
backend's kernels in interpret mode) and through the port (rings of 1, 2
and 4 gloo processes; its ``kernel`` backend runs the kernels' plain
versions on the CPU):

* the LSH tables, single-device and per ring member, from the JAX
  package's hyperplanes: exact, except for rows whose projection on a
  plane lies within fp32 rounding of 0 (listed, never re-seeded away);
* ``selective_active`` ids and masks, exact, truncated and at the whole
  candidate set;
* ``selective_softmax_local``, ``mach_softmax_local`` and the sampled body
  (``uniform`` and ``log_uniform``, with the JAX package's draw injected):
  loss, metrics and the W and f gradients, on both backends;
* ``mach_hashes`` bit for bit, the single-device MACH loss and prediction;
* ``mach_predict_local`` and ``csoft_predict_local`` (min and mean): ids
  exact outside reported near-ties;
* the sampled body at ``n_samples >= V`` (uniform) against the full
  softmax, on the port's own draw;
* the dense CE gates at MACH's shard (scale 1, unnormalised features):
  3xTF32 products pass them, 1xTF32 products fail them;
* the port's own draws: uniform ids distinct and on the shard,
  ``log_uniform`` the same on every member, the same (seed, step, labels)
  the same draw.

Tolerances as in ``test_torch_knn.py``: bodies ``rtol=atol=1e-5``; ids,
masks and tables exact. One ring per ring size runs every ring case.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import baselines as jbl
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.api.experiment import paper_model_config
from repro_torch.api.heads import make_head
from repro_torch.configs.base import HeadConfig
from repro_torch.core import baselines as tbl
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
BACKENDS = (("ref", "ref"), ("pallas", "kernel"))    # (JAX name, port name)
TOL = dict(rtol=1e-5, atol=1e-5)

# the loss bodies: N classes of width D, a batch of B
N, D, B = 64, 32, 16
# selective: R tables of N_BITS bits, CAP classes a bucket
R_LSH, N_BITS, CAP = 4, 3, 4
# MACH / CSoft: R_MACH repetitions of N_BUCKETS buckets
R_MACH, N_BUCKETS = 3, 16
# sampled: (distribution, n_samples)
SAMPLED = (("uniform", 32), ("log_uniform", 48))
STEP = 5
# projections closer to 0 than this may take either sign in fp32 sums of
# another order: such rows may land in another bucket than in JAX
LSH_MARGIN = 1e-5


def _problem():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((B, D)).astype(np.float32)
    w = rng.standard_normal((N, D)).astype(np.float32)
    y = rng.integers(0, N, B).astype(np.int32)
    return f, y, w


def _sketch():
    rng = np.random.default_rng(1)
    w = (0.3 * rng.standard_normal((R_MACH, N_BUCKETS, D))).astype(np.float32)
    return w, jbl.mach_hashes(N, N_BUCKETS, n_rep=R_MACH, seed=0)


def _lsh(n):
    """The JAX package's sharded tables of the problem's W on a ring of n:
    (planes, offsets [n, ...], classes [n, ...])."""
    w = _problem()[2]
    return tuple(np.array(a) for a in jbl.build_sharded_lsh_tables(
        jax.random.PRNGKey(7), jnp.asarray(w), n, R_LSH, N_BITS))


def _m_local(n):
    return max(4, (N // n) // 2)


def _jax_draw(y, step, shard, n_shards, *, v_loc, n_samples, distribution,
              seed=17):
    """``sampled_softmax_local``'s draw on member ``shard``, as the JAX
    package makes it (``src/repro/core/baselines.py``, its lines for the
    salt, the key and each distribution): (ids, valid, logq, logq_y,
    sample_frac) as numpy arrays."""
    n_eff = v_loc * n_shards
    v_start = shard * v_loc
    yj = jnp.asarray(y)
    salt = jnp.sum(yj.astype(jnp.uint32))
    if step is not None:
        salt = salt + jnp.uint32(step) * jnp.uint32(2654435761)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    if distribution == "uniform":
        m_loc = max(1, min(v_loc, n_samples // n_shards))
        perm = jax.random.permutation(jax.random.fold_in(key, shard), v_loc)
        ids = perm[:m_loc].astype(jnp.int32)
        valid = jnp.ones((m_loc,), bool)
        logq = jnp.full((m_loc,), jnp.log(m_loc / v_loc), jnp.float32)
        logq_y = jnp.log(jnp.float32(m_loc) / v_loc)
        frac = jnp.asarray(m_loc * n_shards / n_eff, jnp.float32)
    else:
        m = n_samples
        u = jax.random.uniform(key, (m,), jnp.float32)
        gid = (jnp.exp(u * jnp.log(float(n_eff + 1))) - 1.0).astype(jnp.int32)
        gid = jnp.clip(gid, 0, n_eff - 1)
        q = jnp.log((gid + 2.0) / (gid + 1.0)) / jnp.log(float(n_eff + 1))
        logq = jnp.log(jnp.float32(m) * q)
        rel = gid - v_start
        valid = (rel >= 0) & (rel < v_loc)
        ids = jnp.clip(rel, 0, v_loc - 1)
        qy = jnp.log((yj + 2.0) / (yj + 1.0)) / jnp.log(float(n_eff + 1))
        logq_y = jnp.log(jnp.float32(m) * qy)
        frac = jnp.asarray(min(m, n_eff) / n_eff, jnp.float32)
    return tuple(np.array(a) for a in (ids.astype(jnp.int32), valid, logq,
                                       logq_y, frac))


def _jax_draws(n, distribution, n_samples, y=None, step=STEP):
    y = _problem()[1] if y is None else y
    return [_jax_draw(y, step, p, n, v_loc=N // n, n_samples=n_samples,
                      distribution=distribution) for p in range(n)]


# ---------------------------------------------------------------------------
# single-device pieces, no ring
# ---------------------------------------------------------------------------


def _bucket_map(offsets, classes, n):
    """class -> bucket [R, n] from a CSR."""
    out = np.full((offsets.shape[0], n), -1, np.int64)
    for r in range(offsets.shape[0]):
        for k in range(offsets.shape[1] - 1):
            out[r, classes[r, offsets[r, k]:offsets[r, k + 1]]] = k
    return out


def _margin_rows(w, planes):
    """Rows of w whose projection on some plane lies within LSH_MARGIN of
    0 (float64 arithmetic on the normalised rows)."""
    wn = w.astype(np.float64)
    wn /= np.linalg.norm(wn, axis=1, keepdims=True) + 1e-12
    proj = np.einsum("nd,rdb->rnb", wn, planes.astype(np.float64))
    return np.nonzero((np.abs(proj) < LSH_MARGIN).any(axis=(0, 2)))[0]


def _assert_tables_equal(port, ref, w, planes):
    """The port's (offsets, classes) against the JAX package's: each row's
    bucket exactly, outside the rows within the margin; where there are no
    such rows, the arrays bit for bit."""
    margin = _margin_rows(w, planes)
    n = w.shape[0]
    pm, rm = _bucket_map(*port, n), _bucket_map(*ref, n)
    keep = np.setdiff1d(np.arange(n), margin)
    np.testing.assert_array_equal(pm[:, keep], rm[:, keep])
    if margin.size == 0:
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    return margin


@pytest.mark.parametrize("n", RINGS)
def test_sharded_lsh_tables_match_jax(n):
    """Each member's CSR over its own rows, through the JAX package's
    planes, equals the JAX shard's. 4,096 classes of width 64, 4 tables
    of 8 bits; rows within the margin of a plane are reported."""
    rng = np.random.default_rng(n)
    w = rng.standard_normal((4096, 64)).astype(np.float32)
    planes, offsets, classes = (np.array(a) for a in
                                jbl.build_sharded_lsh_tables(
                                    jax.random.PRNGKey(n), jnp.asarray(w), n,
                                    4, 8))
    v_loc = 4096 // n
    margins = []
    for p in range(n):
        rows = w[p * v_loc:(p + 1) * v_loc]
        port = [t.numpy() for t in tbl.build_sharded_lsh_tables(
            torch.from_numpy(rows), torch.from_numpy(planes))]
        margins.append(_assert_tables_equal(port, (offsets[p], classes[p]),
                                            rows, planes).tolist())
        assert port[1].shape == (4, v_loc) and port[0][:, -1].tolist() == [
            v_loc] * 4
    print(f"rows within {LSH_MARGIN:g} of a plane, by member: {margins}")


def test_lsh_tables_match_jax():
    """The single-device tables and ``selective_active`` (truncated to 20
    and at every candidate) equal the JAX package's, and so does
    ``selective_softmax_ce``."""
    f, y, w = _problem()
    jt = jbl.build_lsh_tables(jax.random.PRNGKey(3), jnp.asarray(w), R_LSH,
                              N_BITS)
    tt = tbl.build_lsh_tables(torch.from_numpy(w),
                              torch.from_numpy(np.array(jt.planes)))
    _assert_tables_equal([tt.offsets.numpy(), tt.classes.numpy()],
                         [np.array(jt.offsets), np.array(jt.classes)], w,
                         np.array(jt.planes))
    tt = tbl.LSHTables(*(torch.from_numpy(np.array(a)) for a in jt))
    for m in (20, B + R_LSH * B * CAP):
        jid, jmask = jbl.selective_active(jnp.asarray(f), jnp.asarray(y), jt,
                                          m=m, cap=CAP)
        tid, tmask = tbl.selective_active(torch.from_numpy(f),
                                          torch.from_numpy(y), tt, m=m,
                                          cap=CAP)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert tid.dtype == torch.int32 and np.asarray(jmask).any()
    jl = jbl.selective_softmax_ce(jnp.asarray(f), jnp.asarray(y),
                                  jnp.asarray(w), jt, m=40, cap=CAP)
    tl = tbl.selective_softmax_ce(torch.from_numpy(f), torch.from_numpy(y),
                                  torch.from_numpy(w), tt, m=40, cap=CAP)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("n_classes,n_buckets,n_rep,seed", [
    (64, 16, 3, 0), (1000, 97, 4, 1), (1_020_250, 63_765, 4, 0)])
def test_mach_hashes_bit_equal(n_classes, n_buckets, n_rep, seed):
    """numpy on both sides: the tables are the JAX package's bit for bit,
    at the paper's 1M-class width too; the heads' own tables as well."""
    t = tbl.mach_hashes(n_classes, n_buckets, n_rep=n_rep, seed=seed)
    j = jbl.mach_hashes(n_classes, n_buckets, n_rep=n_rep, seed=seed)
    assert t.dtype == np.int32 and np.array_equal(t, j)
    assert t.min() >= 0 and t.max() < n_buckets


@pytest.mark.parametrize("impl", ["mach", "csoft"])
@pytest.mark.parametrize("n", RINGS)
def test_sketch_head_init(impl, n):
    """Each member holds its bucket block [R, B/P, D] (B rounded up to the
    ring) and the whole hash table, equal to the JAX package's; the blocks
    of a ring put together are the ring of one's W."""
    hcfg = HeadConfig(softmax_impl=impl, mach_b=30, csoft_b=30, mach_r=3,
                      csoft_r=3)
    head = make_head(paper_model_config("feats", N, D), hcfg)
    blocks = []
    for r in range(n):
        g = torch.Generator().manual_seed(4)
        hs = head.init(g, n, rank=r, device="cpu")
        blocks.append(hs.params)
        n_buckets = -(-30 // n) * n
        assert hs.params.shape == (3, n_buckets // n, D)
        np.testing.assert_array_equal(
            hs.aux[0].numpy(), jbl.mach_hashes(N, n_buckets, n_rep=3,
                                               seed=int(impl == "csoft")))
    assert head.aux_spec() == ("replicated",)
    assert not head.params_are_class_weights
    if n == 2:    # 30 buckets divide a ring of 2 as they do a ring of 1
        g = torch.Generator().manual_seed(4)
        whole = head.init(g, 1, rank=0, device="cpu").params
        assert torch.equal(torch.cat(blocks, dim=1), whole)
    sd = float(torch.cat(blocks, dim=1).std())
    assert abs(sd - D ** -0.5) < 0.1 * D ** -0.5


def test_mach_single_device_matches_jax():
    """``mach_loss`` and ``mach_predict`` on the same head equal the JAX
    package's; ``init_mach`` makes its hash tables."""
    f, y, _ = _problem()
    w, hashes = _sketch()
    jh = jbl.MACHHead(jnp.asarray(hashes), jnp.asarray(w))
    th = tbl.MACHHead(torch.from_numpy(hashes), torch.from_numpy(w))
    np.testing.assert_allclose(
        tbl.mach_loss(th, torch.from_numpy(f), torch.from_numpy(y)).numpy(),
        np.asarray(jbl.mach_loss(jh, jnp.asarray(f), jnp.asarray(y))), **TOL)
    np.testing.assert_array_equal(
        tbl.mach_predict(th, torch.from_numpy(f)).numpy(),
        np.asarray(jbl.mach_predict(jh, jnp.asarray(f))))
    # the single-device init: the JAX package's tables, W ~ N(0, 1/D)
    t0 = tbl.init_mach(torch.Generator().manual_seed(0), 4096, 64,
                       n_buckets=N_BUCKETS, n_rep=R_MACH, seed=1)
    j0 = jbl.init_mach(jax.random.PRNGKey(0), 4096, 64, n_buckets=N_BUCKETS,
                       n_rep=R_MACH, seed=1)
    np.testing.assert_array_equal(t0.hashes.numpy(), np.asarray(j0.hashes))
    assert t0.w.shape == j0.w.shape
    assert abs(float(t0.w.std()) - 64 ** -0.5) < 0.01


def _mach_shard_gates(passes):
    """The dense CE gates at MACH's shapes cut to size: f a batch of 256
    of the port's feature stream (norms ~4.6; MACH does not normalise),
    one repetition's 8,192 buckets ~ N(0, 1/D), D = 512, scale 1, limit =
    B; the plain versions with their products emulated in ``passes``xTF32,
    the backward with the loss's cotangents."""
    from repro_torch.data.synthetic import (ClassificationStream,
                                            sku_feature_batch)
    from repro_torch.kernels import ce_softmax as tce
    b, v, d = 256, 8192, 512
    batch = sku_feature_batch(0, b, ClassificationStream(4096, d))
    f = batch["features"].float()
    g = torch.Generator().manual_seed(5)
    w = torch.randn((v, d), generator=g) / d ** 0.5
    y = torch.randint(0, v, (b,), generator=g, dtype=torch.int32)
    ref = tce.ce_forward_plain(f, w, y, v, 1.0)
    m, z = ref[0], ref[1]
    gz, gc = 1.0 / (b * z), torch.full_like(z, -1.0 / b)
    fwd = testing.ce_forward_gate(
        testing.ce_forward_tf32(f, w, y, v, 1.0, passes), ref, f, w, v, 1.0)
    bwd = testing.ce_backward_gate(
        *testing.ce_backward_tf32(f, w, y, m, gz, gc, v, 1.0, passes),
        *tce.ce_backward_plain(f, w, y, m, gz, gc, v, 1.0), y)
    return fwd, bwd


def test_ce_gates_at_the_mach_shard():
    """At MACH's scale 1 and unnormalised features the CE kernels' 3xTF32
    products still pass the gates that chip_smoke.py holds them to there,
    with room, and plain TF32 products still fail both: the forward's m
    (and corr, z) and every part of the backward."""
    fwd, bwd = _mach_shard_gates(3)
    assert fwd["ok"] and bwd["ok"], (fwd, bwd)
    assert fwd["m_corr_err"] < testing.CE_ATOL / 10
    assert all(r < testing.CE_BWD_TOL / 2 for _, r in bwd["parts"].values())
    fwd, bwd = _mach_shard_gates(1)
    assert "m" in fwd["failed"], fwd
    assert set(bwd["failed"]) == {"df", "dW label rows", "dW other rows"}


# ---------------------------------------------------------------------------
# the JAX side of the ring tests
# ---------------------------------------------------------------------------

SEL_SPEC = {"accuracy": P(), "logz": P(), "active_frac": P(),
            "label_recall": P()}
BASE_SPEC = {"accuracy": P(), "logz": P()}
SAMP_SPEC = {"accuracy": P(), "logz": P(), "sample_frac": P()}
# (kind, variant): variant is the sampled distribution, or the selective
# active set ("trunc": m_local below the candidates; "pad": above them)
BODY_CASES = ([("selective", v) for v in ("trunc", "pad")] + [("mach", "")]
              + [("sampled", d) for d, _ in SAMPLED])


def _sel_m(n, variant):
    return _m_local(n) if variant == "trunc" else B + R_LSH * B * CAP + 10


def _jax_value_and_grads(n, loss, in_specs, args, w_spec, metric_spec):
    """One JAX shard_map body's loss, metrics and (W, f) gradients on a
    mesh of n host devices."""
    mesh = jhybrid.make_hybrid_mesh(n)

    def body(f, *rest):
        (l, metrics), (gw, gf) = jax.value_and_grad(
            lambda w_, f_: loss(f_, w_, *rest[1:]), (0, 1), has_aux=True)(
                rest[0], f)
        return l, metrics, gw, gf[None]

    fn = jax.shard_map(
        body, mesh=mesh, in_specs=in_specs,
        out_specs=(P(), dict(metric_spec), w_spec,
                   P(jhybrid.AXIS, None, None)), check_vma=False)
    with jax.set_mesh(mesh):
        loss_v, metrics, gw, gf = jax.device_get(jax.jit(fn)(*args))
    return {"loss": loss_v, **metrics, "grad": gw, "grad_f": gf}


def _jax_body(n, kind, variant, jb):
    f, y, w = _problem()
    ax = jhybrid.AXIS
    if kind == "selective":
        planes, offsets, classes = _lsh(n)

        def loss(f_, w_, y_, pl, off, cl):
            return jbl.selective_softmax_local(
                f_, y_, w_, pl, off, cl, model_axis=ax, batch_axes=(),
                global_batch=B, m_local=_sel_m(n, variant), cap=CAP,
                cosine_scale=16.0, backend=jb, block_a=8)
        return _jax_value_and_grads(
            n, loss, (P(), P(ax, None), P(), P(), P(ax, None, None),
                      P(ax, None, None)),
            (f, w, y, planes, offsets, classes), P(ax, None), SEL_SPEC)
    if kind == "mach":
        wm, hashes = _sketch()

        def loss(f_, w_, y_, h):
            return jbl.mach_softmax_local(
                f_, y_, w_, h, model_axis=ax, batch_axes=(), global_batch=B,
                backend=jb, block_v=8)
        return _jax_value_and_grads(
            n, loss, (P(), P(None, ax, None), P(), P()),
            (f, wm, y, hashes), P(None, ax, None), BASE_SPEC)
    n_samples = dict(SAMPLED)[variant]

    def loss(f_, w_, y_, st):
        return jbl.sampled_softmax_local(
            f_, y_, w_, model_axis=ax, batch_axes=(), global_batch=B,
            n_samples=n_samples, distribution=variant, seed=17,
            cosine_scale=16.0, step=st, backend=jb, block_a=8)
    return _jax_value_and_grads(
        n, loss, (P(), P(ax, None), P(), P()),
        (f, w, y, jnp.int32(STEP)), P(ax, None), SAMP_SPEC)


def _jax_predict(n):
    """mach_predict_local and csoft_predict_local (min, mean) on a mesh of
    n: [b] class ids each."""
    f = _problem()[0]
    w, hashes = _sketch()
    mesh = jhybrid.make_hybrid_mesh(n)
    ax = jhybrid.AXIS

    def body(f_, w_, h):
        return {"mach": jbl.mach_predict_local(f_, w_, h, model_axis=ax),
                **{f"csoft_{agg}": jbl.csoft_predict_local(
                    f_, w_, h, model_axis=ax, agg=agg)
                   for agg in ("min", "mean")}}

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(None, ax, None),
                                                  P()),
                       out_specs={k: P() for k in ("mach", "csoft_min",
                                                   "csoft_mean")},
                       check_vma=False)
    with jax.set_mesh(mesh):
        return {k: np.array(v) for k, v in
                jax.device_get(jax.jit(fn)(f, w, hashes)).items()}


@functools.lru_cache(maxsize=None)
def jax_results():
    return {n: {"bodies": {(kind, variant, tb): _jax_body(n, kind, variant,
                                                         jb)
                           for kind, variant in BODY_CASES
                           for jb, tb in BACKENDS},
                "predict": _jax_predict(n)}
            for n in RINGS}


# ---------------------------------------------------------------------------
# the port's side: one ring per ring size runs every case
# ---------------------------------------------------------------------------


def _port_case(n, kind, variant, tb):
    f, y, w = _problem()
    if kind == "selective":
        return ("head_loss_body", ("selective", f, y, w, _lsh(n)),
                dict(backend=tb, m_local=_sel_m(n, variant), cap=CAP,
                     cosine_scale=16.0))
    if kind == "mach":
        wm, hashes = _sketch()
        return ("head_loss_body", ("mach", f, y, wm, hashes),
                dict(backend=tb))
    return ("head_loss_body", ("sampled", f, y, w,
                               _jax_draws(n, variant, dict(SAMPLED)[variant])),
            dict(backend=tb, cosine_scale=16.0))


RING_BODIES = [(kind, variant, tb) for kind, variant in BODY_CASES
               for _, tb in BACKENDS]


@pytest.fixture(scope="module")
def port_results():
    """Every ring's cases. The spawned rings run while this process makes
    the JAX references; the ring of one (in this process) comes last."""
    f, y, w = _problem()
    wm, hashes = _sketch()
    cases = {}
    for n in RINGS:
        cases[n] = [_port_case(n, *c) for c in RING_BODIES]
        cases[n] += [("sketch_predict", (f, wm, hashes), {})]
        cases[n] += [("sampled_full_draw", (f, y, w), dict(backend=tb))
                     for _, tb in BACKENDS]
        cases[n] += [("sampled_draws", (y,), dict(
            v_loc=N // n, n_samples=48, seed=17, steps=(0, STEP)))]
    with concurrent.futures.ThreadPoolExecutor(len(RINGS)) as pool:
        rings = {n: pool.submit(dist.spawn_ring, testing.run_all, n,
                                cases[n]) for n in RINGS if n > 1}
        jax_results()
        if 1 in RINGS:
            rings[1] = pool.submit(dist.spawn_ring, testing.run_all, 1,
                                   cases[1])
        res = {}
        for n in RINGS:
            per_rank = rings[n].result()
            k = len(RING_BODIES)
            res[n] = {"bodies": [dict(zip(RING_BODIES, r[:k]))
                                 for r in per_rank],
                      "predict": per_rank[0][k],
                      "full_draw": dict(zip([tb for _, tb in BACKENDS],
                                            per_rank[0][k + 1:k + 3])),
                      "draws": [r[k + 3] for r in per_rank]}
    return res


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("kind,variant,backend", RING_BODIES)
def test_head_body_matches_jax(port_results, n, kind, variant, backend):
    """Loss, every metric and the W and f gradients of each member's body
    equal the shard_map body's (the JAX ``pallas`` branch against the
    port's ``kernel`` one); every member returns the same loss. Selective:
    every label in its active set (label_recall 1), the padded case with
    invalid columns (active_frac below 1). Sampled: the JAX package's draw
    injected. MACH: the gradient only on the buckets the batch's labels
    and scores reach, each member on its own block."""
    port = port_results[n]["bodies"][0][(kind, variant, backend)]
    ref = jax_results()[n]["bodies"][(kind, variant, backend)]
    assert set(ref) <= set(port)
    for key in ref:
        np.testing.assert_allclose(port[key], ref[key],
                                   err_msg=f"{key} P={n}", **TOL)
    for member in port_results[n]["bodies"][1:]:
        np.testing.assert_array_equal(member[(kind, variant, backend)]["loss"],
                                      port["loss"])
    if kind == "selective":
        assert port["label_recall"] == 1.0
        assert (port["active_frac"] < 1.0) == (variant == "pad")
    if kind == "sampled":
        assert 0.0 < port["sample_frac"] <= 1.0
    assert np.abs(port["grad"]).max() > 0


def _near_tie_rows(scores, a, b, rel=1e-5):
    """Rows where ids a and b differ but their float64 scores lie within
    ``rel`` of the row's scale (both are the best up to rounding)."""
    rows = np.nonzero(a != b)[0]
    sa = scores[rows, a[rows]]
    sb = scores[rows, b[rows]]
    scale = np.abs(scores[rows]).max(axis=1)
    return rows, np.abs(sa - sb) <= rel * scale


def _sketch_scores(f, w, hashes):
    """float64 class scores of the three decodes [b, N] each."""
    logits = np.einsum("bd,rkd->rbk", f.astype(np.float64),
                       w.astype(np.float64))
    logp = logits - logits.max(-1, keepdims=True)
    logp -= np.log(np.exp(logp).sum(-1, keepdims=True))
    per = np.stack([logp[r][:, hashes[r]] for r in range(len(hashes))])
    return {"mach": np.exp(per).sum(0), "csoft_min": per.min(0),
            "csoft_mean": per.mean(0)}


@pytest.mark.parametrize("n", RINGS)
def test_sketch_predictions_match_jax(port_results, n):
    """``mach_predict_local`` and ``csoft_predict_local`` (min and mean)
    give the JAX package's class ids, except on rows where the two ids'
    float64 scores tie within 1e-5 (reported)."""
    f = _problem()[0]
    w, hashes = _sketch()
    scores = _sketch_scores(f, w, hashes)
    port, ref = port_results[n]["predict"], jax_results()[n]["predict"]
    for key in ("mach", "csoft_min", "csoft_mean"):
        assert port[key].dtype == np.int32 and port[key].shape == (B,)
        rows, tied = _near_tie_rows(scores[key], port[key], ref[key])
        if rows.size:
            print(f"{key} P={n}: near-tie rows {rows.tolist()}")
        assert tied.all(), (key, rows[~tied], port[key][rows],
                            ref[key][rows])
        assert (port[key] == scores[key].argmax(1)).mean() >= 0.9


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("backend", [tb for _, tb in BACKENDS])
def test_sampled_full_draw_is_the_full_softmax(port_results, n, backend):
    """Uniform draws of every class (``n_samples = V``, the port's own
    draw, not injected): the sampled loss and head gradient equal the full
    softmax's, and sample_frac is 1."""
    out = port_results[n]["full_draw"][backend]
    (ls, gs), (lf, gf) = out["sampled"], out["full"]
    np.testing.assert_allclose(ls, lf, **TOL)
    np.testing.assert_allclose(gs, gf, **TOL)
    assert out["sample_frac"] == 1.0


@pytest.mark.parametrize("n", RINGS)
def test_port_draws(port_results, n):
    """The port's own draws: uniform ids distinct and on the member's
    shard, n_samples // P of them, a constant logQ; log_uniform ids the
    same global draw on every member (each keeps the ones it owns, and
    together they cover all of them); the same (seed, step, labels) the
    same draw, and another step or other labels another."""
    draws = port_results[n]["draws"]
    v_loc = N // n
    owned = np.zeros(48, np.int64)
    logq_lu = []
    for member in draws:
        ids, valid, logq, logq_y, frac = member[("uniform", STEP)]
        assert ids.dtype == np.int32 and len(ids) == 48 // n
        assert len(np.unique(ids)) == len(ids)
        assert ids.min() >= 0 and ids.max() < v_loc and valid.all()
        assert np.all(logq == logq[0]) and frac == pytest.approx(48 / N)
        for key in [("uniform", 0), ("log_uniform", 0),
                    ("uniform", STEP), ("log_uniform", STEP)]:
            for a, b in zip(member[key], member[key + ("again",)]):
                np.testing.assert_array_equal(a, b)
        for d, part in (("uniform", 0), ("log_uniform", 2)):   # ids, logq
            for other in (0, "shifted"):
                assert not np.array_equal(member[(d, other)][part],
                                          member[(d, STEP)][part])
        ids, valid, logq, _, frac = member[("log_uniform", STEP)]
        owned += valid
        logq_lu.append(logq)
        assert ids.min() >= 0 and ids.max() < v_loc
        assert frac == pytest.approx(48 / N)
    assert np.all(owned == 1)         # each draw owned by exactly one member
    for logq in logq_lu[1:]:
        np.testing.assert_array_equal(logq, logq_lu[0])
    if n > 1:   # the uniform draw folds in the member's index
        assert not all(np.array_equal(draws[0][("uniform", STEP)][0],
                                      m[("uniform", STEP)][0])
                       for m in draws[1:])
