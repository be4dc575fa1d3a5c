"""Elastic restores in the port, against the JAX package's, on the CPU.

* ``elastic.plan`` (``plan_reshard``, ``validate_geometry``,
  ``geometry_from_meta``) gives the JAX functions' results and errors on
  the same inputs, and every re-pack of ``elastic.reshard`` gives the JAX
  function's arrays bit for bit on the same numpy arrays;
* a checkpoint of 8 steps under ``rebuild_every=5`` (the knn graph and the
  LSH tables stale by three steps) restores 4->2, 2->4 and 4->3 gloo
  processes for the dense heads (full, knn, selective, sampled): the
  global W, the moments and the FE params bitwise, the knn graph and the
  LSH bucket map exact, and the served top-5 ids exact and scores bitwise
  (per-row dot products merged over the ring: no sum crosses members);
  2->4->2 is the identity;
* the sketch heads (mach, csoft) keep their buckets verbatim while B = 64
  divides the ring (4->2) and re-bucket onto B = 66 for a ring of 3,
  equal to JAX's ``rebucket_sketch``, and train on;
* DGC's residual mass is preserved 4->2;
* a different ring without ``reshard``, or a different class count, raises
  ``ReshardError`` before any leaf is read, and the restore reports its
  reshard span and bytes;
* a JAX checkpoint written on a ring of 4 restores with ``reshard`` into a
  port ring of 2 equal to the JAX package's own 4->2 restore;
* ``elastic_kill_and_recover`` kills a run on a ring of 2 and resumes it
  on a ring of 1.
"""
import concurrent.futures
import functools
import os

import jax
import numpy as np
import pytest
import torch

import repro.elastic as jel
from repro.api import Experiment as JaxExperiment
from repro.configs.base import DGCConfig as JaxDGCConfig
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import knn_graph as jkg
from repro.train import hybrid as jhybrid
from repro_torch import dist, elastic, testing
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.core import baselines as bl
from repro_torch.resilience import elastic_kill_and_recover, tree_compare
from tests.torch_threads import one_thread  # noqa: F401

V, D, B, STEPS = 240, 16, 24, 8
HEAD = dict(backend="ref", knn_k=8, knn_kprime=16, active_frac=0.25,
            rebuild_every=5, sampled_n=64, mach_b=64, mach_r=2, csoft_b=64,
            csoft_r=2)
DENSE = ("full", "knn", "selective", "sampled")
SKETCH = ("mach", "csoft")
MOVES = [(4, 2), (2, 4), (4, 3)]
ROUNDTRIP = ("full", "knn", "selective")
CROSS = ("knn", "selective", "mach")

def _spec(head, dgc=False, trunk="feats", batch=B):
    return {"head": dict(HEAD, softmax_impl=head),
            "train": dict(optimizer="sgd",
                          fccs=dict(eta0=0.5, t_warm=2, b0=batch,
                                    b_min=batch, b_max=2 * batch, t_ini=2,
                                    t_final=8),
                          dgc=dict(enabled=dgc, sparsity=0.95, chunk=512,
                                   backend="ref")),
            "trunk": trunk, "classes": V, "feat_dim": D, "batch": batch,
            "hw": 16, "ckpt_every": 0}


SPECS = {**{h: _spec(h) for h in DENSE + SKETCH},
         "cnn+dgc": _spec("full", dgc=True, trunk="cnn", batch=8)}
QUERIES = testing.numpy_batch(10**6, B, classes=V, dim=D)["features"]


# ---------------------------------------------------------------------------
# plan geometry and the re-packs, against the JAX functions
# ---------------------------------------------------------------------------

GEOMS = [(s, d) for s in (1, 2, 3, 4, 5, 8) for d in (1, 2, 3, 4, 7, 8)]


def _plan_fields(p):
    return (p.n_rows, p.aligned, p.moved_rows, p.describe(),
            [(t.src_shard, t.dst_shard, t.start, t.stop, t.rows)
             for t in p.transfers], p.bytes_moved(64))


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:             # ReshardError in both packages
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("src,dst", GEOMS)
def test_plan_and_geometry_equal_jax(src, dst):
    for rows in (V, 0, None):
        a = _outcome(elastic.plan_reshard,
                     elastic.MeshGeometry(src, src, V),
                     elastic.MeshGeometry(dst, dst, V), rows)
        b = _outcome(jel.plan_reshard, jel.MeshGeometry(src, src, V),
                     jel.MeshGeometry(dst, dst, V), rows)
        assert a[0] == b[0]
        assert (_plan_fields(a[1]) == _plan_fields(b[1]) if a[0] == "ok"
                else a[1] == b[1])
    for classes in (V, 2 * V, 7 * 8 * 9):
        for reshard in (False, True):
            a = _outcome(elastic.validate_geometry,
                         elastic.MeshGeometry(src, src, classes),
                         elastic.MeshGeometry(dst, dst, V), reshard=reshard)
            b = _outcome(jel.validate_geometry,
                         jel.MeshGeometry(src, src, classes),
                         jel.MeshGeometry(dst, dst, V), reshard=reshard)
            assert a == b
    meta = elastic.MeshGeometry(src, src, V).meta()
    assert meta == jel.MeshGeometry(src, src, V).meta()
    for m in (meta, None, {}, {"n_model": src}):
        got = elastic.geometry_from_meta(m, elastic.MeshGeometry(dst, dst, V))
        want = jel.geometry_from_meta(m, jel.MeshGeometry(dst, dst, V))
        assert (got.n_model, got.n_data, got.n_classes) == \
            (want.n_model, want.n_data, want.n_classes)
    a = elastic.analytic_reshard_ledger(
        elastic.MeshGeometry(src, n_classes=V * 56),
        elastic.MeshGeometry(dst), row_bytes=64, n_moment_trees=2)
    b = jel.analytic_reshard_ledger(
        jel.MeshGeometry(src, n_classes=V * 56), jel.MeshGeometry(dst),
        row_bytes=64, n_moment_trees=2)
    assert a.per_kind() == b.per_kind()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n_src,n_dst", MOVES + [(1, 4), (3, 1)])
def test_repacks_equal_jax_bit_for_bit(n_src, n_dst):
    rng = np.random.default_rng(n_src * 10 + n_dst)
    g = rng.integers(0, 24, (24, 5)).astype(np.int32)
    aux = tuple(jkg.compress_graph(g, n_src))
    _same(elastic.decompress_graph(*aux), jel.decompress_graph(*aux))
    for a, b in zip(elastic.repack_knn_aux(aux, n_dst),
                    jel.repack_knn_aux(aux, n_dst)):
        _same(a, b)
    # LSH tables of a random bucket assignment, laid out as the build lays
    # them
    bucket = rng.integers(0, 16, (3, 24))
    v_loc = 24 // n_src
    offs = np.stack([np.stack([np.searchsorted(
        np.sort(bucket[r, p * v_loc:(p + 1) * v_loc], kind="stable"),
        np.arange(17)) for r in range(3)]) for p in range(n_src)]
    ).astype(np.int32)
    cls = np.stack([np.stack([np.argsort(
        bucket[r, p * v_loc:(p + 1) * v_loc], kind="stable")
        for r in range(3)]) for p in range(n_src)]).astype(np.int32)
    planes = rng.standard_normal((3, 4, 4)).astype(np.float32)
    _same(elastic.lsh_bucket_map(offs, cls), jel.lsh_bucket_map(offs, cls))
    _same(elastic.lsh_bucket_map(offs, cls), bucket)
    for a, b in zip(elastic.repack_lsh_aux((planes, offs, cls), n_dst),
                    jel.repack_lsh_aux((planes, offs, cls), n_dst)):
        _same(a, b)
    w = rng.standard_normal((2, 8 * n_src, 4)).astype(np.float32)
    h_old = bl.mach_hashes(24, 8 * n_src, n_rep=2, seed=1)
    h_new = bl.mach_hashes(24, 8 * n_dst + 1, n_rep=2, seed=1)
    _same(elastic.rebucket_sketch(w, h_old, h_new, 8 * n_dst + 1),
          jel.rebucket_sketch(w, h_old, h_new, 8 * n_dst + 1))
    tree = {"a": rng.standard_normal((n_src, 3, 2)).astype(np.float32),
            "b": [rng.standard_normal((n_src, 5)).astype(np.float32)]}
    mine, theirs = (elastic.redistribute_dgc(tree, n_dst),
                    jel.redistribute_dgc(tree, n_dst))
    _same(mine["a"], theirs["a"])
    _same(mine["b"][0], theirs["b"][0])
    rows = np.arange(12, dtype=np.float32).reshape(6, 2)
    _same(elastic.resize_vocab_rows(rows, 6, 4 + n_dst, n_real=4),
          jel.resize_vocab_rows(rows, 6, 4 + n_dst, n_real=4))


# ---------------------------------------------------------------------------
# the port's rings
# ---------------------------------------------------------------------------


def _jax_experiment(name, n, ckpt_dir):
    spec = SPECS[name]
    t = spec["train"]
    return JaxExperiment.from_config(
        system="paper", classes=V, feat_dim=D, batch=B,
        head=JaxHeadConfig(**spec["head"]),
        train=JaxTrainConfig(optimizer=t["optimizer"],
                             fccs=JaxFCCSConfig(**t["fccs"]),
                             dgc=JaxDGCConfig(**t["dgc"])),
        mesh=jhybrid.make_hybrid_mesh(n), ckpt_dir=ckpt_dir,
        ckpt_every=STEPS, log_every=0,
        data_fn=lambda s, b: testing.numpy_batch(s, b, classes=V, dim=D))


def _jax_cross(name, root):
    """A JAX run on a ring of 4 saves at step 8; the JAX package's own
    restore of it onto a ring of 2."""
    ck = os.path.join(root, f"jax4_{name}")
    _jax_experiment(name, 4, ck).fit(STEPS, use_fccs_batch=False)
    dst = _jax_experiment(name, 2, ck)
    assert dst.restore(reshard=True) == STEPS
    return ck, jax.tree.map(np.asarray, jax.device_get(
        dst.trainer._snapshot()))


def _ring(n, cases):
    per_rank = dist.spawn_ring(testing.run_all, n, [c for _, c in cases])
    return {key: per_rank[0][i] for i, (key, _) in enumerate(cases)}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))

    def d(tag):
        return os.path.join(root, tag)

    def src(name, n, steps=STEPS):
        return (("src", name, n),
                ("elastic_source", (SPECS[name], d(f"src{n}_{name}")),
                 dict(steps=steps, queries=_queries(name))))

    def dst(name, frm, n, tag="", **kw):
        return (("dst", name, frm, n, tag),
                ("elastic_restore", (SPECS[name], frm),
                 dict(queries=_queries(name), **kw)))

    with concurrent.futures.ThreadPoolExecutor(len(CROSS)) as pool:
        jax_cross = pool.map(functools.partial(_jax_cross, root=root), CROSS)
        out = _ring(2, [src(h, 2) for h in DENSE])
        out.update(_ring(4, [src(h, 4) for h in DENSE + SKETCH]
                         + [src("cnn+dgc", 4, steps=2)]
                         + [dst(h, d(f"src2_{h}"), 4,
                                save_dir=d(f"mid4_{h}")) for h in DENSE]))
        jax_cross = dict(zip(CROSS, jax_cross))
    out.update(_ring(2, [dst(h, d(f"src4_{h}"), 2)
                         for h in DENSE + SKETCH + ("cnn+dgc",)]
                     + [dst(h, d(f"mid4_{h}"), 2, "back") for h in ROUNDTRIP]
                     + [dst(h, jax_cross[h][0], 2, "jax") for h in CROSS]))
    out.update(_ring(3, [dst(h, d(f"src4_{h}"), 3, train_steps=2)
                         for h in DENSE + SKETCH]))
    return out, jax_cross, d


def _queries(name):
    return None if SPECS[name]["trunk"] == "cnn" else QUERIES


def _bitwise(a, b):
    cmp = tree_compare(a, b)
    assert cmp["bitwise"], cmp["mismatches"]


@pytest.mark.parametrize("src_n,dst_n", MOVES)
@pytest.mark.parametrize("head", DENSE)
def test_dense_elastic_restore(rings, head, src_n, dst_n):
    out, _, d = rings
    a = out[("src", head, src_n)]
    b = out[("dst", head, d(f"src{src_n}_{head}"), dst_n, "")]
    assert b["step"] == STEPS and b["t"] == STEPS
    sa, sb = a["snap"], b["snap"]
    # the global [V, D] rows, the FE params and the moments: re-placement
    _same(sa["head"]["params"], sb["head"]["params"])
    _bitwise({"fe": sa["fe"], "opt": sa["opt"], "extra": sa["extra"]},
             {"fe": sb["fe"], "opt": sb["opt"], "extra": sb["extra"]})
    if head == "knn":
        _same(elastic.decompress_graph(*sa["head"]["aux"]),
              elastic.decompress_graph(*sb["head"]["aux"]))
        assert sb["head"]["aux"][0].shape[0] == dst_n
    if head == "selective":
        _same(sa["head"]["aux"][0], sb["head"]["aux"][0])
        _same(elastic.lsh_bucket_map(*sa["head"]["aux"][1:]),
              elastic.lsh_bucket_map(*sb["head"]["aux"][1:]))
    # served top-5: ids exact; scores bitwise (each a dot product of one
    # row, merged over the ring by a gather)
    _same(a["serve"][0], b["serve"][0])
    _same(a["serve"][1], b["serve"][1])


@pytest.mark.parametrize("head", ROUNDTRIP)
def test_roundtrip_2_4_2_is_the_identity(rings, head):
    out, _, d = rings
    _bitwise(out[("src", head, 2)]["snap"],
             out[("dst", head, d(f"mid4_{head}"), 2, "back")]["snap"])


@pytest.mark.parametrize("head", SKETCH)
def test_sketch_keeps_buckets_while_b_divides_the_ring(rings, head):
    out, _, d = rings
    a = out[("src", head, 4)]
    b = out[("dst", head, d(f"src4_{head}"), 2, "")]
    _bitwise({k: a["snap"][k] for k in ("fe", "head", "opt")},
             {k: b["snap"][k] for k in ("fe", "head", "opt")})
    _same(a["serve"], b["serve"])


@pytest.mark.parametrize("head", SKETCH)
def test_sketch_rebuckets_onto_a_ring_it_does_not_divide(rings, head):
    """B = 64 does not divide 3: the classes are re-hashed with the same
    family at B = 66 and each new bucket takes the mean of its classes'
    old bucket weights, JAX's ``rebucket_sketch``; moments likewise; the
    run trains on."""
    out, _, d = rings
    a = out[("src", head, 4)]["snap"]
    b = out[("dst", head, d(f"src4_{head}"), 3, "")]
    seed = 1 if head == "csoft" else 0
    h_new = bl.mach_hashes(V, 66, n_rep=2, seed=seed)
    _same(b["snap"]["head"]["aux"][0], h_new)
    _same(b["snap"]["head"]["params"], jel.rebucket_sketch(
        a["head"]["params"], a["head"]["aux"][0], h_new, 66))
    _same(b["snap"]["opt"].mu[1], jel.rebucket_sketch(
        a["opt"].mu[1], a["head"]["aux"][0], h_new, 66))
    assert len(b["losses"]) == 2 and np.isfinite(b["losses"]).all()


def test_dgc_mass_is_preserved(rings):
    """4 -> 2 members of the reduced ResNet with DGC: each parameter's
    total pending residual (u and v summed over the members) is the same,
    exactly (a power-of-two split of an fp32 sum), and each new member
    holds half of it."""
    out, _, d = rings
    a = out[("src", "cnn+dgc", 4)]["snap"]["dgc"]
    b = out[("dst", "cnn+dgc", d("src4_cnn+dgc"), 2, "")]["snap"]["dgc"]
    for name in ("u", "v"):
        leaves_a = elastic.reshard.tree_leaves(a[name])
        leaves_b = elastic.reshard.tree_leaves(b[name])
        assert len(leaves_a) == len(leaves_b) > 20
        assert sum(np.abs(x).sum() for x in leaves_a) > 0
        for xa, xb in zip(leaves_a, leaves_b):
            assert xa.shape[0] == 4 and xb.shape[0] == 2
            _same(xa.sum(axis=0), xb.sum(axis=0))
            _same(xb[0], xb[1])


def test_reshard_telemetry(rings):
    out, _, d = rings
    b = out[("dst", "full", d("src4_full"), 2, "")]
    depth = dict(b["spans"])
    assert depth["train.reshard"] == depth["train.restore"] + 1
    assert b["counters"]["reshard.bytes_moved"] > 0
    assert b["counters"]["reshard.bytes_moved"] == \
        b["last_reshard"]["bytes_moved"]
    assert "4->2" in b["last_reshard"]["plan"]


def test_mismatch_raises_before_any_leaf_is_read(rings, monkeypatch):
    """A ring of 1 restoring a ring of 4's checkpoint without ``reshard``,
    or with another class count: ``ReshardError`` from the meta alone."""
    _, _, d = rings

    def no_leaves(*a, **k):
        raise AssertionError("a leaf was read")
    monkeypatch.setattr(ckpt_mod, "restore", no_leaves)
    exp = testing.ckpt_experiment(SPECS["full"], d("src4_full"))
    with pytest.raises(elastic.ReshardError, match="reshard"):
        exp.restore()
    bad = testing.ckpt_experiment(dict(SPECS["full"], classes=2 * V),
                                  d("src4_full"))
    with pytest.raises(elastic.ReshardError, match="classes"):
        bad.restore(reshard=True)
    with pytest.raises(elastic.ReshardError, match="classes"):
        bad.fit(2, resume="reshard")


@pytest.mark.parametrize("name", CROSS)
def test_jax_checkpoint_reshards_into_the_port(rings, name):
    """A JAX checkpoint of a ring of 4, restored with ``reshard`` on a port
    ring of 2, equals the JAX package's own 4->2 restore."""
    out, jax_cross, _ = rings
    ck, want = jax_cross[name]
    got = out[("dst", name, ck, 2, "jax")]
    assert got["step"] == STEPS
    _bitwise(got["snap"], want)


def _elastic_exp(ckpt_dir):
    return testing.ckpt_experiment(dict(SPECS["full"], ckpt_every=4),
                                   ckpt_dir)


def test_elastic_kill_and_recover(tmp_path):
    """Kill on a ring of 2, resume on a ring of 1. The head gradient's
    scale follows the ring size (as in the JAX trainer), so the resumed
    losses follow the reference on the ring of 1 to within ``loss_tol``."""
    rep = elastic_kill_and_recover(
        _elastic_exp, src_ring=2, dst_ring=1, total_steps=8, kill_at=6,
        ckpt_dir=str(tmp_path / "ck"), head="full/2->1",
        fit_kw={"use_fccs_batch": False}, loss_tol=0.15)
    assert rep.restored_step == 4 and rep.steps_replayed == 2
    assert rep.reshard_bytes_moved > 0 and rep.reshard_s > 0
    assert (rep.src_mesh, rep.dst_mesh) == ("ring of 2", "ring of 1")
    assert [r["step"] for r in rep.resumed_history] == [4, 5, 6, 7]
    assert rep.ok, rep.summary()
    assert "reshard" in rep.summary()


def test_default_reshard_leg_reinitializes_aux_and_asks_for_a_refresh():
    """A head with aux and no re-pack rule of its own takes the base
    class's leg: a shape-correct aux for the dst ring from ``init_aux``,
    and ``needs_refresh``; a head without aux passes through."""
    from repro_torch.api.heads import SoftmaxHead, make_head
    from repro_torch.configs.base import HeadConfig

    model = testing.ckpt_experiment(SPECS["knn"]).model_cfg
    knn = make_head(model, HeadConfig(**SPECS["knn"]["head"]))
    tree = {"params": np.zeros((V, D), np.float32), "aux": knn.init_aux(4)}
    src, dst = elastic.MeshGeometry(4, 4, V), elastic.MeshGeometry(3, 3, V)
    out, refresh = SoftmaxHead.reshard_state(knn, tree, src, dst)
    assert refresh and out["params"] is tree["params"]
    for a, b in zip(out["aux"], knn.init_aux(3)):
        _same(a, b)
    assert SoftmaxHead.reshard_state(knn, tree, src, src) == (tree, False)
    full = make_head(model, HeadConfig(**SPECS["full"]["head"]))
    bare = {"params": tree["params"], "aux": ()}
    assert full.reshard_state(bare, src, dst) == (bare, False)
