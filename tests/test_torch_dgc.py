"""The port's DGC (``core/sparsify.py``, ``ops.topk_threshold``) against the
JAX package, on the CPU.

* thresholds: ``topk_threshold_ref``, ``topk_threshold_dc`` and
  ``ops.topk_threshold`` (stage 1 on ``stage1_topk``'s plain version here)
  against JAX's ``ref`` and ``pallas`` (interpret mode) thresholds, exact;
* grouping: the ResNet-50 trunk's 160 leaves in ``jax.tree.flatten``'s
  order pack into the JAX package's 26 groups of 4 MiB;
* ``dgc_exchange`` on injected gradients over 3 rounds with the state
  carried, on both of the port's backends, factor masking on and off, at
  rings of 1, 2 and 4 gloo processes, against the JAX exchange under
  ``shard_map`` (psum over the ring): thresholds and masks exact, the
  update, u and v within 1e-6 of their max, the wire accounting equal;
* the port's own properties, mirroring ``tests/test_sparsify_fccs.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import sku100m_resnet as jax_sku
from repro.configs.base import DGCConfig as JaxDGCConfig
from repro.core import sparsify as jsp
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.configs import sku100m_resnet
from repro_torch.configs.base import DGCConfig
from repro_torch.core import sparsify as sp
from repro_torch.kernels import ops
from repro_torch.models import resnet
from repro_torch.optim import tree_leaves, tree_map
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2, 4)
ROUNDS = 3
# small groups and chunks so one tree runs every regime: groups no longer
# than a chunk (a plain sort), k below a chunk, and k past it (whole chunks
# survive stage 1). Momentum 0.5 makes momentum * u exact, so u is the
# same bits whether or not it is taken as one fused multiply-add (which
# XLA does in some of the jitted step's fusions and not in others): then
# every threshold and mask is exact. At momentum 0.9 (MOMENTUM_09) u may
# differ in its last bit, and so may a threshold; the masks may then
# differ at entries within that bit of it, which the test counts.
EXCHANGE = dict(sparsity=0.95, momentum=0.5, chunk=128, group_bytes=4096)
UPDATE_TOL = 1e-6


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------

def _abs_values(n, seed, ties=False):
    x = np.abs(np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)
    return np.round(x * 8) / 8 if ties else x


@pytest.mark.parametrize("n,k,chunk,ties", [
    (5000, 1, 128, False), (5000, 7, 128, False), (5000, 100, 128, False),
    (5000, 129, 128, False), (5000, 4999, 128, False), (100, 7, 128, False),
    (5000, 50, 128, True), (6144, 6, 2048, False)])
def test_thresholds_match_jax(n, k, chunk, ties):
    x = _abs_values(n, n + k, ties)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ref = float(jsp.topk_threshold_ref(jx, min(k, n)))
    assert float(jsp.topk_threshold_dc(jx, k, chunk=chunk)) == ref
    assert float(sp.topk_threshold_ref(tx, min(k, n))) == ref
    assert float(sp.topk_threshold_dc(tx, k, chunk=chunk)) == ref
    assert float(ops.topk_threshold(tx, k, chunk=chunk)) == ref


@pytest.mark.parametrize("n,k,chunk", [(5000, 7, 128), (2000, 100, 128),
                                       (300, 299, 64)])
def test_threshold_matches_the_pallas_kernel(n, k, chunk):
    """``ops.topk_threshold`` (the plain stage 1 here, the kernel on a card)
    gives the Pallas kernel's threshold (interpret mode) bit for bit."""
    x = _abs_values(n, 3 * n + k)
    pallas = float(jops.topk_threshold(jnp.asarray(x), k, chunk=chunk))
    assert float(ops.topk_threshold(torch.from_numpy(x), k,
                                    chunk=chunk)) == pallas


# ---------------------------------------------------------------------------
# grouping in the JAX package's leaf order
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _resnet50_leaves():
    """(JAX leaf shapes, the port's) of the FE tree of config_1m's trunk,
    the head popped as ``hybrid.init_state`` does."""
    tree = jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0),
                                                 jax_sku.config_1m()))
    tree.pop("head")
    jax_leaves = [tuple(a.shape) for a in jax.tree.leaves(tree)]
    gen = torch.Generator().manual_seed(0)
    fe = {"trunk": resnet.init_resnet(gen, sku100m_resnet.config_1m())}
    port = sp.flatten(fe)[0]
    return jax_leaves, port, fe


def test_resnet50_groups_match_jax():
    jax_leaves, port, _ = _resnet50_leaves()
    assert [tuple(t.shape) for t in port] == jax_leaves
    assert len(port) == 160
    assert sum(t.numel() for t in port) == 24_556_608
    group_bytes = DGCConfig().group_bytes
    jgroups = jsp.group_leaves([np.empty(s, np.int8) for s in jax_leaves],
                               group_bytes)
    groups = sp.group_leaves(port, group_bytes)
    assert groups == jgroups and len(groups) == 26
    sizes = sorted(sum(port[i].numel() for i in g) for g in groups)
    # four small groups (k = 6 to 10), 18 of 0.52M to 1.05M entries, and
    # four whose k passes the chunk, so that stage 1 keeps whole chunks
    assert sizes[:4] == [6144, 6272, 9408, 10240]
    assert 524_288 <= sizes[4] and sizes[21] == 1_048_576
    assert sizes.count(1_048_576) == 6
    assert sizes[-4:] == [2_097_152] + [2_359_296] * 3
    # every group is longer than a chunk: one stage1_topk launch each
    assert min(sizes) > DGCConfig().chunk


def test_insertion_order_would_group_otherwise():
    """The port's generic ``tree_leaves`` follows insertion order; in the
    JAX init's insertion order the same leaves make other groups, which is
    why the exchange flattens in sorted-key order."""
    _, port, fe = _resnet50_leaves()
    order = ("stem", "gn_stem", "blocks", "head_w")
    blk_order = ("conv1", "gn1", "conv2", "gn2", "conv3", "gn3", "proj",
                 "gn_proj")

    def jax_insertion(node):
        if isinstance(node, dict):
            keys = [k for k in order + blk_order + ("scale", "bias")
                    if k in node] or list(node)
            return {k: jax_insertion(node[k]) for k in keys}
        if isinstance(node, list):
            return [jax_insertion(v) for v in node]
        return node

    insertion = tree_leaves(jax_insertion(fe["trunk"]))
    groups = sp.group_leaves(insertion, DGCConfig().group_bytes)
    assert len(groups) == 31
    assert sp.flatten(jax_insertion(fe))[0][0] is port[0]


def test_flatten_roundtrip_keeps_structure():
    tree = {"b": [torch.ones(2), {"z": torch.zeros(3), "a": torch.ones(1)}],
            "a": torch.full((2,), 2.0), "n": None}
    leaves, unflatten = sp.flatten(tree)
    assert [t.tolist() for t in leaves] == [[2.0, 2.0], [1.0, 1.0], [1.0],
                                            [0.0, 0.0, 0.0]]
    back = unflatten([t + 1 for t in leaves])
    assert list(back) == ["a", "b", "n"] and back["n"] is None
    assert back["b"][1]["a"].tolist() == [2.0]
    assert back["b"][1]["z"].tolist() == [1.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# the exchange at rings of 1, 2 and 4
# ---------------------------------------------------------------------------


def _grad_tree(rng, scale):
    """A small trunk-shaped gradient tree, keys inserted out of order."""
    def g(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"trunk": {
        "stem": g(7, 7, 3, 8), "gn_stem": {"scale": g(8), "bias": g(8)},
        "blocks": [{"conv1": g(1, 1, 8, 4), "gn1": {"scale": g(4),
                                                      "bias": g(4)},
                    "conv2": g(3, 3, 4, 4), "proj": g(1, 1, 8, 16)},
                   {"conv2": g(3, 3, 16, 16), "conv1": g(1, 1, 16, 16)}],
        "head_w": g(64, 64)}}


def _grads(n):
    """ROUNDS rounds of one gradient tree per member."""
    rng = np.random.default_rng(100 + n)
    return [[_grad_tree(rng, 1.0 + 0.5 * r + 0.25 * m) for m in range(n)]
            for r in range(ROUNDS)]


def _jax_rounds(grads, n, factor_masking, momentum=EXCHANGE["momentum"]):
    """The JAX exchange on a mesh of n, the state carried over the rounds
    inside one shard_map body; each group's threshold captured from the
    selection it runs."""
    cfg = JaxDGCConfig(enabled=True, factor_masking=factor_masking,
                       **{**EXCHANGE, "momentum": momentum})
    captured = []

    def topk(x, k):
        t = jsp.topk_threshold_dc(x, k, chunk=cfg.chunk)
        captured.append(t)
        return t

    def body(stacked):
        gs = [jax.tree.map(lambda a: a[0], g) for g in stacked]
        st = jsp.init_dgc_state(gs[0])
        outs = []
        for g in gs:
            captured.clear()
            upd, st, info = jsp.dgc_exchange(
                g, st, cfg, batch_axes=(jhybrid.AXIS,), n_workers=n,
                topk_fn=topk)
            row = {"update": upd, "u": st.u, "v": st.v,
                   **info, "thresholds": jnp.stack(captured)}
            outs.append(jax.tree.map(lambda a: a[None], row))
        return outs

    mesh = jhybrid.make_hybrid_mesh(n)
    stacked = [jax.tree.map(lambda *xs: np.stack(xs), *rnd) for rnd in grads]
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(jhybrid.AXIS),),
                               out_specs=P(jhybrid.AXIS), check_vma=False))
    with jax.set_mesh(mesh):
        return jax.device_get(fn(stacked))


FM = (True, False)
BACKENDS = ("ref", "kernel")


@functools.lru_cache(maxsize=None)
def jax_exchanges():
    res = {(n, fm): _jax_rounds(_grads(n), n, fm) for n in RINGS
           for fm in FM}
    res["m09"] = _jax_rounds(_grads(2), 2, True, 0.9)
    return res


@pytest.fixture(scope="module")
def port_exchanges():
    res = {}
    for n in RINGS:
        keys = [(fm, b) for fm in FM for b in BACKENDS]
        cases = [("dgc_rounds", (_grads(n),),
                  dict(dgc_cfg=dict(enabled=True, factor_masking=fm,
                                    backend=b, **EXCHANGE)))
                 for fm, b in keys]
        if n == 2:
            cases.append(("dgc_rounds", (_grads(n),), dict(dgc_cfg=dict(
                enabled=True, backend="kernel",
                **{**EXCHANGE, "momentum": 0.9}))))
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        for i, key in enumerate(keys):
            res[(n,) + key] = [per_rank[r][i] for r in range(n)]
        if n == 2:
            res["m09"] = [per_rank[r][-1] for r in range(n)]
    return res


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    scale = float(np.abs(b).max()) or 1.0
    assert float(np.abs(a - b).max()) <= UPDATE_TOL * scale, what


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("fm", FM)
@pytest.mark.parametrize("backend", BACKENDS)
def test_exchange_matches_jax(port_exchanges, n, fm, backend):
    ref = jax_exchanges()[(n, fm)]
    n_groups = len(sp.group_leaves(
        tree_leaves(tree_map(torch.from_numpy, _grads(1)[0][0])),
        EXCHANGE["group_bytes"]))
    for r, rounds in enumerate(port_exchanges[(n, fm, backend)]):
        for i, port in enumerate(rounds):
            jr = jax.tree.map(lambda a: a[r], ref[i])
            what = f"P={n} rank {r} round {i} fm={fm} {backend}"
            assert port["thresholds"].shape == (n_groups,)
            np.testing.assert_array_equal(port["thresholds"],
                                          jr["thresholds"], err_msg=what)
            for key in ("update", "u", "v"):
                pl, jl = sp.flatten(port[key])[0], jax.tree.leaves(jr[key])
                assert len(pl) == len(jl) == 11
                for a, b in zip(pl, jl):
                    _close(a, b, f"{key} {what}")
            # the mask: the entries the residual zeroed
            for a, b in zip(sp.flatten(port["v"])[0],
                            jax.tree.leaves(jr["v"])):
                np.testing.assert_array_equal(a == 0, b == 0, err_msg=what)
            for key in ("wire_bytes", "dense_bytes", "compression"):
                assert float(port[key]) == float(jr[key]), f"{key} {what}"


def test_exchange_at_momentum_09_within_a_bit(port_exchanges):
    """At momentum 0.9 the JAX step's u is rounded once or twice depending
    on XLA's fusion: the thresholds agree within an ulp, the update, u and
    v within 1e-6 of their max, and the masks differ only at entries
    within an ulp of the threshold (counted; a handful at most)."""
    ref = jax_exchanges()["m09"]
    flips = 0
    for r, rounds in enumerate(port_exchanges["m09"]):
        for i, port in enumerate(rounds):
            jr = jax.tree.map(lambda a: a[r], ref[i])
            np.testing.assert_array_max_ulp(port["thresholds"],
                                            jr["thresholds"], maxulp=1)
            for key in ("update", "u", "v"):
                for a, b in zip(sp.flatten(port[key])[0],
                                jax.tree.leaves(jr[key])):
                    _close(a, b, f"{key} rank {r} round {i}")
            for a, b in zip(sp.flatten(port["v"])[0],
                            jax.tree.leaves(jr["v"])):
                flips += int(((a == 0) != (b == 0)).sum())
    print(f"momentum 0.9, ring of 2, 3 rounds: {flips} mask flips")
    assert flips <= 4


@pytest.mark.parametrize("n", RINGS)
def test_exchange_backends_agree_bitwise(port_exchanges, n):
    """The two backends select the same entries, so the whole exchange is
    bit-identical between them."""
    for fm in FM:
        for a, b in zip(port_exchanges[(n, fm, "ref")],
                        port_exchanges[(n, fm, "kernel")]):
            for ra, rb in zip(a, b):
                for key in ("update", "u", "v"):
                    for x, y in zip(sp.flatten(ra[key])[0],
                                    sp.flatten(rb[key])[0]):
                        np.testing.assert_array_equal(x, y)


def test_exchange_updates_are_the_ring_mean(port_exchanges):
    """Every member gets the same update: the mean of the members' sent
    entries."""
    for rounds in zip(*port_exchanges[(4, True, "kernel")]):
        first = sp.flatten(rounds[0]["update"])[0]
        for other in rounds[1:]:
            for a, b in zip(first, sp.flatten(other["update"])[0]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port's own properties (tests/test_sparsify_fccs.py)
# ---------------------------------------------------------------------------


def _torch_grads(seed, shapes=((64, 32), (128,), (16, 16, 4))):
    rng = np.random.default_rng(seed)
    return {f"p{i}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
        for i, s in enumerate(shapes)}


@pytest.mark.parametrize("backend", BACKENDS)
def test_first_step_conservation(backend):
    """Step 1: communicated + residual == gradient exactly."""
    g = _torch_grads(0)
    cfg = DGCConfig(enabled=True, sparsity=0.9, momentum=0.9, chunk=64,
                    backend=backend)
    out, st, _ = sp.dgc_exchange(g, sp.init_dgc_state(g), cfg)
    for k in g:
        assert float((out[k] + st.v[k] - g[k]).abs().max()) < 1e-6


@pytest.mark.parametrize("backend", BACKENDS)
def test_sparsity_level(backend):
    g = _torch_grads(1)
    n_total = sum(x.numel() for x in g.values())
    cfg = DGCConfig(enabled=True, sparsity=0.95, chunk=64,
                    group_bytes=1 << 30, backend=backend)
    out, _, info = sp.dgc_exchange(g, sp.init_dgc_state(g), cfg)
    kept = sum(int((x.abs() > 0).sum()) for x in out.values())
    assert kept <= int(n_total * 0.05) + len(g) * 2
    assert float(info["compression"]) > 5.0
    assert float(info["wire_bytes"]) == 8.0 * kept
    assert float(info["dense_bytes"]) == 4.0 * n_total


@pytest.mark.parametrize("backend", BACKENDS)
def test_momentum_factor_masking(backend):
    """Selected coordinates have their momentum buffer zeroed."""
    g = _torch_grads(2)
    cfg = DGCConfig(enabled=True, sparsity=0.8, momentum=0.9, chunk=64,
                    factor_masking=True, backend=backend)
    out, st, _ = sp.dgc_exchange(g, sp.init_dgc_state(g), cfg)
    for k in g:
        sel = out[k].abs() > 0
        assert bool(sel.any())
        assert float(st.u[k][sel].abs().max()) == 0.0


def test_error_feedback_accumulates():
    """A coordinate below threshold is sent once its residual has
    accumulated."""
    cfg = DGCConfig(enabled=True, sparsity=0.75, momentum=0.0, chunk=8,
                    factor_masking=False)
    g = {"p": torch.tensor([1.0, 0.4, 0.3, 0.2])}   # keep 1 of 4
    st = sp.init_dgc_state(g)
    sent = []
    for _ in range(4):
        out, st, _ = sp.dgc_exchange(g, st, cfg)
        sent.append(out["p"].numpy())
    np.testing.assert_allclose(np.sum(sent, axis=0) + st.v["p"].numpy(),
                               4 * g["p"].numpy(), atol=1e-6)
    assert (np.abs(np.sum(sent, axis=0))[1:] > 0).any()


def test_init_dgc_state_is_zero_and_apart():
    p = {"a": torch.ones(3, dtype=torch.float64), "b": [torch.ones(2, 2)]}
    st = sp.init_dgc_state(p)
    for t in tree_leaves(st.u) + tree_leaves(st.v):
        assert t.dtype == torch.float32 and not bool(t.any())
    st.u["a"] += 1
    assert not bool(st.v["a"].any())


def test_dense_exchange_is_the_identity_on_one_member():
    g = _torch_grads(3)
    out = sp.dense_exchange(g, n_workers=1)
    for k in g:
        assert torch.equal(out[k], g[k])


def test_interop_carries_dgc_rows_and_the_nested_trunk():
    """``paper_state_from_numpy`` keeps row ``rank`` of each DGC leaf's
    ring axis and the nested trunk tree (HWIO kernels as they are)."""
    from repro_torch import interop

    rng = np.random.default_rng(9)
    fe = {"trunk": {"blocks": [{"conv1": rng.standard_normal(
        (1, 1, 4, 2)).astype(np.float32)}], "head_w": np.ones((8, 4),
                                                             np.float32)}}
    stacked = jax.tree.map(lambda a: np.stack([a, 2 * a, 3 * a]), fe)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    st = interop.paper_state_from_numpy(
        fe, w, opt_state={"step": 0, "mu": (fe, w), "nu": None},
        dgc={"u": stacked, "v": stacked}, rank=1, world_size=3,
        device="cpu")
    np.testing.assert_array_equal(
        st.dgc.u["trunk"]["blocks"][0]["conv1"].numpy(),
        2 * fe["trunk"]["blocks"][0]["conv1"])
    assert st.fe_params["trunk"]["blocks"][0]["conv1"].shape == (1, 1, 4, 2)
    assert st.opt_state.mu[0]["trunk"]["head_w"].shape == (8, 4)
    assert tuple(st.head_params.shape) == (2, 4)
    with pytest.raises(ValueError, match="ring axis"):
        interop.paper_state_from_numpy(fe, w, dgc={"u": fe, "v": fe},
                                       rank=0, world_size=3, device="cpu")
