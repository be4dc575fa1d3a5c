"""The grid's layout against the JAX package's, and the dry run on the
production grids, on the CPU, in shapes only.

* ``train.gspmd.param_pspecs`` equals the JAX ``param_pspecs`` leaf for
  leaf (each spec a tuple of mesh-axis entries against the JAX
  ``PartitionSpec``'s entries), for every ``ARCH_IDS`` entry at full width
  under ``make_host_parallel_config(2, 4)``, ``make_parallel_config()``
  (16 x 16, FSDP) and ``make_parallel_config(multi_pod=True)``: the JAX
  side through ``jax.eval_shape``, the port's through
  ``lm.abstract_model``. Exact.
* ``dist.grid`` on a (2, 2) gloo grid: each axis's index, ``psum`` over
  ``data``, ``model`` and the whole grid, the all-gather over (data,
  model) in the JAX device order, ``ppermute`` on the model axis, and the
  backward rules (``psum``'s a psum, the gather's a reduce-scatter,
  ``psum_invariant``'s the identity). Exact.
* ``launch.dryrun.lower_one`` on ``16x16`` and ``2x16x16`` returns records
  for the dense, vlm and moe families, kimi-K2 at full width (depth cut)
  among them: member (0, 0)'s argument bytes equal its params' blocks by
  ``param_pspecs`` (with the SGD momentum in training) plus its data
  shard's inputs, exactly; so does every family the grid once refused
  (mamba2-370M, hymba-1.5B, whisper-tiny, their frames counted).
* ``lower_one`` of those three at the reduced width on ``"2x2"`` equals
  a real step of member (0, 0) of a (2, 2) gloo grid in its collectives,
  by kind, bytes and count, exactly.
"""
import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.train import gspmd as jgspmd
from repro_torch import dist, testing
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.train import gspmd as tgspmd

CONFIGS = {
    "host2x4": (lambda m: m.make_host_parallel_config(2, 4)),
    "16x16": (lambda m: m.make_parallel_config()),
    "2x16x16": (lambda m: m.make_parallel_config(multi_pod=True)),
}


def _leaves(tree, kind):
    return {jax.tree_util.keystr(k): tuple(v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, kind))[0]}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("arch", tbase.ARCH_IDS)
def test_param_pspecs_match_jax(arch, config):
    want = _leaves(jgspmd.param_pspecs(jbase.get_model_config(arch),
                                       CONFIGS[config](jmesh)), P)
    got = _leaves(tgspmd.param_pspecs(tbase.get_model_config(arch),
                                      CONFIGS[config](tmesh)), tuple)
    assert got == want


def test_grid_collectives_and_their_gradients():
    members = dist.spawn_grid(testing.run_all, 2, 2,
                              [("grid_collectives", (), {})])
    for r, (out,) in enumerate(members):
        d, m = divmod(r, 2)
        assert out["index"] == (d, m)
        assert out["sums"] == (float(m + (2 + m)), float(2 * d * 2 + 1), 6.0)
        assert out["gather"].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert out["grad"] == 2 + 2 * 2 + 3 * 4 + 4
        assert out["shift"] == float(d * 2 + (m - 1) % 2)
        assert out["invariant_grad"] == float(m + 1)


def _member_bytes(cfg, par, grid, rows, seq, train):
    """Member (0, 0)'s params (fp32, and SGD's momentum in training) by
    ``param_pspecs``, and its rows of tokens (and labels) in int32."""
    specs = tgspmd.param_pspecs(cfg, par)
    whole = lm.params_tree(lm.abstract_model(cfg))
    sizes = dict(zip(dist.AXES, grid))
    n = 0
    for leaf, spec in zip(jax.tree.leaves(whole), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, tuple))):
        numel = leaf.numel()
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                numel //= sizes[a]
        n += numel * 4
    return n * (2 if train else 1) + rows * seq * 4 * (2 if train else 1)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["smollm_135m", "chameleon_34b",
                                  "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b"])
def test_lower_one_on_the_production_grids(arch, mesh):
    """A train step (member (0, 0), FSDP, remat) at full width with its
    depth cut to one layer, 64 rows of 256 tokens: the record names the
    grid, the member's rows are the batch over its data shards, its
    argument bytes its blocks' exactly; a prefill and a decode step run."""
    grid = (1,) * (3 - len(mesh.split("x"))) + tuple(
        int(x) for x in mesh.split("x"))
    rec = dryrun.lower_one(arch, "train_4k", mesh=mesh, n_layers=1,
                           batch=64, seq=256)
    assert rec["mesh"] == mesh and rec["mode"] == "train"
    rows = 64 // (grid[0] * grid[1])
    assert rec["member_rows"] == rows and rec["n_micro"] == 1
    cfg = tbase.pad_vocab(tbase.get_model_config(arch).__class__(
        **{**tbase.get_model_config(arch).__dict__, "n_layers": 1}), 128)
    par = tmesh.make_parallel_config(multi_pod=grid[0] > 1)
    assert rec["memory"]["argument_bytes"] == _member_bytes(
        cfg, par, grid, rows, 256, True)
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]
    assert rec["counted"]["flops"] > 0
    for shape in ("prefill_32k", "decode_32k"):
        r = dryrun.lower_one(arch, shape, mesh=mesh, n_layers=1, batch=32,
                             seq=512)
        assert r["mesh"] == mesh and r["memory"]["peak_bytes"] > 0


FAMILIES = ["mamba2_370m", "hymba_1_5b", "whisper_tiny"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_one_refuses_the_families_not_split_yet(arch):
    """The ssm, hybrid and encdec families, which the grid once refused,
    lower now on 16 x 16 (member (0, 0), FSDP, remat) at full width with
    the depth cut to one layer: member (0, 0)'s argument bytes are its
    blocks by ``param_pspecs`` plus its data shard's inputs exactly (with
    whisper's frames); a prefill and a decode step run. None is refused."""
    rec = dryrun.lower_one(arch, "train_4k", mesh="16x16", n_layers=1,
                           batch=32, seq=64)
    assert rec["mesh"] == "16x16" and rec["member_rows"] == 2
    cfg = tbase.pad_vocab(tbase.get_model_config(arch).__class__(
        **{**tbase.get_model_config(arch).__dict__, "n_layers": 1}), 128)
    frames = (2 * cfg.enc_seq * cfg.d_model * 2 if cfg.family == "encdec"
              else 0)
    assert rec["memory"]["argument_bytes"] == _member_bytes(
        cfg, tmesh.make_parallel_config(), (1, 16, 16), 2, 64,
        True) + frames
    for shape in ("prefill_32k", "decode_32k"):
        r = dryrun.lower_one(arch, shape, mesh="16x16", n_layers=1,
                             batch=32, seq=64)
        assert r["memory"]["peak_bytes"] > 0


@pytest.fixture(scope="module")
def grid_counts():
    """The collectives of one real train step of each reduced family on
    every member of a (2, 2) gloo grid."""
    return [r[0] for r in dist.spawn_grid(
        testing.run_all, 2, 2, [("grid_step_collectives", (FAMILIES,),
                                 dict(batch=8, seq=16))])]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_one_of_the_families_is_a_real_members_step(grid_counts,
                                                          arch, monkeypatch):
    """``lower_one`` at the reduced config on ``"2x2"`` (the host policy,
    remat, the full head on ``ref``) against a direct run of the same
    step on a (2, 2) gloo grid: the simulated member's collectives equal
    every real member's by kind, bytes and count, exactly, and its
    argument bytes are its blocks plus its rows. The record splits the
    ssm mixer, the hybrid block and the encoder-decoder as the live grid
    does."""
    monkeypatch.setattr(dryrun, "get_model_config",
                        lambda a: tbase.get_model_config(a, True))
    rec = dryrun.lower_one(arch, "train_4k", mesh="2x2", batch=8, seq=16,
                           backend="ref")
    i = FAMILIES.index(arch)
    for member in grid_counts:
        assert member[i] == rec["collectives"]
    cfg = tbase.pad_vocab(tbase.get_model_config(arch, True), 128)
    if cfg.family != "encdec":    # the ssm mixer's gathered columns
        assert rec["collectives"]["all-gather"]["count"] > 0
    frames = (4 * cfg.enc_seq * cfg.d_model * 2 if cfg.family == "encdec"
              else 0)
    assert rec["memory"]["argument_bytes"] == _member_bytes(
        cfg, tmesh.make_host_parallel_config(2, 2), (1, 2, 2), 4, 16,
        True) + frames


def test_lower_deep_is_the_direct_lowering():
    """``lower_deep``'s extrapolation from 1 and 2 layers equals the
    direct lowering of SmolLM-135M's 30 layers on 16 x 16 (64 rows of 256
    tokens): argument bytes, peak, counted work and collectives, exactly."""
    deep = dryrun.lower_deep("smollm_135m", "train_4k", mesh="16x16",
                             batch=64, seq=256)
    direct = dryrun.lower_one("smollm_135m", "train_4k", mesh="16x16",
                              batch=64, seq=256)
    assert deep["n_layers"] == direct["n_layers"] == 30
    assert deep["extrapolated_from"] == [1, 2]
    for key in ("memory", "counted", "collectives", "n_params"):
        assert deep[key] == direct[key], key
