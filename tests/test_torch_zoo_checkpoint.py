"""The zoo's checkpoints in the port against the JAX package's
``ZooExperiment``, on the CPU.

* across packages: a JAX ``ZooExperiment`` (rebuilt on a (1, n) mesh: the
  port's ring has no data axis) of the reduced SmolLM-135M with each of
  the six heads at rings of 1 and 2, and of the reduced mamba2-370M and
  hymba-1.5B with the full head, trains ``STEPS`` steps and saves; the
  port restores each on a ring of the same size, and its GLOBAL snapshot
  equals the JAX package's bit for bit (``tree_compare``), with the
  cursor of the save; the port saves, and the JAX package ``restore()``s
  a snapshot bitwise equal to its own; the two files' decompressed
  payloads are byte-equal, meta included (``system``, the geometry,
  ``padded_vocab``);
* ``kill_and_recover`` of the port's zoo gives the classes that
  ``tests/test_resilience.py``'s ``ZOO_EQUIVALENCE`` lists for the JAX
  package (every one ``"bitwise"``): kill at 5, restore t=4, one step
  replayed, on a ring of 1 and (the full head) of 2, and on each new
  family;
* elastic restores 4 -> 2 and 2 -> 4 (``reshard_zoo_snapshot``) with the
  full and MACH heads: a plain restore raises ``ReshardError``, the
  resharded model, head and moments are bit-equal to the source's, and
  training goes on (``tests/test_elastic.py``'s zoo test);
  ``reshard_zoo_snapshot`` re-pads the vocab 512 -> 513 (a ring of 3);
* ``fit(resume=True)`` with nothing saved, the cadence and ``ckpt_keep``;
* the train launcher's ``--system zoo --ckpt-dir --ckpt-every 2`` and then
  ``--resume``, and its ``--resume-reshard``.
"""
import concurrent.futures
import contextlib
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import zstandard

from repro.api.heads import HeadState as JaxHeadState
from repro.configs import base as jbase
from repro.resilience import tree_compare as jax_tree_compare
from repro_torch import checkpoint as ckpt
from repro_torch import dist, testing
from repro_torch.elastic import reshard_zoo_snapshot
from repro_torch.launch import train as train_launcher
from repro_torch.resilience import kill_and_recover, tree_compare
from tests.test_torch_zoo_train import jax_zoo_on_ring
from tests.torch_threads import one_thread  # noqa: F401

STEPS = 2
HEAD = dict(backend="ref", knn_k=8, knn_kprime=16, active_frac=0.25,
            rebuild_every=5, sampled_n=64, mach_b=64, mach_r=2, csoft_b=64,
            csoft_r=2)
HEADS = ("full", "knn", "selective", "mach", "sampled", "csoft")
# tests/test_resilience.py's ZOO_EQUIVALENCE
ZOO_EQUIVALENCE = {"full": "bitwise", "knn": "bitwise",
                   "sampled": "bitwise", "csoft": "bitwise"}


def _spec(head, arch="smollm_135m", **kw):
    return {"arch": arch, "head": dict(HEAD, softmax_impl=head),
            "batch": 4, "seq": 8, "ckpt_every": STEPS, **kw}


SPECS = {h: _spec(h) for h in HEADS}
SPECS["mamba2"] = _spec("full", "mamba2_370m")
SPECS["hymba"] = _spec("full", "hymba_1_5b")
CASES = ([(h, n) for h in HEADS for n in (1, 2)]
         + [("mamba2", 2), ("hymba", 1)])


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_zoo(spec, n, ckpt_dir):
    """The JAX ZooExperiment of ``spec`` on a (1, n) mesh."""
    return jax_zoo_on_ring(
        n, arch=spec["arch"], reduced=True, batch=spec["batch"],
        seq=spec["seq"], head=jbase.HeadConfig(**spec["head"]),
        train=jbase.TrainConfig(optimizer="sgd"), ckpt_dir=ckpt_dir,
        ckpt_every=spec["ckpt_every"])


_EXPS: dict = {}       # this process's JAX experiments, by case


def _jax_save(case, root):
    """A JAX experiment's checkpoint at cursor STEPS and its snapshot as
    host arrays. No step is compiled (the compiles would be this file's
    time): the state is the init's params and bucket weights, the head's
    aux refreshed from the class matrix (the knn graph, the LSH tables),
    and moments set to an affine map of the params, so every leaf holds
    its own values and a leaf read into another's place shows."""
    name, n = case
    jdir = os.path.join(root, f"jax_{name}_{n}")
    exp = _jax_zoo(SPECS[name], n, jdir)
    exp.refresh_head()
    exp._ensure_opt()
    with jax.set_mesh(exp.mesh):
        exp.opt_state = exp.opt_state._replace(
            step=exp.opt_state.step + STEPS, mu=jax.tree.map(
                lambda a: 0.5 * a + 0.25,
                (exp.params, exp.head_state.params)))
    exp._t = STEPS
    exp.save_checkpoint()
    _EXPS[case] = exp
    return jdir, _host(exp._snapshot())


def _jax_restore(case, pdir, snap):
    """The JAX package's restore of the port's file under ``pdir`` into
    the experiment that saved ``case`` (kept by this process: building
    another is this file's time), its state wiped first so only the
    restore can bring it back; its snapshot against ``snap``."""
    exp = _EXPS.pop(case)
    with jax.set_mesh(exp.mesh):
        exp.params = jax.tree.map(jnp.zeros_like, exp.params)
        exp.head_state = JaxHeadState(
            jax.tree.map(jnp.zeros_like, exp.head_state.params),
            jax.tree.map(jnp.zeros_like, exp.head_state.aux))
        exp.opt_state = jax.tree.map(jnp.zeros_like, exp.opt_state)
    exp._t = 0
    exp.ckpt_dir = pdir
    step = exp.restore()
    return step, jax_tree_compare(_host(exp._snapshot()), snap)


def _payload(path: str, step: int) -> bytes:
    with open(os.path.join(path, f"ckpt_{step}.msgpack.zst"), "rb") as f:
        raw = f.read()
    if raw[:4] == b"\x28\xb5\x2f\xfd":
        return zstandard.ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


@contextlib.contextmanager
def _jax_processes(n_procs=6):
    """``n_procs`` processes of their own for the JAX package, each its own
    executor (a case's save and restore go to the same one), their XLA
    compiling single-threaded without LLVM's costly passes (the programs
    are tiny; their compiles are this file's time)."""
    import torch
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    pools = [concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
             for _ in range(n_procs)]
    try:
        yield pools
    finally:
        os.environ["XLA_FLAGS"] = flags
        for p in pools:      # their exits overlap the tests that follow
            p.shutdown(wait=False)


@pytest.fixture(scope="module")
def cross(tmp_path_factory, elastic_runs):
    """The JAX saves, the port's restores and saves on one ring per size,
    then the JAX package's restores of the port's files; the elastic
    rings run meanwhile, in a thread."""
    root = str(tmp_path_factory.mktemp("zoo_cross"))
    with _jax_processes() as pools:
        owner = {c: pools[i % len(pools)] for i, c in enumerate(CASES)}
        saves = {c: owner[c].submit(_jax_save, c, root) for c in CASES}
        saved = {c: f.result() for c, f in saves.items()}
        port = {}
        for n in sorted({c[1] for c in CASES}):
            names = [name for name, m in CASES if m == n]
            cases = [("zoo_ckpt_from_jax",
                      (SPECS[name], saved[(name, n)][0],
                       os.path.join(root, f"port_{name}_{n}"),
                       saved[(name, n)][1]), {}) for name in names]
            per_rank = dist.spawn_ring(testing.run_all, n, cases)
            for i, name in enumerate(names):
                port[(name, n)] = [r[i] for r in per_rank]
        backs = {c: owner[c].submit(
            _jax_restore, c, os.path.join(root, f"port_{c[0]}_{c[1]}"),
            saved[c][1]) for c in CASES}
        back = {c: f.result() for c, f in backs.items()}
    return root, saved, port, back


@pytest.mark.parametrize("name,n", CASES)
def test_jax_zoo_checkpoint_restores_in_the_port(cross, name, n):
    """Every member's GLOBAL snapshot after the restore is the JAX
    package's, leaf for leaf and bit for bit, at the saved cursor."""
    for member in cross[2][(name, n)]:
        assert member["step"] == STEPS and member["t"] == STEPS
        assert member["cmp"]["bitwise"], member["cmp"]["mismatches"]
        assert member["version"] == (1, STEPS)


@pytest.mark.parametrize("name,n", CASES)
def test_port_zoo_checkpoint_restores_in_jax(cross, name, n):
    step, cmp = cross[3][(name, n)]
    assert step == STEPS
    assert cmp["bitwise"], cmp["mismatches"]


@pytest.mark.parametrize("name,n", CASES)
def test_zoo_payload_bytes_equal(cross, name, n):
    """The decompressed payloads of the JAX save and of the port's save of
    the same state are byte-equal: the same leaves, order, dtypes and
    meta."""
    root = cross[0]
    jax_raw = _payload(os.path.join(root, f"jax_{name}_{n}"), STEPS)
    port_raw = _payload(os.path.join(root, f"port_{name}_{n}"), STEPS)
    assert port_raw == jax_raw
    meta = msgpack.unpackb(port_raw, raw=False)["meta"]
    assert meta == {"system": "zoo", "n_model": n, "n_data": 1,
                    "n_classes": 512, "padded_vocab": 512}
    leaves = msgpack.unpackb(port_raw, raw=False)["leaves"]
    assert leaves["model/blocks/ln1/scale"]["shape"][0] == 2
    if name == "hymba":
        assert "model/blocks/fuse_ssm" in leaves
        assert "opt/mu/0/blocks/ssm/A_log" in leaves


# ---------------------------------------------------------------------------
# kill and recover
# ---------------------------------------------------------------------------


def _recover(spec, tmp_path):
    return kill_and_recover(
        lambda d: testing.zoo_ckpt_experiment(spec, d), total_steps=6,
        kill_at=5, ckpt_dir=str(tmp_path / "ck"),
        equivalence="bitwise", head=spec["head"]["softmax_impl"],
        fit_kw={"lr": 0.5})


@pytest.mark.parametrize("head", sorted(ZOO_EQUIVALENCE))
def test_zoo_kill_and_recover(head, tmp_path):
    """tests/test_resilience.py's zoo scenario on the port (batch 8, seq
    16, a checkpoint every 2 steps, kill at 5): restore t=4, one step
    replayed, the final snapshot and losses bitwise equal to the
    uninterrupted run's; the report carries the save's and the restore's
    parts."""
    spec = _spec(head, batch=8, seq=16)
    rep = _recover(spec, tmp_path)
    assert ZOO_EQUIVALENCE[head] == rep.equivalence == "bitwise"
    assert rep.restored_step == 4 and rep.steps_replayed == 1
    assert rep.ok, rep.summary()
    assert rep.save_s > 0 and rep.restore_s > 0 and rep.ckpt_bytes > 0
    assert 0 < rep.restore_read_s <= rep.restore_s
    assert [r["step"] for r in rep.resumed_history] == [4, 5]


@pytest.mark.parametrize("family", ["mamba2_370m", "hymba_1_5b"])
def test_zoo_kill_and_recover_new_families(family, tmp_path):
    rep = _recover(_spec("full", family, batch=4, seq=16), tmp_path)
    assert rep.restored_step == 4 and rep.steps_replayed == 1
    assert rep.ok, rep.summary()


def test_zoo_kill_and_recover_on_a_ring_of_2(tmp_path):
    spec = _spec("full", batch=8, seq=16)
    cases = [("zoo_kill_recover", (spec, str(tmp_path / "ck")),
              dict(total_steps=6, kill_at=5, fit_kw={"lr": 0.5}))]
    reps = [r[0] for r in dist.spawn_ring(testing.run_all, 2, cases)]
    for rep in reps:
        assert rep.restored_step == 4 and rep.ok, rep.summary()
        assert rep.src_mesh == rep.dst_mesh == "ring of 2"
    assert reps[0].resumed_history == reps[1].resumed_history


# ---------------------------------------------------------------------------
# elastic restores
# ---------------------------------------------------------------------------


ELASTIC = {h: _spec(h, batch=8, seq=16) for h in ("full", "mach")}


def _elastic(root):
    """For each (src, dst): both heads' runs on a ring of src (fit(4),
    checkpointing), then both restored onto a ring of dst and trained on
    to step 6: {(src, dst, head): (source rank 0, [dst members])}."""
    out = {}
    for src, dst in ((4, 2), (2, 4)):
        dirs = {h: str(root / f"{src}_{dst}_{h}") for h in ELASTIC}
        a = dist.spawn_ring(testing.run_all, src, [
            ("zoo_elastic_source", (ELASTIC[h], dirs[h]), dict(steps=4))
            for h in ELASTIC])[0]
        b = dist.spawn_ring(testing.run_all, dst, [
            ("zoo_elastic_restore", (ELASTIC[h], dirs[h]), dict(train_to=6))
            for h in ELASTIC])
        for i, h in enumerate(ELASTIC):
            out[(src, dst, h)] = (a[i], [m[i] for m in b])
    return out


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """``_elastic`` started in a thread (its rings overlap the JAX
    processes of ``cross``)."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(_elastic, tmp_path_factory.mktemp("zoo_elastic"))
    yield fut
    pool.shutdown()


@pytest.fixture(scope="module")
def elastic(elastic_runs, cross):
    return elastic_runs.result()


@pytest.mark.parametrize("head", ["full", "mach"])
@pytest.mark.parametrize("src,dst", [(4, 2), (2, 4)])
def test_zoo_elastic_restore(elastic, head, src, dst):
    """A checkpoint written on a ring of ``src`` restores onto ``dst``
    only with ``reshard``; the model tree (the embedding rows included:
    512 divides both rings), the head and the moments move bit for bit
    (mach's buckets ride the keep-verbatim leg: 64 divides both), and
    the run trains on to step 6 on finite losses, every member alike."""
    a, members = elastic[(src, dst, head)]
    for got in members:
        assert got["blocked"] and "reshard" in got["blocked"]
        assert got["step"] == 4
        cmp = tree_compare(a["snap"], got["snap"])
        assert cmp["bitwise"], cmp["mismatches"]
        assert "train.reshard" in got["spans"]
        assert len(got["losses"]) == 2
        assert np.isfinite(got["losses"]).all()
        assert got["losses"] == members[0]["losses"]


def test_reshard_zoo_snapshot_repads_the_vocab(tmp_path):
    """A ring of 3 pads the 512-token vocab to 513: the embedding table
    and its moment gain a zero row, the real rows and the blocks are
    untouched, and the ledger counts the row."""
    from repro_torch.elastic import MeshGeometry
    exp = testing.zoo_ckpt_experiment(_spec("full"))
    exp.fit(1, lr=0.5)
    tree = testing._np_tree(exp._snapshot())
    cfg3 = dataclasses.replace(exp.model_cfg, vocab_size=513,
                               real_vocab_size=512)
    # no class count: 512 classes do not divide a ring of 3, which a
    # restore refuses before it gets here; the function itself re-pads
    g1 = MeshGeometry(n_model=1, n_data=1)
    g3 = MeshGeometry(n_model=3, n_data=1)
    out, refresh, led = reshard_zoo_snapshot(tree, exp.head, cfg3, g1, g3,
                                             padded_vocab_src=512)
    assert not refresh
    table = out["model"]["embed"]["table"]
    assert table.shape == (513, tree["model"]["embed"]["table"].shape[1])
    np.testing.assert_array_equal(table[:512],
                                  tree["model"]["embed"]["table"])
    assert not table[512].any()
    assert out["opt"].mu[0]["embed"]["table"].shape[0] == 513
    assert led.total_bytes() > 0
    np.testing.assert_array_equal(out["model"]["blocks"]["ln1"]["scale"],
                                  tree["model"]["blocks"]["ln1"]["scale"])


# ---------------------------------------------------------------------------
# the experiment's checkpoint surface and the launcher
# ---------------------------------------------------------------------------


def test_cadence_keep_and_resume_with_nothing_saved(tmp_path):
    """``fit(resume=True)`` with no checkpoint trains from 0; checkpoints
    land every ``ckpt_every`` steps and at the end of ``fit``, ``keep``
    prunes, the spans and counters say so, and a restore needs a
    ckpt_dir; a resumed fit at its total runs nothing."""
    from repro_torch.telemetry import Tracer
    ck = str(tmp_path / "ck")
    spec = dict(_spec("knn"), ckpt_every=2)
    exp = testing.zoo_ckpt_experiment(spec, ck)
    exp.ckpt_keep = 2
    tr = Tracer()
    hist = exp.fit(5, lr=0.5, resume=True, telemetry=tr)
    assert [r["step"] for r in hist] == list(range(5))
    assert ckpt.all_steps(ck) == [4, 5]
    assert tr.counters["train.checkpoints"] == 2
    assert tr.span_stats("train.checkpoint")["count"] == 3
    assert tr.counters["train.checkpoint.write_s"] > 0
    again = testing.zoo_ckpt_experiment(spec, ck)
    assert again.fit(5, lr=0.5, resume=True) == []
    assert again._t == 5 and again.weights_version == (1, 5)
    bare = testing.zoo_ckpt_experiment(spec)
    with pytest.raises(ValueError, match="ckpt_dir"):
        bare.restore()
    with pytest.raises(ValueError, match="ckpt_dir"):
        bare.save_checkpoint()
    with pytest.raises(FileNotFoundError):
        testing.zoo_ckpt_experiment(spec, str(tmp_path / "none")).restore()


def test_train_launcher_zoo_checkpoints_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--system", "zoo", "--arch", "mamba2_370m",
            "--reduced", "--batch", "2", "--seq", "8", "--lr", "0.5",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    assert train_launcher.main(base + ["--steps", "4"]) == 0
    assert ckpt.all_steps(ck) == [2, 4]
    assert ckpt.read_meta(ck)["system"] == "zoo"
    capsys.readouterr()
    assert train_launcher.main(base + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[zoo] resumed at t=4: 2 steps to 6" in out
    assert "[zoo] final next-token accuracy" in out
    assert train_launcher.main(base + ["--steps", "6", "--resume"]) == 0
    assert "nothing to run" in capsys.readouterr().out
    assert train_launcher.main(
        base[:-4] + ["--resume-reshard", "--ckpt-dir", ck, "--steps",
                     "7"]) == 0
    assert ckpt.all_steps(ck) == [2, 4, 6, 7]
