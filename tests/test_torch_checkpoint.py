"""The port's checkpoints against the JAX package's, on the CPU.

* the codec: the port's msgpack encoder gives ``msgpack.packb(...,
  use_bin_type=True)``'s bytes on every int size, str and bin length,
  nesting and dtype a trainer writes, and its decoder reads
  ``msgpack.packb``'s output;
* the files: the write is atomic, ``keep`` prunes the oldest first and
  never the new file, both codecs (zstd, and zlib's stored blocks where
  ``zstandard`` is missing) round-trip and are read by the JAX package,
  the port reads the JAX package's zlib files, and a zstd file without
  ``zstandard`` raises;
* across packages: a JAX ``PaperExperiment`` (each of the six heads on the
  feats trunk, and the reduced ResNet with DGC) saves after 6 steps of
  ``rebuild_every=5`` (the knn graph and the LSH tables stale by a step)
  at rings of 1 and 2; the port restores each on a ring of the same size,
  and its state equals ``interop.paper_state_from_numpy`` of the JAX state
  exactly; the port saves, and the JAX package ``restore()``s a snapshot
  bitwise equal to its own; the two files' decompressed payloads are
  byte-equal;
* the IVF index round-trips through the port's checkpoint module.
"""
import concurrent.futures
import os
import zlib

import jax
import msgpack
import numpy as np
import pytest
import torch
import zstandard

from repro import checkpoint as jax_ckpt
from repro.api import Experiment as JaxExperiment
from repro.configs.base import DGCConfig as JaxDGCConfig
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.resilience import tree_compare as jax_tree_compare
from repro.train import hybrid as jhybrid
from repro_torch import checkpoint as ckpt
from repro_torch import dist, testing
from repro_torch.checkpoint import checkpoint as ckpt_mod
from repro_torch.checkpoint import codec
from repro_torch.optim import OptState
from repro_torch.serving import IVFIndex
from tests.torch_threads import one_thread  # noqa: F401

RINGS = (1, 2)
V, D, B, STEPS, HW = 240, 16, 24, 6, 16
HEAD = dict(backend="ref", knn_k=8, knn_kprime=16, active_frac=0.25,
            rebuild_every=5, sampled_n=64, mach_b=64, mach_r=2, csoft_b=64,
            csoft_r=2)
FCCS = dict(eta0=0.5, t_warm=2, b0=B, b_min=B, b_max=2 * B, t_ini=2,
            t_final=8)

def _spec(head, *, dgc=False, trunk="feats", batch=B):
    return {"head": dict(HEAD, softmax_impl=head),
            "train": dict(optimizer="sgd", fccs=FCCS,
                          dgc=dict(enabled=dgc, sparsity=0.95, chunk=512,
                                   backend="ref")),
            "trunk": trunk, "classes": V, "feat_dim": D, "batch": batch,
            "hw": HW, "ckpt_every": STEPS}


SPECS = {h: _spec(h) for h in ("full", "knn", "selective", "mach", "sampled",
                               "csoft")}
SPECS["cnn+dgc"] = _spec("full", dgc=True, trunk="cnn", batch=8)
CASES = [(name, n) for name in SPECS for n in RINGS]


def _payload(path: str, step: int) -> bytes:
    with open(os.path.join(path, f"ckpt_{step}.msgpack.zst"), "rb") as f:
        raw = f.read()
    if raw[:4] == b"\x28\xb5\x2f\xfd":
        return zstandard.ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
OBJECTS = {
    "ints": INTS,
    "strs": ["", "a" * 31, "a" * 32, "é" * 128, "b" * 256, "c" * 70_000],
    "bins": [b"", b"x" * 255, b"x" * 256, b"y" * 70_000,
             bytearray(b"z" * 3)],
    "arrays": [list(range(15)), list(range(16)), list(range(70_000)), []],
    "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): None for i in range(70_000)}, {}],
    "nested": {"step": 4, "meta": {"system": "paper", "n_model": 2,
                                   "n_data": 2, "n_classes": 1_020_250},
               "leaves": {"a/0": {"dtype": "float32", "shape": [2, 3],
                                  "data": b"\0" * 24}}},
    "scalars": [None, True, False, 1.5, -0.0],
}


@pytest.mark.parametrize("kind", list(OBJECTS))
def test_encoder_bytes_equal_msgpack_packb(kind):
    obj = OBJECTS[kind]
    assert codec.pack(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("kind", list(OBJECTS))
def test_decoder_reads_msgpack_packb(kind):
    raw = memoryview(msgpack.packb(OBJECTS[kind], use_bin_type=True))
    pos = [0]

    def fill(view):
        view[:] = raw[pos[0]:pos[0] + view.nbytes]
        pos[0] += view.nbytes
    got = codec.Unpacker(fill).obj()
    assert pos[0] == len(raw)
    want = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    assert msgpack.packb(got, use_bin_type=True) == \
        msgpack.packb(want, use_bin_type=True)


def _every_dtype_tree():
    """A tree with the dtypes, shapes and containers a trainer writes:
    fp32 tensors and arrays, int32 / int64 scalars, empty and [0, k]
    leaves, a NamedTuple with a None field, lists and tuples."""
    return {"fe": {"trunk": {"stem": torch.randn(3, 3, 2, 4),
                             "blocks": [{"w": torch.ones(5)},
                                        {"w": torch.zeros(0, 3)}]}},
            "head": {"params": np.arange(12, dtype=np.float32).reshape(4, 3),
                     "aux": (np.arange(5, dtype=np.int32),
                             torch.tensor([[1, 2]], dtype=torch.int32))},
            "opt": OptState(step=np.asarray(7, np.int32),
                            mu=({"x": torch.ones(2)}, torch.ones(4, 3)),
                            nu=None),
            "extra": {"t": torch.tensor(70_000, dtype=torch.int32),
                      "n": 2**40, "flag": np.asarray(True)}}


def test_streamed_payload_equals_msgpack_packb_of_the_tree():
    """The streamed payload of a whole tree is ``packb`` of the JAX
    package's payload dict for the same leaves, and its length is known
    before a leaf is fetched."""
    tree = _every_dtype_tree()
    leaves = [ckpt_mod._Leaf(k, v)
              for k, v in ckpt_mod.flatten(tree, with_paths=True)[0]]
    meta = {"system": "paper", "n_model": 1}
    streamed = b"".join(bytes(c) for c in
                        ckpt_mod._payload_chunks(70_000, meta, leaves))
    payload = {"step": 70_000, "meta": meta, "leaves": {}}
    for key, leaf in ckpt_mod.flatten(tree, with_paths=True)[0]:
        arr = ckpt_mod._host(leaf)
        payload["leaves"][key] = {"dtype": str(arr.dtype),
                                  "shape": list(arr.shape),
                                  "data": arr.tobytes()}
    assert streamed == msgpack.packb(payload, use_bin_type=True)
    assert len(streamed) == ckpt_mod._payload_len(70_000, meta, leaves)
    assert list(payload["leaves"])[:3] == ["extra/flag", "extra/n",
                                           "extra/t"]
    assert "opt/step" in payload["leaves"] and "opt/nu" not in str(
        list(payload["leaves"]))


# ---------------------------------------------------------------------------
# the files
# ---------------------------------------------------------------------------


@pytest.fixture(params=["zstd", "zlib"])
def codec_kind(request, monkeypatch):
    if request.param == "zlib":
        monkeypatch.setattr(ckpt_mod, "zstandard", None)
    return request.param


def test_both_codecs_round_trip_and_jax_reads_them(codec_kind, tmp_path):
    tree = _every_dtype_tree()
    path = str(tmp_path / "ck")
    f = ckpt.save(path, tree, step=3, meta={"system": "paper"})
    raw = open(f, "rb").read()
    assert (raw[:4] == b"\x28\xb5\x2f\xfd") == (codec_kind == "zstd")
    assert ckpt.codec_name() == ("zstd-3" if codec_kind == "zstd"
                                 else "zlib-0")
    back, step = ckpt.restore(path, tree)
    assert step == 3
    for (ka, a), (kb, b) in zip(
            ckpt_mod.flatten(tree, with_paths=True)[0],
            ckpt_mod.flatten(back, with_paths=True)[0]):
        a = ckpt_mod._host(a)
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert isinstance(back["opt"], OptState) and back["opt"].nu is None
    assert ckpt.read_meta(path) == {"system": "paper"}
    # the JAX package's reader takes the same file
    jtree, jstep = jax_ckpt.restore(path, {"head": {"params": 0}}, step=3)
    assert jstep == 3
    np.testing.assert_array_equal(jtree["head"]["params"],
                                  tree["head"]["params"])


def test_port_reads_jax_zlib_files(tmp_path, monkeypatch):
    """The JAX package's fallback writes zlib at level 6; the port reads
    any level."""
    import repro.checkpoint.checkpoint as jmod
    monkeypatch.setattr(jmod, "zstandard", None)
    path = str(tmp_path / "ck")
    w = np.random.default_rng(0).standard_normal((300, 7)).astype(np.float32)
    jax_ckpt.save(path, {"w": w, "s": np.int32(5)}, step=2)
    assert open(os.path.join(path, "ckpt_2.msgpack.zst"), "rb").read(
        1) == b"\x78"
    back, step = ckpt.restore(path, {"w": 0, "s": 0})
    assert step == 2 and back["w"].tobytes() == w.tobytes()
    assert back["s"].dtype == np.int32 and int(back["s"]) == 5


def test_zstd_without_zstandard_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    ckpt.save(path, {"x": np.zeros(3, np.float32)}, step=1)
    monkeypatch.setattr(ckpt_mod, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        ckpt.restore(path, {"x": 0})
    with pytest.raises(RuntimeError, match="zstandard"):
        ckpt.read_meta(path)


def test_write_is_atomic(tmp_path, monkeypatch):
    """A write that dies mid-payload leaves neither the file nor its tmp
    file, and the earlier checkpoints as they were."""
    path = str(tmp_path / "ck")
    ckpt.save(path, {"x": np.arange(4, dtype=np.float32)}, step=1)
    before = open(os.path.join(path, "ckpt_1.msgpack.zst"), "rb").read()

    def dying(chunks):
        for i, c in enumerate(chunks):
            if i == 2:
                raise OSError("disk gone")
            yield c
    real = ckpt_mod._payload_chunks
    monkeypatch.setattr(ckpt_mod, "_payload_chunks",
                        lambda *a: dying(real(*a)))
    with pytest.raises(OSError, match="disk gone"):
        ckpt.save(path, {"x": np.arange(4, dtype=np.float32),
                         "y": np.ones(3, np.float32)}, step=2)
    assert sorted(os.listdir(path)) == ["ckpt_1.msgpack.zst"]
    assert open(os.path.join(path, "ckpt_1.msgpack.zst"), "rb").read() \
        == before
    assert ckpt.latest_step(path) == 1


def test_keep_prunes_the_oldest_first(tmp_path):
    path = str(tmp_path / "ck")
    for s in (3, 1, 2):
        ckpt.save(path, {"x": np.zeros(1, np.float32)}, step=s)
    assert ckpt.all_steps(path) == [1, 2, 3]
    ckpt.save(path, {"x": np.zeros(1, np.float32)}, step=4, keep=2)
    assert ckpt.all_steps(path) == [3, 4]
    # the new file survives even when it is not the highest step
    ckpt.save(path, {"x": np.zeros(1, np.float32)}, step=5, keep=1)
    assert ckpt.all_steps(path) == [5]
    assert ckpt.prune(path, 1) == []
    with pytest.raises(ValueError, match="keep"):
        ckpt.prune(path, 0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), {})


def test_missing_leaf_raises(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save(path, {"x": np.zeros(1, np.float32)}, step=0)
    with pytest.raises(KeyError, match="'y'"):
        ckpt.restore(path, {"x": 0, "y": 0})


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _jax_config(spec):
    t = spec["train"]
    return (JaxHeadConfig(**spec["head"]),
            JaxTrainConfig(optimizer=t["optimizer"],
                           fccs=JaxFCCSConfig(**t["fccs"]),
                           dgc=JaxDGCConfig(**t["dgc"])))


def _jax_experiment(spec, n, ckpt_dir):
    hcfg, tcfg = _jax_config(spec)
    if spec["trunk"] == "cnn":
        kw = dict(trunk="cnn", data_fn=lambda t, b: testing.numpy_image_batch(
            t, b, classes=V, hw=HW))
    else:
        kw = dict(feat_dim=D, data_fn=lambda t, b: testing.numpy_batch(
            t, b, classes=V, dim=D))
    return JaxExperiment.from_config(
        system="paper", classes=V, batch=spec["batch"], head=hcfg,
        train=tcfg, mesh=jhybrid.make_hybrid_mesh(n), ckpt_dir=ckpt_dir,
        ckpt_every=STEPS, log_every=0, **kw)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_save(name, n, root):
    """A JAX run that saves at STEPS; its state as numpy for interop, and
    its snapshot."""
    jdir = os.path.join(root, f"jax_{name}_{n}")
    exp = _jax_experiment(SPECS[name], n, jdir)
    exp.fit(STEPS, use_fccs_batch=False)
    st = exp.state
    state = {"fe": _host(st.fe_params), "params": np.asarray(st.head_params),
             "aux": [np.asarray(a) for a in st.head_aux],
             "opt": {"step": int(st.opt_state.step),
                     "mu": _host(st.opt_state.mu), "nu": None},
             "dgc": (None if st.dgc is None else
                     {"u": _host(st.dgc.u), "v": _host(st.dgc.v)}),
             "step": int(st.step)}
    return jdir, state, _host(exp.trainer._snapshot())


def _jax_restore(name, n, pdir, snap):
    exp = _jax_experiment(SPECS[name], n, pdir)
    step = exp.restore()
    return step, jax_tree_compare(_host(exp.trainer._snapshot()), snap)


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The JAX saves (in threads: XLA compiles outside the interpreter
    lock), the port's restores and saves on one ring per size, then the
    JAX package's restores of the port's files."""
    root = str(tmp_path_factory.mktemp("cross"))
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        saved = dict(zip(CASES, pool.map(lambda c: _jax_save(*c, root),
                                         CASES)))
    port = {}
    for n in RINGS:
        names = [name for name in SPECS]
        cases = [("ckpt_from_jax",
                  (SPECS[name], saved[(name, n)][0],
                   os.path.join(root, f"port_{name}_{n}"),
                   saved[(name, n)][1]), {}) for name in names]
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        for i, name in enumerate(names):
            port[(name, n)] = [r[i] for r in per_rank]
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        back = dict(zip(CASES, pool.map(
            lambda c: _jax_restore(*c, os.path.join(root,
                                                    f"port_{c[0]}_{c[1]}"),
                                   saved[c][2]), CASES)))
    return root, saved, port, back


@pytest.mark.parametrize("name,n", CASES)
def test_jax_checkpoint_restores_in_the_port(cross, name, n):
    """Every member's restored state is ``interop`` of the JAX state, leaf
    for leaf and bit for bit, with the cursor and step of the save."""
    for member in cross[2][(name, n)]:
        assert member["step"] == STEPS and member["t"] == STEPS
        assert member["cmp"]["bitwise"], member["cmp"]["mismatches"]
        # a restore moves weights_version
        assert member["version"] == (1, STEPS)


@pytest.mark.parametrize("name,n", CASES)
def test_port_checkpoint_restores_in_jax(cross, name, n):
    step, cmp = cross[3][(name, n)]
    assert step == STEPS
    assert cmp["bitwise"], cmp["mismatches"]


@pytest.mark.parametrize("name,n", CASES)
def test_payload_bytes_equal(cross, name, n):
    """The decompressed payloads of the JAX save and of the port's save of
    the same state are byte-equal: same leaves, order, dtypes and meta."""
    root = cross[0]
    jax_raw = _payload(os.path.join(root, f"jax_{name}_{n}"), STEPS)
    port_raw = _payload(os.path.join(root, f"port_{name}_{n}"), STEPS)
    assert port_raw == jax_raw
    meta = msgpack.unpackb(port_raw, raw=False)["meta"]
    assert meta == {"system": "paper", "n_model": n, "n_data": n,
                    "n_classes": V}
    if name == "cnn+dgc":
        leaves = msgpack.unpackb(port_raw, raw=False)["leaves"]
        assert leaves["dgc/u/trunk/blocks/0/conv1"]["shape"][0] == n


# ---------------------------------------------------------------------------
# the IVF index's files
# ---------------------------------------------------------------------------


def test_ivf_index_round_trips_through_the_checkpoint(tmp_path):
    exp = testing.ckpt_experiment(SPECS["full"])
    exp.fit(2, use_fccs_batch=False)
    idx = exp.ivf_index(refit=True)
    path = str(tmp_path / "ivf")
    ckpt.save(path, idx.state_to_save(), step=0)
    tree, step = ckpt.restore(path, idx.state_to_save(), step=0)
    assert step == 0
    back = IVFIndex.state_from_restore(tree, device="cpu")
    assert torch.equal(back.centroids, idx.centroids)
    assert torch.equal(back.members, idx.members)
    np.testing.assert_array_equal(back.counts, idx.counts)
    assert (back.n_clusters, back.cap, back.nprobe, back.iters,
            back.version) == (idx.n_clusters, idx.cap, idx.nprobe,
                              idx.iters, idx.version)
    queries = testing.numpy_batch(10**6, 8, classes=V, dim=D)
    ids_a, sc_a = exp.serve(queries, top_k=5, return_scores=True,
                            index="ivf")
    exp.install_ivf_index(back)
    assert exp.ivf_index() is back                # no refit
    ids_b, sc_b = exp.serve(queries, top_k=5, return_scores=True,
                            index="ivf")
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)
