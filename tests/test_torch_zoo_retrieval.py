"""The port's zoo feature retrieval against the JAX package's, on the CPU.

The reduced SmolLM in fp32 (d_model 96, vocab 512). The JAX
``ZooExperiment``'s params are carried to the port by ``interop``; both
packages classify the same d_model-wide queries against the model's class
matrix (the tied embedding table) through the serving engine, at rings of
1 and 2, with the ``full`` head (raw inner products: its LM trunk trains
raw logits) and the ``knn`` head (cosine: queries and rows normalised):

* ``serve(top_k=5, queries=...)`` exactly, through the IVF index at its
  default nprobe and at every cluster, and on the default query pool
  (``np.random.default_rng(0)``): ids equal, scores within 1e-5; the IVF
  index's clusters, cap and nprobe equal; greedy ids through the engine
  equal; padded rows of an engine batch come back (-1, -inf);
* at every cluster the IVF top-5 is the exact scan's;
* mach and csoft refuse top-k and the IVF index with the JAX package's
  reason; the index is refit once a step moves ``weights_version``;
* the serve launcher with ``--system zoo --topk``, ``--index ivf`` and
  ``--replay``.
"""
import jax
import numpy as np
import pytest

from repro.api.experiment import ZooExperiment as JaxZooExperiment
from repro.configs import base as jbase
from repro_torch import dist, testing
from repro_torch.api import Experiment
from repro_torch.configs.base import HeadConfig
from repro_torch.launch import serve as serve_launcher

ARCH, K, NQ = "smollm_135m", 5, 6
RINGS = (1, 2)
HEADS = {"full": dict(softmax_impl="full"), "knn": dict(softmax_impl="knn")}
SCORE_TOL = dict(rtol=0, atol=1e-5)


def _queries():
    return np.random.default_rng(5).standard_normal((NQ, 96)).astype(
        np.float32)


def _jax_case(n, head):
    """The JAX experiment's params and its retrieval results."""
    exp = JaxZooExperiment(arch=ARCH, reduced=True, n_model=n, batch=4,
                           seq=8, head=jbase.HeadConfig(**HEADS[head]),
                           log_every=0)
    q = _queries()
    kw = dict(top_k=K, queries=q, return_scores=True)
    out = {"exact": exp.serve(**kw), "ivf": exp.serve(index="ivf", **kw),
           "ivf_all": exp.serve(index="ivf", nprobe=10**6, **kw),
           "default": exp.serve(top_k=K, return_scores=True)}
    idx = exp.ivf_index()
    out.update(n_clusters=idx.n_clusters, cap=idx.cap, nprobe=idx.nprobe)
    out["greedy"] = exp.serving_engine(max_batch=8).step_fn(q, NQ)[0]
    tree = jax.tree.map(np.asarray, jax.device_get(exp.params))
    return tree, out


@pytest.fixture(scope="module")
def results():
    """{(ring, head): (JAX results, per-member port results)}."""
    jax_out = {(n, h): _jax_case(n, h) for n in RINGS for h in HEADS}
    out = {}
    for n in RINGS:
        keys = [(n, h) for h in HEADS]
        cases = [("zoo_retrieve", (jax_out[k][0], dict(HEADS[k[1]])),
                  dict(arch=ARCH, queries=_queries(), top_k=K))
                 for k in keys]
        per_rank = dist.spawn_ring(testing.run_all, n, cases)
        for i, k in enumerate(keys):
            out[k] = (jax_out[k][1], [r[i] for r in per_rank])
    return out


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("n", RINGS)
def test_retrieval_matches_the_jax_zoo(results, n, head):
    ref, members = results[(n, head)]
    for port in members:
        for key in ("exact", "ivf", "ivf_all", "default"):
            ids, scores = port[key]
            rids, rscores = ref[key]
            assert ids.shape == rids.shape == (rids.shape[0], K), key
            np.testing.assert_array_equal(ids, rids, err_msg=key)
            np.testing.assert_allclose(scores, rscores, err_msg=key,
                                       **SCORE_TOL)
        assert (port["n_clusters"], port["cap"], port["nprobe"]) == (
            ref["n_clusters"], ref["cap"], ref["nprobe"])
        np.testing.assert_array_equal(port["greedy"], ref["greedy"])
        # every cluster probed: the exact scan's top-k
        np.testing.assert_array_equal(port["ivf_all"][0], port["exact"][0])
        pad_ids, pad_scores = port["pad"]
        assert pad_ids.shape == (4, K)
        assert (pad_ids[3] == -1).all() and np.isneginf(pad_scores[3]).all()
        assert (pad_ids[:3] >= 0).all()
        np.testing.assert_array_equal(pad_ids[:3], port["exact"][0][:3])
    assert ref["exact"][0].shape == (NQ, K) and ref["default"][0].shape == (
        4, K)


@pytest.mark.parametrize("impl", ["mach", "csoft"])
def test_sketch_heads_refuse_zoo_retrieval(impl):
    exp = Experiment.from_config(
        system="zoo", arch=ARCH, reduced=True, batch=2, seq=8, device="cpu",
        head=HeadConfig(softmax_impl=impl, mach_b=32, csoft_b=32),
        log_every=0)
    for call in (lambda: exp.serve(top_k=3),
                 lambda: exp.serve(top_k=3, index="ivf"),
                 lambda: exp.ivf_index(),
                 lambda: exp.serving_engine(top_k=3)):
        with pytest.raises(NotImplementedError,
                           match="full/knn/selective/sampled"):
            call()
    # greedy feature serving decodes through the hashed buckets
    ids = exp.serving_engine(max_batch=4).step_fn(
        np.ones((4, 96), np.float32), 2)[0]
    assert ids.shape == (4,) and (ids[2:] == -1).all()
    assert ((0 <= ids[:2]) & (ids[:2] < 512)).all()


def test_ivf_index_refits_after_a_step_and_serve_checks_args():
    exp = Experiment.from_config(system="zoo", arch=ARCH, reduced=True,
                                 batch=2, seq=8, device="cpu", log_every=0)
    idx = exp.ivf_index()
    assert exp.ivf_index() is idx
    ids0 = exp.serve(top_k=K, index="ivf")
    exp.fit(1, lr=0.5)
    idx2 = exp.ivf_index()
    assert idx2 is not idx and tuple(idx2.version) == exp.weights_version
    assert exp.serve(top_k=K, index="ivf").shape == ids0.shape == (2, K)
    with pytest.raises(ValueError, match="pass top_k"):
        exp.serve(queries=np.ones((2, 96), np.float32))
    with pytest.raises(ValueError, match="top_k must be"):
        exp.serve(top_k=10**6)
    with pytest.raises(ValueError, match="unknown serving index"):
        exp.serve(top_k=K, index="hnsw")


@pytest.mark.parametrize("extra", [["--topk", "5"],
                                   ["--topk", "5", "--index", "ivf"],
                                   ["--topk", "5", "--index", "ivf",
                                    "--nprobe", "3"]])
def test_serve_launcher_zoo_retrieval(extra, capsys):
    rc = serve_launcher.main(["--device", "cpu", "--system", "zoo",
                              "--arch", ARCH, "--reduced", "--batch", "8"]
                             + extra)
    assert rc == 0
    out = capsys.readouterr().out
    assert "zoo full-head top-5 retrieval over 512 classes" in out
    ids = eval(out.split("first query ids:")[1].splitlines()[0].strip())
    assert len(ids) == 5 and all(0 <= i < 512 for i in ids)
    if "ivf" in extra:
        assert "[serve] ivf index:" in out


@pytest.mark.parametrize("extra", [[], ["--topk", "5", "--index", "ivf"]])
def test_serve_launcher_zoo_replay(extra, capsys):
    rc = serve_launcher.main(["--device", "cpu", "--system", "zoo",
                              "--arch", ARCH, "--reduced", "--batch", "8",
                              "--replay", "0.3"] + extra)
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] replayed" in out and "p99=" in out
