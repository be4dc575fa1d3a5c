"""The paper trainer on the reduced SKU ResNet trunk (``trunk="cnn"``),
with and without DGC, against the JAX ``PaperTrainer``, on the CPU.

* A 4-step FCCS run (micro-batch counts 1, 1, 1, 2) of the reduced ResNet
  with the full head and LARS, from the JAX experiment's initial trunk,
  class matrix, moments and DGC state carried by ``interop``, on the same
  numpy images, at rings of 1 and 2 gloo processes: losses, accuracy, lr
  and batch within rtol 1e-4 without DGC, within 1e-3 with it (sparsity
  0.99, 256 KiB groups, the threshold on ``ops.topk_threshold``), where
  entries within rounding of a group's threshold may be sent by one
  package and kept by the other: the test counts those flips in the final
  residual. ATen's CPU GroupNorm backward sums in an order that depends
  on the intra-op thread count, so every ring runs at a fixed count and
  its result is one on every machine: each spawned member at one thread,
  the ring of one, in this process, at two (at one thread its trunk's
  conv3 and proj weights move up to 1.35e-5 from the two-thread run's
  and miss rtol 1e-4 by 5.2e-6 to 9.6e-6).
* ``evaluate``, greedy and top-k ``serve`` of image queries, explicit and
  through the serving engine's padded micro-batches, from the trained JAX
  state, against the JAX experiment's.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.api import Experiment as JaxExperiment
from repro.configs.base import DGCConfig as JaxDGCConfig
from repro.configs.base import FCCSConfig as JaxFCCSConfig
from repro.configs.base import HeadConfig as JaxHeadConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.train import hybrid as jhybrid
from repro_torch import dist, testing
from repro_torch.core import sparsify as sp

RINGS = (1, 2)
CLASSES, HW, BATCH, STEPS, TOP_K = 256, 16, 8, 4, 3
FCCS = dict(eta0=0.4, t_warm=1, b0=8, b_min=8, b_max=16, t_ini=2,
            t_final=3)
DGC = dict(sparsity=0.99, chunk=2048, group_bytes=1 << 18)
HEAD = JaxHeadConfig(softmax_impl="full", backend="ref")
TOL = {False: dict(rtol=1e-4, atol=1e-6), True: dict(rtol=1e-3, atol=1e-5)}


def _jax_fit(n, dgc):
    exp = JaxExperiment.from_config(
        system="paper", trunk="cnn", classes=CLASSES, batch=BATCH, head=HEAD,
        train=JaxTrainConfig(optimizer="lars", fccs=JaxFCCSConfig(**FCCS),
                             dgc=JaxDGCConfig(enabled=dgc, backend="ref",
                                              **DGC)),
        mesh=jhybrid.make_hybrid_mesh(n), log_every=0,
        data_fn=functools.partial(testing.numpy_image_batch, classes=CLASSES,
                                  hw=HW))
    st = exp.state
    init = {"fe": jax.device_get(st.fe_params),
            "w0": np.array(st.head_params),
            "mu": (jax.device_get(st.opt_state.mu[0]),
                   np.array(st.opt_state.mu[1])),
            "dgc": (None if st.dgc is None else
                    {"u": jax.device_get(st.dgc.u),
                     "v": jax.device_get(st.dgc.v)})}
    hist = exp.fit(STEPS, use_fccs_batch=True)
    st = exp.state
    return {"init": init, "history": [dict(r) for r in hist],
            "w": np.array(st.head_params), "fe": jax.device_get(st.fe_params),
            "v": None if st.dgc is None else jax.device_get(st.dgc.v),
            "exp": exp}


def _serve_inputs():
    b = testing.numpy_image_batch(10**6, 8, classes=CLASSES, hw=HW)
    return b["images"], b["labels"]


@functools.lru_cache(maxsize=None)
def jax_results():
    # the four runs compile their steps at once: XLA compiles outside the
    # interpreter lock
    keys = [(n, dgc) for n in RINGS for dgc in (False, True)]
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        futures = {k: pool.submit(_jax_fit, *k) for k in keys}
        res = {k: f.result() for k, f in futures.items()}
    for n in RINGS:
        exp = res[(n, False)].pop("exp")
        images, labels = _serve_inputs()
        inputs = {"images": images, "labels": labels}
        ids, scores = exp.serve(inputs, top_k=TOP_K, return_scores=True)
        res[(n, "serve")] = {
            "eval": exp.evaluate(inputs), "greedy": np.asarray(
                exp.serve(inputs)),
            "topk": (np.asarray(ids), np.asarray(scores)),
            "state": {"fe": res[(n, False)]["fe"],
                      "w0": res[(n, False)]["w"]}}
        res[(n, True)].pop("exp")
    return res


def _pinned(threads, fn, *args, **kwargs):
    """``fn`` at ``threads`` intra-op threads (the ring of one runs in this
    process, where the count is otherwise the machine's)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port_results():
    jr = jax_results()
    res = {}
    for n in RINGS:
        cases = []
        for dgc in (False, True):
            tcfg = dict(optimizer="lars", fccs=FCCS,
                        dgc=dict(enabled=dgc, backend="kernel", **DGC))
            cases.append(("cnn_fit", (jr[(n, dgc)]["init"],
                                      dataclasses.asdict(HEAD), tcfg),
                          dict(steps=STEPS, batch=BATCH, classes=CLASSES,
                               hw=HW)))
        images, labels = _serve_inputs()
        cases.append(("cnn_serve", (jr[(n, "serve")]["state"],
                                    dataclasses.asdict(HEAD)),
                      dict(classes=CLASSES, images=images, labels=labels,
                           k=TOP_K)))
        # the thread count of the ring of one, which runs in this process
        per_rank = _pinned(2, dist.spawn_ring, testing.run_all, n, cases)
        res[(n, False)], res[(n, True)] = per_rank[0][0], per_rank[0][1]
        res[(n, "serve")] = per_rank[0][2]
        res[(n, "ranks")] = per_rank
    return res


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("dgc", [False, True])
def test_cnn_fit_trajectory_matches_jax(port_results, n, dgc):
    port, ref = port_results[(n, dgc)], jax_results()[(n, dgc)]
    assert [r["batch"] for r in port["history"]] == \
        [r["batch"] for r in ref["history"]] == [8, 8, 8, 16]
    for key in ("lr", "loss", "acc"):
        np.testing.assert_allclose(
            [r[key] for r in port["history"]],
            [r[key] for r in ref["history"]], err_msg=key, **TOL[dgc])
    np.testing.assert_allclose(port["w"], ref["w"], **TOL[dgc])
    for a, b in zip(sp.flatten(port["fe"])[0], jax.tree.leaves(ref["fe"])):
        np.testing.assert_allclose(a, b, **TOL[dgc])
    assert not np.allclose(port["w"], ref["init"]["w0"])
    if not dgc:
        assert port["v"] is None
        return
    # entries sent by one package and kept by the other (within rounding
    # of their group's threshold), in each member's final residual
    flips, zeros = 0, 0
    for r in range(n):
        mine = port_results[(n, "ranks")][r][1]["v"]
        for a, b in zip(sp.flatten(mine)[0], jax.tree.leaves(ref["v"])):
            flips += int(((a == 0) != (np.asarray(b)[r] == 0)).sum())
            zeros += int((np.asarray(b)[r] == 0).sum())
    print(f"ring of {n}, DGC: {flips} near-threshold flips; {zeros} "
          f"residual entries zero (sent at the last step, or no gradient)")
    assert zeros > 0 and flips <= max(4, zeros // 100)


@pytest.mark.parametrize("n", RINGS)
def test_cnn_fit_members_agree(port_results, n):
    """Every member ends with the same trunk: the exchanged gradients are
    the ring's mean on every member."""
    for dgc in (0, 1):
        first = sp.flatten(port_results[(n, "ranks")][0][dgc]["fe"])[0]
        for r in range(1, n):
            other = sp.flatten(port_results[(n, "ranks")][r][dgc]["fe"])[0]
            for a, b in zip(first, other):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", RINGS)
def test_cnn_serving_matches_jax(port_results, n):
    port, ref = port_results[(n, "serve")], jax_results()[(n, "serve")]
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    np.testing.assert_array_equal(port["greedy"], ref["greedy"])
    np.testing.assert_array_equal(port["topk"][0], ref["topk"][0])
    np.testing.assert_allclose(port["topk"][1], ref["topk"][1], rtol=1e-5,
                               atol=1e-5)
    # image queries through the engine's padded micro-batches
    np.testing.assert_array_equal(port["engine_greedy"][0], ref["greedy"])
    np.testing.assert_array_equal(port["engine_topk"][0], ref["topk"][0])
    np.testing.assert_allclose(port["engine_topk"][1], ref["topk"][1],
                               rtol=1e-5, atol=1e-5)
