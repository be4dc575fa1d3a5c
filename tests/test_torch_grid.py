"""The zoo on a (data, model) grid of gloo processes against the JAX
package's ``ZooExperiment`` on a mesh of the same shape, on the CPU.

The reduced Qwen3-1.7B in fp32 (2 layers, d_model 128, 4 heads and 2 KV
heads of 32, MLP 256, vocab 512), 8 sequences of 8 tokens a step, SGD at
lr 0.1, on a (2, 2) grid: its heads, KV heads, MLP and vocab all split
over ``model`` (asserted), the batch over ``data``. Each JAX experiment is
rebuilt on the first four devices as a (2, 2) mesh
(``tests.test_torch_zoo_train.jax_zoo_on_grid``); the port starts from its
params and head state (carried by ``interop`` and cut by
``param_pspecs``), trains on the JAX package's ``lm_batch`` arrays, the
sampled head takes the JAX package's draws of each data shard's labels,
knn runs without fillers:

* ``fit(3)``'s loss and accuracy at every step, the final params gathered
  whole and every member's slices of them, and the sketch heads' bucket
  weights, within ``TRAJ_TOL`` (rtol 1e-4, atol 1e-6), and ``evaluate``
  within 1e-6, for all six heads on both backends in one micro-batch, and
  the full and knn heads in two (where a member must take the JAX
  package's rows: each micro-batch of the global batch split over the
  data shards). knn, selective and sampled then pick their classes per
  data shard, so the (1, n) ring's numbers are not these. The same for
  batches whose micro-batch rows do not split over ``data`` (5 rows in
  one micro-batch, full head; 6 in two, knn): every data shard runs the
  micro-batch's rows and its loss takes its half of their tokens, as the
  JAX loss ``shard_map`` does.
* The reduced Qwen3-MoE's ``fit(3)`` with its 4 experts over ``model``
  and the reduced Qwen3's with FSDP (``param_rules = (("embed",
  "data"),) + rules``), each against the JAX zoo under the same
  ``ParallelConfig`` within ``TRAJ_TOL``, FSDP's also against the port's
  run without it.
* ``apply_moe`` at capacity factor 0.5 on (1, 2) and (2, 2) grids: the
  output and the input's gradient within 1e-5 and each param's gradient
  within 1e-5 of its own scale of the JAX ``apply_moe``'s (the file
  ``tests/test_torch_zoo_moe.py`` holds), the router loss within 1e-6
  relative, and the pairs kept past capacity the JAX dispatch's exactly.
* LARS on a leaf split over ``model``: the whole leaf's update within
  1e-6, and the member-local norms' update shown to differ.
* A zoo checkpoint written by the JAX package on (2, 2) restores on the
  port's (2, 2) grid bit for bit, and the port's save of it restores in
  the JAX package bit for bit (full and MACH heads).
* Exact top-5 retrieval on (2, 2): ids equal to the JAX zoo's, scores
  within 1e-5; greedy decoding on (2, 2), each data shard its prompts:
  the tokens equal the JAX zoo's exactly, on both backends.
* A (1, 2) member holds its slices only: each leaf's shape is its
  ``param_pspecs`` block, and the member's element count is under the
  whole model's.
* The reduced SmolLM on a (2, 4) grid of 8 processes, ``default_grid``'s
  layout of 8 and the one ``scripts/smoke_torch.sh`` trains: its 3 heads
  and 3 KV heads do not split over a model axis of 4 and stay whole on
  every member, its MLP and vocab split. ``fit(3)`` of the full head
  against the JAX zoo on a (2, 4) mesh as the (2, 2) cases are held; and
  both launchers' zoo runs on that grid print their lines and write
  their metrics and traces once, on member 0.

The JAX runs go to four processes of their own; the port's (2, 2) grid
runs every case of its shape in one spawn, and the (1, 2) and (2, 4)
grids theirs.
"""
import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.models import moe as jmoe
from repro.resilience import tree_compare as jax_tree_compare
from repro_torch import dist, testing
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.train import gspmd as tgspmd
from tests.test_torch_heads import _jax_draw
from tests.test_torch_zoo_checkpoint import _payload
from tests.test_torch_zoo_train import HEADS, TRAJ_TOL, _host, jax_zoo_on_grid

ARCH, MOE_ARCH = "qwen3_1_7b", "qwen3_moe_30b_a3b"
BATCH, SEQ, STEPS, LR = 8, 8, 3, 0.1
GRID = (2, 2)
# the (2, 4) grid's run: the reduced SmolLM, the full head, one micro-batch
WIDE = (2, 4)
WIDE_KEY = ("smollm_135m", "full", 1, False, BATCH, WIDE)
BACKENDS = ("ref", "kernel")
# (head, n_micro): every head in one micro-batch, full and knn in two
CASES = [(h, 1) for h in HEADS] + [("full", 2), ("knn", 2)]
# (head, n_micro, batch): micro-batches of rows that do not split over data
ODD = [("full", 1, 5), ("knn", 2, 6)]
# the extra fits: (arch, label), each on the ref backend with the full head
EXTRA = [(MOE_ARCH, "moe"), (ARCH, "fsdp")]
CKPT_HEADS = ("full", "mach")
MOE_TOL = 1e-5
SERVE = dict(prompt_len=8, gen=4, batch=4)
MOE_ROWS = (4, 32)            # [b, s] rows of apply_moe's input


def _fsdp(jax_side: bool):
    base = (jbase.ParallelConfig if jax_side else tbase.ParallelConfig)()
    cls = jbase.ParallelConfig if jax_side else tbase.ParallelConfig
    return cls(mesh_shape=GRID, axis_names=("data", "model"),
               param_rules=(("embed", "data"),) + base.rules)


def _batches(batch=BATCH):
    fn = jax.jit(jax_lm_batch, static_argnums=(1, 2, 3))
    return [_host(fn(t, batch, SEQ, 512)) for t in range(STEPS)]


# ---------------------------------------------------------------------------
# the JAX side (processes of its own)
# ---------------------------------------------------------------------------


def _jax_exp(key, **kw):
    """The JAX experiment of ``key`` = (arch, head, n_micro, fsdp[,
    batch[, grid]]) on the (2, 2) mesh or ``grid``, its selective tables
    refreshed, its batches the test's."""
    arch, head, n_micro, fsdp, *rest = key
    batch = rest[0] if rest else BATCH
    grid = rest[1] if len(rest) > 1 else GRID
    exp = jax_zoo_on_grid(
        *grid, par=_fsdp(True) if fsdp else None, arch=arch, reduced=True,
        batch=batch, seq=SEQ, head=jbase.HeadConfig(**HEADS[head]),
        train=jbase.TrainConfig(optimizer="sgd", micro_batch=n_micro), **kw)
    if head == "selective":
        exp.refresh_head()
    batches = _batches(batch)
    exp._batch = lambda t: batches[t]
    return exp


def _jax_start(key):
    """The JAX experiment's params and head state (the port's start)."""
    exp = _jax_exp(key)
    params, hp, aux = _host((exp.params, exp.head_state.params,
                             exp.head_state.aux))
    return key, {"tree": params, "head_state": {"params": hp,
                                                "aux": list(aux)}}


def _jax_fit(key):
    exp = _jax_exp(key)
    hist = exp.fit(STEPS, lr=LR)
    return key, {"history": [dict(r) for r in hist],
                 "params": _host(exp.params),
                 "eval": exp.evaluate(exp._batch(0)),
                 "head_params": (None if exp.head.params_are_class_weights
                                 else _host(exp.head_state.params))}


def _ckpt_spec(head):
    return {"arch": ARCH, "head": dict(HEADS[head], backend="ref"),
            "batch": BATCH, "seq": SEQ, "ckpt_every": 2}


_EXPS: dict = {}


def _jax_save(head, root):
    """A JAX (2, 2) experiment's checkpoint at cursor 2 (moments an affine
    map of the params, no step compiled) and its snapshot."""
    jdir = os.path.join(root, f"jax_{head}")
    exp = _jax_exp((ARCH, head, 1, False), ckpt_dir=jdir, ckpt_every=2)
    exp.refresh_head()
    exp._ensure_opt()
    with jax.set_mesh(exp.mesh):
        exp.opt_state = exp.opt_state._replace(
            step=exp.opt_state.step + 2, mu=jax.tree.map(
                lambda a: 0.5 * a + 0.25,
                (exp.params, exp.head_state.params)))
    exp._t = 2
    exp.save_checkpoint()
    _EXPS[head] = exp
    return jdir, _host(exp._snapshot())


def _jax_restore(head, pdir, snap):
    """The JAX package's restore of the port's file into the experiment
    that saved, its state zeroed first; its snapshot against ``snap``."""
    from repro.api.heads import HeadState as JaxHeadState
    exp = _EXPS.pop(head)
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


def _jax_retrieval(tree, queries):
    """The JAX zoo's exact top-5 on (2, 2) from the port's start."""
    exp = _jax_exp((ARCH, "full", 1, False))
    with jax.set_mesh(exp.mesh):
        exp.params = jax.tree.map(
            lambda a, s: jax.device_put(a, s), tree,
            jax.tree.map(lambda x: x.sharding, exp.params))
    return exp.serve(top_k=5, queries=queries, return_scores=True)


def _jax_serve():
    """The JAX zoo's greedy tokens on (2, 2) (``SERVE``), and its prompts:
    the stream's first batch, as the JAX ``serve`` draws them."""
    exp = _jax_exp((ARCH, "full", 1, False))
    toks = exp.serve(**SERVE)
    prompts = _host(jax_lm_batch(0, SERVE["batch"], SERVE["prompt_len"],
                                 512))["tokens"]
    return np.asarray(toks), prompts


def _jax_moe(cf):
    """The JAX ``apply_moe`` of the reduced Qwen3-MoE at capacity ``cf``:
    its params, input, cotangent, output, router loss, gradients and kept
    pairs."""
    from tests.test_torch_zoo_moe import _jax_kept
    jcfg = dataclasses.replace(jbase.get_model_config(MOE_ARCH, True),
                               dtype="float32")
    jp = _host(jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(7)
    x = rng.standard_normal(MOE_ROWS + (jcfg.d_model,)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def loss(p, xx):
        out, aux = jmoe.apply_moe(p, jcfg, xx, capacity_factor=cf)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(x))
    kept, routed = _jax_kept(jp, jcfg, jnp.asarray(x), cf)
    return {"params": jp, "x": x, "cot": cot, "out": np.asarray(out),
            "aux": float(aux), "grads": _host(gp), "dx": np.asarray(gx),
            "kept": kept, "routed": routed}


def _draws(n_micro, batches):
    """The JAX package's sampled draw of every model member for every data
    shard's labels of every micro-batch, keyed by their salt."""
    from repro_torch.core import baselines as tbl
    n_data, n_model = GRID
    out = {}
    for t, b in enumerate(batches):
        labels = b["labels"].reshape(n_micro, n_data, -1)
        for y in labels.reshape(n_micro * n_data, -1):
            out[tbl.sampled_salt(torch.tensor(y), t)] = [
                _jax_draw(y, t, p, n_model, v_loc=512 // n_model,
                          n_samples=HEADS["sampled"]["sampled_n"],
                          distribution="uniform") for p in range(n_model)]
    return out


# ---------------------------------------------------------------------------
# the port's grids, and the module's runs
# ---------------------------------------------------------------------------


def _fit_case(start, head, n_micro, backend, batches, arch=ARCH, par=None,
              draws=None):
    # the heads whose state the JAX run made (the knn graph the port
    # builds itself, as the JAX fit's first refresh does)
    carried = head in ("selective", "mach", "csoft")
    kw = dict(arch=arch, batch=len(batches[0]["tokens"]), seq=SEQ, steps=STEPS, lr=LR,
              batches=batches, eval_inputs=batches[0],
              head_state=start["head_state"] if carried else None,
              draws=draws, par=par)
    return ("zoo_fit", (start["tree"], dict(HEADS[head], backend=backend),
                        {"optimizer": "sgd", "micro_batch": n_micro}), kw)


def _port(shape, cases):
    """``cases`` on one spawned grid of ``shape``: {key: per-member}."""
    keys = [k for k, _ in cases]
    per_rank = dist.spawn_grid(testing.run_all, *shape,
                               [c for _, c in cases])
    return {k: [r[i] for r in per_rank] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX starts, fits, saves and apply_moe runs in four processes;
    the port's (2, 2) grid with every case of its shape once the saves are
    in, and the (1, 2) grid beside it; then the JAX package's restores of
    the port's saves."""
    root = str(tmp_path_factory.mktemp("grid"))
    batches = _batches()
    fit_keys = ([(ARCH, h, m, False) for h, m in CASES]
                + [(MOE_ARCH, "full", 1, False), (ARCH, "full", 1, True)]
                + [(ARCH, h, m, False, b) for h, m, b in ODD] + [WIDE_KEY])
    ctx = torch.multiprocessing.get_context("spawn")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_multi_thread_eigen=false"
        " intra_op_parallelism_threads=1"
        " --xla_backend_optimization_level=0"
        " --xla_llvm_disable_expensive_passes=true")
    pools = [concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx)
             for _ in range(4)]
    try:
        saves = {h: pools[i].submit(_jax_save, h, root)
                 for i, h in enumerate(CKPT_HEADS)}
        moes = {cf: pools[2 + i].submit(_jax_moe, cf)
                for i, cf in enumerate((0.5,))}
        starts = dict(f.result() for f in [
            pools[i % 4].submit(_jax_start, k)
            for i, k in enumerate(fit_keys)])
        fits = [pools[i % 4].submit(_jax_fit, k)
                for i, k in enumerate(fit_keys)]
        saved = {h: f.result() for h, f in saves.items()}
        moe = moes[0.5].result()
        q = np.random.default_rng(5).standard_normal(
            (8, 128)).astype(np.float32)
        ret = pools[2].submit(_jax_retrieval,
                              starts[(ARCH, "full", 1, False)]["tree"], q)
        served = pools[3].submit(_jax_serve)
        cases = []
        for head, n_micro in CASES:
            start = starts[(ARCH, head, n_micro, False)]
            draws = _draws(n_micro, batches) if head == "sampled" else None
            for backend in BACKENDS:
                cases.append(((head, n_micro, backend), _fit_case(
                    start, head, n_micro, backend, batches, draws=draws)))
        for head, n_micro, b in ODD:
            cases.append((("odd", head, n_micro, b), _fit_case(
                starts[(ARCH, head, n_micro, False, b)], head, n_micro,
                "ref", _batches(b))))
        cases.append(("moe", _fit_case(starts[(MOE_ARCH, "full", 1, False)],
                                       "full", 1, "ref", batches,
                                       arch=MOE_ARCH)))
        cases.append(("fsdp", _fit_case(starts[(ARCH, "full", 1, True)],
                                        "full", 1, "ref", batches,
                                        par=_fsdp(False))))
        for head in CKPT_HEADS:
            cases.append((("ckpt", head), (
                "zoo_ckpt_from_jax", (_ckpt_spec(head), saved[head][0],
                                      os.path.join(root, f"port_{head}"),
                                      saved[head][1]), {})))
        cases.append(("retrieval", ("zoo_retrieve", (
            starts[(ARCH, "full", 1, False)]["tree"],
            {"softmax_impl": "full"}), dict(arch=ARCH, queries=q,
                                            top_k=5))))
        toks, prompts = served.result()
        for backend in BACKENDS:
            cases.append((("serve", backend), ("zoo_serve", (
                starts[(ARCH, "full", 1, False)]["tree"],), dict(
                    arch=ARCH, prompts=prompts, gen=SERVE["gen"],
                    backend=backend))))
        moe_case = ("grid_moe", (moe["params"], MOE_ARCH, moe["x"],
                                 moe["cot"], 0.5), {})
        cases.append(("apply_moe", moe_case))
        w = np.random.default_rng(9).standard_normal((8, 6)).astype(
            np.float32)
        g = np.random.default_rng(10).standard_normal((8, 6)).astype(
            np.float32)
        zoo = ["--device", "cpu", "--system", "zoo", "--arch", WIDE_KEY[0],
               "--reduced", "--batch", str(BATCH)]
        train_argv = zoo + ["--seq", str(SEQ), "--steps", "2", "--lr", "0.5",
                            "--metrics-out", os.path.join(root, "wide.jsonl"),
                            "--trace-out", os.path.join(root, "wide.json")]
        serve_argv = zoo + ["--prompt-len", "4", "--gen", "2", "--trace-out",
                            os.path.join(root, "wide_serve.json")]
        with concurrent.futures.ThreadPoolExecutor(2) as side:
            small = side.submit(_port, (1, 2), [
                ("apply_moe", moe_case),
                ("lars", ("grid_lars", (w, g, ("model", None)), {})),
                ("bytes", ("grid_member_bytes", (ARCH,), {}))])
            wide = side.submit(_port, WIDE, [
                ("fit", _fit_case(starts[WIDE_KEY], "full", 1, "kernel",
                                  batches, arch=WIDE_KEY[0])),
                ("train_launcher", ("zoo_launcher", ("train", train_argv),
                                    {})),
                ("serve_launcher", ("zoo_launcher", ("serve", serve_argv),
                                    {}))])
            port = _port(GRID, cases)
            port_small = small.result()
            port_wide = wide.result()
        backs = {h: pools[i].submit(_jax_restore, h,
                                    os.path.join(root, f"port_{h}"),
                                    saved[h][1])
                 for i, h in enumerate(CKPT_HEADS)}
        refs = dict(f.result() for f in fits)
        out = {"refs": refs, "port": port, "small": port_small,
               "wide": port_wide,
               "tokens": toks,
               "moe": moe, "retrieval": ret.result(), "saved": saved,
               "back": {h: f.result() for h, f in backs.items()},
               "root": root, "wg": (w, g)}
    finally:
        os.environ["XLA_FLAGS"] = flags
        for p in pools:
            p.shutdown(wait=False)
    return out


def _flat(tree):
    return jax.tree.leaves(tree)


def _member_slice(leaf, spec, d, m, grid=GRID):
    """Grid member (d, m)'s block of a whole leaf by ``spec``."""
    idx = {"data": d, "model": m}
    size = dict(zip(("data", "model"), grid))
    out = leaf
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = out.shape[dim] // size[entry]
        out = np.take(out, np.arange(idx[entry] * n, (idx[entry] + 1) * n),
                      axis=dim)
    return out


def _check_fit(ref, members, arch=ARCH, par=None, grid=GRID):
    port = members[0]
    for key in ("loss", "acc"):
        np.testing.assert_allclose([r[key] for r in port["history"]],
                                   [r[key] for r in ref["history"]],
                                   err_msg=key, **TRAJ_TOL)
    got, want = _flat(port["params"]), _flat(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TRAJ_TOL)
    if ref["head_params"] is not None:
        np.testing.assert_allclose(port["head_params"], ref["head_params"],
                                   **TRAJ_TOL)
    assert port["eval"] == pytest.approx(ref["eval"], abs=1e-6)
    # every member holds its slice of the JAX leaf
    cfg = dataclasses.replace(tbase.get_model_config(arch, True),
                              dtype="float32")
    specs = tgspmd.param_pspecs(tbase.pad_vocab(cfg, grid[1]), par or
                                tmesh.make_host_parallel_config(*grid))
    for i, member in enumerate(members):
        d, m = divmod(i, grid[1])
        assert member["history"] == port["history"]
        for leaf, mine, spec in zip(
                _flat(ref["params"]), _flat(member["member"]),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                    x, tuple))):
            np.testing.assert_allclose(
                mine, _member_slice(leaf, spec, d, m, grid), **TRAJ_TOL)


def test_the_grid_splits_heads_mlp_and_vocab():
    """The reduced shape of this file really splits: on (2, 2) the
    attention's heads and KV heads, the MLP and the vocab go over
    ``model``; with FSDP the embed dim over ``data`` too."""
    cfg = tbase.get_model_config(ARCH, True)
    sp = tgspmd.param_pspecs(cfg, tmesh.make_host_parallel_config(*GRID))
    attn, mlp = sp["blocks"]["attn"], sp["blocks"]["mlp"]
    assert attn["wq"] == (None, None, "model", None)
    assert attn["wk"] == (None, None, "model", None)
    assert attn["wo"] == (None, "model", None, None)
    assert mlp["wi_gate"] == (None, None, "model")
    assert mlp["wo"] == (None, "model", None)
    assert sp["embed"]["table"] == ("model", None)
    fs = tgspmd.param_pspecs(cfg, _fsdp(False))
    assert fs["embed"]["table"] == ("model", "data")
    assert fs["blocks"]["attn"]["wq"] == (None, "data", "model", None)
    moe = tgspmd.param_pspecs(tbase.get_model_config(MOE_ARCH, True),
                              tmesh.make_host_parallel_config(*GRID))
    assert moe["blocks"]["moe"]["wi_gate"] == (None, "model", None, None)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-micro{c[1]}")
def test_grid_fit_matches_the_jax_zoo(runs, case, backend):
    """fit(3) on the (2, 2) grid from the JAX run's start: every step's
    loss and accuracy, the final params gathered whole and every member's
    slices, the bucket weights, within TRAJ_TOL; evaluate equal; every
    member's history the same. knn and selective keep every label (recall
    1), sampled draws 1/4 of the classes."""
    head, n_micro = case
    members = runs["port"][(head, n_micro, backend)]
    _check_fit(runs["refs"][(ARCH, head, n_micro, False)], members)
    hist = members[0]["history"]
    if head in ("knn", "selective"):
        assert all(r["label_recall"] == 1.0 for r in hist)
    if head == "sampled":
        assert all(r["sample_frac"] == 0.25 for r in hist)


@pytest.mark.parametrize("case", ODD, ids=lambda c: f"{c[0]}-micro{c[1]}"
                         f"-batch{c[2]}")
def test_grid_fit_on_rows_that_do_not_split_matches_the_jax_zoo(runs, case):
    """fit(3) on the (2, 2) grid where a micro-batch's rows do not divide
    the data shards: the trunk runs them all on every data shard and each
    shard's loss takes half their tokens, so the loss and gradient are
    the JAX zoo's, not twice them; loss, accuracy, params and every
    member's slices within TRAJ_TOL, evaluate equal."""
    head, n_micro, batch = case
    assert (batch // n_micro) % GRID[0]
    members = runs["port"][("odd",) + case]
    _check_fit(runs["refs"][(ARCH, head, n_micro, False, batch)], members)
    if head == "knn":
        assert all(r["label_recall"] == 1.0 for r in members[0]["history"])


@pytest.mark.parametrize("label", [e[1] for e in EXTRA])
def test_grid_moe_and_fsdp_fits_match_the_jax_zoo(runs, label):
    """The reduced Qwen3-MoE with its experts over ``model``, and the
    reduced Qwen3 with FSDP: fit(3) against the JAX zoo under the same
    ParallelConfig; FSDP's numbers are also the port's without it."""
    arch = dict((b, a) for a, b in EXTRA)[label]
    members = runs["port"][label]
    fsdp = label == "fsdp"
    _check_fit(runs["refs"][(arch, "full", 1, fsdp)], members, arch,
               par=_fsdp(False) if fsdp else None)
    if fsdp:
        plain = runs["port"][("full", 1, "ref")][0]
        np.testing.assert_allclose(
            [r["loss"] for r in members[0]["history"]],
            [r["loss"] for r in plain["history"]], **TRAJ_TOL)
        for a, b in zip(_flat(members[0]["params"]),
                        _flat(plain["params"])):
            np.testing.assert_allclose(a, b, **TRAJ_TOL)


@pytest.mark.parametrize("shape", ["small", "port"], ids=["1x2", "2x2"])
def test_grid_apply_moe_matches_the_jax_package(runs, shape):
    """apply_moe at capacity factor 0.5, the experts over ``model`` (2 a
    member) and the rows over ``data``: output, router loss, gradients and
    the kept pairs against the JAX ``apply_moe``."""
    ref = runs["moe"]
    for member in runs[shape]["apply_moe"]:
        assert member["experts"] == 2
        np.testing.assert_allclose(member["out"], ref["out"], atol=MOE_TOL,
                                   rtol=0)
        np.testing.assert_allclose(member["dx"], ref["dx"], atol=MOE_TOL,
                                   rtol=0)
        assert member["aux"] == pytest.approx(ref["aux"], rel=1e-6)
        for g, w in zip(_flat(member["grads"]), _flat(ref["grads"])):
            np.testing.assert_allclose(
                g, w, atol=MOE_TOL * max(1.0, np.abs(w).max()), rtol=0)
        assert member["kept"] == ref["kept"] < ref["routed"]


def test_lars_takes_the_whole_leafs_norms(runs):
    """LARS on a leaf split over ``model``: the update is one process's on
    the whole leaf; the members' local norms would give another."""
    from repro_torch.optim import lars
    w, g = runs["wg"]
    p = torch.tensor(w)
    opt = lars(momentum=0.9, weight_decay=1e-4)
    opt.update_([torch.tensor(g)], opt.init([p]), [p], 0.5)
    for member in runs["small"]["lars"]:
        np.testing.assert_allclose(member["whole"], p.numpy(), rtol=1e-6,
                                   atol=1e-7)
        assert np.abs(member["local"] - p.numpy()).max() > 1e-6


@pytest.mark.parametrize("head", CKPT_HEADS)
def test_zoo_checkpoints_cross_between_the_grid_and_jax(runs, head):
    """The JAX (2, 2) save restores on the port's (2, 2) grid bit for bit
    (every member's gathered snapshot); the port's save restores in the
    JAX package bit for bit; the decompressed payloads are byte-equal, the
    meta counting 2 data shards."""
    for member in runs["port"][("ckpt", head)]:
        assert member["step"] == 2 and member["t"] == 2
        assert member["cmp"]["bitwise"], member["cmp"]["mismatches"]
    step, cmp = runs["back"][head]
    assert step == 2 and cmp["bitwise"], cmp["mismatches"]
    root = runs["root"]
    jax_raw = _payload(os.path.join(root, f"jax_{head}"), 2)
    port_raw = _payload(os.path.join(root, f"port_{head}"), 2)
    assert port_raw == jax_raw
    assert b"n_data" in port_raw


def test_grid_top5_retrieval_matches_the_jax_zoo(runs):
    """Exact top-5 of 8 queries on the (2, 2) grid, every member serving
    the same queries over ``model``: ids equal to the JAX zoo's, scores
    within 1e-5."""
    ids, scores = runs["retrieval"]
    for member in runs["port"]["retrieval"]:
        got_ids, got_scores = member["exact"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_scores, scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_grid_serve_tokens_equal_the_jax_zoos(runs, backend):
    """Greedy decoding on the (2, 2) grid, each data shard decoding its
    two prompts: every member's [4, 4] tokens equal the JAX zoo's on its
    (2, 2) mesh, exactly."""
    for member in runs["port"][("serve", backend)]:
        np.testing.assert_array_equal(member, runs["tokens"])


def test_a_member_holds_its_slices_only(runs):
    """A (1, 2) member's params: every leaf its ``param_pspecs`` block of
    the whole leaf, the element count under the whole model's."""
    cfg = tbase.pad_vocab(tbase.get_model_config(ARCH, True), 2)
    specs = tgspmd.param_pspecs(cfg, tmesh.make_host_parallel_config(1, 2))
    from repro_torch.models import lm
    whole = lm.params_tree(lm.abstract_model(cfg))
    for member in runs["small"]["bytes"]:
        assert member["numel"] < member["whole"]
        for shape, spec, leaf in zip(
                jax.tree.leaves(member["shapes"],
                                is_leaf=lambda x: isinstance(x, tuple)),
                jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                    x, tuple)),
                jax.tree.leaves(whole)):
            want = tuple(s // (2 if e == "model" else 1)
                         for s, e in zip(leaf.shape, spec + (None,) * 9))
            assert shape == want


def test_smollm_on_a_2x4_grid_matches_the_jax_zoo(runs):
    """The reduced SmolLM on (2, 4): its attention whole on every member
    (3 heads over 4), its MLP and vocab split; fit(3) of the full head on
    the kernel backend against the JAX zoo on a (2, 4) mesh: losses,
    accuracies, the params gathered whole and every member's slices within
    TRAJ_TOL, evaluate equal, every member's history the same."""
    specs = tgspmd.param_pspecs(
        tbase.pad_vocab(tbase.get_model_config(WIDE_KEY[0], True), WIDE[1]),
        tmesh.make_host_parallel_config(*WIDE))
    assert set(specs["blocks"]["attn"].values()) == {(None,) * 4}
    assert specs["blocks"]["mlp"]["wo"] == (None, "model", None)
    assert specs["embed"]["table"] == ("model", None)
    members = runs["wide"]["fit"]
    assert len(members) == 8
    _check_fit(runs["refs"][WIDE_KEY], members, arch=WIDE_KEY[0],
               grid=WIDE)


def test_the_zoo_launchers_print_and_write_once_on_a_grid(runs):
    """Both launchers' zoo runs on each member of the (2, 4) grid: member
    0 prints the train launcher's step, result and trace lines once and
    writes one metrics row a step, and the serve launcher's tokens and
    trace lines once; the other members print nothing."""
    for name, want in (("train_launcher", (
            "[zoo] step=0 ", "[zoo] final next-token accuracy",
            "[telemetry] 2 train.step spans")),
            ("serve_launcher", ("[serve] smollm-135m-reduced",
                                "[telemetry] trace ->"))):
        lead, *rest = runs["wide"][name]
        assert lead["rc"] == 0 and all(m["rc"] == 0 for m in rest)
        lines = lead["stdout"].splitlines()
        for key in want:
            assert sum(x.startswith(key) for x in lines) == 1, (name, key)
        assert [m["stdout"] for m in rest] == [""] * 7, name
    rows = open(os.path.join(runs["root"], "wide.jsonl")).read().splitlines()
    assert len(rows) == 2
