"""The port's ``ParallelConfig``, per-layer remat, loss scaling and the
in-place optimizer update, on the CPU.

* ``ParallelConfig`` and the two factories of ``launch/mesh.py`` against
  the JAX package's, field for field, with ``mesh_axis_for[_param]``
  under the default, FSDP and first-match rules;
* ``remat="full"`` against ``"none"``: the loss and every gradient
  bit-equal for the dense, moe, ssm, hybrid, encdec and vlm families at
  ``reduced()``, fewer bytes saved for the backward, and one zoo step's
  loss and gradient with ``remat="full"`` on both sides against the JAX
  package's;
* ``optim/scale.py`` against the JAX package's;
* ``Optimizer.update_`` (what the trainers call) bit-equal to ``update``
  + ``apply_updates`` for sgd, nesterov, lars and adam, and ``fit(3)`` of
  the paper and the zoo trainer bit-equal to the old whole-tree formula.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.experiment import ZooExperiment as JaxZooExperiment
from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.optim import scale as jscale
from repro.train import gspmd as jgspmd
from repro_torch import interop, testing
from repro_torch.api import Experiment
from repro_torch.configs import base as tbase
from repro_torch.core.pipeline import _value_and_grad
from repro_torch.launch import mesh as tmesh
from repro_torch.models import decoder, lm
from repro_torch.optim import (adam, apply_updates, assign, lars, scale,
                               sgd, tree_leaves)
from repro_torch.train import gspmd as tgspmd
from repro_torch.train import hybrid as thybrid
from tests.torch_threads import one_thread  # noqa: F401

FAMILIES = {"dense": "smollm_135m", "moe": "qwen3_moe_30b_a3b",
            "ssm": "mamba2_370m", "hybrid": "hymba_1_5b",
            "encdec": "whisper_tiny", "vlm": "chameleon_34b"}
LOGICAL = ("batch", "vocab", "heads", "kv_heads", "mlp", "experts",
           "expert_mlp", "head_dim", "inner", "embed", "seq", "layers",
           "unknown")


# ---------------------------------------------------------------------------
# ParallelConfig and the factories
# ---------------------------------------------------------------------------


def _policies():
    """(port, JAX) pairs: the default, both factories (FSDP on and off,
    one pod and two, remat both ways), the host factory, and a config
    whose rules repeat a logical axis (the first match wins)."""
    pairs = [(tbase.ParallelConfig(), jbase.ParallelConfig())]
    for kw in (dict(), dict(multi_pod=True), dict(fsdp=False),
               dict(remat="none", multi_pod=True, fsdp=False)):
        pairs.append((tmesh.make_parallel_config(**kw),
                       jmesh.make_parallel_config(**kw)))
    for args in ((2, 4), (1, 3, "full")):
        pairs.append((tmesh.make_host_parallel_config(*args),
                      jmesh.make_host_parallel_config(*args)))
    rules = (("seq", "model"), ("seq", None), ("batch", ("pod", "data")),
             ("vocab", ("data", "model")), ("embed", "pod"))
    pairs.append((tbase.ParallelConfig(mesh_shape=(2, 4), rules=rules,
                                       param_rules=(("seq", "data"),)),
                  jbase.ParallelConfig(mesh_shape=(2, 4), rules=rules,
                                       param_rules=(("seq", "data"),))))
    return pairs


@pytest.mark.parametrize("i", range(len(_policies())))
def test_parallel_config_is_the_jax_packages(i):
    port, ref = _policies()[i]
    assert ([f.name for f in dataclasses.fields(port)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.batch_axes == ref.batch_axes
    assert port.model_axis == ref.model_axis
    for name in LOGICAL:
        assert port.mesh_axis_for(name) == ref.mesh_axis_for(name), name
        assert (port.mesh_axis_for_param(name)
                == ref.mesh_axis_for_param(name)), name


def test_parallel_config_rules():
    """The counterparts of the JAX package's own checks
    (``tests/test_roofline.py``): FSDP puts the params' embed over data
    and leaves the activations' alone; the first matching rule wins; the
    ring's default policy is (1, n) with no remat, and a remat policy
    outside none / full is refused where a stack reads it."""
    p = tmesh.make_parallel_config(multi_pod=True)
    assert p.axis_names == ("pod", "data", "model")
    assert p.batch_axes == ("pod", "data")
    assert p.mesh_axis_for_param("embed") == "data"
    assert p.mesh_axis_for("embed") is None
    assert tmesh.make_parallel_config(fsdp=False).param_rules is None
    assert tmesh.make_host_parallel_config(2, 4).mesh_shape == (2, 4)
    first = tbase.ParallelConfig(mesh_shape=(2, 4), rules=(
        ("seq", "model"), ("seq", None)))
    assert first.mesh_axis_for("seq") == "model"
    ring = tbase.ring_parallel_config(4)
    assert (ring.mesh_shape, ring.remat, ring.mesh_axis_for("vocab")) == (
        (1, 4), "none", "model")
    with pytest.raises(ValueError, match="remat"):
        decoder.remat_wanted("dots", False)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _family_batch(cfg, seed=1, b=2, s=16):
    g = torch.Generator().manual_seed(seed)
    x = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g),
         "labels": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.family == "encdec":
        x["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model), generator=g)
    return x


def _loss_and_grads(cfg, params, inputs, remat):
    """The zoo's loss through ``make_head_loss_fn`` with ``remat``, and the
    gradient of every param; the bytes autograd saved for the backward."""
    fn = tgspmd.make_head_loss_fn(
        cfg, tbase.HeadConfig(backend="ref"),
        global_tokens=inputs["labels"].numel(),
        par=tbase.ring_parallel_config(1, remat))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (loss, _), grads = _value_and_grad(
            lambda p, x: fn(p, (), (), x), params, inputs)
    return loss, tree_leaves(grads), sum(saved)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bit_equal_to_none(family):
    """Each family at ``reduced()``: the loss (with the moe family's router
    loss) and every gradient with each layer checkpointed equal those
    without, bit for bit, while the backward keeps fewer bytes."""
    cfg = tbase.get_model_config(FAMILIES[family], reduced=True)
    assert cfg.family == family
    params = lm.init_model(torch.Generator().manual_seed(0), cfg)
    inputs = _family_batch(cfg)
    l0, g0, saved0 = _loss_and_grads(cfg, params, inputs, "none")
    l1, g1, saved1 = _loss_and_grads(cfg, params, inputs, "full")
    assert torch.isfinite(l0)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) == len(tree_leaves(params))
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert saved1 < saved0


def test_remat_spares_caches_and_inference():
    """A prefill wants its caches and an evaluation takes no gradient:
    with ``remat="full"`` both run unchanged."""
    cfg = tbase.get_model_config("hymba_1_5b", reduced=True)
    params = lm.init_model(torch.Generator().manual_seed(0), cfg)
    x = _family_batch(cfg)
    shape = tbase.InputShape("p", 16, 2, "prefill")
    outs = [tgspmd.make_prefill_step(
        cfg, shape, par=tbase.ring_parallel_config(1, r))(params, x)
        for r in ("none", "full")]
    assert torch.equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k])
    accs = [tgspmd.make_head_eval_step(
        cfg, tbase.HeadConfig(backend="ref"),
        par=tbase.ring_parallel_config(1, r))(params, (), (), x)
        for r in ("none", "full")]
    assert torch.equal(*accs)


def test_zoo_step_with_remat_matches_the_jax_zoo():
    """One zoo batch's loss and gradient with ``remat="full"`` on both
    sides (the JAX package's ``jax.checkpoint`` around its scan body,
    the port's per-layer ``torch.utils.checkpoint``), within the zoo
    trainer's gradient tolerance."""
    exp = JaxZooExperiment(arch="smollm_135m", reduced=True, n_model=1,
                           batch=4, seq=8, log_every=0)
    par = dataclasses.replace(exp.par, remat="full")
    inputs = jax.tree.map(np.asarray, exp._batch(0))
    with jax.set_mesh(exp.mesh):
        loss_fn = jgspmd.make_head_loss_fn(
            exp.model_cfg, exp.head_cfg, par, exp.mesh, global_tokens=32,
            head=exp.head)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, (), (), inputs), has_aux=True))(exp.params)
    tree = jax.tree.map(np.asarray, jax.device_get(exp.params))
    port = testing._zoo_experiment(tree, {"softmax_impl": "full"},
                                   arch="smollm_135m", batch=4, seq=8)
    fn = tgspmd.make_head_loss_fn(
        port.model_cfg, port.head_cfg, global_tokens=32, head=port.head,
        par=tbase.ring_parallel_config(1, "full"))
    x = {k: torch.as_tensor(np.array(v)) for k, v in inputs.items()}
    (tl, _), tg = _value_and_grad(lambda p, xx: fn(p, (), (), xx),
                                  port.params, x)
    assert float(tl) == pytest.approx(float(loss), rel=1e-6)
    got = jax.tree.leaves(interop.zoo_params_to_numpy(tg))
    want = jax.tree.leaves(jax.device_get(grads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------------------
# loss scaling
# ---------------------------------------------------------------------------


def test_scaled_grads_match_the_jax_package():
    """``scaled_grads`` returns the unscaled gradient and the loss, as the
    JAX package's does; an overflow clears the finite flag."""
    w, xv = np.asarray([1.0, 2.0], np.float32), np.asarray([0.5, -1.0],
                                                           np.float32)
    (jl, _), jg, jf = jscale.scaled_grads(
        lambda p, x: (jnp.sum(p["w"] * x) ** 2, {}), {"w": jnp.asarray(w)},
        jnp.asarray(xv), scale=jnp.asarray(1024.0))
    (tl, aux), tg, tf = scale.scaled_grads(
        lambda p, x: ((p["w"] * x).sum() ** 2, {}), {"w": torch.tensor(w)},
        torch.tensor(xv), scale=torch.tensor(1024.0))
    assert bool(tf) and bool(jf) and aux == {}
    assert float(tl) == pytest.approx(float(jl))
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]),
                               rtol=1e-6)
    _, _, finite = scale.scaled_grads(
        lambda p, x: ((p["w"] * x).sum() ** 2, {}), {"w": torch.tensor(w)},
        torch.tensor(xv), scale=torch.tensor(3e38))
    assert not bool(finite)


def test_dynamic_loss_scale_matches_the_jax_package():
    """The same scale and good-step count as the JAX package's over a
    sequence of finite and non-finite steps, through the growth interval,
    the floor and the ceiling."""
    flags = [True] * 5 + [False] + [True] * 7 + [False] * 4 + [True] * 9
    for initial, kw in ((1024.0, dict(growth_interval=4)),
                        (-2.0, dict(growth_interval=3, min_scale=1.0)),
                        (2.0 ** 23, dict(growth_interval=2))):
        js, ts = jscale.init_loss_scale(initial), scale.init_loss_scale(
            initial)
        for flag in flags:
            js, japply = jscale.dynamic_loss_scale(js, jnp.asarray(flag),
                                                   **kw)
            ts, tapply = scale.dynamic_loss_scale(ts, flag, **kw)
            assert float(ts.scale) == float(js.scale)
            assert int(ts.good_steps) == int(js.good_steps)
            assert bool(tapply) == bool(japply) == flag
        assert ts.scale.dtype == torch.float32
        assert ts.good_steps.dtype == torch.int32


# ---------------------------------------------------------------------------
# the in-place update
# ---------------------------------------------------------------------------


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((5, 3), generator=g),
            "b": [torch.randn(7, generator=g), torch.randn((2, 2, 2),
                                                           generator=g)]}


@pytest.mark.parametrize("name", ["sgd", "nesterov", "lars", "adam"])
def test_update_in_place_equals_the_tree_update(name):
    """Three steps of ``update_`` write, into the params and the moments,
    bit for bit what ``update`` + ``apply_updates`` return."""
    opt = {"sgd": sgd(0.9, 1e-4), "nesterov": sgd(0.9, 1e-4, nesterov=True),
           "lars": lars(), "adam": adam(weight_decay=1e-4)}[name]
    p_tree, p_inpl = _tree(0), _tree(0)
    s_tree, s_inpl = opt.init(p_tree), opt.init(p_inpl)
    for step in range(3):
        grads = _tree(10 + step)
        upd, s_tree = opt.update(grads, s_tree, p_tree, 0.1)
        p_tree = apply_updates(p_tree, upd)
        mu_before = tree_leaves(s_inpl.mu)
        s_inpl = opt.update_(grads, s_inpl, p_inpl, 0.1)
        assert all(a is b for a, b in zip(tree_leaves(s_inpl.mu),
                                          mu_before))
        assert s_inpl.step == s_tree.step == step + 1
        for a, b in zip(tree_leaves((p_inpl, s_inpl)),
                        tree_leaves((p_tree, s_tree))):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _old_formula(monkeypatch, module):
    """Make ``module``'s trainers update through the whole-tree formula
    the port used before the in-place update."""
    real = module.make_optimizer

    def make(cfg):
        opt = real(cfg)

        def update_(grads, state, params, lr):
            updates, state = opt.update(grads, state, params, lr)
            assign(params, apply_updates(params, updates))
            return state
        return opt._replace(update_=update_)

    monkeypatch.setattr(module, "make_optimizer", make)


def _paper_fit():
    exp = Experiment.from_config(system="paper", classes=64, feat_dim=16,
                                 batch=16, device="cpu", log_every=0,
                                 train=tbase.TrainConfig(optimizer="lars"))
    hist = exp.fit(3, use_fccs_batch=False)
    return hist, tree_leaves((exp.state.fe_params, exp.state.head_params,
                              exp.state.opt_state.mu))


def _zoo_fit():
    exp = Experiment.from_config(system="zoo", arch="smollm_135m",
                                 reduced=True, batch=4, seq=8, device="cpu",
                                 log_every=0,
                                 train=tbase.TrainConfig(optimizer="sgd"))
    hist = exp.fit(3, lr=0.5)
    return hist, tree_leaves((exp.params, exp.opt_state.mu))


@pytest.mark.parametrize("trainer", ["paper", "zoo"])
def test_fit_in_place_is_bit_equal_to_the_old_update(trainer, monkeypatch):
    """``fit(3)`` of the paper trainer (LARS) and of the zoo trainer (SGD)
    with the in-place update against the same runs through the old
    ``apply_updates`` + ``assign``: histories and every param and moment
    bit-equal."""
    run = _paper_fit if trainer == "paper" else _zoo_fit
    hist, leaves = run()
    _old_formula(monkeypatch, thybrid if trainer == "paper" else tgspmd)
    hist_old, leaves_old = run()
    assert hist == hist_old
    assert len(leaves) == len(leaves_old)
    for a, b in zip(leaves, leaves_old):
        assert torch.equal(a, b)
