"""The port's ResNet trunk (``models/resnet.py``, the cnn branches of
``models/lm.py``, ``data.synthetic.sku_image_batch``) against the JAX
package, on the CPU, on the same numpy arrays.

* XLA's ``"SAME"`` padding: ``conv`` and the max pool at strides 1 and 2
  on odd and even sizes, exact (integer-valued convolutions);
* ``group_norm``, one bottleneck with and without projection, the reduced
  ResNet forward and its gradient (fp32: rtol 1e-4, atol 1e-5);
* ResNet-50 (``sku100m_resnet.config(64)``) forward on 2 x 32 x 32 images
  with the JAX params, fp32; the reduced trunk in bf16 within 2e-2;
* the cnn model's tree, leaf order and head; the synthetic images' class
  pattern.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import sku100m_resnet as jax_sku
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.models import resnet as jres
from repro_torch.configs import sku100m_resnet
from repro_torch.core import sparsify as sp
from repro_torch.data import synthetic
from repro_torch.models import lm, resnet
from repro_torch.optim import tree_map
from tests.torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)

def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _nchw(x):
    """NHWC numpy -> an NCHW view, as the port's layers take it."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# ---------------------------------------------------------------------------
# "SAME" padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [7, 8, 9, 32, 33])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (7, 2)])
def test_conv_same_padding_exact(size, k, stride):
    rng = np.random.default_rng(size * 10 + k + stride)
    x = rng.integers(-3, 4, (2, size, size, 5)).astype(np.float32)
    w = rng.integers(-2, 3, (k, k, 5, 4)).astype(np.float32)
    ref = np.asarray(jres.conv(jnp.asarray(x), jnp.asarray(w), stride))
    out = _nhwc(resnet.conv(_nchw(x), torch.from_numpy(w), stride))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size", [7, 8, 9, 112])
@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_same_padding_exact(size, stride):
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    x[0, 0, :, 0] = -5.0                      # an edge where -inf pads
    ref = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
        (1, stride, stride, 1), "SAME"))
    out = _nhwc(resnet.max_pool_same(_nchw(x), 3, stride))
    np.testing.assert_array_equal(out, ref)


def test_same_padding_is_xla_not_symmetric():
    assert resnet.same_padding(224, 7, 2) == (2, 3)
    assert resnet.same_padding(112, 3, 2) == (0, 1)
    assert resnet.same_padding(56, 1, 2) == (0, 0)
    assert resnet.same_padding(56, 3, 1) == (1, 1)


# ---------------------------------------------------------------------------
# layers and the trunk, fp32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [4, 16, 64])
def test_group_norm_matches_jax(c):
    rng = np.random.default_rng(c)
    x = (2 + 3 * rng.standard_normal((2, 5, 6, c))).astype(np.float32)
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    ref = np.asarray(jres.group_norm(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x)))
    out = _nhwc(resnet.group_norm(tree_map(torch.from_numpy, p), _nchw(x)))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("c_in,c_mid,stride", [(64, 16, 1), (32, 16, 2),
                                               (64, 16, 2)])
def test_bottleneck_matches_jax(c_in, c_mid, stride):
    p = jres.init_bottleneck(jax.random.PRNGKey(c_in + stride), c_in, c_mid,
                             stride)
    assert ("proj" in p) == (stride != 1 or c_in != 4 * c_mid)
    x = np.random.default_rng(stride).standard_normal(
        (2, 9, 9, c_in)).astype(np.float32)
    ref = np.asarray(jres.apply_bottleneck(p, jnp.asarray(x), stride))
    out = _nhwc(resnet.apply_bottleneck(_to_torch(p), _nchw(x), stride))
    np.testing.assert_allclose(out, ref, **TOL)


def _images(b, hw, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, hw, hw, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reduced():
    cfg = dataclasses.replace(jax_sku.reduced(64), dtype="float32")
    p = jres.init_resnet(jax.random.PRNGKey(1), cfg)
    return cfg, p


def test_reduced_forward_and_grad_match_jax():
    cfg, p = _reduced()
    tcfg = dataclasses.replace(sku100m_resnet.reduced(64), dtype="float32")
    x = _images(3, 32)
    r = np.random.default_rng(5).standard_normal((3, 1, 128)).astype(
        np.float32)

    def jloss(p):
        return jnp.sum(jres.apply_resnet(p, cfg, jnp.asarray(x)) * r)

    ref_feat = np.asarray(jax.jit(
        lambda p: jres.apply_resnet(p, cfg, jnp.asarray(x)))(p))
    ref_grad = jax.jit(jax.grad(jloss))(p)
    tp = tree_map(lambda t: t.requires_grad_(True), _to_torch(p))
    feat = resnet.apply_resnet(tp, tcfg, torch.from_numpy(x))
    assert feat.shape == (3, 1, 128)
    np.testing.assert_allclose(feat.detach().numpy(), ref_feat, **TOL)
    (feat * torch.from_numpy(r)).sum().backward()
    jl, (pl, _) = jax.tree.leaves(ref_grad), sp.flatten(tp)
    assert len(jl) == len(pl)
    for a, b in zip(pl, jl):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL)


def test_resnet50_forward_matches_jax():
    """ResNet-50 at D=512 (``config(64)``, fp32) on 2 x 32 x 32 images."""
    cfg = dataclasses.replace(jax_sku.config(64), dtype="float32")
    tcfg = dataclasses.replace(sku100m_resnet.config(64), dtype="float32")
    p = jres.init_resnet(jax.random.PRNGKey(2), cfg)
    x = _images(2, 32, seed=2)
    ref = np.asarray(jax.jit(lambda p, x: jres.apply_resnet(p, cfg, x))(
        p, jnp.asarray(x)))
    with torch.no_grad():
        out = resnet.apply_resnet(_to_torch(p), tcfg,
                                  torch.from_numpy(x)).numpy()
    assert out.shape == (2, 1, 512)
    np.testing.assert_allclose(out, ref, **TOL)


def test_reduced_bf16_forward_within_2e_2():
    """bf16 convs over fp32 params: rounding at other places than XLA's,
    relative error of the features within 2e-2."""
    cfg, p = _reduced()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    tcfg = sku100m_resnet.reduced(64)
    assert tcfg.dtype == "bfloat16"
    x = _images(4, 32, seed=3)
    ref = np.asarray(jax.jit(lambda p, x: jlm.backbone(
        {"trunk": p}, cfg, {"images": x})[0].astype(jnp.float32))(
            p, jnp.asarray(x)))
    with torch.no_grad():
        out, aux, caches = lm.backbone({"trunk": _to_torch(p)}, tcfg,
                                       {"images": torch.from_numpy(x)})
    assert out.dtype == torch.bfloat16 and caches is None
    assert float(aux) == 0.0
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= 2e-2, err


# ---------------------------------------------------------------------------
# the model tree and the data
# ---------------------------------------------------------------------------


def test_cnn_model_tree_matches_jax():
    cfg = jax_sku.reduced(64)
    jtree = jax.eval_shape(lambda: jlm.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    tree = lm.init_model(torch.Generator().manual_seed(0),
                         sku100m_resnet.reduced(64))
    lm.require_ported(sku100m_resnet.config_1m())
    paths = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    leaves = sp.flatten(tree)[0]
    assert [tuple(t.shape) for t in leaves] == [
        tuple(a.shape) for a in jax.tree.leaves(jtree)]
    assert len(paths) == len(leaves)
    assert lm.head_weight(tree, sku100m_resnet.reduced(64)) is tree["head"]
    assert tuple(tree["head"].shape) == (64, 128)
    # the init's scales: He-normal kernels, unit GroupNorm
    stem = tree["trunk"]["stem"]
    assert abs(float(stem.std()) - (2 / (7 * 7 * 3)) ** 0.5) < 0.02
    assert torch.equal(tree["trunk"]["gn_stem"]["scale"], torch.ones(64))


def test_sku_image_batch_pattern_matches_jax():
    ref = jsyn.sku_image_batch(3, 6, 1000, hw=16, noise=0.0)
    labels = torch.from_numpy(np.asarray(ref["labels"]).astype(np.int64))
    # sin and cos of arguments up to ~70 in fp32 (an ulp of 70 is 7.6e-6),
    # from linspaces that may differ in their last bit
    np.testing.assert_allclose(
        synthetic.class_pattern(labels, 16).numpy(),
        np.asarray(ref["images"]), atol=5e-5)
    b = synthetic.sku_image_batch(3, 6, 1000, hw=16)
    assert b["images"].shape == (6, 16, 16, 3)
    assert b["images"].dtype == torch.float32
    assert int(b["labels"].max()) < 1000
    again = synthetic.sku_image_batch(3, 6, 1000, hw=16)
    assert torch.equal(b["images"], again["images"])
    noise = b["images"] - synthetic.class_pattern(b["labels"], 16)
    assert 0.2 < float(noise.std()) < 0.4
