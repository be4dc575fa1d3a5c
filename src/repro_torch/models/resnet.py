"""ResNet-v1.5-style CNN feature extractor, the paper's own FE trunk
(ResNet-50, D=512 embedding): the port of the JAX package's
``models/resnet.py``.

GroupNorm stands in for BatchNorm, as there: the data-parallel trunk keeps
no cross-member batch statistics and no train/eval state. Plain functions
over nested dicts of tensors, in the JAX package's layouts and names:

* images are NHWC ``[B, H, W, 3]``; conv kernels are HWIO ``[kh, kw, in,
  out]``, so the port's params, their LARS moments and DGC's u and v map
  one to one onto the JAX trees (``repro_torch.interop``). The forward
  runs contiguous NCHW (the images transposed once) and forms each
  kernel's OIHW copy where it is used: on an H100 80GB HBM3 at 700 W the
  trunk's forward and backward of 128 images at 224 x 224 in bf16 took
  69 ms so against 104 ms in the ``channels_last`` format, whose
  GroupNorm copied every activation to NCHW and back (PERF.md).
* ``"SAME"`` padding is XLA's: for a window k at stride s over n
  positions, ``(ceil(n / s) - 1) s + k - n`` in all, the smaller half
  before. The 7x7/2 stem pads (2, 3) at 224, the 3x3/2 convs and the
  3x3/2 max pool (0, 1), the 1x1/2 projections nothing; torch's
  ``padding=`` pads both sides alike, so the port pads explicitly (the max
  pool with -inf).
* GroupNorm: groups of ``min(8, c)``, fp32 statistics, biased variance,
  eps 1e-5, fp32 scale and bias, cast back to the input dtype; the kernel
  of a conv is cast to the activation dtype (bf16 convs over fp32 params
  for ``sku100m_resnet.config``).
* The param dicts are built with their keys in sorted order, the order of
  ``jax.tree.flatten``, so the port's leaf order is the JAX package's
  (DGC groups leaves in that order, ``core.sparsify``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import randn

STAGES_50 = ((64, 3), (128, 4), (256, 6), (512, 3))
STAGES_REDUCED = ((32, 1), (64, 1))


def stages_for(cfg: ModelConfig):
    return STAGES_50 if cfg.n_layers >= 50 else STAGES_REDUCED


def _conv_init(gen: torch.Generator, shape):
    fan_in = shape[0] * shape[1] * shape[2]
    return randn(gen, shape) / math.sqrt(fan_in / 2)


def _gn_params(c: int, device):
    return {"bias": torch.zeros(c, device=device),
            "scale": torch.ones(c, device=device)}


def same_padding(n: int, k: int, s: int) -> tuple:
    """XLA's ``"SAME"`` padding (low, high) of a window k at stride s over
    n positions."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, s: int, value: float = 0.0):
    """x [B, C, H, W] padded as XLA pads it for a k x k window at stride
    s."""
    (ht, hb), (wl, wr) = (same_padding(x.shape[2], k, s),
                          same_padding(x.shape[3], k, s))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x


def group_norm(p, x, groups: int = 8, eps: float = 1e-5):
    """GroupNorm of x [B, C, H, W] in fp32 statistics, cast back to x's
    dtype (``F.group_norm`` of the fp32 copy: biased variance, eps inside
    the root, the JAX package's arithmetic)."""
    g = min(groups, x.shape[1])
    y = F.group_norm(x.float(), g, p["scale"], p["bias"], eps)
    return y.to(x.dtype)


def conv(x, w, stride: int = 1):
    """x [B, C, H, W] with the HWIO kernel w, cast to x's dtype, "SAME"
    padded."""
    wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous()     # OIHW
    x = _pad_same(x, w.shape[0], stride)
    return F.conv2d(x, wt, stride=stride)


def max_pool_same(x, k: int = 3, s: int = 2):
    """k x k max pool at stride s, "SAME" padded with -inf."""
    return F.max_pool2d(_pad_same(x, k, s, float("-inf")), k, s)


def init_bottleneck(gen: torch.Generator, c_in: int, c_mid: int,
                    stride: int) -> dict:
    c_out = c_mid * 4
    dev = gen.device
    p = {"conv1": _conv_init(gen, (1, 1, c_in, c_mid)),
         "conv2": _conv_init(gen, (3, 3, c_mid, c_mid)),
         "conv3": _conv_init(gen, (1, 1, c_mid, c_out)),
         "gn1": _gn_params(c_mid, dev), "gn2": _gn_params(c_mid, dev),
         "gn3": _gn_params(c_out, dev)}
    if stride != 1 or c_in != c_out:
        p["gn_proj"] = _gn_params(c_out, dev)
        p["proj"] = _conv_init(gen, (1, 1, c_in, c_out))
    return p


def apply_bottleneck(p, x, stride: int):
    h = F.relu(group_norm(p["gn1"], conv(x, p["conv1"])))
    h = F.relu(group_norm(p["gn2"], conv(h, p["conv2"], stride)))
    h = group_norm(p["gn3"], conv(h, p["conv3"]))
    if "proj" in p:
        x = group_norm(p["gn_proj"], conv(x, p["proj"], stride))
    return F.relu(x + h)


def _strides(cfg: ModelConfig):
    """The stride of every bottleneck, in order."""
    return [2 if (si > 0 and bi == 0) else 1
            for si, (_, n) in enumerate(stages_for(cfg)) for bi in range(n)]


def init_resnet(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random fp32 trunk params on ``gen``'s device: ``blocks`` (a list of
    bottleneck dicts), ``gn_stem``, ``head_w`` [C, D] and ``stem``."""
    stem = _conv_init(gen, (7, 7, 3, 64))
    blocks, c_in = [], 64
    for si, (c_mid, n_blocks) in enumerate(stages_for(cfg)):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            blocks.append(init_bottleneck(gen, c_in, c_mid, stride))
            c_in = c_mid * 4
    head_w = randn(gen, (c_in, cfg.d_model)) / math.sqrt(c_in)
    return {"blocks": blocks, "gn_stem": _gn_params(64, gen.device),
            "head_w": head_w, "stem": stem}


def apply_resnet(p, cfg: ModelConfig, images):
    """images [B, H, W, 3] -> features [B, 1, d_model] in images' dtype."""
    dt = images.dtype
    x = images.permute(0, 3, 1, 2).contiguous()    # NHWC -> NCHW
    x = F.relu(group_norm(p["gn_stem"], conv(x, p["stem"], 2)))
    x = max_pool_same(x)
    for bp, stride in zip(p["blocks"], _strides(cfg)):
        x = apply_bottleneck(bp, x, stride)
    feat = x.float().mean(dim=(2, 3)).to(dt)       # global average pool
    feat = feat @ p["head_w"].to(dt)
    return feat[:, None, :]
