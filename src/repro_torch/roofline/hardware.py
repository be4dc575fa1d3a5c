"""The H100 SXM's rates, the denominators of every bound and roofline
term in the port (``kernels.cost``, ``roofline.analysis``,
``chip_smoke.py``). They replace the TPU v5e constants of the JAX
package's ``roofline/analysis.py``.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 data sheet (dense, no sparsity):
BF16_FLOPS = 989e12      # bf16 / fp16 tensor cores
TF32_FLOPS = 494.7e12    # TF32 tensor cores
FP32_FLOPS = 67e12       # fp32 outside the tensor cores (FMA = 2 ops)
HBM_BW = 3.35e12         # HBM3, bytes/s
# NVLink 4: 900 GB/s a card in both directions together; a ring's
# collective moves one direction's share, so 450 GB/s each way is the
# rate a collective term divides by (the choice stated)
LINK_BW = 450e9
HBM_BYTES = 80e9         # the H100 SXM 80GB's memory, what a step must fit

# operations a second by the rate class a count carries
RATES = {"bf16": BF16_FLOPS, "tf32": TF32_FLOPS, "fp32": FP32_FLOPS}
