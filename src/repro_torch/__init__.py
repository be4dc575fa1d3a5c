"""``repro_torch`` — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

The module layout mirrors the JAX package, so each module's counterpart
is easy to find. The port imports ``torch`` and numpy only: nothing of
JAX and nothing of the JAX package. Its entry points run on the card
(``device=None`` means ``"cuda"``) and raise when there is none, unless
the caller passes ``device="cpu"``.

Ported so far: the paper system's serving path (``Experiment.serve``,
the serving engine and ``python -m repro_torch.launch.serve``) with the
``full`` head, and its two kernels (``kernels/ce_softmax.py`` and
``kernels/topk_dc.py``). ROADMAP.md lists what comes next.
"""
