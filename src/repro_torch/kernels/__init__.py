"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch
versions. Each kernel module holds the wrapper (kernel on a CUDA tensor,
plain version on a CPU tensor), the plain version, and a ``LAUNCHES``
counter; ``build`` compiles ``csrc/*.cu`` at first use."""
