"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``).  Sources live in each
kernel's ``csrc/`` and are built on first use by ``_build``."""
