"""PyTorch/CUDA port of the CGRA power and timing estimator.

The JAX package ``repro`` is the reference; this package mirrors its
layout module for module (``core/``, ``kernels/``, ``apps/``) and holds
each part to it in ``tests/test_torch_*.py``.  It imports ``torch`` and
numpy, never ``jax`` or ``repro``: framework-free modules of the
reference are carried over as copies.

Entry points (``core.dse.sweep``, ``core.dse.make_sweep_fn``,
``core.cgra.run_program``, ``core.characterization.characterize``) run
on the CUDA device unless the caller passes ``device="cpu"``; with no
GPU and no explicit device they raise instead of choosing the CPU.
"""
