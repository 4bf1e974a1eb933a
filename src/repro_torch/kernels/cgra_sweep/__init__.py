"""Fused CGRA sweep engine: CUDA kernel (``csrc/cgra_sweep.cu``), plain
version (``ref.sweep_ref``) and wrapper (``ops.sweep_engine``)."""
