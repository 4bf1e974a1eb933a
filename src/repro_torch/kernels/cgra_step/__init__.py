"""Batched CGRA ALU dispatch: CUDA kernel, plain version and wrapper."""
