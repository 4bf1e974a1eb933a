"""Mamba2 intra-chunk SSD: CUDA kernel (``csrc/ssd_intra_chunk.cu``),
plain version (``ref.intra_chunk_ref``) and wrapper
(``ops.ssd_intra_chunk``)."""
