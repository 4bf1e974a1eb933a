"""Flash attention: CUDA kernel (``csrc/flash_attention.cu``), plain
version (``ref.attention_ref``) and wrapper (``ops.attention``)."""
