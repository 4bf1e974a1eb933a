"""Model code of the port: every family of the reference (the hybrid
zamba2, the decoder-only dense / moe / vlm transformers, the
encoder-decoder whisper and the xLSTM).  Mirrors ``repro.models``."""
from .config import ModelConfig, ShapeConfig, pad_vocab
from .model import Model, make_model
