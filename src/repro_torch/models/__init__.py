"""Model code of the port: the hybrid (zamba2) family and the decoder-only
transformer families (dense, moe, vlm) that the serving path runs.
Mirrors ``repro.models``; encdec and ssm wait (see ROADMAP.md)."""
from .config import ModelConfig, ShapeConfig, pad_vocab
from .model import Model, make_model
