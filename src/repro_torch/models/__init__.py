"""Model code of the port: the hybrid (zamba2) family that the serving
path runs.  Mirrors ``repro.models``; the other families wait (see
ROADMAP.md)."""
from .config import ModelConfig, ShapeConfig, pad_vocab
from .model import Model, make_model
