from .pipeline import DataConfig, SyntheticLMStream, make_stream
