"""Data of the PyTorch port: the synthetic LM token stream."""
from repro_torch.data import lm_stream  # noqa: F401
