"""NN substrate of the PyTorch port: hashed-capable layers and blocks."""
from repro_torch.nn import layers, attention, ffn  # noqa: F401
