"""Data of the PyTorch port: the synthetic LM token stream and the
synthetic analogues of the paper's eight image datasets."""
from repro_torch.data import lm_stream, mnist_synthetic  # noqa: F401
