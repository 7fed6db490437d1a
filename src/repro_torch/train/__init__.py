"""Training of the PyTorch port: optimizers and the train step."""
from repro_torch.train import optimizer, step  # noqa: F401
