"""Training of the PyTorch port: optimizers, the train step, gradient
compression, checkpoints and fault tolerance."""
from repro_torch.train import (checkpoint, fault_tolerance,  # noqa: F401
                               grad_compress, optimizer, step)
