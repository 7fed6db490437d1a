"""The paper's own experiments (Chen et al. 2015 §6) in the PyTorch
port: HashNet and its baselines as MLPs (``mlp``) and their SGD training
loop (``train``)."""
from repro_torch.paper import mlp, train  # noqa: F401
