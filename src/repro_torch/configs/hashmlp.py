"""The paper's own experimental architectures: 3-layer (1 hidden) and
5-layer (3 hidden) fully-connected nets with 1000 hidden units, ReLU,
on 784-dim MNIST-variant inputs (Chen et al. 2015 §6).  The port's copy
of the JAX package's ``configs/hashmlp.py``."""
from repro_torch.configs.base import ArchConfig, register

# These are run by repro_torch.paper (a dedicated MLP implementation);
# the registry entries make them selectable by name, as in the JAX
# package.
MLP_3 = register(ArchConfig(
    name="hashmlp-3layer", family="mlp", arch_kind="decoder",
    num_layers=1, d_model=1000, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=1000, vocab_size=10, activation="relu",
))
MLP_5 = register(ArchConfig(
    name="hashmlp-5layer", family="mlp", arch_kind="decoder",
    num_layers=3, d_model=1000, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=1000, vocab_size=10, activation="relu",
))
