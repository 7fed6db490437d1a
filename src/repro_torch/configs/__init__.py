"""Architecture configs of the PyTorch port.  Importing this package
registers everything: qwen3-1.7b (and its ``-reduced`` / ``-hashedN``
variants, derived by name) and the paper's two MLPs
(``hashmlp-3layer``, ``hashmlp-5layer``, run by ``repro_torch.paper``);
the other architectures of the JAX package come with ROADMAP Queue A
item 11."""
from repro_torch.configs.base import ArchConfig, get, names, register  # noqa: F401
from repro_torch.configs import hashmlp, qwen3_1_7b  # noqa: F401
from repro_torch.configs.reduced import reduced  # noqa: F401

ASSIGNED = ["qwen3-1.7b"]
