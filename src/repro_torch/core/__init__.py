"""HashedNets core (PyTorch port): stateless hashed weight sharing."""
from repro_torch.core.hashed import (HashedSpec, init, materialize,  # noqa: F401
                                     materialize_rows, matmul,
                                     spec_from_dict, spec_to_dict)
from repro_torch.core import hashing  # noqa: F401
