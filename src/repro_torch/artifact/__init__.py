"""Compressed model artifacts (the paper's storage claim, deployable): the
PyTorch port of the JAX package's ``artifact`` package, in its file
format.

A HashedNet is fully described by its real parameter banks plus hash
seeds; the virtual weights are recomputed at load with no additional
memory overhead (Chen et al., 2015).

- :mod:`repro_torch.artifact.format`   single-file mmap-able container
- :mod:`repro_torch.artifact.quant`    int8/fp8 bank quantization
- :mod:`repro_torch.artifact.io`       zero-copy cold-start loading
- :mod:`repro_torch.artifact.report`   paper-style compression tables
- :mod:`repro_torch.artifact.registry` versioned name -> artifact

Typical flow::

    from repro_torch import artifact
    header = artifact.export_model("m.hnart", cfg, params, quant="int8")
    print(artifact.report.report("m.hnart"))
    cfg, model, params = artifact.load_model("m.hnart")
"""
from __future__ import annotations

from typing import Optional

from repro_torch.artifact import format, io, quant, registry, report  # noqa: F401
from repro_torch.artifact.io import load, load_model, open_artifact  # noqa: F401


def export_model(path: str, cfg, params, *, quant: Optional[str] = None,
                 group: Optional[int] = None, quant_min_size: int = 4096,
                 meta: Optional[dict] = None) -> dict:
    """Serialize a built model's params into a compressed artifact.

    quant/group default to the config's artifact knobs
    (cfg.artifact_quant / cfg.artifact_group); a compression policy's
    per-slot quant overrides the scheme for that bank leaf.  Returns the
    header."""
    from repro_torch.artifact import format as F
    from repro_torch.models.transformer import bank_spec_map, slot_assignments

    scheme = getattr(cfg, "artifact_quant", "none") if quant is None \
        else quant
    grp = getattr(cfg, "artifact_group", 64) if group is None else group
    overrides = {path: a.quant for path, a in slot_assignments(cfg).items()
                 if a.quant is not None}
    return F.write(path, params, config=F.config_to_dict(cfg),
                   bank_specs=bank_spec_map(cfg), quant=scheme,
                   quant_group=grp, quant_min_size=quant_min_size,
                   quant_overrides=overrides, meta=meta)


def export_tree(path: str, params, *, bank_specs=None, quant: str = "none",
                group: int = 64, meta: Optional[dict] = None) -> dict:
    """Serialize any tree (e.g. a paper-MLP parameter list) without an
    ArchConfig; pass bank_specs for hashed-bank accounting."""
    from repro_torch.artifact import format as F
    return F.write(path, params, config=None, bank_specs=bank_specs,
                   quant=quant, quant_group=group, meta=meta)
