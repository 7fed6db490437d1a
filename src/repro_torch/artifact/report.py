"""Per-layer compression accounting: virtual vs real vs on-disk bytes.

The PyTorch port's copy of the JAX package's ``artifact/report.py``: the
same rows and the same text for the same file.  Reproduces the paper's
compression-ratio tables for our configs, extended
with the two things the paper didn't have to account for: per-group
quantization scales and the artifact header.  Three sizes per leaf:

- virtual: the dense matrix the layer *behaves* as (rows x cols x stack,
  at the restore dtype) — what a non-hashed checkpoint would store.
- real:   the bank actually parameterizing it (spec.real_param_count).
- disk:   bytes in the artifact (codes + scales after quantization).

Rows are aggregated per top-level component ("layers/attn/q", ...), which
matches the per-layer budgeting view of Structured Multi-Hashing (Eban et
al., 2019): each component's ratio is independently visible, so a config
sweep can trade compression between, say, attention and FFN banks.

When the artifact's config carries a compression policy, a second view
(:func:`rows_by_rule`) groups leaves by the policy rule that decided them
— the accounting that tells you whether each rule's slice of the budget
landed where the solver put it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.artifact import format as F
from repro_torch.artifact import quant as Q
from repro_torch.core import hashed as H


def _dtype_size(name: str) -> int:
    return Q.itemsize(name)


def _group_name(path) -> str:
    parts = [str(p) for p in path if not isinstance(p, int)]
    return "/".join(parts[:-1] if len(parts) > 1 else parts)


def artifact_rows(header: dict) -> List[Dict[str, Any]]:
    """One accounting row per leaf group, from the header alone."""
    groups: Dict[str, Dict[str, Any]] = {}
    for e in header["leaves"]:
        name = _group_name(e["path"])
        g = groups.setdefault(name, {
            "name": name, "kind": e["kind"], "virtual_params": 0,
            "real_params": 0, "virtual_bytes": 0, "real_bytes": 0,
            "disk_bytes": 0})
        n_elems = int(np.prod(e["shape"])) if e["shape"] else 1
        esize = _dtype_size(e["dtype"])
        if e["kind"] == "bank":
            spec = H.spec_from_dict(e["spec"])
            stack = int(e.get("stack", 1))
            virtual = spec.virtual_size * stack
        else:
            virtual = n_elems
        g["virtual_params"] += virtual
        g["real_params"] += n_elems
        g["virtual_bytes"] += virtual * esize
        g["real_bytes"] += n_elems * esize
        disk = e["nbytes"]
        if e.get("quant"):
            disk += e["quant"]["scales_nbytes"]
        g["disk_bytes"] += disk
        if e["kind"] == "bank":
            g["kind"] = "bank"
    rows = sorted(groups.values(), key=lambda r: -r["virtual_bytes"])
    for r in rows:
        r["param_ratio"] = r["real_params"] / max(r["virtual_params"], 1)
        r["disk_ratio"] = r["disk_bytes"] / max(r["virtual_bytes"], 1)
    return rows


def totals(rows: List[Dict[str, Any]], header: Optional[dict] = None
           ) -> Dict[str, Any]:
    t = {"name": "TOTAL", "virtual_params": 0, "real_params": 0,
         "virtual_bytes": 0, "real_bytes": 0, "disk_bytes": 0}
    for r in rows:
        for k in ("virtual_params", "real_params", "virtual_bytes",
                  "real_bytes", "disk_bytes"):
            t[k] += r[k]
    if header is not None:
        t["header_bytes"] = header["data_start"]
        t["disk_bytes_with_header"] = t["disk_bytes"] + header["data_start"]
    t["param_ratio"] = t["real_params"] / max(t["virtual_params"], 1)
    t["disk_ratio"] = t["disk_bytes"] / max(t["virtual_bytes"], 1)
    return t


def format_table(rows: List[Dict[str, Any]],
                 total: Optional[Dict[str, Any]] = None) -> str:
    """The paper's table, per component: virtual / real / disk / ratios."""
    hdr = (f"{'component':<28} {'kind':<6} {'virtual':>12} {'real':>12} "
           f"{'disk(B)':>12} {'c':>7} {'disk/dense':>10}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows + ([total] if total else []):
        lines.append(
            f"{r['name']:<28} {r.get('kind', ''):<6} "
            f"{r['virtual_params']:>12,} {r['real_params']:>12,} "
            f"{r['disk_bytes']:>12,} {r['param_ratio']:>7.3f} "
            f"{r['disk_ratio']:>10.4f}")
    return "\n".join(lines)


def rows_by_rule(header: dict) -> Optional[List[Dict[str, Any]]]:
    """Accounting rows grouped by the policy rule that matched each leaf.

    Returns None when the artifact has no hashed config to derive a
    policy from.  Bank leaves group under their matched rule's pattern
    (``(defaults)`` when no rule matched); non-bank leaves group under
    ``(dense)``.
    """
    from repro_torch import policy as POL
    cfg_dict = header.get("config")
    if not cfg_dict or not cfg_dict.get("hashed"):
        return None
    cfg = F.config_from_dict(cfg_dict)
    pol = POL.effective(cfg)
    groups: Dict[str, Dict[str, Any]] = {}
    for e in header["leaves"]:
        if e["kind"] == "bank":
            rule = pol.match(POL.slot_path(tuple(e["path"])))
            name = rule.match if rule is not None else "(defaults)"
        else:
            name = "(dense)"
        g = groups.setdefault(name, {
            "name": name, "kind": e["kind"], "virtual_params": 0,
            "real_params": 0, "virtual_bytes": 0, "real_bytes": 0,
            "disk_bytes": 0})
        n_elems = int(np.prod(e["shape"])) if e["shape"] else 1
        esize = _dtype_size(e["dtype"])
        if e["kind"] == "bank":
            spec = H.spec_from_dict(e["spec"])
            virtual = spec.virtual_size * int(e.get("stack", 1))
        else:
            virtual = n_elems
        g["virtual_params"] += virtual
        g["real_params"] += n_elems
        g["virtual_bytes"] += virtual * esize
        g["real_bytes"] += n_elems * esize
        disk = e["nbytes"]
        if e.get("quant"):
            disk += e["quant"]["scales_nbytes"]
        g["disk_bytes"] += disk
    rows = sorted(groups.values(), key=lambda r: -r["virtual_bytes"])
    for r in rows:
        r["param_ratio"] = r["real_params"] / max(r["virtual_params"], 1)
        r["disk_ratio"] = r["disk_bytes"] / max(r["virtual_bytes"], 1)
    return rows


def report(path_or_header) -> str:
    """Convenience: artifact path (or header) -> printable table(s)."""
    header = (path_or_header if isinstance(path_or_header, dict)
              else F.read_header(path_or_header))
    rows = artifact_rows(header)
    out = format_table(rows, totals(rows, header))
    by_rule = rows_by_rule(header)
    if by_rule is not None:
        out += "\n\nby policy rule:\n"
        out += format_table(by_rule, totals(by_rule))
    return out
