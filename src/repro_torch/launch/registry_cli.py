"""Registry CLI of the PyTorch port: list / inspect / verify the sha256
artifact registry (the JAX package's ``launch/registry_cli.py``, the same
commands, output and exit codes over the same registry layout).

    python -m repro_torch.launch.registry_cli --registry runs/registry list
    python -m repro_torch.launch.registry_cli --registry runs/registry \
        inspect qwen3-hashed@2
    python -m repro_torch.launch.registry_cli --registry runs/registry verify
    python -m repro_torch.launch.registry_cli --registry runs/registry \
        verify qwen3-hashed

- ``list``    — every model, its versions, sizes, and latest pointer.
- ``inspect`` — one entry in full: index record + the artifact file's
  own header (config name, sections, dtypes) via `artifact.format`.
- ``verify``  — re-hash artifact files against the recorded sha256
  (all models, or the named ones).  Exit code 1 if anything fails —
  usable as a pre-serving health gate in CI/cron.

``--json`` switches every command to machine-readable output.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from repro_torch.artifact import registry as reg


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"               # pragma: no cover


def cmd_list(root: str, as_json: bool) -> int:
    models = reg.list_models(root)
    if as_json:
        print(json.dumps(models, indent=1, sort_keys=True))
        return 0
    if not models:
        print(f"registry {root}: empty")
        return 0
    for name in sorted(models):
        m = models[name]
        print(f"{name}  (latest: v{m['latest']})")
        for v in sorted(m["versions"], key=int):
            e = m["versions"][v]
            meta = f"  {e['metadata']}" if e.get("metadata") else ""
            print(f"  v{v}: {e['file']}  {_fmt_bytes(e['bytes'])}  "
                  f"sha256={e['sha256'][:12]}…{meta}")
    return 0


def cmd_inspect(root: str, spec: str, as_json: bool) -> int:
    from repro_torch.artifact import format as afmt
    entry = reg.resolve(root, spec, verify=False)
    header = afmt.read_header(entry["path"])
    out = {"name": entry["name"], "version": entry["version"],
           "path": entry["path"], "index_entry": {
               k: v for k, v in entry.items()
               if k not in ("name", "version", "path")},
           "header": header}
    if as_json:
        print(json.dumps(out, indent=1, sort_keys=True, default=str))
        return 0
    print(f"{entry['name']}@{entry['version']}  -> {entry['path']}")
    print(f"  bytes={_fmt_bytes(entry['bytes'])}  "
          f"sha256={entry['sha256']}")
    if entry.get("metadata"):
        print(f"  metadata: {entry['metadata']}")
    cfg = header.get("config") or {}
    if cfg:
        print(f"  config: {cfg.get('name', '?')}  "
              f"family={cfg.get('family', '?')}  "
              f"layers={cfg.get('num_layers', '?')}  "
              f"d_model={cfg.get('d_model', '?')}")
    tensors = header.get("tensors") or header.get("sections") or []
    print(f"  header keys: {sorted(header)}  ({len(tensors)} tensor "
          f"records)" if tensors else f"  header keys: {sorted(header)}")
    return 0


def cmd_verify(root: str, specs: List[str], as_json: bool) -> int:
    targets: List[str] = []
    if specs:
        targets = specs
    else:
        for name, m in sorted(reg.list_models(root).items()):
            targets.extend(f"{name}@{v}" for v in sorted(m["versions"],
                                                         key=int))
    results = []
    failed = 0
    for spec in targets:
        try:
            entry = reg.resolve(root, spec, verify=False)
            actual = reg.sha256_file(entry["path"]) \
                if os.path.exists(entry["path"]) else None
            ok = actual == entry["sha256"]
        except (KeyError, FileNotFoundError) as e:
            results.append({"spec": spec, "ok": False, "error": str(e)})
            failed += 1
            continue
        results.append({"spec": f"{entry['name']}@{entry['version']}",
                        "ok": ok,
                        "expected": entry["sha256"],
                        "actual": actual})
        failed += 0 if ok else 1
    if as_json:
        print(json.dumps({"verified": len(results), "failed": failed,
                          "results": results}, indent=1))
    else:
        for r in results:
            mark = "ok " if r["ok"] else "FAIL"
            detail = r.get("error") or \
                (f"sha256 mismatch (file {str(r.get('actual'))[:12]}…)"
                 if not r["ok"] else f"sha256={r['expected'][:12]}…")
            print(f"[{mark}] {r['spec']}  {detail}")
        print(f"{len(results)} verified, {failed} failed")
    return 1 if failed else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="list/inspect/verify the model artifact registry")
    p.add_argument("--registry", required=True,
                   help="registry root directory")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="all models and versions")
    pi = sub.add_parser("inspect", help="one entry + artifact header")
    pi.add_argument("spec", help="name[@version]")
    pv = sub.add_parser("verify",
                        help="re-hash artifacts against recorded sha256")
    pv.add_argument("specs", nargs="*",
                    help="name[@version]... (default: everything)")
    args = p.parse_args(argv)
    if not os.path.isdir(args.registry):
        print(f"no registry at {args.registry}", file=sys.stderr)
        return 2
    if args.cmd == "list":
        return cmd_list(args.registry, args.json)
    if args.cmd == "inspect":
        return cmd_inspect(args.registry, args.spec, args.json)
    return cmd_verify(args.registry, args.specs, args.json)


if __name__ == "__main__":
    raise SystemExit(main())
