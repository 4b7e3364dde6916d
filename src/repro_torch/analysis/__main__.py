"""``python -m repro_torch.analysis`` — the port's tracelint CLI.

Exit codes: 0 clean (or informational run), 1 non-baselined findings
under ``--check``, 2 usage errors.

Typical invocations (from the repo root, with ``PYTHONPATH=src``)::

    python -m repro_torch.analysis                 # scan + audits, report
    python -m repro_torch.analysis --check         # gate: fail on new findings
    python -m repro_torch.analysis --write-baseline  # grandfather findings
    python -m repro_torch.analysis --rules host-sync,cuda-kernel --no-audit
    python -m repro_torch.analysis --check --device cpu  # audit on the CPU

Besides the AST rules it runs the dead-seed and port-import audits (the
latter also over ``chip_smoke.py`` and ``tools/*.py`` beside ``src/``)
and the entry-point audit on the tiny graph.  The audit runs where the
port's entry points run: on the current CUDA device unless ``--device``
names another; without one it is a usage error (exit 2) unless
``--device cpu`` or ``--no-audit`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from . import config  # noqa: F401  (imported for rule side effects)
from ..device import resolve_device
from . import engine, entrypoints, imports


def _default_root() -> Path:
    """The directory containing the `repro_torch` package (so scanned
    paths read `repro_torch/...`)."""
    return engine.default_root()


def _default_baseline(root: Path) -> Path:
    """`tracelint_torch_baseline.json` at the repo root (one above
    `src/`)."""
    return root.parent / "tracelint_torch_baseline.json"


def _scripts(root: Path) -> List[Path]:
    """The port's scripts beside the scan root: the repo's chip_smoke.py
    and tools/*.py, where present."""
    repo = root.parent
    out = [repo / "chip_smoke.py"] + sorted((repo / "tools").glob("*.py"))
    return [p for p in out if p.is_file()]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="tracelint: enforce the port's device-loop invariants")
    p.add_argument("--root", type=Path, default=None,
                   help="scan root (default: the dir containing "
                        "`repro_torch`)")
    p.add_argument("--baseline", type=Path, default=None,
                   help="baseline file (default: "
                        "tracelint_torch_baseline.json at the repo root)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if any non-baselined finding remains")
    p.add_argument("--write-baseline", action="store_true",
                   help="grandfather all current findings into the "
                        "baseline file and exit")
    p.add_argument("--rules", type=str, default=None,
                   help="comma-separated rule ids (default: all AST rules)")
    p.add_argument("--no-audit", action="store_true",
                   help="skip the entry-point audit")
    p.add_argument("--no-imports", action="store_true",
                   help="skip the dead-seed and port-import audits")
    p.add_argument("--device", type=str, default=None,
                   help="device of the entry-point audit (default: the "
                        "current CUDA device; `cpu` audits the plain "
                        "versions)")
    p.add_argument("--report", type=Path, default=None,
                   help="write the full findings report as JSON")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    root = args.root if args.root is not None else _default_root()
    if not (root / config.PACKAGE).is_dir():
        print(f"error: scan root {root} does not contain a "
              f"`{config.PACKAGE}` package", file=sys.stderr)
        return 2
    baseline_path = (args.baseline if args.baseline is not None
                     else _default_baseline(root))
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    audit = not args.no_audit and rules is None
    if audit:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e} (here: --device cpu, or --no-audit)",
                  file=sys.stderr)
            return 2

    findings = engine.scan_tree(root, rules=rules)
    if not args.no_imports and rules is None:
        findings.extend(imports.audit_dead_seed(root))
        findings.extend(imports.audit_port_imports(root, _scripts(root)))
    if audit:
        findings.extend(entrypoints.run_audit(device=device))
    findings.sort()

    baseline = engine.load_baseline(baseline_path)
    new, grandfathered = engine.partition_findings(findings, baseline)

    if args.write_baseline:
        engine.write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} fingerprint(s) to {baseline_path}")
        return 0

    if args.report is not None:
        args.report.write_text(json.dumps({
            "root": str(root),
            "total": len(findings),
            "new": [f.to_json() for f in new],
            "grandfathered": [f.to_json() for f in grandfathered],
        }, indent=1) + "\n")

    for f in new:
        print(f)
    summary = (f"tracelint: {len(new)} new finding(s), "
               f"{len(grandfathered)} baselined, "
               f"{len(engine.RULES)} AST rules + dead-seed + port-import"
               + (" + entry-point audit" if audit else ""))
    print(summary)
    if args.check and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
