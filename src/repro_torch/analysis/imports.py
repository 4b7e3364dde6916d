"""Import audits of the port: the dead-seed audit and the port-import rule.

* ``dead-seed`` — every module of the port must be reachable from the
  product packages (`config.REACHABILITY_ROOTS`), or sit in a package
  whose ``__init__`` carries a ``seed_fixtures`` note.  The port's one
  seed package is the LM substrate (`repro_torch.models`); every other
  module must be wired in.  The
  port's ROOT ``__init__`` carries that note for the JAX package's own
  audit (no module of `repro` imports the port); read here as a marker it
  would quarantine the whole port and make this audit vacuous, so the
  root package's own ``__init__`` is never taken as one.
* ``port-import`` — no module of the port (and no script given beside
  it, such as ``chip_smoke.py``) imports `jax` or the JAX package
  `repro` (`config.FORBIDDEN_IMPORTS`): by ``import``, ``from``, a
  relative import that climbs out of the port, or ``importlib.
  import_module`` / ``__import__`` of a literal name.

The import graph is *static and by-name*, as in the JAX package's
audit: an edge exists when a module names another in an
``import``/``from`` statement (relative imports resolved).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from . import config
from .engine import Finding, iter_py_files

RULE_ID = "dead-seed"
PORT_IMPORT_RULE = "port-import"


def module_name(rel_posix: str) -> str:
    """'repro_torch/core/graph.py' -> 'repro_torch.core.graph';
    'repro_torch/core/__init__.py' -> 'repro_torch.core'."""
    parts = rel_posix[:-3].split("/")  # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _import_targets(tree: ast.AST, mod: str,
                    is_package: bool) -> Iterator[Tuple[ast.AST, str]]:
    """(node, dotted target) for every name an import statement of `mod`
    names, relative imports resolved against `mod`'s package."""
    pkg_parts = mod.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative: drop `level` trailing components of the
                # *package* path (a module's package is its parent)
                base_parts = pkg_parts if is_package else pkg_parts[:-1]
                base_parts = base_parts[:len(base_parts) - node.level + 1]
                base = ".".join(base_parts)
            else:
                base = ""
            stem = (f"{base}.{node.module}" if base and node.module
                    else (node.module or base))
            if stem:
                yield node, stem
                for a in node.names:
                    yield node, f"{stem}.{a.name}"


def build_import_graph(root: Path) -> Dict[str, Set[str]]:
    """module -> set of (known, in-tree) modules it names."""
    root = Path(root)
    paths = {module_name(p.relative_to(root).as_posix()): p
             for p in iter_py_files(root)}
    known = set(paths)
    edges: Dict[str, Set[str]] = {m: set() for m in known}

    for mod, path in paths.items():
        try:
            tree = ast.parse(path.read_text())
        except SyntaxError:
            continue
        for _, t in _import_targets(tree, mod, path.name == "__init__.py"):
            # longest known prefix of the dotted target
            parts = t.split(".")
            for i in range(len(parts), 0, -1):
                cand = ".".join(parts[:i])
                if cand in known and cand != mod:
                    edges[mod].add(cand)
                    break
    return edges


def reachable_modules(edges: Dict[str, Set[str]]) -> Set[str]:
    """Closure of the product-surface roots over the import graph."""
    roots = [m for m in edges
             if any(m == r or m.startswith(r + ".")
                    for r in config.REACHABILITY_ROOTS)]
    seen = set(roots)
    stack = list(roots)
    while stack:
        for nxt in edges.get(stack.pop(), ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return seen


def _quarantined(root: Path, mod: str) -> bool:
    """True if `mod` or an ancestor package BELOW the port's root package
    carries the seed marker in its `__init__` source."""
    parts = mod.split(".")
    for i in range(len(parts), 1, -1):
        init = root.joinpath(*parts[:i]) / "__init__.py"
        if init.exists() and config.SEED_MARKER in init.read_text():
            return True
    return False


def _in_port(mod: str) -> bool:
    return mod == config.PACKAGE or mod.startswith(config.PACKAGE + ".")


def audit_dead_seed(root: Path) -> List[Finding]:
    """Findings for port modules unreachable from the product packages
    and not quarantined.  Modules of other packages under `root` (the
    JAX package beside the port) are not the port's and are skipped."""
    root = Path(root)
    relpath = {module_name(p.relative_to(root).as_posix()):
               p.relative_to(root).as_posix()
               for p in iter_py_files(root)}
    edges = build_import_graph(root)
    live = reachable_modules(edges)
    findings: List[Finding] = []
    for mod in sorted(edges):
        if not _in_port(mod) or mod in live or mod == config.PACKAGE:
            continue
        if mod.startswith(config.PACKAGE + ".analysis"):
            continue  # the linter itself is tooling, not product surface
        if _quarantined(root, mod):
            continue
        findings.append(Finding(
            path=relpath.get(mod, mod.replace(".", "/") + ".py"), line=0,
            rule=RULE_ID,
            message=(f"`{mod}` is unreachable from the product packages "
                     f"({', '.join(config.REACHABILITY_ROOTS)}) and its "
                     "package __init__ carries no `seed_fixtures` note: "
                     "either wire it in or quarantine it explicitly"),
            snippet=mod))
    return findings


def _forbidden(target: str) -> Optional[str]:
    for pkg in config.FORBIDDEN_IMPORTS:
        if target == pkg or target.startswith(pkg + "."):
            return pkg
    return None


def _dynamic_imports(tree: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
    """(node, name) of ``importlib.import_module("...")`` and
    ``__import__("...")`` calls with a literal name."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            continue
        f = node.func
        name = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else "")
        if name in ("import_module", "__import__"):
            yield node, node.args[0].value


def _port_import_findings(rel: str, text: str, mod: str,
                          is_package: bool) -> List[Finding]:
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []  # the AST scan reports it as a parse error
    lines = text.splitlines()
    seen = set()
    out: List[Finding] = []
    targets = list(_import_targets(tree, mod, is_package))
    targets += list(_dynamic_imports(tree))
    for node, target in targets:
        pkg = _forbidden(target)
        if pkg is None or (node.lineno, pkg) in seen:
            continue
        seen.add((node.lineno, pkg))
        out.append(Finding(
            path=rel, line=node.lineno, rule=PORT_IMPORT_RULE,
            message=(f"imports `{target}`: the port stands alone and "
                     f"imports nothing of `{pkg}` (keep a copy of what it "
                     "needs)"),
            snippet=lines[node.lineno - 1].strip()))
    return out


def audit_port_imports(root: Path,
                       scripts: Sequence[Path] = ()) -> List[Finding]:
    """``port-import`` findings for every module of the port under `root`
    and for each script in `scripts` (reported by file name)."""
    root = Path(root)
    findings: List[Finding] = []
    for p in iter_py_files(root):
        rel = p.relative_to(root).as_posix()
        mod = module_name(rel)
        if _in_port(mod):
            findings.extend(_port_import_findings(
                rel, p.read_text(), mod, p.name == "__init__.py"))
    for s in scripts:
        s = Path(s)
        findings.extend(_port_import_findings(
            s.name, s.read_text(), s.stem, False))
    return sorted(findings)
