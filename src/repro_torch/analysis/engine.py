"""tracelint engine: findings, pragmas, rule registry, baseline.

The port's own copy of the JAX package's `repro.analysis.engine`: it
imports nothing of that package, and on the same inputs gives the same
findings, fingerprints, pragma tables and baseline bytes.  The one
addition is the scan root a `ModuleSource` carries (`root`), which lets
a rule read the files beside a module (the CUDA sources of
`kernels/csrc/`).

The engine is deliberately small: it walks ``*.py`` files under a scan
root, parses each into a :class:`ModuleSource` (AST + per-line pragma
tables + enclosing-function map), runs every registered rule over it,
and filters the results through ``# tracelint:`` pragmas and the
committed baseline.

Pragmas (line comments, honored on the finding's own line):

* ``# tracelint: disable=rule-a,rule-b`` — suppress those rules here;
  bare ``# tracelint: disable`` suppresses every rule on the line.
* ``# tracelint: boundary`` on a ``def`` line — mark the function a
  host boundary (equivalent to a `config.HOST_BOUNDARIES` entry), for
  one-off boundaries that don't warrant a config entry.

Baseline: a JSON list of fingerprints ``(path, rule, snippet)`` — the
snippet is the stripped source line, so findings survive line drift but
NOT edits to the offending line itself.  Matching is count-aware: two
identical findings need two baseline entries.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

PRAGMA_RE = re.compile(
    r"#\s*tracelint:\s*(?P<kind>disable|boundary)"
    r"(?:\s*=\s*(?P<rules>[A-Za-z0-9_,\-\* ]+))?")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint result, addressable and baseline-able."""

    path: str      # scan-root-relative POSIX path (or "<audit>" pseudo-path)
    line: int      # 1-based; 0 for whole-module / audit findings
    rule: str      # rule id, e.g. "host-sync"
    message: str   # human explanation of the violated invariant
    snippet: str   # stripped source line (the baseline fingerprint key)

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.path, self.rule, self.snippet)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}"
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.snippet:
            out += f"\n    {self.snippet}"
        return out


class ModuleSource:
    """A parsed module plus the lookup tables rules need.

    `path` is the scan-root-relative POSIX path rules scope on; `text`
    the full source; `root` the directory the path is relative to (None:
    the directory that holds this package's `repro_torch`).  Pragmas are
    parsed from raw line text (a ``#``
    inside a string literal on the same line can confuse this — an
    accepted limitation for a lint tool).
    """

    def __init__(self, path: str, text: str, root: Optional[Path] = None):
        self.path = path.replace("\\", "/")
        self.root = Path(root) if root is not None else default_root()
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        #: line -> set of disabled rule ids ("*" disables all)
        self.disables: Dict[int, Set[str]] = {}
        #: lines carrying a `boundary` pragma
        self.boundary_lines: Set[int] = set()
        for i, line in enumerate(self.lines, start=1):
            m = PRAGMA_RE.search(line)
            if not m:
                continue
            if m.group("kind") == "boundary":
                self.boundary_lines.add(i)
            else:
                rules = m.group("rules")
                ids = ({r.strip() for r in rules.split(",") if r.strip()}
                       if rules else {"*"})
                self.disables.setdefault(i, set()).update(ids)
        #: node -> tuple of enclosing FunctionDef/AsyncFunctionDef nodes,
        #: outermost first (decorators get the stack OUTSIDE their def)
        self._func_stack: Dict[int, Tuple[ast.AST, ...]] = {}
        self._assign_stacks(self.tree, ())
        #: module-level integer constants (NAME = <int literal>)
        self.int_constants: Dict[str, int] = {}
        for node in self.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, int)):
                self.int_constants[node.targets[0].id] = node.value.value

    def _assign_stacks(self, node: ast.AST, stack: Tuple[ast.AST, ...]):
        self._func_stack[id(node)] = stack
        is_func = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        if is_func:
            # decorators/defaults see the OUTER stack; the body sees +self
            for dec in node.decorator_list:
                self._assign_stacks(dec, stack)
            for d in list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None]:
                self._assign_stacks(d, stack)
            inner = stack + (node,)
            for child in node.body:
                self._assign_stacks(child, inner)
            return
        for child in ast.iter_child_nodes(node):
            self._assign_stacks(child, stack)

    # -- queries rules use -------------------------------------------------

    def enclosing_functions(self, node: ast.AST) -> Tuple[ast.AST, ...]:
        """FunctionDef nodes enclosing `node`, outermost first."""
        return self._func_stack.get(id(node), ())

    def enclosing_names(self, node: ast.AST) -> Tuple[str, ...]:
        return tuple(f.name for f in self.enclosing_functions(node))

    def is_boundary(self, node: ast.AST) -> bool:
        """True if any enclosing function is whitelisted as a host
        boundary (config entry or `# tracelint: boundary` def-line
        pragma), or the whole module is ("*" entry)."""
        from . import config

        allowed = config.boundary_functions(self.path)
        if "*" in allowed:
            return True
        for f in self.enclosing_functions(node):
            if f.name in allowed:
                return True
            # pragma anywhere on the def header (def line .. first body line)
            body_start = f.body[0].lineno if f.body else f.lineno
            if any(f.lineno <= ln <= body_start
                   for ln in self.boundary_lines):
                return True
        return False

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def disabled(self, lineno: int, rule: str) -> bool:
        ids = self.disables.get(lineno, ())
        return "*" in ids or rule in ids

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(path=self.path, line=line, rule=rule,
                       message=message, snippet=self.line_text(line))


# ---------------------------------------------------------------------------
# Rule registry
# ---------------------------------------------------------------------------


class Rule:
    """Base class: subclass, set `id`/`summary`, implement `check`."""

    id: str = ""
    summary: str = ""

    def applies(self, path: str) -> bool:
        return True

    def check(self, mod: ModuleSource) -> Iterable[Finding]:
        raise NotImplementedError


#: rule id -> rule instance (AST rules only; the dead-seed and
#: entry-point audits are separate passes over the tree / the runtime)
RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the registry."""
    inst = cls()
    if not inst.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    RULES[inst.id] = inst
    return cls


def _selected(rules: Optional[Sequence[str]]) -> List[Rule]:
    # imported for side effect: populates RULES on first use
    from . import rules as _rules  # noqa: F401

    if rules is None:
        return list(RULES.values())
    unknown = [r for r in rules if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule ids {unknown}; have {sorted(RULES)}")
    return [RULES[r] for r in rules]


# ---------------------------------------------------------------------------
# Scanning
# ---------------------------------------------------------------------------


def iter_py_files(root: Path) -> Iterator[Path]:
    for p in sorted(root.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        yield p


def default_root() -> Path:
    """The directory that holds the `repro_torch` package (so scanned
    paths read `repro_torch/...`)."""
    return Path(__file__).resolve().parents[2]


def scan_source(text: str, path: str,
                rules: Optional[Sequence[str]] = None,
                root: Optional[Path] = None) -> List[Finding]:
    """Run the AST rules over one source string.

    `path` is the virtual scan-root-relative path the snippet pretends
    to live at — rule scoping and boundary whitelists key on it.  This
    is the fixture-test entry point and the doctest surface.  `root`
    (default `default_root()`) is where a rule finds the files beside
    the module.
    """
    mod = ModuleSource(path, text, root)
    findings: List[Finding] = []
    for rule in _selected(rules):
        if not rule.applies(mod.path):
            continue
        for f in rule.check(mod):
            if not mod.disabled(f.line, f.rule):
                findings.append(f)
    return sorted(findings)


def scan_tree(root: Path,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the AST rules over every module under `root` (the directory
    containing the `repro_torch` package); returns sorted findings."""
    root = Path(root)
    findings: List[Finding] = []
    for p in iter_py_files(root):
        rel = p.relative_to(root).as_posix()
        try:
            text = p.read_text()
            findings.extend(scan_source(text, rel, rules=rules, root=root))
        except SyntaxError as e:
            findings.append(Finding(
                path=rel, line=e.lineno or 0, rule="parse-error",
                message=f"could not parse: {e.msg}", snippet=""))
    return sorted(findings)


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> Counter:
    """Fingerprint multiset from a baseline file (empty if missing)."""
    path = Path(path)
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text())
    return Counter(tuple(fp) for fp in data.get("fingerprints", []))


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    """Write the grandfathered-findings baseline (sorted, versioned)."""
    fps = sorted(f.fingerprint() for f in findings)
    Path(path).write_text(json.dumps(
        {"version": 1, "count": len(fps), "fingerprints": fps},
        indent=1) + "\n")


def partition_findings(
    findings: Sequence[Finding], baseline: Counter,
) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, grandfathered) against the baseline multiset."""
    budget = Counter(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in sorted(findings):
        fp = f.fingerprint()
        if budget[fp] > 0:
            budget[fp] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old
