"""The tracelint AST rules of the port — one class per enforced invariant.

Rule ids (stable; pragmas and the baseline key on them), the JAX
package's ids where the invariant exists in the port:

* ``host-sync`` — no device→host read inside the protected packages
  outside whitelisted boundary functions, in PyTorch's idiom.
* ``retrace-hazard`` — the parts that exist in eager PyTorch: no mutable
  default on a cached function, and no shape-derived value reaching an
  `lru_cache` key without a bucket helper.
* ``sorted-ell`` — every write to a `nbr` adjacency routes through the
  approved sort/splice helpers.
* ``cache-key`` — caches must be registered in `config.CACHE_SCHEMAS`
  and key on their full declared tuple.
* ``cuda-kernel`` — the ctypes bindings of the hand-written CUDA
  kernels agree with their C signatures, every launch passes the
  declared argument count, and every launch bumps its wrapper's counter.

All rules are heuristic in the way static analysis must be: they see
names and shapes of expressions, not values.  Each rule's docstring
states exactly what is matched so a reader can predict (and with a
``# tracelint: disable=`` pragma, override) any individual verdict.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from . import config
from .engine import Finding, ModuleSource, Rule, register


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute chains / Names; None
    otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def contains_call(node: ast.AST, names: Iterable[str]) -> bool:
    """True if any descendant Call's dotted name (or its last component)
    is in `names`."""
    names = set(names)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if name and (name in names or name.split(".")[-1] in names):
                return True
    return False


#: tensor methods that reduce to a scalar a host conversion would read
TENSOR_SCALAR_METHODS = frozenset({
    "max", "min", "sum", "any", "all", "amax", "amin", "argmax", "argmin",
    "count_nonzero", "prod", "mean", "std", "var", "norm", "dot", "equal",
})

#: module names whose `.max()` & co. are host calls, not tensor methods
_HOST_MODULES = ("np", "numpy", "math", "builtins")


def _mentions_torch(node: ast.AST) -> bool:
    """True if the expression subtree references torch or calls a tensor
    reduction method (so `int(...)` of it plausibly blocks on a device
    value)."""
    for sub in ast.walk(node):
        name = dotted_name(sub) or ""
        if name == "torch" or name.startswith("torch."):
            return True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr in TENSOR_SCALAR_METHODS
                and (dotted_name(sub.func.value) or "") not in _HOST_MODULES):
            return True
    return False


def _is_tensor_annotation(node: Optional[ast.AST]) -> bool:
    name = dotted_name(node) if node is not None else None
    return name in ("torch.Tensor", "Tensor")


def tensor_names(fn: ast.AST) -> Set[str]:
    """Names a function binds to tensors, one assignment deep: parameters
    annotated ``torch.Tensor`` and locals assigned an expression that
    mentions torch (`_mentions_torch`)."""
    out: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if _is_tensor_annotation(a.annotation):
            out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _mentions_torch(node.value):
            for t in node.targets:
                out.update(e.id for e in ast.walk(t)
                           if isinstance(e, ast.Name))
        elif (isinstance(node, ast.AugAssign)
              and isinstance(node.target, ast.Name)
              and _mentions_torch(node.value)):
            out.add(node.target.id)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and (_is_tensor_annotation(node.annotation)
                   or (node.value is not None
                       and _mentions_torch(node.value)))):
            out.add(node.target.id)
    return out


def _decorator_names(fn: ast.AST) -> List[str]:
    """Dotted names of a def's decorators; `lru_cache(...)` reports its
    callee ('functools.partial' resolves to its first argument's name)."""
    out: List[str] = []
    for dec in getattr(fn, "decorator_list", []):
        if isinstance(dec, ast.Call):
            name = dotted_name(dec.func) or ""
            if name.split(".")[-1] == "partial" and dec.args:
                inner = dotted_name(dec.args[0])
                if inner:
                    out.append(inner)
                    continue
            out.append(name)
        else:
            out.append(dotted_name(dec) or "")
    return out


def _is_cache_decorator(name: str) -> bool:
    return name.split(".")[-1] in ("lru_cache", "cache")


def _functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

#: tensor methods that copy to the host or read a value there
_READ_METHODS = ("item", "tolist", "cpu", "numpy")


def _is_cpu_target(node: ast.AST) -> bool:
    """A literal CPU device: "cpu", "cpu:0" or torch.device("cpu")."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if (isinstance(node, ast.Call)
            and (call_name(node) or "").split(".")[-1] == "device"
            and node.args):
        return _is_cpu_target(node.args[0])
    return False


@register
class HostSyncRule(Rule):
    """No device→host reads in the protected device-loop packages.

    Flags, inside `config.SYNC_SCOPE` files and outside whitelisted
    boundary functions (`config.HOST_BOUNDARIES` or a
    ``# tracelint: boundary`` def-line pragma):

    * ``.item()``, ``.tolist()``, ``.cpu()`` and ``.numpy()`` calls,
    * ``.to("cpu")`` (or ``device="cpu"``, ``torch.device("cpu")``),
    * ``np.asarray(...)`` / ``np.array(...)`` — a blocking copy when the
      argument is a CUDA tensor,
    * ``int(x)`` / ``float(x)`` / ``bool(x)`` where `x` mentions torch,
      calls a tensor reduction (``.max()``, ``.any()``, ...), or is a
      name the enclosing function binds to such an expression or
      annotates ``torch.Tensor`` — a blocking read of a device value.
      Exempt when the argument already contains one of the calls above
      (that call is the finding; flagging both would double-count one
      read).

    The JAX package's rule matches ``jax.device_get`` and jnp values;
    this is the same invariant in PyTorch's idiom.  Reads through names
    the rule cannot see (a flag returned by another function) are the
    entry-point audit's job (`entrypoints.count_host_reads`).
    """

    id = "host-sync"
    summary = "device→host read outside a whitelisted boundary"

    def applies(self, path: str) -> bool:
        return config.in_sync_scope(path)

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        names_of: Dict[int, Set[str]] = {}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fns = mod.enclosing_functions(node)
            tensors: Set[str] = set()
            if fns:
                key = id(fns[-1])
                if key not in names_of:
                    names_of[key] = tensor_names(fns[-1])
                tensors = names_of[key]
            kind = self._sync_kind(node, tensors)
            if kind is None or mod.is_boundary(node):
                continue
            yield mod.finding(
                self.id, node,
                f"{kind} synchronizes host and device inside a protected "
                "device loop; move it behind a whitelisted boundary "
                "function or keep the value on device")

    @staticmethod
    def _direct_kind(node: ast.Call) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _READ_METHODS and not node.args:
                return f".{f.attr}()"
            if f.attr == "to" and (
                    any(_is_cpu_target(a) for a in node.args)
                    or any(k.arg == "device" and _is_cpu_target(k.value)
                           for k in node.keywords)):
                return '.to("cpu")'
        name = call_name(node)
        if name in ("np.asarray", "numpy.asarray", "np.array",
                    "numpy.array"):
            return f"{name}() on a (possibly device) tensor"
        return None

    @classmethod
    def _reads_inside(cls, node: Optional[ast.AST]) -> bool:
        return node is not None and any(
            isinstance(s, ast.Call) and cls._direct_kind(s)
            for s in ast.walk(node))

    @classmethod
    def _sync_kind(cls, node: ast.Call,
                   tensors: Set[str]) -> Optional[str]:
        # a read of what another read already copied (``x.cpu().numpy()``,
        # ``np.asarray(x.cpu())``, ``int(x.item())``) is that read's finding
        receiver = (node.func.value if isinstance(node.func, ast.Attribute)
                    else None)
        if cls._reads_inside(receiver) or any(
                cls._reads_inside(a) for a in node.args):
            return None
        kind = cls._direct_kind(node)
        if kind is not None:
            return kind
        name = call_name(node)
        if name in ("int", "float", "bool") and len(node.args) == 1 \
                and not node.keywords:
            arg = node.args[0]
            if _mentions_torch(arg) or (isinstance(arg, ast.Name)
                                        and arg.id in tensors):
                return f"{name}() on a tensor"
        return None


# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------


def _cached_names(mod: ModuleSource) -> Set[str]:
    """Names of the cached functions a module can call: its own
    `lru_cache`/`cache` defs and every registered `CACHE_SCHEMAS` site."""
    out = {key.split("::")[1] for key in config.CACHE_SCHEMAS}
    for fn in _functions(mod.tree):
        if any(_is_cache_decorator(d) for d in _decorator_names(fn)):
            out.add(fn.name)
    return out


@register
class RetraceHazardRule(Rule):
    """Cache keys must be bucketed and hashable.

    Eager PyTorch traces and compiles nothing, so of the JAX package's
    three checks only the cache parts carry over; the jit parts (a jit
    static argument from a shape, a `jax.jit` built in a function body)
    have no counterpart.  Two checks inside `config.SYNC_SCOPE`:

    1. **Unbucketed shape-derived cache key**: an argument of a call to a
       cached function (an `lru_cache` def of the module or a registered
       `config.CACHE_SCHEMAS` site) that reads ``.shape``, ``.numel()``,
       ``.size()`` or ``len()``, or reduces a degree vector
       (``max/min(... .deg ...)``) — directly or through a local the
       function assigns one assignment before — keys one cache entry per
       distinct value.  It must route through one of the
       `config.BUCKET_HELPERS`; the helpers' own bodies are exempt.
    2. **Mutable default on a cached def**: a list/dict/set default on a
       function under `lru_cache` is unhashable as a key (TypeError at
       call time) or a shared mutable one.
    """

    id = "retrace-hazard"
    summary = "shape-derived cache key / unhashable cache default"

    def applies(self, path: str) -> bool:
        return config.in_sync_scope(path)

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        yield from self._check_shape_keys(mod)
        yield from self._check_mutable_defaults(mod)

    # -- 1: unbucketed shape-derived cache keys ----------------------------

    def _check_shape_keys(self, mod: ModuleSource) -> Iterator[Finding]:
        cached = _cached_names(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and (call_name(node) or "").split(".")[-1] in cached):
                continue
            names = mod.enclosing_names(node)
            if any(n in config.BUCKET_HELPERS for n in names):
                continue  # inside a bucket helper itself
            args = list(node.args) + [k.value for k in node.keywords]
            if any(self._unbucketed(mod, node, a) for a in args):
                yield mod.finding(
                    self.id, node,
                    "shape/degree-derived cache key never passes a pow2 "
                    "bucket helper (_pow2_bucket/degree_bound/...): the "
                    "cache keeps one entry per distinct value")

    def _unbucketed(self, mod: ModuleSource, site: ast.AST,
                    arg: ast.AST) -> bool:
        if contains_call(arg, config.BUCKET_HELPERS):
            return False
        if self._shape_derived(arg):
            return True
        if not isinstance(arg, ast.Name):
            return False
        fns = mod.enclosing_functions(site)
        scope = fns[-1] if fns else mod.tree
        for stmt in ast.walk(scope):
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == arg.id
                            for t in stmt.targets)
                    and self._shape_derived(stmt.value)
                    and not contains_call(stmt.value,
                                          config.BUCKET_HELPERS)):
                return True
        return False

    @staticmethod
    def _shape_derived(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Attribute) and sub.attr == "shape":
                return True
            if isinstance(sub, ast.Call):
                name = (call_name(sub) or "").split(".")[-1]
                if name in ("numel", "size", "len"):
                    return True
                if name in ("max", "min") and any(
                        isinstance(s, ast.Attribute) and s.attr == "deg"
                        for s in ast.walk(sub)):
                    return True
        return False

    # -- 2: mutable defaults on cached defs --------------------------------

    def _check_mutable_defaults(self, mod: ModuleSource) -> Iterator[Finding]:
        for node in _functions(mod.tree):
            if not any(_is_cache_decorator(d)
                       for d in _decorator_names(node)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    yield mod.finding(
                        self.id, d,
                        f"mutable default on cached `{node.name}`: "
                        "unhashable as a cache key (and shared across "
                        "calls)")


# ---------------------------------------------------------------------------
# sorted-ell
# ---------------------------------------------------------------------------


@register
class SortedEllRule(Rule):
    """Every `nbr` write routes through the approved sort/splice helpers.

    The sorted-ELL invariant (valid slots of every adjacency row
    ascending, PAD=-1 slots packed right) is what the triangle kernels'
    row probes and the row-length stops of every ELL kernel rely on; ONE
    unsorted write anywhere silently corrupts their results.

    Flags, in every non-seed `repro_torch` module, writes to a `nbr`
    target — ``nbr[...] = ...`` / ``g.nbr[...] = ...`` / ``g.nbr = ...``
    stores, the in-place tensor methods ``nbr.copy_/index_put_/
    scatter_/masked_fill_/fill_/...(...)`` (on `nbr` or a subscript of
    it), the functional ``... .nbr.at[...].set(...)`` form, and ``nbr=``
    keyword arguments to `dataclasses.replace` / `GraphBlocks(...)` —
    unless the written value's expression contains a call to an approved
    helper (`config.SORTED_ELL_HELPERS`), is a verbatim copy of a `nbr`
    (``g.nbr.clone()``, ``.contiguous()``, ``.to(...)``), or the
    enclosing function is an approved raw writer
    (`config.SORTED_ELL_WRITERS`).

    A bare-name value is resolved ONE assignment deep inside the
    enclosing function, as in the JAX package's rule.  Matching is exact
    on the name ``nbr`` (so `nbr_local`, halo tables etc. never trigger).
    """

    id = "sorted-ell"
    summary = "nbr write bypassing the sorted-ELL helpers"

    _AT_SETTERS = ("set", "add", "max", "min", "mul", "apply")
    _INPLACE = ("copy_", "index_put_", "scatter_", "scatter_add_",
                "masked_fill_", "masked_scatter_", "fill_", "zero_",
                "index_copy_", "index_fill_", "put_")

    def applies(self, path: str) -> bool:
        return path.startswith(config.PACKAGE + "/") and not config.is_seed(
            path)

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            for site, value in self._nbr_writes(node):
                if self._approved(mod, site, value):
                    continue
                yield mod.finding(
                    self.id, site,
                    "write to `nbr` bypasses the approved sorted-ELL "
                    "helpers (sort_nbr_rows / _sorted_rows / "
                    "_sorted_insert_row / _sorted_delete_row / "
                    "_insert_sorted / _delete_sorted): an unsorted row "
                    "breaks the row probes and row-length stops")

    def _approved(self, mod: ModuleSource, site: ast.AST,
                  value: Optional[ast.AST]) -> bool:
        if value is not None and contains_call(
                value, config.SORTED_ELL_HELPERS):
            return True
        if self._verbatim_copy(value):
            return True
        if isinstance(value, ast.Name) and self._local_routes_through(
                mod, site, value.id):
            return True
        return any(n in config.SORTED_ELL_WRITERS
                   for n in mod.enclosing_names(site))

    @classmethod
    def _verbatim_copy(cls, value: Optional[ast.AST]) -> bool:
        """``g.nbr.clone()`` / ``.contiguous()`` / ``.to(device)``: a copy
        of an adjacency that already holds the invariant."""
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("clone", "contiguous", "to")
                and cls._is_nbr_ref(value.func.value))

    @staticmethod
    def _local_routes_through(mod: ModuleSource, site: ast.AST,
                              name: str) -> bool:
        """One-deep dataflow: does a local assignment `name = ...` in the
        enclosing function route through an approved helper?"""
        fns = mod.enclosing_functions(site)
        if not fns:
            return False
        for stmt in ast.walk(fns[-1]):
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AnnAssign):
                targets = [stmt.target]
            else:
                continue
            if stmt.value is None:
                continue
            if any(isinstance(t, ast.Name) and t.id == name
                   for t in targets) and contains_call(
                       stmt.value, config.SORTED_ELL_HELPERS):
                return True
        return False

    @classmethod
    def _nbr_writes(
        cls, node: ast.AST,
    ) -> Iterator[Tuple[ast.AST, Optional[ast.AST]]]:
        """(site, written-value) pairs for `nbr` mutations at `node`."""
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                for e in elts:
                    if cls._is_nbr_store_target(e):
                        yield e, getattr(node, "value", None)
        elif isinstance(node, ast.Call):
            f = node.func
            # <...>.nbr.at[...].set(value)
            if (isinstance(f, ast.Attribute) and f.attr in cls._AT_SETTERS
                    and isinstance(f.value, ast.Subscript)
                    and isinstance(f.value.value, ast.Attribute)
                    and f.value.value.attr == "at"
                    and cls._is_nbr_ref(f.value.value.value)):
                val = node.args[0] if node.args else None
                yield node, val
            # nbr.copy_(value) / nbr[rows].index_put_(..., value) / ...
            if (isinstance(f, ast.Attribute) and f.attr in cls._INPLACE
                    and (cls._is_nbr_ref(f.value)
                         or (isinstance(f.value, ast.Subscript)
                             and cls._is_nbr_ref(f.value.value)))):
                yield node, node.args[-1] if node.args else None
            # dataclasses.replace(g, nbr=...) / GraphBlocks(..., nbr=...)
            name = (call_name(node) or "").split(".")[-1]
            if name in ("replace", "GraphBlocks"):
                for kw in node.keywords:
                    if kw.arg == "nbr":
                        yield node, kw.value

    @classmethod
    def _is_nbr_store_target(cls, t: ast.AST) -> bool:
        if isinstance(t, ast.Subscript):
            return cls._is_nbr_ref(t.value)
        return isinstance(t, ast.Attribute) and t.attr == "nbr"

    @staticmethod
    def _is_nbr_ref(node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id == "nbr"
        return isinstance(node, ast.Attribute) and node.attr == "nbr"


# ---------------------------------------------------------------------------
# cache-key
# ---------------------------------------------------------------------------


@register
class CacheKeyRule(Rule):
    """Caches must register and carry their full key.

    Two cache-site patterns are detected inside `config.SYNC_SCOPE`:

    * ``@functools.lru_cache`` / ``@cache`` defs — the parameter list IS
      the key; it must include every name in the site's registered
      schema (`config.CACHE_SCHEMAS`, keyed ``path::funcname``).
    * dict caches — an (ann)assignment of a dict literal to a name or
      attribute containing ``cache``.  Every tuple key stored/looked up
      on that name in the module (via ``[...]``, ``.get``,
      ``.setdefault``, or a `key = (...)` local resolved one assignment
      deep) must mention every schema name — element names are the
      trailing identifier; string/number literals are free
      discriminators.

    A detected site with NO schema entry is itself a finding: new caches
    must declare their key in `config.CACHE_SCHEMAS`, so a reader sees
    exactly what the cached artifact varies over.
    """

    id = "cache-key"
    summary = "unregistered or under-keyed cache"

    def applies(self, path: str) -> bool:
        return config.in_sync_scope(path)

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        yield from self._check_lru_sites(mod)
        yield from self._check_dict_sites(mod)

    # -- lru_cache sites ---------------------------------------------------

    def _check_lru_sites(self, mod: ModuleSource) -> Iterator[Finding]:
        for node in _functions(mod.tree):
            if not any(_is_cache_decorator(d)
                       for d in _decorator_names(node)):
                continue
            key = f"{mod.path}::{node.name}"
            schema = config.CACHE_SCHEMAS.get(key)
            if schema is None:
                yield mod.finding(
                    self.id, node,
                    f"lru_cache site `{node.name}` is not registered; add "
                    f'"{key}" with its key names to '
                    "analysis/config.CACHE_SCHEMAS")
                continue
            params = {a.arg for a in (node.args.posonlyargs + node.args.args
                                      + node.args.kwonlyargs)}
            missing = [s for s in schema if s not in params]
            if missing:
                yield mod.finding(
                    self.id, node,
                    f"lru_cache site `{node.name}` is missing registered "
                    f"key fields {missing}: cached results would be "
                    "shared across values that must not share them")

    # -- dict cache sites --------------------------------------------------

    def _check_dict_sites(self, mod: ModuleSource) -> Iterator[Finding]:
        sites = {}  # cache attr/name -> defining node
        for node in ast.walk(mod.tree):
            target = value = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                target, value = node.target, node.value
            if target is None or not isinstance(value, ast.Dict):
                continue
            name = (target.id if isinstance(target, ast.Name)
                    else target.attr if isinstance(target, ast.Attribute)
                    else None)
            if name and "cache" in name.lower():
                sites.setdefault(name, node)
        for name, site in sites.items():
            key = f"{mod.path}::{name}"
            schema = config.CACHE_SCHEMAS.get(key)
            if schema is None:
                yield mod.finding(
                    self.id, site,
                    f"dict cache `{name}` is not registered; add "
                    f'"{key}" with its key names to '
                    "analysis/config.CACHE_SCHEMAS")
                continue
            for use, key_expr in self._key_exprs(mod, name):
                tup = self._resolve_tuple(mod, use, key_expr)
                if tup is None:
                    continue  # opaque key expression: nothing to verify
                names = {n for n in map(self._element_name, tup.elts) if n}
                missing = [s for s in schema if s not in names]
                if missing:
                    yield mod.finding(
                        self.id, use,
                        f"cache key for `{name}` is missing registered "
                        f"fields {missing}: a change in those would "
                        "silently reuse a stale entry")

    @staticmethod
    def _key_exprs(mod: ModuleSource,
                   name: str) -> Iterator[Tuple[ast.AST, ast.AST]]:
        """(usage-node, key-expression) for subscripts / .get / .setdefault
        on the cache called `name`."""
        def is_cache_ref(n: ast.AST) -> bool:
            return ((isinstance(n, ast.Name) and n.id == name)
                    or (isinstance(n, ast.Attribute) and n.attr == name))

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Subscript) and is_cache_ref(node.value):
                yield node, node.slice
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("get", "setdefault", "pop")
                  and is_cache_ref(node.func.value) and node.args):
                yield node, node.args[0]

    @staticmethod
    def _resolve_tuple(mod: ModuleSource, use: ast.AST,
                       expr: ast.AST) -> Optional[ast.Tuple]:
        if isinstance(expr, ast.Tuple):
            return expr
        if isinstance(expr, ast.Name):
            # one-assignment-deep local resolution within the same function
            funcs = mod.enclosing_functions(use)
            scope = funcs[-1] if funcs else mod.tree
            found = None
            for node in ast.walk(scope):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == expr.id
                        and isinstance(node.value, ast.Tuple)):
                    found = node.value
            return found
        return None

    @staticmethod
    def _element_name(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant):
            return None  # literal discriminators are free
        name = dotted_name(node)
        if name:
            return name.split(".")[-1]
        if isinstance(node, ast.Call):
            inner = call_name(node)
            return inner.split(".")[-1] if inner else None
        return None


# ---------------------------------------------------------------------------
# cuda-kernel
# ---------------------------------------------------------------------------

#: the module that declares the kernels (`SOURCES`) and launches them
BUILD_MODULE = "repro_torch/kernels/_build.py"
#: the kernels' CUDA sources, relative to the scan root
CSRC_DIR = "repro_torch/kernels/csrc"
#: the ctypes argument types `SOURCES` may use and the C parameter kind
#: each one passes
CTYPES_KINDS = {
    "c_void_p": "pointer",
    "c_int": "int",
    "c_longlong": "long long",
}

_LAUNCH_SIG = re.compile(
    r'extern\s+"C"\s+int\s+(?P<name>\w+)_launch\s*\((?P<params>[^)]*)\)')
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def c_param_kind(param: str) -> Tuple[str, str]:
    """(kind, name) of one C parameter: ``const void* nbr`` -> ("pointer",
    "nbr"), ``long long n_rows`` -> ("long long", "n_rows")."""
    words = param.replace("*", " * ").split()
    name = words[-1] if words else ""
    if "*" in words:
        return "pointer", name
    kind = " ".join(w for w in words[:-1]
                    if w not in ("const", "unsigned", "signed"))
    return kind, name


def launch_signatures(text: str) -> Dict[str, List[Tuple[str, str]]]:
    """{kernel name: [(kind, name) per parameter]} of every
    ``extern "C" int <name>_launch(...)`` in a CUDA source."""
    out = {}
    for m in _LAUNCH_SIG.finditer(_COMMENTS.sub(" ", text)):
        params = [p.strip() for p in m.group("params").split(",")]
        out[m.group("name")] = [c_param_kind(p) for p in params if p]
    return out


def _ctypes_env(tree: ast.Module) -> Dict[str, str]:
    """Module-level names bound to ctypes types (``_P = ctypes.c_void_p``,
    ``_P, _I = ctypes.c_void_p, ctypes.c_int``) -> the type's name."""
    env: Dict[str, str] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        t, v = node.targets[0], node.value
        pairs = (list(zip(t.elts, v.elts))
                 if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                 else [(t, v)])
        for tn, vn in pairs:
            name = (dotted_name(vn) or "").split(".")[-1]
            if isinstance(tn, ast.Name) and name in CTYPES_KINDS:
                env[tn.id] = name
    return env


def _eval_argtypes(node: ast.AST,
                   env: Dict[str, str]) -> Optional[List[str]]:
    """The ctypes names of an argtypes tuple expression: tuples of type
    names, ``+`` and ``* <int>``; None if it is anything else."""
    if isinstance(node, ast.Tuple):
        out = []
        for e in node.elts:
            name = dotted_name(e) or ""
            kind = env.get(name, name.split(".")[-1])
            if kind not in CTYPES_KINDS:
                return None
            out.append(kind)
        return out
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _eval_argtypes(node.left, env), _eval_argtypes(node.right, env)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                a = _eval_argtypes(seq, env)
                return None if a is None else a * n.value
    return None


def read_sources(tree: ast.Module) -> Tuple[Optional[ast.AST],
                                            Dict[str, Tuple[ast.AST,
                                                            Optional[List[str]]]]]:
    """(the `SOURCES` assignment, {kernel: (key node, ctypes names or
    None)}) of a parsed `_build.py`."""
    env = _ctypes_env(tree)
    for node in tree.body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  and len(node.targets) == 1 else
                  node.target if isinstance(node, ast.AnnAssign) else None)
        if (isinstance(target, ast.Name) and target.id == "SOURCES"
                and isinstance(node.value, ast.Dict)):
            out = {}
            for k, v in zip(node.value.keys, node.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out[k.value] = (k, _eval_argtypes(v, env))
            return node, out
    return None, {}


def _is_build_launch(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (call_name(node) or "") in ("_build.launch", "launch"))


@register
class CudaKernelRule(Rule):
    """The ctypes bindings of the CUDA kernels agree with their sources.

    A launch function is called through ctypes with the argument types
    `kernels/_build.SOURCES` declares; a wrong type or count there is
    silent undefined behaviour on the card, which no CPU test can see.
    Scope: ``repro_torch/kernels/*.py``.  In `_build.py`:

    * every `SOURCES` entry has a ``csrc/<name>.cu`` that defines
      ``extern "C" int <name>_launch(...)``, and every ``csrc/*.cu`` has
      an entry;
    * the signature's parameters match the argtypes tuple in count and
      kind (pointer ↔ ``c_void_p``, ``int`` ↔ ``c_int``, ``long long`` ↔
      ``c_longlong``), the last being ``void* stream`` ↔ ``c_void_p``.

    In every other kernel module:

    * a ``_build.launch("<name>", device, ...)`` call names a `SOURCES`
      entry and passes ``len(SOURCES[name]) - 1`` arguments after the
      device (the stream is appended); a starred argument, whose count
      cannot be read, is itself a finding;
    * a launch helper (a function whose ``_build.launch`` takes the
      kernel's name from its parameter) is called only with literal
      names of `SOURCES` entries whose argument count its launch passes;
    * each wrapper (a function that launches, directly or through a
      helper) bumps its own ``<wrapper>.launches`` by one once per
      launch, the module sets it to 0, and nothing else bumps it.

    `SOURCES` and the CUDA sources are read from the scan root, so a
    module scanned alone is checked against the checkout's kernels.
    """

    id = "cuda-kernel"
    summary = "CUDA binding disagrees with its source / launch counter"

    def applies(self, path: str) -> bool:
        return (path.startswith("repro_torch/kernels/")
                and path.count("/") == 2 and path.endswith(".py"))

    def check(self, mod: ModuleSource) -> Iterator[Finding]:
        if mod.path == BUILD_MODULE:
            yield from self._check_build(mod)
            return
        build = mod.root / BUILD_MODULE
        if not build.exists():
            return
        _, sources = read_sources(ast.parse(build.read_text()))
        counts = {n: len(t) - 1 for n, (_, t) in sources.items()
                  if t is not None}
        yield from self._check_launches(mod, counts)

    # -- _build.py: SOURCES against csrc/*.cu -------------------------------

    def _check_build(self, mod: ModuleSource) -> Iterator[Finding]:
        site, sources = read_sources(mod.tree)
        if site is None:
            yield mod.finding(self.id, mod.tree.body[0] if mod.tree.body
                              else mod.tree,
                              "no literal `SOURCES` dict: the kernels' "
                              "bindings cannot be checked")
            return
        csrc = mod.root / CSRC_DIR
        on_disk = {p.stem for p in csrc.glob("*.cu")}
        for stem in sorted(on_disk - set(sources)):
            yield mod.finding(
                self.id, site,
                f"csrc/{stem}.cu has no `SOURCES` entry: it is never built "
                "or bound")
        for name, (key, types) in sources.items():
            yield from self._check_entry(mod, csrc, name, key, types)

    def _check_entry(self, mod: ModuleSource, csrc: Path, name: str,
                     key: ast.AST, types: Optional[List[str]]
                     ) -> Iterator[Finding]:
        cu = csrc / f"{name}.cu"
        if types is None:
            yield mod.finding(self.id, key,
                              f"`SOURCES[{name!r}]` is not a tuple of "
                              "ctypes types: its binding cannot be checked")
            return
        if not cu.exists():
            yield mod.finding(self.id, key,
                              f"`SOURCES[{name!r}]` has no csrc/{name}.cu")
            return
        sig = launch_signatures(cu.read_text()).get(name)
        if sig is None:
            yield mod.finding(self.id, key,
                              f'csrc/{name}.cu defines no extern "C" int '
                              f"{name}_launch(...)")
            return
        if len(sig) != len(types):
            yield mod.finding(
                self.id, key,
                f"`SOURCES[{name!r}]` declares {len(types)} argument "
                f"types but {name}_launch takes {len(sig)} parameters")
            return
        for i, ((kind, pname), t) in enumerate(zip(sig, types)):
            if CTYPES_KINDS[t] != kind:
                yield mod.finding(
                    self.id, key,
                    f"`SOURCES[{name!r}]` argument {i} is {t} but "
                    f"{name}_launch's parameter `{pname}` is {kind}")
        kind, pname = sig[-1]
        if pname != "stream" or kind != "pointer":
            yield mod.finding(
                self.id, key,
                f"{name}_launch's last parameter must be `void* stream` "
                f"(got {kind} `{pname}`): `launch` appends the stream")

    # -- wrappers: launch calls and counters --------------------------------

    def _check_launches(self, mod: ModuleSource,
                        counts: Dict[str, int]) -> Iterator[Finding]:
        top = [n for n in mod.tree.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        helpers = {}  # helper name -> arguments its launch passes
        for fn in top:
            params = [a.arg for a in fn.args.args]
            for call in filter(_is_build_launch, ast.walk(fn)):
                if (call.args and isinstance(call.args[0], ast.Name)
                        and call.args[0].id in params):
                    helpers[fn.name] = (
                        None if any(isinstance(a, ast.Starred)
                                    for a in call.args)
                        else len(call.args) - 2)
        for fn in top:
            sites = []
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                if _is_build_launch(call) and fn.name not in helpers:
                    sites.append(call)
                    yield from self._check_call(mod, call, counts,
                                                len(call.args) - 2)
                elif (call_name(call) or "") in helpers:
                    sites.append(call)
                    yield from self._check_call(
                        mod, call, counts, helpers[call_name(call)])
            yield from self._check_counter(mod, fn, sites)
        yield from self._check_stray_bumps(mod, top, helpers)

    def _check_call(self, mod: ModuleSource, call: ast.Call,
                    counts: Dict[str, int],
                    passed: Optional[int]) -> Iterator[Finding]:
        first = call.args[0] if call.args else None
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            return  # a helper's own launch: checked at its callers
        name = first.value
        if name not in counts:
            yield mod.finding(self.id, call,
                              f"launch of {name!r}, which `SOURCES` does "
                              "not declare")
            return
        starred = any(isinstance(a, ast.Starred) for a in call.args)
        if passed is None or (starred and _is_build_launch(call)):
            yield mod.finding(
                self.id, call,
                f"launch of {name!r} with a starred argument: its count "
                "cannot be checked against `SOURCES`; pass the arguments "
                "one by one")
        elif passed != counts[name]:
            yield mod.finding(
                self.id, call,
                f"launch of {name!r} passes {passed} arguments, but "
                f"`SOURCES[{name!r}]` declares {counts[name]} before the "
                "stream")

    @staticmethod
    def _bumps(fn: ast.AST) -> List[ast.AugAssign]:
        return [n for n in ast.walk(fn)
                if isinstance(n, ast.AugAssign)
                and isinstance(n.target, ast.Attribute)
                and n.target.attr == "launches"]

    def _check_counter(self, mod: ModuleSource, fn: ast.AST,
                       sites: List[ast.Call]) -> Iterator[Finding]:
        if not sites:
            return
        bumps = self._bumps(fn)
        own = [b for b in bumps
               if dotted_name(b.target.value) == fn.name
               and isinstance(b.op, ast.Add)
               and isinstance(b.value, ast.Constant) and b.value.value == 1]
        if len(own) != len(sites) or len(bumps) != len(own):
            yield mod.finding(
                self.id, fn,
                f"`{fn.name}` launches {len(sites)} time(s) but bumps "
                f"`{fn.name}.launches` by one {len(own)} time(s)"
                + (f" (and another counter {len(bumps) - len(own)} "
                   "time(s))" if len(bumps) != len(own) else "")
                + ": the count must be one per launch")
        if not any(isinstance(n, ast.Assign) and len(n.targets) == 1
                   and isinstance(n.targets[0], ast.Attribute)
                   and n.targets[0].attr == "launches"
                   and dotted_name(n.targets[0].value) == fn.name
                   for n in mod.tree.body):
            yield mod.finding(self.id, fn,
                              f"`{fn.name}.launches` is never set to 0 at "
                              "module level")

    def _check_stray_bumps(self, mod: ModuleSource, top: List[ast.AST],
                           helpers: Dict[str, Optional[int]]
                           ) -> Iterator[Finding]:
        launching = set()
        for fn in top:
            if any(_is_build_launch(c) or (isinstance(c, ast.Call) and (
                    call_name(c) or "") in helpers) for c in ast.walk(fn)):
                launching.add(fn.name)
        for fn in top:
            if fn.name in launching and fn.name not in helpers:
                continue
            for b in self._bumps(fn):
                yield mod.finding(
                    self.id, b,
                    f"`{dotted_name(b.target.value)}.launches` bumped in "
                    f"`{fn.name}`, which launches no kernel: the count "
                    "must move only where a kernel launches")
        for node in mod.tree.body:
            if isinstance(node, ast.AugAssign) and isinstance(
                    node.target, ast.Attribute) \
                    and node.target.attr == "launches":
                yield mod.finding(self.id, node,
                                  "`.launches` bumped at module level")
