"""tracelint for the port (`repro_torch.analysis`) against the JAX
package's (`repro.analysis`).

* each port rule: a snippet that MUST produce a finding and a minimally
  different one that MUST NOT;
* the engine, the import graph and the rules the two packages share give
  the same results on the same inputs (written under `repro/...` for one
  and `repro_torch/...` for the other);
* the port's own tree is clean against the committed empty
  `tracelint_torch_baseline.json`, and the CLI gate fails on a
  deliberate violation;
* `cuda-kernel` catches mutations of a scratch copy of the kernels, and
  `port-import` a module that imports the JAX package;
* the entry-point audit is clean on the tiny graph, flags a leaky entry
  and a data-dependent-shape op, counts each kind of host read once, and
  each manifest entry computes what the JAX package's entry computes.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_port import (assert_same_state, needs_cuda,  # noqa: F401
                         one_torch_thread, require_cuda)

import repro.analysis as ref
import repro.analysis.engine as ref_engine
import repro.analysis.entrypoints as ref_entrypoints
import repro.analysis.imports as ref_imports
import repro_torch.analysis as port
import repro_torch.analysis.engine as port_engine
import repro_torch.analysis.entrypoints as port_entrypoints
import repro_torch.analysis.imports as port_imports
from repro_torch.analysis.__main__ import main as tracelint_main
from repro_torch.analysis.entrypoints import (EntryPoint, World,
                                              count_host_reads, probe_syncs,
                                              run_audit, tiny_world)
from test_tracelint import _ELL_BAD, _ELL_OK, _SYNC_BAD

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parents[1]
SRC_ROOT = REPO / "src"
BASELINE = REPO / "tracelint_torch_baseline.json"


def _scan(text, path, rule):
    return port.scan_source(text, path, rules=[rule])


def _write(path: Path, text: str = "") -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


# ---------------------------------------------------------------------------
# host-sync, in PyTorch's idiom
# ---------------------------------------------------------------------------

_READS = {
    "item": "x.item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.numpy()",
    "to_cpu": 'x.to("cpu")',
    "to_device_cpu": 'x.to(device=torch.device("cpu"))',
    "np_asarray": "np.asarray(x)",
    "int_torch": "int(torch.sum(x))",
    "bool_method": "bool(x.any())",
    "float_name": "float(t)",
}


@pytest.mark.parametrize("expr", sorted(_READS))
def test_host_sync_trigger_and_boundary(expr):
    text = ("import numpy as np\nimport torch\n\n"
            "def superstep(x):\n    t = torch.zeros(())\n"
            f"    return {_READS[expr]}\n")
    fs = _scan(text, "repro_torch/runtime/fake.py", "host-sync")
    assert [(f.rule, f.line) for f in fs] == [("host-sync", 6)]
    # the same read behind a boundary pragma, or out of scope, is clean
    marked = text.replace("def superstep(x):",
                          "def superstep(x):  # tracelint: boundary")
    assert _scan(marked, "repro_torch/runtime/fake.py", "host-sync") == []
    assert _scan(text, "repro_torch/graphgen/fake.py", "host-sync") == []


def test_host_sync_non_triggers():
    text = ("import numpy as np\n\ndef f(x, n):\n"
            "    a = int(n)\n"            # a host int
            "    b = x.cpu().numpy()\n"   # ONE read, not two
            "    c = int(np.max(a))\n"     # numpy, not a tensor
            "    return x.to(torch.int32), a, b, c\n")
    fs = _scan(text, "repro_torch/kernels/fake.py", "host-sync")
    assert [f.line for f in fs] == [5]
    # build_blocks is a registered boundary of core/graph.py
    text = "def build_blocks(e):\n    return e.cpu()\n"
    assert _scan(text, "repro_torch/core/graph.py", "host-sync") == []
    assert len(_scan(text.replace("build_blocks", "sneaky"),
                     "repro_torch/core/graph.py", "host-sync")) == 1


def test_host_sync_item_and_asarray_parity():
    """`.item()` and `np.asarray` findings on the same snippet agree with
    the JAX package's rule line for line."""
    text = ("import numpy as np\n\ndef superstep(x):\n"
            "    a = x.item()\n    b = np.asarray(x)\n"
            "    c = np.array(x)\n    return a, b, c\n")
    want = ref.scan_source(text, "repro/runtime/fake.py", rules=["host-sync"])
    got = port.scan_source(text, "repro_torch/runtime/fake.py",
                           rules=["host-sync"])
    assert [f.line for f in got] == [f.line for f in want] == [4, 5, 6]


# ---------------------------------------------------------------------------
# retrace-hazard (the cache parts)
# ---------------------------------------------------------------------------

_KEY_BAD = """\
import functools

@functools.lru_cache(maxsize=8)
def _table(width):
    return width

def step(x):
    return _table(x.shape[1])
"""


def test_retrace_shape_key_trigger_and_bucketed_escape():
    bad = _scan(_KEY_BAD, "repro_torch/runtime/fake.py", "retrace-hazard")
    assert [(f.rule, f.line) for f in bad] == [("retrace-hazard", 8)]
    ok = _KEY_BAD.replace("_table(x.shape[1])",
                          "_table(_pow2_bucket(x.shape[1]))")
    assert _scan(ok, "repro_torch/runtime/fake.py", "retrace-hazard") == []
    # one assignment deep
    local = _KEY_BAD.replace("    return _table(x.shape[1])",
                             "    w = x.numel()\n    return _table(w)")
    assert len(_scan(local, "repro_torch/runtime/fake.py",
                     "retrace-hazard")) == 1


def test_retrace_mutable_default_on_cached_def():
    bad = ("import functools\n\n@functools.lru_cache\n"
           "def f(x, hist=[]):\n    return x\n")
    assert len(_scan(bad, "repro_torch/runtime/fake.py",
                     "retrace-hazard")) == 1
    assert _scan(bad.replace("hist=[]", "hist=()"),
                 "repro_torch/runtime/fake.py", "retrace-hazard") == []


# ---------------------------------------------------------------------------
# sorted-ell and cache-key: the JAX package's snippets give the same
# findings
# ---------------------------------------------------------------------------

_CACHE_SNIPPETS = {
    "unregistered_lru": ("import functools\n\n@functools.lru_cache(maxsize=8)"
                         "\ndef _compiled_step(mesh, H):\n    return None\n"),
    "unregistered_dict": "class Engine:\n    _plan_cache: dict = {}\n",
}
_ELL_SNIPPETS = {
    "bad": _ELL_BAD,
    "ok": _ELL_OK,
    "other_names": ("def f(tbl, u, v):\n    halo = tbl.halo.at[u].set(v)\n"
                    "    return halo\n"),
}


@pytest.mark.parametrize("rule,name", [("sorted-ell", n)
                                       for n in sorted(_ELL_SNIPPETS)]
                         + [("cache-key", n) for n in sorted(_CACHE_SNIPPETS)])
def test_shared_rules_parity(rule, name):
    text = (_ELL_SNIPPETS if rule == "sorted-ell" else _CACHE_SNIPPETS)[name]
    want = ref.scan_source(text, "repro/runtime/fake.py", rules=[rule])
    got = port.scan_source(text, "repro_torch/runtime/fake.py", rules=[rule])
    assert [(f.line, f.rule, f.snippet) for f in got] == \
        [(f.line, f.rule, f.snippet) for f in want]


def test_sorted_ell_torch_writes():
    bad = ("def corrupt(g, u, v):\n    g.nbr[u, 0] = v\n"
           "    g.nbr.copy_(g.nbr.flip(1))\n    return g\n")
    fs = _scan(bad, "repro_torch/core/fake.py", "sorted-ell")
    assert [f.line for f in fs] == [2, 3]
    ok = ("from dataclasses import replace\n\n"
          "def splice(g, u, v):\n"
          "    g.nbr[u] = _sorted_insert_row(g.nbr[u], v)\n"
          "    return replace(g, nbr=g.nbr.clone())\n")
    assert _scan(ok, "repro_torch/core/fake.py", "sorted-ell") == []


def test_cache_key_registered_launcher():
    ok = ("import functools\n\n@functools.lru_cache(maxsize=None)\n"
          "def launcher(name):\n    return name\n")
    assert _scan(ok, "repro_torch/kernels/_build.py", "cache-key") == []
    under = ok.replace("launcher(name)", "launcher(kernel)")
    assert len(_scan(under, "repro_torch/kernels/_build.py",
                     "cache-key")) == 1


# ---------------------------------------------------------------------------
# the engine: same results as the JAX package's on the same inputs
# ---------------------------------------------------------------------------

_PRAGMAS = """\
def f(x):  # tracelint: boundary
    a = int(x)  # tracelint: disable=host-sync,sorted-ell
    b = x.item()  # tracelint: disable
    return a, b
"""


def test_engine_parity(tmp_path):
    rm = ref_engine.ModuleSource("repro/runtime/fake.py", _PRAGMAS)
    pm = port_engine.ModuleSource("repro/runtime/fake.py", _PRAGMAS)
    assert (pm.disables, pm.boundary_lines, pm.int_constants) == \
        (rm.disables, rm.boundary_lines, rm.int_constants)
    fields = dict(path="repro/runtime/fake.py", line=3, rule="host-sync",
                  message="m", snippet="b = x.item()")
    rf, pf = ref_engine.Finding(**fields), port_engine.Finding(**fields)
    assert (pf.fingerprint(), str(pf), pf.to_json()) == \
        (rf.fingerprint(), str(rf), rf.to_json())
    assert port_engine.Finding.from_json(rf.to_json()) == pf
    fs_r = ref.scan_source(_SYNC_BAD, "repro/runtime/fake.py",
                           rules=["host-sync"])
    fs_p = [port_engine.Finding(**f.to_json()) for f in fs_r]
    ref_engine.write_baseline(tmp_path / "r.json", fs_r)
    port_engine.write_baseline(tmp_path / "p.json", fs_p)
    assert (tmp_path / "r.json").read_bytes() == \
        (tmp_path / "p.json").read_bytes()
    base = port_engine.load_baseline(tmp_path / "r.json")
    assert base == ref_engine.load_baseline(tmp_path / "p.json")
    extra = dict(fields, line=99, snippet="int(jnp.prod(x))")
    new_r, old_r = ref_engine.partition_findings(
        fs_r + [ref_engine.Finding(**extra)], base)
    new_p, old_p = port_engine.partition_findings(
        fs_p + [port_engine.Finding(**extra)], base)
    assert [f.to_json() for f in new_p + old_p] == \
        [f.to_json() for f in new_r + old_r]
    assert len(new_p) == 1 and new_p[0].line == 99


_IMPORT_TREE = {
    "{p}/__init__.py": "",
    "{p}/core/__init__.py": "from .graph import build\n",
    "{p}/core/graph.py": "import numpy as np\nfrom ..kernels import ops\n",
    "{p}/kernels/__init__.py": "",
    "{p}/kernels/ops.py": "from . import ref\nfrom .ref import oracle\n",
    "{p}/kernels/ref.py": "",
    "{p}/service/queries.py": ("from ..core.graph import build\n"
                               "import {p}.kernels.ops\n"),
}


def test_import_graph_parity(tmp_path):
    for pkg in ("repro", "repro_torch"):
        for rel, text in _IMPORT_TREE.items():
            _write(tmp_path / pkg / rel.format(p=pkg), text.format(p=pkg))
    want = ref_imports.build_import_graph(tmp_path / "repro")
    graphs = port_imports.build_import_graph(tmp_path / "repro_torch")

    def rename(m):
        return m.replace("repro_torch", "repro", 1)
    got = {rename(m): {rename(e) for e in es} for m, es in graphs.items()}
    assert got == want
    assert sum(map(len, got.values())) == 7


# ---------------------------------------------------------------------------
# the port's tree, its audits and the CLI
# ---------------------------------------------------------------------------


def test_self_scan_is_clean_against_committed_baseline():
    findings = (port.scan_tree(SRC_ROOT) + port.audit_dead_seed(SRC_ROOT)
                + port.audit_port_imports(
                    SRC_ROOT, [REPO / "chip_smoke.py",
                               *sorted((REPO / "tools").glob("*.py"))]))
    new, _ = port.partition_findings(findings, port.load_baseline(BASELINE))
    assert new == [], "\n".join(str(f) for f in new)
    data = json.loads(BASELINE.read_text())
    assert data == {"version": 1, "count": 0, "fingerprints": []}


def test_dead_seed_reads_no_root_marker(tmp_path):
    _write(tmp_path / "repro_torch/__init__.py",
           '"""carries a seed_fixtures note for another audit"""\n')
    _write(tmp_path / "repro_torch/core/graph.py", "")
    _write(tmp_path / "repro_torch/orphan.py", "")
    _write(tmp_path / "repro/models/zoo.py", "")  # not the port's
    fs = port.audit_dead_seed(tmp_path)
    assert [(f.rule, f.snippet) for f in fs] == [
        ("dead-seed", "repro_torch.orphan")]
    # a sub-package's own marker still quarantines it
    _write(tmp_path / "repro_torch/fixtures/__init__.py",
           '"""seed_fixtures"""\n')
    _write(tmp_path / "repro_torch/fixtures/zoo.py", "")
    assert [f.snippet for f in port.audit_dead_seed(tmp_path)] == [
        "repro_torch.orphan"]


@pytest.mark.parametrize("line", [
    "import repro.core", "from repro.core import graph", "import jax",
    "from jax import numpy", "from ...repro import core",
    "importlib.import_module('repro.core.graph')",
])
def test_port_import_flags_the_jax_package(tmp_path, line):
    _write(tmp_path / "repro_torch/core/__init__.py", "")
    _write(tmp_path / "repro_torch/core/fake.py",
           f"import importlib\nimport torch\n{line}\n")
    _write(tmp_path / "script.py", f"{line}\n")
    fs = port.audit_port_imports(tmp_path, [tmp_path / "script.py"])
    assert [(f.rule, f.path, f.line) for f in fs] == [
        ("port-import", "repro_torch/core/fake.py", 3),
        ("port-import", "script.py", 1)]
    _write(tmp_path / "repro_torch/core/fake.py",
           "import torch\nfrom .. import kernels\nimport repro_torch.core\n")
    _write(tmp_path / "script.py", "import reprolib\n")
    assert port.audit_port_imports(tmp_path, [tmp_path / "script.py"]) == []


def test_cli_audit_needs_a_device_or_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("resolves to the card here")
    assert tracelint_main(["--check"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_cli_deliberate_violation_fails_then_baselines(tmp_path):
    _write(tmp_path / "repro_torch/runtime/bad.py",
           "def f(x):\n    return x.item()\n")
    baseline = tmp_path / "baseline.json"
    check = ["--root", str(tmp_path), "--baseline", str(baseline),
             "--no-audit", "--check"]
    assert tracelint_main(check) == 1
    assert tracelint_main(["--root", str(tmp_path), "--baseline",
                           str(baseline), "--no-audit",
                           "--write-baseline"]) == 0
    assert tracelint_main(check) == 0
    report = tmp_path / "report.json"
    assert tracelint_main(["--root", str(tmp_path), "--baseline",
                           str(tmp_path / "none.json"), "--no-audit",
                           "--report", str(report)]) == 0
    data = json.loads(report.read_text())
    assert data["total"] == len(data["new"]) == 1
    assert tracelint_main(["--root", str(tmp_path / "repro_torch")]) == 2


# ---------------------------------------------------------------------------
# cuda-kernel: clean on the tree, and each mutation of a scratch copy
# ---------------------------------------------------------------------------


def _kernels_copy(tmp_path) -> Path:
    src = SRC_ROOT / "repro_torch" / "kernels"
    dst = tmp_path / "repro_torch" / "kernels"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _mutate(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert text.count(old) == 1, (path, old)
    path.write_text(text.replace(old, new))


_MUTATIONS = {
    # an argtypes tuple one short
    "argtypes_short": ("_build.py",
                       '"ell_cc": (_P, _P, _P, _P, _L, _I, _I, _P),',
                       '"ell_cc": (_P, _P, _P, _P, _L, _I, _P),',
                       ("_build.py", "ell_cc")),
    # a .cu with an extra parameter
    "cu_extra_param": ("csrc/ell_hindex.cu",
                       "int ld, int C, void* stream) {",
                       "int ld, int C, int extra, void* stream) {",
                       ("_build.py", "ell_hindex")),
    # a launch call missing an argument
    "launch_short": ("ell_pagerank.py",
                     "deg_ptr(deg), out.data_ptr(), N, Cd,\n"
                     "                  columns(Cd, K))",
                     "deg_ptr(deg), out.data_ptr(), N, Cd)",
                     ("ell_pagerank.py", "passes 6")),
    # a kind mismatch: long long bound as int
    "kind": ("_build.py", '"kcore_hindex": (_P, _P, _P, _L, _I, _P),',
             '"kcore_hindex": (_P, _P, _P, _I, _I, _P),',
             ("_build.py", "long long")),
    # a source with no entry
    "orphan_cu": ("csrc/spare.cu", "", 'extern "C" int spare_launch('
                  "void* stream) { return 0; }\n", ("_build.py", "spare")),
    # a launch whose counter is not bumped
    "no_bump": ("ell_cc.py", "    neighbor_min_ell.launches += 1\n", "",
                ("ell_cc.py", "bumps")),
    # a counter bumped where nothing launches
    "stray_bump": ("frontier.py", "    fm = f.to(torch.float32)\n",
                   "    fm = f.to(torch.float32)\n"
                   "    frontier_step.launches += 1\n",
                   ("frontier.py", "launches no")),
    # a helper called with a name SOURCES does not declare
    "helper_name": ("ell_hindex.py", '_launch("ell_hindex_count",',
                    '_launch("ell_hindex_cnt",', ("ell_hindex.py",
                                                 "ell_hindex_cnt")),
}


def test_cuda_kernel_rule_is_clean_on_the_tree():
    assert port.scan_tree(SRC_ROOT, rules=["cuda-kernel"]) == []
    from repro_torch.kernels import _build

    # the ten ports, mirror_hindex and cc_union
    assert len(_build.SOURCES) == 12


@pytest.mark.parametrize("name", sorted(_MUTATIONS))
def test_cuda_kernel_rule_catches_mutation(tmp_path, name):
    rel, old, new, (where, what) = _MUTATIONS[name]
    kernels = _kernels_copy(tmp_path)
    if old:
        _mutate(kernels / rel, old, new)
    else:
        (kernels / rel).write_text(new)
    fs = port.scan_tree(tmp_path, rules=["cuda-kernel"])
    assert fs, name
    assert all(f.rule == "cuda-kernel" for f in fs)
    assert any(f.path == f"repro_torch/kernels/{where}" and what in f.message
               for f in fs), [str(f) for f in fs]


def test_cuda_kernel_rule_on_a_scanned_snippet():
    """A module scanned alone is checked against the checkout's SOURCES."""
    text = ("from . import _build\n\ndef f(nbr, out):\n"
            '    _build.launch("ell_cc", nbr.device, 1, 2, 3, 4, 5, 6)\n'
            "    f.launches += 1\n\nf.launches = 0\n")
    fs = _scan(text, "repro_torch/kernels/fake.py", "cuda-kernel")
    assert [f.line for f in fs] == [4] and "passes 6" in fs[0].message
    ok = text.replace("5, 6)", "5, 6, 7)")
    assert _scan(ok, "repro_torch/kernels/fake.py", "cuda-kernel") == []
    star = text.replace("1, 2, 3, 4, 5, 6)", "*args)")
    assert "starred" in _scan(star, "repro_torch/kernels/fake.py",
                              "cuda-kernel")[0].message


# ---------------------------------------------------------------------------
# the entry-point audit
# ---------------------------------------------------------------------------


def test_entry_point_audit_is_clean():
    assert run_audit(device="cpu") == []


def test_run_audit_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("resolves to the card here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_audit()


_READ_CALLS = {
    "bool": lambda x: bool(x[0]),
    "int": lambda x: int(x[0]),
    "float": lambda x: float(x[0]),
    "index": lambda x: [0, 1, 2][x[1]],
    "item": lambda x: x[0].item(),
    "tolist": lambda x: x.tolist(),
    "cpu_numpy": lambda x: x.cpu().numpy(),
    "np_asarray": lambda x: np.asarray(x),
    "to_cpu": lambda x: x.to("cpu").tolist(),
    "equal": lambda x: torch.equal(x, x),
    "format": lambda x: f"{x[0]}",
}


@pytest.mark.parametrize("kind", sorted(_READ_CALLS))
def test_count_host_reads_counts_each_read_once(kind):
    x = torch.arange(4, dtype=torch.int32)
    with count_host_reads("cpu") as box:
        _READ_CALLS[kind](x)
    assert box.count == 1, dict(box.sites)
    assert all("test_torch_analysis.py" in s for s in box.sites)


def test_count_host_reads_ignores_device_work():
    x = torch.arange(4, dtype=torch.int32)
    with count_host_reads("cpu") as box:
        y = (x * 2).to(torch.int64).to(x.device).sum()
        z = torch.from_numpy(np.zeros(3)).to(x.device)
        y.cpu()  # one read; its copy is host data from then on
        host = y.cpu()
        host.tolist()
    assert box.count == 2 and z.shape == (3,)


def _leaky_route(x):
    if bool(x.any()):
        return x + 1
    return x


def test_audit_flags_extra_host_read():
    ep = EntryPoint(name="leaky", invariant="routing is pure device code",
                    max_host_reads=0,
                    prepare=lambda w: (_leaky_route, (torch.arange(4),)))
    fs = run_audit([ep], device="cpu")
    assert len(fs) == 1 and "1 host read(s), budget 0" in fs[0].message
    assert "_leaky_route" in fs[0].message


def _hidden_sync(x):
    return x[x > 1] + x.nonzero().sum()


def test_audit_probe_flags_data_dependent_shapes():
    ep = EntryPoint(name="shapes", invariant="pure device code",
                    max_host_reads=99, probe=True,
                    prepare=lambda w: (_hidden_sync, (torch.arange(4),)))
    fs = run_audit([ep], device="cpu")
    assert len(fs) == 1 and "nonzero" in fs[0].message \
        and "bool-mask __getitem__" in fs[0].message
    with probe_syncs("cpu") as seen:
        torch.arange(4).repeat_interleave(torch.tensor([1, 2, 0, 1]))
        torch.arange(4).repeat_interleave(torch.tensor([1, 2, 0, 1]),
                                          output_size=4)
    assert len(seen) == 1 and "repeat_interleave" in seen[0]


_REF_ENTRIES = {rep.name: rep for rep in ref_entrypoints.MANIFEST}


def test_manifest_budgets_beside_the_reference():
    paired = [ep.reference for ep in port.MANIFEST if ep.reference]
    left_out = set(port_entrypoints.LEFT_OUT)
    assert len(paired) == len(set(paired)) and not left_out & set(paired)
    assert set(paired) | left_out == set(_REF_ENTRIES)
    for ep in port.MANIFEST:
        assert "the JAX package's" in ep.invariant, ep.name
        if ep.reference is None:
            assert ep.reference_budget is None, ep.name
        else:
            assert ep.reference_budget == \
                _REF_ENTRIES[ep.reference].max_device_gets, ep.name
            assert ep.name.split("[")[0] == ep.reference.split("[")[0]
    probes = {ep.name for ep in port.MANIFEST if ep.probe}
    assert probes == {"stream._route_window"}


def _port_value(name, out):
    """The part of a port entry's output its JAX counterpart returns."""
    if name.startswith(("ops.", "algorithms.")):
        return out[0]  # (result, supersteps)
    return out


@pytest.fixture(scope="module")
def worlds():
    return tiny_world("cpu"), {}


@pytest.mark.parametrize("i", range(len(port_entrypoints.MANIFEST)))
def test_manifest_entry_equals_reference(worlds, i):
    world, _ = worlds
    ep = port_entrypoints.MANIFEST[i]
    res = port_entrypoints.audit_entry(ep, world)
    assert res.error is None and res.host_reads <= res.read_budget
    if ep.name == "StreamSession.apply_window[escalated]":
        # the JAX package's clean-window session, fed the escalated window
        fn, _ = _REF_ENTRIES["StreamSession.apply_window[clean]"].prepare()
        args = (world.escalated,)
        assert res.steps[2:] == (1, 1)  # one batched, one sequential
    else:
        fn, args = _REF_ENTRIES[ep.reference].prepare()
    want = fn(*args)
    got = _port_value(ep.name, res.out)
    if ep.name.startswith("StreamSession"):
        want = fn.__self__.result()
    assert_same_state(got, want, ep.name)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@needs_cuda
def test_entry_point_audit_is_clean_on_cuda():
    assert run_audit(device="cuda") == []


@needs_cuda
def test_cuda_probe_and_sync_count():
    x = torch.arange(4, device="cuda")
    with probe_syncs("cuda") as seen:
        x.nonzero()
    assert len(seen) == 1
    with port_entrypoints.count_cuda_syncs() as box:
        x.cpu()
        torch.as_tensor(np.zeros(3), device="cuda")
        x + 1
    assert box.count == 2, dict(box.sites)


@needs_cuda
def test_clean_window_on_cuda():
    world = tiny_world("cuda")
    g = world.g
    window = port_entrypoints.clean_window(g, world.window)
    assert window == world.window
    assert isinstance(World(g, window).route_inputs()[0], torch.Tensor)
