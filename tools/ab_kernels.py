#!/usr/bin/env python3
"""Compare this checkout's ELL kernels that take row lengths with another
checkout's, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 tools/ab_kernels.py --base DIR

DIR is the root of another checkout of the repo, for example a
`git archive` of the parent commit unpacked under `build/`.  Its
`src/repro_torch` is loaded as a second package, `base_repro_torch`,
which builds its kernels into DIR's own build directory.  For each of
`ell_cc`, `ell_pagerank`, `ell_multi`, `ell_triangles`,
`ell_hindex_count` and `ell_allpairs`:

* registers: `nvcc -Xptxas -v` of the source in both checkouts (the
  build flags of `kernels/_build.py`), each kernel's registers a thread
  and spills;
* on chip_smoke.py's DS1 graph and on its 2^21-node scale graph, with
  the fields the analytics path gives them (CC labels, PageRank
  contributions, an h-index field for `ell_multi` and the count variant,
  rows = nbr for the two triangle kernels): every output of this
  checkout, with the row lengths `deg` and without, equal bit for bit to
  the base's (with `deg` too where the base's wrapper takes it); and each
  call's device time, as chip_smoke.py times a kernel (`_time_ms`: the
  median of 20 back-to-back calls), in turns: base, this, this, base,
  each side the smaller of its two medians.

Prints the card line, then one JSON object per graph; exits non-zero if
any output differs or there is no CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: kernel name -> its wrapper (module.function under repro_torch.kernels)
WRAPPERS = {
    "ell_cc": "ell_cc.neighbor_min_ell",
    "ell_pagerank": "ell_pagerank.neighbor_sum_ell",
    "ell_multi": "ell_multi.neighbor_multi_ell",
    "ell_triangles": "ell_triangles.neighbor_common_ell",
    "ell_hindex_count": "ell_hindex.hindex_count_ell",
    "ell_allpairs": "ell_triangles.common_allpairs_ell",
}


def load_base(root: Path):
    """`root`'s `src/repro_torch`, imported as the package
    `base_repro_torch` (its modules import one another relatively)."""
    pkg = root / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "base_repro_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["base_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return mod


def wrapper(package: str, name: str):
    mod, fn = WRAPPERS[name].split(".")
    return getattr(importlib.import_module(f"{package}.kernels.{mod}"), fn)


def registers(build_mod, name: str) -> dict:
    """{kernel function: "N registers, S bytes spill stores"} of
    `csrc/<name>.cu` of the checkout `build_mod` (a `kernels._build`)."""
    out_so = build_mod.BUILD_DIR / f"{name}-ptxas.so"
    build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out_so), str(build_mod.CSRC / f"{name}.cu")],
        capture_output=True, text=True, check=True)
    found, fn = {}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            found.setdefault(fn, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            found.setdefault(fn, {})["registers"] = int(m.group(1))
    return found


def compare(graph: str, g, fields, cs) -> dict:
    """Both checkouts' kernels on graph `g`: bit-equality and times."""
    import torch

    nbr, deg = g.nbr, g.deg
    hfield, lab, contrib = fields
    args = {"ell_cc": (nbr, lab), "ell_pagerank": (nbr, contrib),
            "ell_multi": (nbr, (hfield, lab, contrib),
                          ("hindex", "min", "sum")),
            "ell_triangles": (nbr, nbr), "ell_hindex_count": (nbr, hfield),
            "ell_allpairs": (nbr, nbr)}
    line = {"graph": graph, "N": g.N, "Cd": g.Cd,
            "valid_slots": int((nbr >= 0).sum()),
            "order": "base, this, this, base", "kernels": {}}
    for name, a in args.items():
        this, base = wrapper("repro_torch", name), wrapper("base_repro_torch",
                                                           name)
        base_deg = "deg" in inspect.signature(base).parameters

        def bits(out):
            outs = out if isinstance(out, tuple) else (out,)
            return [o.view(torch.int32) for o in outs]

        want = bits(base(*a))
        got = {"this/deg": bits(this(*a, deg=deg)), "this": bits(this(*a))}
        if base_deg:
            got["base/deg"] = bits(base(*a, deg=deg))
        torch.cuda.synchronize()
        equal = {k: all(torch.equal(x, y) for x, y in zip(v, want))
                 for k, v in got.items()}
        entry = {"bit_equal_to_base": equal, "base_takes_deg": base_deg}
        pairs = {"without_deg": (lambda: base(*a), lambda: this(*a)),
                 "this_with_deg_vs_base_without": (
                     lambda: base(*a), lambda: this(*a, deg=deg))}
        if base_deg:
            pairs["with_deg"] = (lambda: base(*a, deg=deg),
                                 lambda: this(*a, deg=deg))
        for pn, (b, t) in pairs.items():
            b1 = cs._time_ms(b)
            t1, t2 = cs._time_ms(t), cs._time_ms(t)
            b2 = cs._time_ms(b)
            entry[pn] = {"base_ms": min(b1, b2), "this_ms": min(t1, t2),
                         "this_over_base": min(t1, t2) / min(b1, b2),
                         "medians_ms": [b1, t1, t2, b2]}
        line["kernels"][name] = entry
    return line


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path,
                    help="root of the checkout to compare with")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.core import (
        build_ell_random, connected_components, coreness, pagerank)
    from repro_torch.core.algorithms import INT32_MAX, PageRankProgram
    from repro_torch.kernels import _build

    base_pkg = load_base(opts.base.resolve())
    base_build = importlib.import_module("base_repro_torch.kernels._build")
    print(cs.card_line(), flush=True)
    _build.build_all()
    base_build.build_all()
    print(json.dumps({"registers": {
        side: {n: registers(b, n) for n in WRAPPERS}
        for side, b in (("base", base_build), ("this", _build))},
        "base": str(opts.base), "base_package": base_pkg.__file__}),
        flush=True)

    dev = torch.device("cuda", 0)
    ok = True
    graphs = (("ds1", lambda: cs.ds1_graph(dev)[0]),
              ("scale_2^%d" % cs.SCALE_LOG2_N, lambda: build_ell_random(
                  2 ** cs.SCALE_LOG2_N, Cd=32, seed=0, m_factor=4.0,
                  device=dev)))
    for graph, make in graphs:
        g = make()
        lab = torch.where(g.node_mask, connected_components(g), INT32_MAX)
        contrib = PageRankProgram._contrib(
            g.deg, pagerank(g, tol=None, max_steps=30))
        hfield = coreness(g) if graph == "ds1" else g.deg
        line = compare(graph, g, (hfield, lab, contrib), cs)
        print(json.dumps(line), flush=True)
        ok = ok and all(all(e["bit_equal_to_base"].values())
                        for e in line["kernels"].values())
        del g
        torch.cuda.empty_cache()
    if not ok:
        print("ab_kernels: an output differs from the base's",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
