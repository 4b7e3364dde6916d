"""Exact roofline terms via affine layer-count extrapolation (the JAX
package's `launch.extrapolate`).

Every scan group of the models has an IDENTICAL body, so a step's
per-device FLOPs, bytes and collective bytes are affine in the
per-group layer counts:

    cost(L_1, ..., L_g) = a + Σ_i b_i · L_i

Each cell is counted (`dryrun.measure_cell`) at g+1 small layer-count
settings (depths 2 and 6 per group), the affine system is solved, and
evaluated at the real depths.  The reference fits XLA's counts of
compiled programs, whose fusions at a group's boundary make the fit
approximate (<1 % there); eager PyTorch runs each layer's ops exactly
as the others', so here the counts are exactly affine and the fit
reproduces a full-depth `dryrun.run_cell` exactly, with one condition
that the reference shares: the ZeRO rule (`sharding.zero_spec`) shards a
stacked leaf's layer dim over ``data`` when ``data`` divides it, so the
optimizer's traffic is affine only across depths that ``data`` divides
alike.  On 16 x 16 the probes (2, 6) never divide, nor do internlm2's
24 layers; a group of 16, 32 or 48 layers (codeqwen's 32, llama4's and
mamba2's 48) is sharded otherwise, and its bytes and collectives are
extrapolated from the probes' layout (its FLOPs stay exact).  The system
is square and its solution is computed in exact rational arithmetic
(the reference's `lstsq` of the same system, without its rounding).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.extrapolate --all \\
      --out build/roofline
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from fractions import Fraction
from pathlib import Path

from ..configs import ARCHS, SHAPES, SHAPES_BY_NAME, cell_applicable
from . import dryrun as DR
from .mesh import make_production_mesh


def group_counts(cfg):
    """The per-group layer-count knobs for this arch, as (names, values)."""
    if cfg.is_encdec:
        return ["enc_layers", "n_layers"], [cfg.enc_layers, cfg.n_layers]
    if cfg.mixer == "mamba" and cfg.shared_attn_period:
        p = cfg.shared_attn_period
        return ["_periods", "_tail"], [cfg.n_layers // p, cfg.n_layers % p]
    if cfg.n_experts and cfg.first_k_dense:
        return ["first_k_dense", "_moe"], [cfg.first_k_dense,
                                           cfg.n_layers - cfg.first_k_dense]
    if cfg.local_global_period:
        p = cfg.local_global_period
        return ["_periods", "_tail"], [cfg.n_layers // p, cfg.n_layers % p]
    return ["n_layers"], [cfg.n_layers]


def with_counts(cfg, names, values):
    """Rebuild a config with the given per-group counts."""
    kw = {}
    vals = dict(zip(names, values))
    if cfg.is_encdec:
        kw["enc_layers"] = vals["enc_layers"]
        kw["n_layers"] = vals["n_layers"]
    elif "_periods" in vals and cfg.shared_attn_period:
        kw["n_layers"] = (vals["_periods"] * cfg.shared_attn_period
                          + vals["_tail"])
    elif "_periods" in vals:
        kw["n_layers"] = (vals["_periods"] * cfg.local_global_period
                          + vals["_tail"])
    elif "first_k_dense" in vals:
        kw["first_k_dense"] = vals["first_k_dense"]
        kw["n_layers"] = vals["first_k_dense"] + vals["_moe"]
    else:
        kw["n_layers"] = vals["n_layers"]
    return dataclasses.replace(cfg, **kw)


def probe_points(real):
    """Affine in g unknowns + constant -> g+1 probe settings: depth 2 per
    group (0 where the real count is 0), then each group in turn at 6.
    Eager counts are exactly affine at any depth; the depths are the
    reference's, which chose them to keep XLA's boundary fusions out of
    the slope."""
    g = len(real)
    base = [2 if r > 0 else 0 for r in real]
    pts = [tuple(base)]
    for i in range(g):
        if real[i] > 0:
            p = list(base)
            p[i] = base[i] + 4
            pts.append(tuple(p))
    return pts


def measure(cfg, shape_name, multi_pod=False, device=None, mesh=None):
    """Count one (small) config on the production mesh (or `mesh`);
    returns the metric dict."""
    m = DR.measure_cell(cfg, shape_name, mesh or make_production_mesh(
        multi_pod=multi_pod), device)
    return {
        "flops": m["flops"],
        "bytes": m["bytes"],
        "coll": m["coll"],
        "coll_by_kind": m["coll_by_kind"],
        "coll_s": m["coll_s"],
    }


def _solve(pts, ys):
    """The affine coefficients (a, b_1, ..., b_g) through the probes, by
    Gaussian elimination on Fractions over the groups the probes vary
    (a group whose real count is 0 is never probed and keeps b = 0)."""
    g = len(pts[0])
    live = [i for i in range(g) if any(p[i] for p in pts)]
    rows = [[Fraction(1)] + [Fraction(p[i]) for i in live] + [Fraction(y)]
            for p, y in zip(pts, ys)]
    n = len(live) + 1
    for c in range(n):
        piv = next(r for r in range(c, n) if rows[r][c] != 0)
        rows[c], rows[piv] = rows[piv], rows[c]
        for r in range(n):
            if r != c and rows[r][c] != 0:
                f = rows[r][c] / rows[c][c]
                rows[r] = [x - f * y for x, y in zip(rows[r], rows[c])]
    sol = [rows[r][n] / rows[r][r] for r in range(n)]
    coef = [sol[0]] + [Fraction(0)] * g
    for j, i in enumerate(live):
        coef[1 + i] = sol[1 + j]
    return coef


def _at(coef, real) -> float:
    return float(max(Fraction(0), coef[0] + sum(
        c * r for c, r in zip(coef[1:], real))))


def extrapolate_cell(arch: str, shape_name, verbose=True, cfg=None,
                     device=None, mesh=None):
    """The reference's extrapolated record of one cell on 16 x 16 (or on
    `mesh`; `cfg` in place of ``ARCHS[arch]``, `shape_name` a name of
    `SHAPES` or a `ShapeConfig`)."""
    cfg = cfg if cfg is not None else ARCHS[arch]
    shape = SHAPES_BY_NAME[shape_name] if isinstance(shape_name, str) \
        else shape_name
    ok, reason = cell_applicable(cfg, shape)
    mesh = mesh or make_production_mesh()
    rec = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(str(s) for s in mesh.axis_sizes),
           "extrapolated": True, "unrolled": True, "mla_absorbed": False}
    if not ok:
        rec.update(status="SKIP", reason=reason)
        return rec

    names, real = group_counts(cfg)
    pts = probe_points(real)
    t0 = time.perf_counter()
    ms = [measure(with_counts(cfg, names, p), shape, device=device,
                  mesh=mesh) for p in pts]

    # solve the affine system  cost = a + sum b_i * L_i  exactly
    rec_metrics = {}
    for key in ("flops", "bytes", "coll", "coll_s"):
        rec_metrics[key] = _at(_solve(pts, [m[key] for m in ms]), real)
    # collective kinds: extrapolate each kind the same way
    kinds = sorted({k for m in ms for k in m["coll_by_kind"]})
    coll_kinds = {k: _at(_solve(pts, [m["coll_by_kind"].get(k, 0)
                                      for m in ms]), real) for k in kinds}

    rec.update({
        "status": "OK",
        "chips": mesh.size,
        "probe_points": [list(p) for p in pts],
        "group_names": names,
        "group_counts": real,
        "compile_s": round(time.perf_counter() - t0, 2),
        "per_device_flops": rec_metrics["flops"],
        "per_device_bytes": rec_metrics["bytes"],
        "collective_bytes_per_device": coll_kinds,
        "collective_bytes_total": rec_metrics["coll"],
        "compute_term_s": rec_metrics["flops"] / DR.PEAK_FLOPS,
        "memory_term_s": rec_metrics["bytes"] / DR.HBM_BW,
        "collective_term_s": rec_metrics["coll_s"],
        "memory_analysis": None,  # from the full-depth pass
    })
    if verbose:
        print(f"[{arch} × {shape_name}] extrapolated "
              f"flops/dev={rec_metrics['flops']:.3e} "
              f"bytes/dev={rec_metrics['bytes']:.3e} "
              f"coll/dev={rec_metrics['coll']:.3e} "
              f"({rec['compile_s']}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default="build/roofline")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = ([(a, s.name) for a in ARCHS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in cells:
        fp = outdir / f"{arch}_{shape}_single_extrap.json"
        real = outdir / f"{arch}_{shape}_single_unrolled.json"
        if args.skip_existing and (fp.exists() or real.exists()):
            print(f"[{arch} × {shape}] exists, skipping")
            continue
        try:
            rec = extrapolate_cell(arch, shape)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": "16x16",
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-1500:]}
            failures += 1
            print(f"[{arch} × {shape}] FAIL {rec['error'][:150]}", flush=True)
        fp.write_text(json.dumps(rec, indent=2, default=str))
    print(f"done; {failures} failures")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
