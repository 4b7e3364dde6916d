#!/usr/bin/env python3
"""The LM training step on one NVIDIA GPU, and where its time goes.

Run from the root of a checkout, on a machine with one CUDA card (no
kernel is built: training reaches none of the port's CUDA kernels):

    python3 tools/train_lm.py [--models NAME,...] [--no-phase]

Runs `chip_smoke.py`'s `train_lm` phase for `--models` (default: its two
models at published widths; the reduced architectures and the drill
too; it raises on a failure) unless `--no-phase`.  Then, for each model
at the phase's width, batch and sequence in bf16, from the phase's seed:
two warm-up steps of `launch.train.make_step`, then on the host clock
around work ending in a synchronize (median of 3 each) the loss and its
backward alone (`value_and_grad` of `loss_fn(remat=True)`), the AdamW
update alone (`optim.update` of those gradients) and the whole step;
then 2 steps under `torch.profiler`.  One JSON line a model: those ms,
the device ms a step summed over every kernel, memcpy and memset of the
profiled steps, the device's busy share of their wall, device
operations a step, and the top kernels.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 3
PROFILED = 2


def _host_ms(fn, reps=REPS) -> float:
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profile_step(cs, name, card, dev):
    """The step of `name` split and profiled: one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import make_step
    from repro_torch.models import build, value_and_grad

    cfg = get_arch(name)
    bundle = build(cfg)
    B, S = cs.TRAIN_LM_BATCH, cs.TRAIN_LM_SEQ
    ocfg = optim.AdamWConfig()
    params = bundle.init(cs.TRAIN_LM_SEED, device=dev)
    state = optim.init(params, ocfg)
    step = make_step(bundle, ocfg, cfg, False, None)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticTokens(
        cfg.vocab, S, B, seed=cs.TRAIN_LM_SEED).batch(0).items()}
    for _ in range(2):  # warm-up
        params, state, _ = step(params, state, batch)
    grad = value_and_grad(lambda p, b: bundle.loss_fn(p, b, remat=True)[0])
    grad_ms = _host_ms(lambda: grad(params, batch))
    _, grads = grad(params, batch)
    update_ms = _host_ms(lambda: optim.update(grads, state, ocfg,
                                              torch.bfloat16))
    del grads

    def one_step():
        nonlocal params, state
        params, state, _ = step(params, state, batch)

    step_ms = _host_ms(one_step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof_ms = _host_ms(one_step, PROFILED)
    by_name = collections.Counter()
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            count += 1
    if count == 0:
        raise RuntimeError("the profiler recorded no device operation")
    device_ms = sum(by_name.values()) / 1e3 / PROFILED
    print(json.dumps({
        "tool": "train_lm", "model": name, "card": card, "batch": B,
        "seq": S, "dtype": cfg.dtype, "grad_ms": grad_ms,
        "update_ms": update_ms, "step_ms": step_ms,
        "wall_profiled_ms_a_step": wall_prof_ms,
        "device_ms_a_step": device_ms,
        "device_busy_share": device_ms / wall_prof_ms,
        "device_ops_a_step": count / PROFILED,
        "top_kernels_ms_a_step": {k[:80]: v / 1e3 / PROFILED
                                  for k, v in by_name.most_common(10)},
    }), flush=True)
    del params, state, batch
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=None,
                    help="comma-separated; default: the phase's models")
    ap.add_argument("--no-phase", action="store_true",
                    help="profile only; skip the train_lm phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_lm: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    models = (tuple(args.models.split(",")) if args.models
              else cs.TRAIN_LM_MODELS)
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    if not args.no_phase:
        cs.train_lm_phase(card, dev, models)
    for name in models:
        profile_step(cs, name, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
