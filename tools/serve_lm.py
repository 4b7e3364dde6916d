#!/usr/bin/env python3
"""The LM serve path on one NVIDIA GPU, alone, and where its decode time goes.

Run from the root of a checkout, on a machine with one CUDA card (no
kernel is built: the serve path reaches none of the port's CUDA kernels):

    python3 tools/serve_lm.py

First runs `chip_smoke.py`'s `serve_lm` phase unchanged (its lines, its
checks; it raises on a failure).  Then, for each of its models at full
width and depth in bf16, block-prefills the same 4 seeded prompts of
1,024 tokens, runs 2 decode steps to warm up, 8 timed on the host clock
and 8 under `torch.profiler`, and prints one JSON line: the wall ms a
step without and with the profiler, the device ms a step summed over
every kernel, memcpy and memset of the profiled steps, the device's busy
share of their wall, device operations a step, and the top kernels.
"""
from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("serve_lm: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.models import build

    card = cs.card_line()
    print(card, flush=True)
    cs.serve_lm_phase(card)
    dev = torch.device("cuda", 0)
    for name in cs.SERVE_MODELS:
        b = build(get_arch(name))
        params = b.init(cs.SERVE_SEED, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SERVE_SEED + 1)
        B, S = cs.SERVE_BATCH, cs.SERVE_PROMPT
        prompts = torch.randint(0, b.cfg.vocab, (B, S), generator=gen,
                                device=dev)
        caches = b.cache_init(B, S + 3 * STEPS, device=dev)
        logits, caches = b.decode_fn(params, prompts, caches, 0)
        pos = S

        def steps(n):
            nonlocal logits, caches, pos
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                logits, caches = b.decode_fn(params, tok, caches, pos)
                pos += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        steps(2)  # warm-up
        wall_ms = steps(STEPS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall_prof_ms = steps(STEPS)
        by_name = collections.Counter()
        count = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name] += e.time_range.elapsed_us()
                count += 1
        if count == 0:
            raise RuntimeError("the profiler recorded no device operation")
        device_ms = sum(by_name.values()) / 1e3 / STEPS
        print(json.dumps({
            "tool": "serve_lm", "model": name, "card": card, "batch": B,
            "steps": STEPS, "wall_ms_a_step": wall_ms,
            "wall_profiled_ms_a_step": wall_prof_ms,
            "device_ms_a_step": device_ms,
            "device_busy_share": device_ms / wall_prof_ms,
            "device_ops_a_step": count / STEPS,
            "top_kernels_ms_a_step": {k[:80]: v / 1e3 / STEPS
                                      for k, v in by_name.most_common(8)},
        }), flush=True)
        del params, caches, logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
