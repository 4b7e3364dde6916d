#!/usr/bin/env python3
"""The LM serve path on one NVIDIA GPU, alone, and where its decode time goes.

Run from the root of a checkout, on a machine with one CUDA card (no
kernel is built: the serve path reaches none of the port's CUDA kernels):

    python3 tools/serve_lm.py [--models NAME,...]
                              [--f32-check NAME[:LAYERS],...]

Runs `chip_smoke.py`'s `serve_lm` phase for `--models` (default: all of
its ten models; its lines, its checks; it raises on a failure).  Then,
for each of those models at the phase's widths and depths in bf16, puts
the same 4 seeded prompts into the cache (a block prefill of 1,024
tokens, paligemma's after its 256 stub patch embeddings; a mamba model's
cache token by token over 64; seamless-m4t's encoder over 4 x 4,096 stub
frame embeddings, its cross caches primed, then 64 decoder tokens one a
step), runs 2 decode steps to warm up, 8 timed on the host clock and 8
under `torch.profiler`, and prints one JSON line: the wall ms a step
without and with the profiler, the device ms a step summed over every
kernel, memcpy and memset of the profiled steps, the device's busy share
of their wall, device operations a step, and the top kernels.

`--f32-check NAME[:LAYERS],...` first runs the phase's decode-vs-forward
check (a) (and deepseek's absorbed-vs-naive check (h)) on NAME at LAYERS
layers (default: the phase's depth) in bf16, each router picking its own
experts and then, as the phase does, replaying the other run's; then in
float32 with the same weights (each bf16 parameter cast to float32),
own picks.  It prints the errors and the tokens routed to other experts:
whether a bf16 error comes from bf16 rounding.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 8


def _to_float32(tree):
    """Cast every tensor of a parameter tree to float32 in place, leaf by
    leaf (at most one bf16 leaf and its copy are held twice)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in list(items):
        if isinstance(v, (dict, list)):
            _to_float32(v)
        else:
            tree[k] = None
            tree[k] = v.float()
            del v


def f32_check(cs, name, layers, card, dev):
    """Checks (a) (and (h) for MLA) on `name` cut to `layers`, in bf16 and
    then float32 with the same weights."""
    import torch
    from repro_torch.models import build
    from repro_torch.models.scan_util import tree_map

    cfg, _ = cs._serve_config(name)
    if cfg.is_encdec:
        raise ValueError(f"--f32-check takes a decoder-only model, not "
                         f"{name}")
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    params = build(cfg).init(cs.SERVE_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SERVE_SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (cs.SERVE_BATCH,
                                           cs.SERVE_CHECK_PROMPT),
                            generator=gen, device=dev)
    out = {"tool": "serve_lm_f32_check", "model": name,
           "layers": cfg.n_layers, "card": card}
    for dtype, replay in (("bfloat16", False), ("bfloat16", True),
                          ("float32", False)):
        if dtype == "float32":
            _to_float32(params)
            torch.cuda.empty_cache()
        b = build(dataclasses.replace(cfg, dtype=dtype))
        err, flips = cs._check_decode(b, params, prompts, dev, replay)
        res = {"decode_vs_forward": err, "route_flips": flips}
        if cfg.attn_impl == "mla":
            P, G = cs.SERVE_CHECK_PROMPT, cs.SERVE_STEPS
            caches = b.cache_init(cs.SERVE_BATCH, P + G, device=dev)
            pre, _ = cs._prefill(b, params, prompts, caches, P)
            snap = tree_map(torch.clone, caches)
            _, fed, _ = cs._decode(b, params, pre, caches, P, G)
            err, flips, _ = cs._check_absorbed(b, params, pre, snap, fed, P,
                                               replay)
            res.update(absorbed_vs_naive=err, absorbed_route_flips=flips)
        out[dtype + ("_routes_replayed" if replay else "")] = res
    print(json.dumps(out), flush=True)
    del params
    torch.cuda.empty_cache()


def profile_decode(cs, name, card, dev):
    """Decode steps of `name` timed, then profiled: one JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build, encdec

    cfg, reduced = cs._serve_config(name)
    b = build(cfg)
    params = b.init(cs.SERVE_SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SERVE_SEED + 1)
    B, S, P = cs.SERVE_BATCH, cs.SERVE_PROMPT, cfg.n_prefix_tokens
    if cfg.is_encdec:
        # the encoder over the frames, the cross caches primed, then the
        # decoder's prompt one token a step
        S = cs.SERVE_CHECK_PROMPT
        src = torch.randn((B, cfg.mem_len, cfg.d_model), generator=gen,
                          device=dev)
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                device=dev)
        memory, _ = b.prefill_fn(params, {"src_embeds": src})
        caches = encdec.encdec_prime_cross(
            params, cfg, memory, b.cache_init(B, S + 3 * STEPS, device=dev))
        del memory
        outs, _, _ = cs._decode(b, params, None, caches, 0, S,
                                feed=[prompts[:, i:i + 1] for i in range(S)])
        logits = outs[-1]
    else:
        block = S
        if cfg.mixer == "mamba":  # its cache takes one token a step
            S, block = cs.SERVE_CHECK_PROMPT, 1
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                device=dev)
        kw = {"prefix_embeds": torch.randn((B, P, cfg.prefix_dim),
                                           generator=gen, device=dev)} \
            if P else {}
        caches = b.cache_init(B, P + S + 3 * STEPS, device=dev)
        logits, _ = cs._prefill(b, params, prompts, caches, block, **kw)
        S += P
    pos = S

    def steps(n):
        nonlocal logits, pos
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            logits, _ = b.decode_fn(params, tok, caches, pos)
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
        "tool": "serve_lm", "model": name, "reduced": reduced,
        "layers": cfg.n_layers, "card": card, "batch": B,
        "prompt_in_cache": S, "steps": STEPS, "wall_ms_a_step": wall_ms,
        "wall_profiled_ms_a_step": wall_prof_ms,
        "device_ms_a_step": device_ms,
        "device_busy_share": device_ms / wall_prof_ms,
        "device_ops_a_step": count / STEPS,
        "top_kernels_ms_a_step": {k[:80]: v / 1e3 / STEPS
                                  for k, v in by_name.most_common(8)},
    }), flush=True)
    del params, caches, logits
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=None,
                    help="comma-separated; default: the phase's models")
    ap.add_argument("--f32-check", default="",
                    help="NAME[:LAYERS],... for the bf16/float32 check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_lm: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs

    models = (tuple(args.models.split(",")) if args.models
              else cs.SERVE_MODELS)
    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    for spec in filter(None, args.f32_check.split(",")):
        name, _, layers = spec.partition(":")
        f32_check(cs, name, int(layers) if layers else 0, card, dev)
    cs.serve_lm_phase(card, models)
    for name in models:
        profile_decode(cs, name, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
