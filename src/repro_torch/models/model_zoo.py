"""Unified model API: build(config) -> ModelBundle with init/step functions.

The JAX package's `models.model_zoo`.  All ten architectures are served by
two assemblies: the decoder-only one (`transformer.py`: the dense family —
internlm2, codeqwen, granite, gemma3, the paligemma prefix-LM stub — the
MoE models, deepseek-v3 with MLA and llama4-scout, mamba2 and the zamba2
hybrid) and the encoder-decoder (`encdec.py`: seamless-m4t).

A user serves a decoder like this: `b = build(cfg)`, `params =
b.init(seed)`, `caches = b.cache_init(B, max_seq)`, a block prefill of the
prompts through `b.decode_fn(params, prompts, caches, 0)`, then one-token
`decode_fn` steps; `b.prefill_fn(params, batch, last_only=True)` is the
serving forward.  A mamba model's cache takes one token a step, so its
prompt goes into the cache token by token (its serving forward is
`prefill_fn`, the chunked scan).  `decode_fn` takes `moe_path`
("capacity" or the "dense" oracle) and `mla_absorbed`; `loss_fn` takes
`moe_path`.  The encoder-decoder's `prefill_fn(params, {"src_embeds":
...})` returns the encoder memory, as the reference's, and the caller
primes the cross caches with `encdec.encdec_prime_cross`; its `decode_fn`
takes one token a step.  Everything runs on the card unless the caller
passes ``device="cpu"`` to `init` and `cache_init`; ``device="meta"``
gives the trees' shapes and dtypes without allocating (`launch.specs`).

`loss_fn(params, batch, remat=True)` is the training loss, and
`value_and_grad(fn)` its gradient over the parameter tree's leaves (the
reference's `jax.value_and_grad`); with `remat` each layer (a period of
`gemma_period` and `zamba_period`) is checkpointed, as the reference's
`jax.checkpoint` does.  `launch.train.make_step` adds the update.

`params_from_numpy` carries a parameter tree of numpy arrays (the JAX
package's `init` output, bf16 leaves as `ml_dtypes.bfloat16`) into the
port's tree, bit for bit; `params_to_numpy` the other way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import encdec as ED
from . import transformer as T
from .scan_util import tree_leaves, tree_map

Params = Dict[str, Any]


def _split_over_ranks(logits) -> bool:
    """Whether `logits` is a DTensor sharded over a mesh dim of more than
    one rank."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(logits, DTensor) and any(
        isinstance(pl, Shard) and logits.device_mesh.size(i) > 1
        for i, pl in enumerate(logits.placements))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE; logits (B,S,V), labels (B,S) (already shifted).

    On logits split over ranks (a DTensor sharded over a mesh dim of
    more than one rank: the batch, or the vocabulary over ``model``) the
    per-token losses are each rank's own (`_vocab_parallel_nll`): the
    (B, S, V) logits are never gathered, and the gather's backward never
    makes them whole (DTensor's own `take_along_dim` backward zeroes a
    global-shape (B, S, V) tensor on every rank)."""
    logits = logits.float()
    if _split_over_ranks(logits):
        return torch.mean(_vocab_parallel_nll(logits, labels))
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return torch.mean(logz - ll)


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce sum over one mesh dim whose result every rank uses
    alike: its gradient is the result's, unreduced (Megatron's reduction
    from the model-parallel region)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_nll(logits, labels):
    """Per-token ``logsumexp - logit[label]`` of float32 DTensor logits
    (B, S, V), each rank on its own rows and slice of the vocabulary
    through `local_map`: the row max, the sum of exponentials and the label's
    logit (zero on the ranks that do not hold it) are each reduced over
    the vocabulary's mesh dims, one all-reduce of a float a token each.
    The result is sharded as the batch, whole on the vocabulary's ranks.
    (PyTorch's `loss_parallel` does the same on a one-dimensional mesh
    only in some versions.)"""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from .layers import local_range

    mesh = logits.device_mesh
    lp = [pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate()
          for pl in logits.placements]
    yp = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
          for pl in lp]
    logits = logits.redistribute(mesh, lp)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, yp)
    vdims = [i for i, pl in enumerate(lp)
             if isinstance(pl, Shard) and pl.dim == 2]
    lo, n = local_range(logits, 2)  # this rank's vocabulary

    def local(lg, y):
        m = lg.detach().amax(dim=-1)
        for i in vdims:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
        e = torch.exp(lg - m[..., None]).sum(dim=-1)
        y = y.long()
        inside = (y >= lo) & (y < lo + n)
        ll = torch.take_along_dim(lg, (y - lo).clamp(0, max(n - 1, 0))[
            ..., None], dim=-1)[..., 0] * inside
        for i in vdims:
            e = _SumOverRanks.apply(e, (mesh, i))
            ll = _SumOverRanks.apply(ll, (mesh, i))
        return torch.log(e) + m - ll

    return local_map(local, out_placements=(yp,), in_placements=(lp, yp),
                     in_grad_placements=(lp, yp), device_mesh=mesh)(
        logits, labels)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    init: Callable[..., Params]
    loss_fn: Callable[..., Tuple[torch.Tensor, torch.Tensor]]  # (params, batch) -> (loss, aux)
    prefill_fn: Optional[Callable] = None
    decode_fn: Optional[Callable] = None
    cache_init: Optional[Callable] = None


class _MetaGenerator(torch.Generator):
    """A CPU generator whose `device` is the meta device, so that the
    inits (which draw on `gen.device`) make meta tensors: torch has no
    generator on the meta device."""

    def __new__(cls):
        return super().__new__(cls, device="cpu")

    def __init__(self):
        pass

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _generator(seed_or_generator: Union[int, torch.Generator],
               device: DeviceLike) -> torch.Generator:
    """A generator on the resolved device: a new one seeded with an int,
    or the caller's, which must lie on that device.  On the meta device
    (shapes and dtypes only) the draws come from a CPU generator."""
    dev = resolve_device(device)
    if dev.type == "meta" and not isinstance(seed_or_generator,
                                             torch.Generator):
        gen = _MetaGenerator()
        gen.manual_seed(int(seed_or_generator))
        return gen
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
        if gen.device != dev:
            raise ValueError(f"a generator on {gen.device} cannot draw "
                             f"parameters on {dev}")
        return gen
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed_or_generator))
    return gen


def _decoder_bundle(cfg) -> ModelBundle:
    prefix = cfg.n_prefix_tokens > 0

    def init(seed_or_generator, device: DeviceLike = None):
        return T.init_lm(_generator(seed_or_generator, device), cfg)

    def loss_fn(params, batch, *, moe_path="capacity", remat=True):
        tokens = batch["tokens"]
        labels = batch["labels"]
        pfx = batch.get("prefix_embeds") if prefix else None
        logits, aux = T.lm_forward(params, cfg, tokens, prefix_embeds=pfx,
                                   moe_path=moe_path, remat=remat)
        if prefix:
            logits = logits[:, cfg.n_prefix_tokens:]
        loss = cross_entropy(logits[:, :-1], labels[:, 1:])
        return loss + 0.01 * aux, aux

    def cache_init(batch, max_seq, ring=False, device: DeviceLike = None):
        return T.init_lm_cache(cfg, batch, max_seq, ring=ring,
                               device=resolve_device(device))

    def prefill_fn(params, batch, last_only=False):
        """Forward over the prompt; returns (logits, aux).  `last_only`:
        serving semantics — logits for the final position only."""
        pfx = batch.get("prefix_embeds") if prefix else None
        return T.lm_forward(params, cfg, batch["tokens"], prefix_embeds=pfx,
                            moe_path="capacity", remat=False,
                            last_only=last_only)

    def decode_fn(params, token, caches, pos, *, mla_absorbed=False,
                  moe_path="capacity", prefix_embeds=None):
        return T.lm_decode_step(params, cfg, token, caches, pos,
                                mla_absorbed=mla_absorbed, moe_path=moe_path,
                                prefix_embeds=prefix_embeds)

    return ModelBundle(cfg, init, loss_fn, prefill_fn, decode_fn, cache_init)


def _encdec_bundle(cfg) -> ModelBundle:
    def init(seed_or_generator, device: DeviceLike = None):
        return ED.init_encdec(_generator(seed_or_generator, device), cfg)

    def loss_fn(params, batch, *, moe_path="capacity", remat=True):
        logits, aux = ED.encdec_forward(params, cfg, batch["src_embeds"],
                                        batch["tokens"], remat=remat)
        loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
        return loss, aux

    def cache_init(batch, max_seq, device: DeviceLike = None):
        return ED.init_encdec_cache(cfg, batch, max_seq, cfg.mem_len,
                                    device=resolve_device(device))

    def prefill_fn(params, batch):
        """The encoder memory and a float32 zero, as the reference's: the
        caller primes the cross caches (`encdec.encdec_prime_cross`)."""
        memory = ED.encode(params, cfg, batch["src_embeds"])
        return memory, torch.zeros((), dtype=torch.float32,
                                   device=memory.device)

    def decode_fn(params, token, caches, pos, **_):
        return ED.encdec_decode_step(params, cfg, token, caches, pos)

    return ModelBundle(cfg, init, loss_fn, prefill_fn, decode_fn, cache_init)


def value_and_grad(fn: Callable) -> Callable:
    """The reference's `jax.value_and_grad` over a parameter tree:
    ``value_and_grad(fn)(params, *args)`` is ``(fn(params, *args),
    grads)``, `grads` the tree of d value / d leaf, each of its leaf's
    dtype (a zero tensor for a leaf the value does not reach).  The
    params are not written and nothing goes into ``.grad``: each leaf is
    taken as a fresh autograd leaf of the same storage."""
    def wrapped(params, *args):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            value = fn(tree_map(lambda _: next(it), params), *args)
            grads = torch.autograd.grad(value, leaves, allow_unused=True,
                                        materialize_grads=True)
        it = iter(grads)
        return value.detach(), tree_map(lambda _: next(it), params)

    return wrapped


def build(cfg) -> ModelBundle:
    return _encdec_bundle(cfg) if cfg.is_encdec else _decoder_bundle(cfg)


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def _tensor_of(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_numpy(tree, device: DeviceLike = None):
    """A tree of numpy arrays (dicts and lists, as the JAX package's
    `init` gives it) -> the same tree of tensors on the resolved device,
    bit for bit (bf16 through its 16-bit pattern)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor_of(a, dev), tree)


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy has no bfloat16 of its own

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(tree):
    """The inverse of `params_from_numpy`: host numpy arrays, bf16 leaves
    as `ml_dtypes.bfloat16`."""
    return tree_map(_numpy_of, tree)
