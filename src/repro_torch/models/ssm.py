"""Mamba2 (SSD — state-space duality) block, chunked-scan prefill form +
O(1)-state decode step (the JAX package's `models.ssm`).
[arXiv:2405.21060]

Shapes: d_inner = expand·d_model; H = d_inner / head_dim(P); state size N;
G groups (G=1 here) share B/C across heads.

Chunked algorithm (SSD paper §6): split the sequence into chunks of length
Q; compute the intra-chunk (quadratic attention-like) term and the
inter-chunk term through a recurrence over per-chunk states.  The
reference runs that recurrence as a `lax.associative_scan`; here it is a
loop over the chunks, the same recurrence, whose float32 sums associate
in another order.  The decode step is the plain SSM recurrence on a
(B, H, P, N) float32 state.

Dtypes are the reference's: `A_log`, `D`, `dt_bias` and the state are
float32; `_causal_conv` runs in the input's dtype and `mamba_step`'s conv
in float32.

A decode cache is written in place (`mamba_step` returns the cache it was
given) and built one token at a time: `mamba_step` takes one token, as the
reference's does, so a block of more than one raises ValueError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import contiguous_local, init_linear, init_rmsnorm, linear, \
    residual, rmsnorm, split_placements

Params = Dict[str, Any]


def _dims(cfg):
    d_in = cfg.d_inner
    H = cfg.n_ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_dim = d_in + 2 * G * N
    return d_in, H, P, N, G, conv_dim


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def init_mamba(gen: torch.Generator, cfg, dtype) -> Params:
    d = cfg.d_model
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    dev = gen.device
    in_dim = 2 * d_in + 2 * G * N + H  # z, xBC, dt
    f32 = dict(dtype=torch.float32, device=dev)
    in_proj = init_linear(gen, d, in_dim, dtype)
    conv_w = torch.randn((cfg.conv_width, conv_dim), generator=gen, **f32)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), **f32),           # a = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),    # softplus(-2)≈0.13
        "norm": init_rmsnorm(d_in, dtype, dev),
        "out_proj": init_linear(gen, d_in, d, dtype),
    }


def _split_proj(cfg, zxbcdt):
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:d_in + conv_dim]
    dt = zxbcdt[..., d_in + conv_dim:]
    return z, xBC, dt


def _conv(conv_w, conv_b, xBC: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of (B, S, C) with (W, C) taps, in xBC's
    dtype."""
    W = conv_w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S, :] * conv_w[i][None, None, :]
              for i in range(W))
    return _silu(out + conv_b[None, None, :])


def _causal_conv(p: Params, cfg, xBC: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, conv_dim), in xBC's dtype.  On
    DTensors each rank convolves its own rows and channels (as the taps
    are sharded) through `local_map`: the conv is elementwise in the
    channels, and DTensor's own rule for the padding fails in some
    PyTorch versions."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xBC, DTensor):
        return _conv(p["conv_w"], p["conv_b"], xBC)
    mesh = xBC.device_mesh
    w, b = p["conv_w"], p["conv_b"]
    rows = [isinstance(pl, Shard) and pl.dim == 0 for pl in xBC.placements]
    chans = [isinstance(pl, Shard) and pl.dim == 1 for pl in w.placements]
    x_pl = split_placements(rows, chans, 0, 2)
    w_pl, b_pl = (split_placements(rows, chans, None, d) for d in (1, 0))
    # the taps serve every rank's rows: their gradients are partial sums
    w_grad, b_grad = (split_placements(rows, chans, None, d, grad=True)
                      for d in (1, 0))
    ins = (xBC.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl),
           b.redistribute(mesh, b_pl))
    return local_map(
        contiguous_local(lambda x, cw, cb: _conv(cw, cb, x)),
        out_placements=(x_pl,), in_placements=(x_pl, w_pl, b_pl),
        in_grad_placements=(x_pl, w_grad, b_grad), device_mesh=mesh)(*ins)


def _ssd(xs, dt, Bm, Cm, A_log, D, dt_bias, Q: int, initial_state=None):
    """The chunked SSD scan: xs (B, S, H, P), dt (B, S, H), Bm and Cm
    (B, S, N), the per-head A_log, D, dt_bias (H,).  Returns (y (B, nc,
    Q, H, P) float32, the final state (B, H, P, N))."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    nc = S // Q

    dt = F.softplus(dt.float() + dt_bias[None, None])   # (B,S,H)
    a = -torch.exp(A_log)                            # (H,)
    dA = dt * a[None, None]                          # (B,S,H) negative

    # chunked views
    xs_c = xs.reshape(B, nc, Q, H, P).float()
    B_c = Bm.reshape(B, nc, Q, N).float()
    C_c = Cm.reshape(B, nc, Q, N).float()
    dt_c = dt.reshape(B, nc, Q, H)
    dA_c = dA.reshape(B, nc, Q, H)
    cum = torch.cumsum(dA_c, dim=2)                  # (B,nc,Q,H)

    # ---- intra-chunk (quadratic within chunk) ----
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg),
                    torch.zeros((), device=xs.device))
    CB = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)            # (B,nc,Q,K)
    att = CB[..., None] * L * dt_c[:, :, None, :, :]          # (B,nc,Q,K,H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xs_c)

    # ---- per-chunk states + inter-chunk recurrence ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,Q,H)
    Sc = torch.einsum("bcqn,bcqhp->bchpn", B_c,
                      (dt_c * decay_to_end)[..., None] * xs_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    if initial_state is not None:
        s = initial_state.float()                             # (B,H,P,N)
    else:
        s = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    prev = []                      # the state BEFORE each chunk
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + Sc[:, c]
    prev = torch.stack(prev, dim=1)                           # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", C_c, prev) \
        * torch.exp(cum)[..., None]

    y = y_intra + y_inter + D[None, None, None, :, None] * xs_c
    return y, s


def _ssd_heads(x, xs, dt, Bm, Cm, A_log, D, dt_bias, Q: int,
               initial_state=None):
    """`_ssd`, on DTensors head by head: every rank scans its own batch
    rows (as `x`, the layer input, is sharded) and heads (over ``model``
    when H divides among its ranks) on its local tensors through
    `local_map`, Bm and Cm whole (one group serves every head, so their
    gradients come back as partial sums over the head shards, as the
    per-head parameters' do over the row shards).  The scan
    is elementwise in the heads, so no value moves; DTensor's rules alone
    would run its chunk loop op by op on every rank's every head."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(xs, DTensor):
        return _ssd(xs, dt, Bm, Cm, A_log, D, dt_bias, Q, initial_state)
    mesh, H = xs.device_mesh, xs.shape[2]
    batch = [isinstance(pl, Shard) and pl.dim == 0 for pl in x.placements]
    heads = [name == "model" and H % mesh.size(i) == 0
             for i, name in enumerate(mesh.mesh_dim_names)]

    def on(dim_b, dim_h, grad=False):
        return split_placements(batch, heads, dim_b, dim_h, grad)

    args = [(xs, on(0, 2)), (dt, on(0, 2)), (Bm, on(0, None)),
            (Cm, on(0, None)), (A_log, on(None, 0)), (D, on(None, 0)),
            (dt_bias, on(None, 0))]
    # Bm and Cm serve every rank's heads, the per-head parameters every
    # rank's rows: their gradients are partial sums over those ranks
    grads = [on(0, 2), on(0, 2), on(0, None, True), on(0, None, True),
             on(None, 0, True), on(None, 0, True), on(None, 0, True)]
    if initial_state is not None:
        args.append((initial_state, on(0, 1)))
        grads.append(on(0, 1))
    ins = [t.redistribute(mesh, pl) for t, pl in args]
    fn = local_map(
        contiguous_local(
            lambda *a: _ssd(*a[:7], Q, a[7] if len(a) > 7 else None)),
        out_placements=(on(0, 3), on(0, 1)),
        in_placements=tuple(pl for _, pl in args),
        in_grad_placements=tuple(grads), device_mesh=mesh)
    return fn(*ins)


def mamba_chunked(
    p: Params, cfg, x: torch.Tensor, chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Prefill form.  x: (B, S, D) -> (B, S, D) [, final state]."""
    B, S, D = x.shape
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"a sequence of {S} is not a whole number of "
                         f"chunks of {Q}")
    if G != 1:
        raise ValueError("only ssm_groups = 1 is supported")

    # in_proj's output is cut at offsets that are no shard bounds: whole
    # on every rank (`residual`) before the cut
    z, xBC, dt = _split_proj(cfg, residual(linear(p["in_proj"], x)))
    xBC = _causal_conv(p, cfg, xBC)
    xs = xBC[..., :d_in].reshape(B, S, H, P)
    Bm = xBC[..., d_in:d_in + N]                    # (B, S, N)
    Cm = xBC[..., d_in + N:]

    y, s = _ssd_heads(x, xs, dt, Bm, Cm, p["A_log"], p["D"], p["dt_bias"],
                      Q, initial_state)
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * _silu(z))
    out = linear(p["out_proj"], y)
    if return_state:
        return out, s
    return out


def init_mamba_cache(cfg, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


def mamba_step(
    p: Params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode: x (B, 1, D) -> (B, 1, D); O(1)-state recurrence.  Returns
    (out, cache), `cache` written in place."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(
            f"a mamba cache takes one token a step, not a block of {S}: "
            "build it token by token (the reference's mamba_step is a "
            "one-token recurrence); prefill without a cache through "
            "mamba_chunked")
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    z, xBC, dt = _split_proj(cfg, residual(linear(p["in_proj"], x)))
    window = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"].float()
    xBC1 = _silu(conv_out)                                  # (B, conv_dim)

    xs = xBC1[:, :d_in].reshape(B, H, P)
    Bm = xBC1[:, d_in:d_in + N]
    Cm = xBC1[:, d_in + N:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"][None])  # (B,H)
    a = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * a[None])                           # (B,H)

    state = cache["state"] * dA[..., None, None] + \
        (dt1[..., None] * xs)[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm, state) + p["D"][None, :, None] * xs
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rmsnorm(p["norm"], y * _silu(z))
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return linear(p["out_proj"], y), cache


def mamba_sequential_ref(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Step-by-step oracle (tests): must equal mamba_chunked."""
    B, S, D = x.shape
    cache = init_mamba_cache(cfg, B, x.dtype, x.device)
    ys = []
    for t in range(S):
        y, cache = mamba_step(p, cfg, x[:, t:t + 1], cache)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
