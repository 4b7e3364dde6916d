"""PyTorch port vs the JAX package: the optimizer substrate.

`repro_torch.optim` (AdamW with its schedule and clipping, the int8
gradient compression with error feedback, the compressed mean over a
`torch.distributed` group) against `repro.optim` on the same inputs, made
from a seed with numpy; and the tree helpers that carry an `AdamWState`
(a NamedTuple) across.

Tolerances:

* AdamW's master weights, moments and params over three steps: within
  1e-6 of the largest |value| of each leaf of the reference's;
* `cosine_lr`, `global_norm`: rtol 1e-6;
* `quantize_int8`: q bit-equal (ties included: both round half to even),
  the scale equal;
* `compressed_psum_mean` at W = 2 and 4 (gloo ranks): the mean allclose
  (rtol 1e-6) to a numpy mean of the ranks' dequantized values, computed
  with the reference's quantizer; the error feedback bit-equal.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import _torch_mesh_worker as mesh_worker

from repro import optim as joptim
from repro.optim import compress as JC

from repro_torch import optim
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.models.scan_util import tree_leaves, tree_map
from repro_torch.optim.compress import (
    dequantize_int8, init_error_feedback, quantize_int8)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LEAF_TOL = 1e-6


def _tree(rng, scale=1.0):
    """A nested tree of float32 numpy leaves: dicts and a list, keys not
    in sorted order (the reference flattens dicts by sorted key)."""
    return {
        "lm_head": {"w": (rng.standard_normal((16, 24)) * scale)},
        "blocks": [{"w": rng.standard_normal((3, 8, 8)) * scale,
                    "scale": np.ones(8) + rng.standard_normal(8) * scale}],
        "embed": {"w": rng.standard_normal((32, 16)) * scale},
    }


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaf_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(got, want, what):
    """Port tree vs reference tree, leaf for leaf (the reference's leaves
    in sorted-key order, the port's read by the same keys)."""
    jl, tdef = jax.tree_util.tree_flatten(want)
    tl = tdef.flatten_up_to(params_to_numpy(got))
    for i, (t, j) in enumerate(zip(tl, jl)):
        assert _leaf_err(_np(torch.from_numpy(np.asarray(t, np.float32))),
                         _np(j)) <= LEAF_TOL, (what, i)


# ---------------------------------------------------------------------------
# the tree helpers and AdamWState
# ---------------------------------------------------------------------------

def test_tree_map_keeps_named_tuples():
    """`scan_util.tree_map` rebuilds a NamedTuple from its fields (a
    NamedTuple takes them as arguments, not one iterable), and
    `params_from_numpy` / `params_to_numpy` carry an `AdamWState` field by
    field."""
    tp = params_from_numpy(_f32(_tree(np.random.default_rng(0))),
                           device="cpu")
    st = optim.init(tp, optim.AdamWConfig())
    doubled = tree_map(lambda t: t * 2, st)
    assert type(doubled) is optim.AdamWState
    assert torch.equal(doubled.master["embed"]["w"],
                       st.master["embed"]["w"] * 2)
    host = params_to_numpy(st)
    assert type(host) is optim.AdamWState
    assert host.step.dtype == np.int32 and host.step.shape == ()
    back = params_from_numpy(host, device="cpu")
    assert type(back) is optim.AdamWState
    for a, b in zip(tree_leaves(back), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's state, carried across, has the port's structure
    js = joptim.init(_f32(_tree(np.random.default_rng(0))),
                     joptim.AdamWConfig())
    jhost = optim.AdamWState(*jax.tree_util.tree_map(np.asarray, tuple(js)))
    got = params_from_numpy(jhost, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(got)] == \
        [tuple(t.shape) for t in tree_leaves(st)]


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(moments, compute):
    """Three updates of one seeded tree, each with its own seeded
    gradients (the second above the clip norm): step, master, m, v and
    the params within LEAF_TOL of the reference's, leaf by leaf."""
    rng = np.random.default_rng(11)
    p0 = _f32(_tree(rng))
    grads = [_f32(_tree(rng, scale=s)) for s in (0.01, 0.5, 0.02)]
    cfg_kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=10,
                  moments_dtype=moments)
    jcfg, tcfg = joptim.AdamWConfig(**cfg_kw), optim.AdamWConfig(**cfg_kw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    jp, js = p0, joptim.init(p0, jcfg)
    tp = params_from_numpy(p0, device="cpu")
    ts = optim.init(tp, tcfg)
    assert ts.m["embed"]["w"].dtype == {"float32": torch.float32,
                                        "bfloat16": torch.bfloat16}[moments]
    for i, g in enumerate(grads):
        jp, js = joptim.update(g, js, jcfg, jdt)
        tp, ts = optim.update(params_from_numpy(g, device="cpu"), ts, tcfg,
                              tdt)
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
        for what, got, want in (("master", ts.master, js.master),
                                ("m", ts.m, js.m), ("v", ts.v, js.v),
                                ("params", tp, jp)):
            _assert_trees_close(got, want, (what, i))
        assert tp["embed"]["w"].dtype == tdt


def test_update_writes_none_of_its_inputs():
    """`update` is functional: the gradients, the state and the params it
    was given are unchanged, and the new state shares no storage with the
    old."""
    rng = np.random.default_rng(3)
    tp = params_from_numpy(_f32(_tree(rng)), device="cpu")
    g = params_from_numpy(_f32(_tree(rng, 0.1)), device="cpu")
    st = optim.init(tp, optim.AdamWConfig(warmup_steps=0))
    before = [t.clone() for t in tree_leaves((tp, g, st))]
    new_p, new_st = optim.update(g, st, optim.AdamWConfig(warmup_steps=0))
    for a, b in zip(tree_leaves((tp, g, st)), before):
        assert torch.equal(a, b)
    old = {t.data_ptr() for t in tree_leaves((tp, st))}
    assert not old & {t.data_ptr() for t in tree_leaves((new_p, new_st))}
    # the master copy is a copy, not the float32 params themselves
    assert not {t.data_ptr() for t in tree_leaves(tp)} & \
        {t.data_ptr() for t in tree_leaves(st.master)}


def test_cosine_lr_and_global_norm_equal_reference():
    for kw in (dict(warmup_steps=10, total_steps=100),
               dict(warmup_steps=0, total_steps=50, lr_min=0.0),
               dict()):
        jc, tc = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
        steps = np.arange(0, max(120, tc.total_steps + 20), 7,
                          dtype=np.int32)
        want = np.asarray(joptim.cosine_lr(jc, jnp.asarray(steps)))
        got = optim.cosine_lr(tc, torch.from_numpy(steps))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        assert float(optim.cosine_lr(tc, 3)) == pytest.approx(
            float(joptim.cosine_lr(jc, jnp.int32(3))), rel=1e-6)
    tree = _f32(_tree(np.random.default_rng(5)))
    np.testing.assert_allclose(
        float(optim.global_norm(params_from_numpy(tree, device="cpu"))),
        float(joptim.global_norm(tree)), rtol=1e-6)


# the reference's own cases (`tests/test_optim.py`), on the port

def test_adamw_converges_on_quadratic():
    ocfg = optim.AdamWConfig(lr_peak=0.1, lr_min=0.01, warmup_steps=5,
                             total_steps=200, weight_decay=0.0)
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = optim.init(params, ocfg)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = optim.update(grads, state, ocfg, torch.float32)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip_bounds_update():
    ocfg = optim.AdamWConfig(lr_peak=1e-2, warmup_steps=0, total_steps=10,
                             clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = optim.init(params, ocfg)
    huge = {"w": torch.full((4,), 1e9)}
    p2, _ = optim.update(huge, state, ocfg, torch.float32)
    assert float(p2["w"].abs().max()) < 1.0


def test_cosine_schedule_shape():
    ocfg = optim.AdamWConfig(lr_peak=1.0, lr_min=0.1, warmup_steps=10,
                             total_steps=100)
    lrs = [float(optim.cosine_lr(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert abs(lrs[10] - 1.0) < 0.05
    assert lrs[-1] < 0.2
    assert all(b <= a + 1e-6 for a, b in zip(lrs[10:], lrs[11:]))


def test_bf16_moments_halve_memory():
    params = {"w": torch.zeros((128, 128))}
    s32 = optim.init(params, optim.AdamWConfig(moments_dtype="float32"))
    s16 = optim.init(params, optim.AdamWConfig(moments_dtype="bfloat16"))
    assert s16.m["w"].dtype == torch.bfloat16
    assert s32.m["w"].dtype == torch.float32
    nbytes = lambda s: sum(t.numel() * t.element_size()
                           for t in tree_leaves((s.m, s.v)))
    assert 2 * nbytes(s16) == nbytes(s32)


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------

def _ties():
    """amax 127 makes the scale exactly 1.0, so x / scale keeps every
    half: ties both ways, at both signs, and -0.5 -> -0."""
    return np.array([127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5,
                     -126.5, 0.0, 4.5, 5.5], np.float32)


@pytest.mark.parametrize("case", ["normal", "ties", "half_steps", "zeros",
                                  "bf16", "wide"])
def test_quantize_int8_bit_equal_reference(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    x = {"normal": lambda: rng.standard_normal(1000).astype(np.float32),
         "ties": _ties,
         # multiples of half an int8 step: every value a tie or exact
         "half_steps": lambda: np.concatenate([
             [127.0], rng.integers(-254, 255, 500) / 2.0]).astype(
                 np.float32),
         "zeros": lambda: np.zeros(17, np.float32),
         "bf16": lambda: rng.standard_normal(300).astype(np.float32),
         "wide": lambda: (rng.standard_normal((40, 30)) * 1e6).astype(
             np.float32)}[case]()
    if case == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = JC.quantize_int8(jx)
    tq, ts = quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.numpy()).tobytes() == \
        np.float32(np.asarray(js)).tobytes()
    np.testing.assert_array_equal(dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    if case == "ties":
        np.testing.assert_array_equal(
            tq.numpy(), [127, 0, 2, 2, 4, 0, -2, -2, 126, -126, 0, 4, 6])


def test_int8_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs().numpy()
    assert err.max() <= float(scale) / 2 + 1e-7


def test_error_feedback_removes_bias():
    """With EF, the *accumulated* applied signal tracks the true sum."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32) * 1e-3)
    ef = init_error_feedback({"g": g})
    applied = torch.zeros(256)
    for _ in range(50):
        target = g + ef["g"]
        q, s = quantize_int8(target)
        deq = dequantize_int8(q, s)
        ef = {"g": target - deq}
        applied = applied + deq
    np.testing.assert_allclose(applied.numpy(), (50 * g).numpy(),
                               atol=float(s) * 1.5)


def _reference_psum_same(same):
    """The reference's `test_compressed_psum_under_shard_map` case through
    its `compressed_psum_mean` under `jax.shard_map` on this process's
    one CPU device."""
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((1,), ("data",))
    grads = {"w": jnp.asarray(same)}
    f = jax.shard_map(lambda g, e: JC.compressed_psum_mean(g, e, "data"),
                      mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()))
    red, ef = f(grads, JC.init_error_feedback(grads))
    return np.asarray(red["w"]), np.asarray(ef["w"])


@pytest.mark.parametrize("W", [2, 4])
def test_compressed_psum_mean_on_gloo(W, tmp_path):
    """W gloo ranks, each with its own seeded gradients and error
    feedback: every rank's mean equals a numpy mean of the ranks'
    dequantized values (the reference's quantizer), and its new error
    feedback the reference's bit for bit; the reference test's case
    (arange(8) on every rank) gives arange(8) within 0.05 and the
    reference's own result under shard_map."""
    rng = np.random.default_rng(W)
    case = {"same": np.arange(8, dtype=np.float32)}
    for r in range(W):
        case[f"g{r}_x"] = rng.standard_normal(64).astype(np.float32)
        case[f"g{r}_y"] = (rng.standard_normal((4, 8)) * 3).astype(
            np.float32)
        case[f"e{r}_x"] = (rng.standard_normal(64) * 0.01).astype(
            np.float32)
        case[f"e{r}_y"] = (rng.standard_normal((4, 8)) * 0.01).astype(
            np.float32)
    res = mesh_worker.spawn_mesh(W, case, tmp_path, body="run_compress")
    for leaf in ("x", "y"):
        deqs, efs = [], []
        for r in range(W):
            target = jnp.asarray(case[f"g{r}_{leaf}"]) + \
                jnp.asarray(case[f"e{r}_{leaf}"])
            q, s = JC.quantize_int8(target)
            deq = JC.dequantize_int8(q, s)
            deqs.append(np.asarray(deq, np.float64))
            efs.append(np.asarray(target - deq))
        want = np.mean(deqs, axis=0)
        for r in range(W):
            np.testing.assert_allclose(res[r][f"red_{leaf}"], want,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(res[r][f"ef_{leaf}"], efs[r])
    ref_red, ref_ef = _reference_psum_same(case["same"])
    for r in range(W):
        np.testing.assert_allclose(res[r]["red_same"], np.arange(8),
                                   atol=0.05)
        np.testing.assert_allclose(res[r]["red_same"], ref_red, rtol=1e-6)
        np.testing.assert_array_equal(res[r]["ef_same"], ref_ef)
