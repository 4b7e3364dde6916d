"""PyTorch port vs the JAX package: training's parts that need no
launcher.

* `repro_torch.data` (`SyntheticTokens`, `ByteCorpus`) against
  `repro.data`: equal numpy batches over several steps and host splits;
* `repro_torch.distributed.fault` against `repro.distributed.fault`: the
  heartbeat file read by either package, and `StragglerMonitor`'s
  verdicts and EWMA over a seeded sequence of step times, equal;
* `repro_torch.checkpoint.save_train_state` against the reference's: a
  model's parameters and `AdamWState` written by either package restore
  in the other through `CheckpointManager.restore`, leaf for leaf equal,
  and a bfloat16 train state written byte for byte as the JAX package
  writes it.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (fixture)

import repro.configs as jcfg
import repro.data as jdata
import repro.distributed.fault as jfault
from repro import optim as joptim
from repro.checkpoint.elastic import save_train_state as j_save_train_state
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.models import build as jbuild

import repro_torch.data as tdata
import repro_torch.distributed.fault as tfault
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, save_train_state
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.models.scan_util import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=16, global_batch=8, seed=1),
    dict(vocab=50, seq_len=8, global_batch=4, seed=0),
    dict(vocab=92416, seq_len=33, global_batch=12, seed=7, zipf_a=1.5),
])
def test_synthetic_tokens_equal_reference(kw):
    """Every host's batch at steps 0..5 under 1, 2 and 4 (where it
    divides) hosts equals the reference's."""
    for hosts in (1, 2, 4):
        if kw["global_batch"] % hosts:
            continue
        for h in range(hosts):
            ref = jdata.SyntheticTokens(**kw, host_index=h, host_count=hosts)
            port = tdata.SyntheticTokens(**kw, host_index=h,
                                         host_count=hosts)
            assert port.local_batch == ref.local_batch
            for step in range(6):
                a, b = port.batch(step), ref.batch(step)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_tokens_deterministic_and_sharded():
    """The reference's own case, on the port."""
    S = tdata.SyntheticTokens
    a = S(1000, 16, 8, seed=1).batch(5)
    b = S(1000, 16, 8, seed=1).batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = S(1000, 16, 8, seed=1).batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    h0 = S(1000, 16, 8, seed=1, host_index=0, host_count=2)
    h1 = S(1000, 16, 8, seed=1, host_index=1, host_count=2)
    assert h0.local_batch == 4
    assert not np.array_equal(h0.batch(0)["tokens"], h1.batch(0)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    ds = S(50, 8, 4, seed=0)
    for s in range(5):
        assert ds.batch(s)["tokens"].max() < 50


def test_byte_corpus_equals_reference(tmp_path):
    """Windows of a local file: equal to the reference's at several steps
    and host splits, within this process (both key their windows by
    ``hash(path)``, which `PYTHONHASHSEED` varies between processes)."""
    p = tmp_path / "corpus.txt"
    p.write_bytes(bytes(np.random.default_rng(4).integers(
        0, 256, 5000, dtype=np.uint8)))
    for hosts in (1, 2):
        for h in range(hosts):
            ref = jdata.ByteCorpus(str(p), seq_len=32, global_batch=4,
                                   host_index=h, host_count=hosts)
            port = tdata.ByteCorpus(str(p), seq_len=32, global_batch=4,
                                    host_index=h, host_count=hosts)
            for step in (0, 1, 3, 10):
                a, b = port.batch(step), ref.batch(step)
                for k in ("tokens", "labels"):
                    assert a[k].shape == (4 // hosts, 32)
                    np.testing.assert_array_equal(a[k], b[k])
    ds = tdata.ByteCorpus(str(p), seq_len=32, global_batch=4)
    assert ds.batch(0)["tokens"].max() < 256
    np.testing.assert_array_equal(ds.batch(3)["tokens"],
                                  ds.batch(3)["tokens"])
    with pytest.raises(AssertionError, match="corpus too small"):
        small = tmp_path / "small.txt"
        small.write_bytes(b"abc")
        tdata.ByteCorpus(str(small), seq_len=32, global_batch=4)


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------

def test_fault_constants_and_exceptions_equal_reference():
    assert tfault.RESTART_EXIT_CODE == jfault.RESTART_EXIT_CODE == 42
    assert issubclass(tfault.SimulatedFailure, RuntimeError)
    assert issubclass(tfault.StragglerWarning, RuntimeWarning)
    assert [f.name for f in dataclasses.fields(tfault.StragglerMonitor)] \
        == [f.name for f in dataclasses.fields(jfault.StragglerMonitor)]
    assert tfault.StragglerMonitor() == tfault.StragglerMonitor(
        factor=jfault.StragglerMonitor().factor,
        alpha=jfault.StragglerMonitor().alpha)


def test_heartbeat_round_trips_across_packages(tmp_path):
    """A beat written by either package is the JSON the other reads
    back; no beat reads as None."""
    for writer, reader in ((tfault, jfault), (jfault, tfault)):
        path = str(tmp_path / writer.__name__ / "hb.json")
        assert reader.Heartbeat(path, host=3).last() is None
        writer.Heartbeat(path, host=3).beat(17)
        got = reader.Heartbeat(path, host=3).last()
        assert got == json.loads(open(path).read())
        assert (got["host"], got["step"]) == (3, 17)
        assert isinstance(got["t"], float)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_monitor_equals_reference(seed):
    """A seeded run of step times with spikes: the same verdict at every
    step and the same EWMA and count, bit for bit."""
    rng = np.random.default_rng(seed)
    times = rng.gamma(4.0, 0.05, 80)
    times[rng.integers(0, 80, 8)] *= rng.uniform(2.0, 8.0, 8)
    kw = dict(factor=[3.0, 2.0, 1.5][seed], alpha=[0.1, 0.3, 0.05][seed])
    ref, port = jfault.StragglerMonitor(**kw), tfault.StragglerMonitor(**kw)
    verdicts = []
    for t in times:
        verdicts.append(port.observe(float(t)))
        assert verdicts[-1] == ref.observe(float(t))
        assert (port._ewma, port._n) == (ref._ewma, ref._n)
    assert any(verdicts) and not all(verdicts)


# ---------------------------------------------------------------------------
# save_train_state
# ---------------------------------------------------------------------------

def _train_state(dtype=None, moments="float32"):
    """The reduced internlm2 model's params and an AdamWState after one
    update, in both packages, from the same numpy weights and
    gradients."""
    cfg = jcfg.ARCHS["internlm2-1.8b"].reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jp = jbuild(cfg).init(jax.random.PRNGKey(2))
    host = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * 0.01).astype(np.float32),
        host)
    ocfg = dict(warmup_steps=0, moments_dtype=moments)
    pdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp2, js = joptim.update(grads, joptim.init(jp, joptim.AdamWConfig(
        **ocfg)), joptim.AdamWConfig(**ocfg), pdt)
    tp = params_from_numpy(host, device="cpu")
    tp2, ts = optim.update(
        params_from_numpy(grads, device="cpu"),
        optim.init(tp, optim.AdamWConfig(**ocfg)), optim.AdamWConfig(**ocfg),
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    return (jp2, js), (tp2, ts)


def _assert_equal_leaves(port_tree, ref_tree):
    if hasattr(ref_tree, "_fields"):  # two AdamWState types: compare fields
        ref_tree, port_tree = tuple(ref_tree), tuple(port_tree)
    jl, tdef = jax.tree_util.tree_flatten(ref_tree)
    tl = tdef.flatten_up_to(params_to_numpy(port_tree))
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


@pytest.mark.parametrize("blocking", [True, False])
def test_save_train_state_restores_in_the_reference(tmp_path, blocking):
    """The port writes ``params/`` and ``opt/`` beside each other; the
    reference's `CheckpointManager.restore` reads both into its own
    trees, equal leaf for leaf to the port's state."""
    (jp, js), (tp, ts) = _train_state()
    mgr = CheckpointManager(str(tmp_path))
    save_train_state(mgr, 5, tp, ts, blocking=blocking)
    for sub in ("params", "opt"):
        CheckpointManager(str(tmp_path / sub)).wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["opt", "params"]
    rp = JManager(str(tmp_path / "params")).restore(5, jp)
    rs = JManager(str(tmp_path / "opt")).restore(5, js)
    assert type(rs) is type(js)
    _assert_equal_leaves(tp, rp)
    _assert_equal_leaves(ts, rs)
    # the port's own state was equal to the reference's to begin with
    np.testing.assert_allclose(
        np.asarray(rs.master["embed"]["w"]),
        np.asarray(js.master["embed"]["w"]), rtol=0, atol=1e-6)


def test_reference_train_state_restores_in_the_port(tmp_path):
    (jp, js), (tp, ts) = _train_state()
    j_save_train_state(JManager(str(tmp_path)), 9, jp, js)
    rp = CheckpointManager(str(tmp_path / "params")).restore(9, tp,
                                                             device="cpu")
    rs = CheckpointManager(str(tmp_path / "opt")).restore(9, ts,
                                                          device="cpu")
    assert type(rs) is optim.AdamWState
    assert rs.step.dtype == torch.int32 and int(rs.step) == 1
    _assert_equal_leaves(rp, jp)
    _assert_equal_leaves(rs, js)


def test_bf16_train_state_round_trips_and_is_written_as_the_reference(
        tmp_path):
    """bfloat16 params and moments: the port restores its own save bit
    for bit, and writes every leaf file byte for byte as the JAX package
    writes the same state (manifest dtype "bfloat16").  The reference's
    own `restore` cannot read a bfloat16 leaf back (numpy loads it as a
    2-byte void, which `astype` cannot cast), so that direction is held
    on the files."""
    (jp, js), (tp, ts) = _train_state("bfloat16", moments="bfloat16")
    assert tp["embed"]["w"].dtype == torch.bfloat16
    assert ts.m["embed"]["w"].dtype == torch.bfloat16
    save_train_state(CheckpointManager(str(tmp_path / "port")), 2, tp, ts)
    j_save_train_state(JManager(str(tmp_path / "ref")), 2,
                       jax.tree_util.tree_map(jnp.asarray,
                                              params_to_numpy(tp)),
                       js._replace(**{
                           f: jax.tree_util.tree_map(
                               jnp.asarray, params_to_numpy(getattr(ts, f)))
                           for f in ("master", "m", "v")}))
    for sub in ("params", "opt"):
        pd = tmp_path / "port" / sub / "step_00000002"
        rd = tmp_path / "ref" / sub / "step_00000002"
        pm, rm = (json.loads((d / "manifest.json").read_text())
                  for d in (pd, rd))
        assert pm["leaves"] == rm["leaves"]
        for leaf in pm["leaves"]:
            name = f"leaf_{leaf['i']:05d}.npy"
            assert (pd / name).read_bytes() == (rd / name).read_bytes(), \
                (sub, name)
    rp = CheckpointManager(str(tmp_path / "port" / "params")).restore(
        2, tp, device="cpu")
    rs = CheckpointManager(str(tmp_path / "port" / "opt")).restore(
        2, ts, device="cpu")
    for a, b in zip(tree_leaves((rp, rs)), tree_leaves((tp, ts))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the template's dtype wins where the caller asks for another
    f32 = CheckpointManager(str(tmp_path / "port" / "params")).restore(
        2, tree_map(lambda t: t.float(), tp), device="cpu")
    assert f32["embed"]["w"].dtype == torch.float32
    assert torch.equal(f32["embed"]["w"], tp["embed"]["w"].float())
