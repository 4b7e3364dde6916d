"""Faults planted in the timed path of the mirror_stream driver, as
`test_portbench_correct.py` plants them in the stream's: a window that
leaves the state unchanged, half of each window left out, an output
altered where it is produced.  Each run comes out not correct."""
import time

import pytest
import torch

from _tiny import tiny_cell
from portbench.harness import runner, spec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: several test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED = 2**31 + 91

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]
         if spec.load_traffic(w["traffic"])["driver"] == "mirror_stream"]


def _unchanged(sess, window):
    """A window that returns the session's state unchanged."""


def _half(orig):
    def apply(sess, window):   # half of each window left out
        return orig(sess, window[:len(window) // 2])
    return apply


def _altered(orig):
    def apply(sess, window):   # one node's coreness altered where produced
        orig(sess, window)
        sess.core = sess.core.clone()
        sess.core[int(torch.nonzero(sess.g.node_mask)[0])] += 1
    return apply


def test_the_cell_is_found():
    assert CELLS == ["kron23.mirror_stream"]


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct_with_nothing_planted(name):
    line, _ = runner.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu",
                              time.perf_counter())
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_mirror_stream_faults_come_out_not_correct(fault, name,
                                                   monkeypatch):
    from repro_torch.runtime.stream import MirrorStream

    orig = MirrorStream.apply_window
    patch = dict(unchanged=_unchanged, half=_half(orig),
                 altered=_altered(orig))[fault]
    monkeypatch.setattr(MirrorStream, "apply_window", patch)
    line, _ = runner.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu",
                              time.perf_counter())
    assert line["correct"] is False, line["compared"]
