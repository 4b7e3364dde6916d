"""PyTorch port vs the JAX package: the abstract prefill and decode
cells (`repro_torch.launch.specs`), checked as `test_torch_specs.py`
checks the training cells."""
import pytest

from test_torch_specs import CELLS, check_cell

SERVE_CELLS = [(a, s) for a, s in CELLS if not s.startswith("train")]


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_abstract_cell_equal_reference(arch, shape):
    check_cell(arch, shape)
