"""Tiny cells: the committed cells' traffic at sizes a CPU test holds."""
from portbench.harness import spec

#: sizes of each configuration that a CPU test runs at
SIZES = {"urand23": dict(vertices=1024, edges=16384)}


def tiny_cell(name: str):
    cell = spec.load_cell(name)
    cell.config.update(SIZES[cell.config_name])
    if "pool" in cell.traffic:
        cell.traffic["pool"] = 256
    return cell
