"""Tiny cells: a cell's configuration and traffic at the sizes a CPU test
holds, which each file gives under its ``"tiny"`` key."""
from portbench.harness import spec


def tiny_cell(name: str):
    cell = spec.load_cell(name)
    cell.config.update(cell.config["tiny"])
    cell.traffic.update(cell.traffic.get("tiny", {}))
    return cell
