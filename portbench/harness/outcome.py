"""What a driver hands back once its measured window has closed."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .record import RunRecord


@dataclasses.dataclass
class Outcome:
    """`outputs` are what the timed path produced, in compact form;
    `inputs` what the benchmark made and hands the reference.  Neither
    holds the program's state, which is freed when the driver returns."""

    record: RunRecord
    attempted: int
    memory_peak_bytes: int
    outputs: Dict[str, object]
    inputs: Dict[str, object]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def device_kind(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
