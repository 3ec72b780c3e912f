"""Phase timing.

The reference writes per-phase wall-clock ms into the results file
(reference main.cpp:152,172-173).  PyTorch returns before the device
finishes, so on a CUDA device a phase ends with `torch.cuda.synchronize()`
before the clock is read: a phase's time is the time its work took, not
the time it took to enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch


class PhaseTimer:
    """Accumulated wall seconds per named phase.  `device`: the device the
    phases' work runs on; a CUDA device is synchronized at each phase's
    end."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block; under torch.profiler it is also a span named
        `name` (record_function), which tools/chip_probes/program_profile.py
        reads."""
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - start)

    def ms(self, name: str) -> int:
        return int(self.phases.get(name, 0.0) * 1000)
