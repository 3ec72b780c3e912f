"""Phase timing.

The reference writes per-phase wall-clock ms into the results file
(reference main.cpp:152,172-173).  PyTorch returns before the device
finishes, so on a CUDA device a phase ends with `torch.cuda.synchronize()`
before the clock is read: a phase's time is the time its work took, not
the time it took to enqueue.  A phase may also write a torch.profiler
trace (the counterpart of the JAX package's jax.profiler trace).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulated wall seconds per named phase.  `device`: the device the
    phases' work runs on; a CUDA device is synchronized at each phase's
    end."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace_dir: Optional[str] = None):
        """Time the block; under torch.profiler it is also a span named
        `name` (record_function), which tools/chip_probes/program_profile.py
        reads.  trace_dir: profile the block (CPU, and CUDA activity on a
        CUDA device) and write its Chrome trace into that directory as
        `<name>.trace.json`."""
        prof = contextlib.nullcontext()
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        start = time.perf_counter()
        with prof:
            with torch.profiler.record_function(name):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - start)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))

    def ms(self, name: str) -> int:
        return int(self.phases.get(name, 0.0) * 1000)

    def qps(self, name: str, n_queries: int) -> float:
        """n_queries over the phase's accumulated seconds (inf before it
        has taken any time)."""
        dt = self.phases.get(name, 0.0)
        return n_queries / dt if dt > 0 else float("inf")
