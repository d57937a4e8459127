"""Step timing + throughput instrumentation (counterpart of
``tpuslam/utils/timing.py``).

The reference brackets every stage with ad-hoc ``std::chrono`` prints
(SURVEY.md §5: scan_match_icp.cc:53-83, hector_slam.cc:188-250,
spa2d.cpp:472-602).  Here timing is a reusable context manager with
aggregate statistics plus an optional ``torch.profiler`` trace.  PyTorch
returns before the card finishes, so a stage given a CUDA device
synchronizes it before the clock stops, as the JAX version blocks on its
results: a stage's time is the work's, not its enqueue's."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def rate_hz(self) -> float:
        return self.count / self.total_s if self.total_s > 0 else 0.0


@dataclass
class StepTimer:
    """Named-stage wall timer; ``with timer.stage("match"): ...``.

    device: the device whose work a stage waits for at its end (a CUDA
    device is synchronized; the CPU runs synchronously)."""

    stats: dict[str, StageStats] = field(
        default_factory=lambda: defaultdict(StageStats)
    )
    device: str | torch.device = "cuda"

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.count += 1
            s.total_s += dt
            s.max_s = max(s.max_s, dt)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items()):
            lines.append(
                f"{name:24s} n={s.count:6d} mean={s.mean_s * 1e3:8.2f} ms "
                f"max={s.max_s * 1e3:8.2f} ms rate={s.rate_hz:9.1f}/s"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Optional ``torch.profiler`` trace around a region, CPU and CUDA
    activity, written as a Chrome trace under ``log_dir`` (no-op when
    dir=None)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
