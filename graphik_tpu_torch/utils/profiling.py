"""Stage timing and profiler hooks.

Port of graphik_tpu/utils/profiling.py:

* `fence(tree)` - wait for the device work behind a tensor, or a dict,
  list or tuple of them: `torch.cuda.synchronize` on each CUDA device the
  tensors lie on (nothing to wait for on the CPU).
* `StageTimer` - named stages with counts and totals of the wall clock
  and, where there is a card, of CUDA events recorded on the current
  device's current stream around the stage (`device_*_s`): the device
  time from the stage's start to the end of the work it enqueued there.
* `timed(name)` - a stage on a shared timer.
* `device_trace(dir)` - a `torch.profiler` trace of the CPU and the card
  into `dir` (a Chrome trace, `trace.json`); a no-op for dir None.

Host-side tools: nothing here runs unless a caller uses it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(tree) -> None:
    """Block until the device work that makes `tree`'s tensors is done."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class StageRecord:
    total_s: float = 0.0
    count: int = 0
    last_s: float = 0.0
    device_total_s: float = 0.0
    device_last_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class StageTimer:
    """Accumulates wall time, and CUDA-event time, per named stage.

    Example:
        timer = StageTimer()
        with timer.stage("solve") as t:
            out = solver(T_goal)
            t.sync(out)              # fence device work into the stage
        print(timer.summary())
    """

    def __init__(self) -> None:
        self.records: Dict[str, StageRecord] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        """Time a stage: the wall clock and, where there is a card, CUDA
        events on the current stream (the stage waits for the second)."""
        events = None
        if torch.cuda.is_available():
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync_result is not None:
                fence(sync_result)
            if events is not None:
                events[1].record()
                events[1].synchronize()
            dt = time.perf_counter() - t0
            rec = self.records.setdefault(name, StageRecord())
            rec.total_s += dt
            rec.count += 1
            rec.last_s = dt
            if events is not None:
                ddt = events[0].elapsed_time(events[1]) / 1e3
                rec.device_total_s += ddt
                rec.device_last_s = ddt

    def sync(self, tree) -> None:
        fence(tree)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(r.total_s, 6),
                "count": r.count,
                "mean_s": round(r.mean_s, 6),
                "last_s": round(r.last_s, 6),
                "device_total_s": round(r.device_total_s, 6),
                "device_last_s": round(r.device_last_s, 6),
            }
            for k, r in self.records.items()
        }

    def reset(self) -> None:
        self.records.clear()


_GLOBAL = StageTimer()


def timed(name: str, sync_result=None):
    """Context manager recording into the module-global timer."""
    return _GLOBAL.stage(name, sync_result=sync_result)


def global_summary() -> Dict[str, Dict[str, float]]:
    return _GLOBAL.summary()


def reset() -> None:
    _GLOBAL.reset()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the CPU and, where there is one, the card,
    written to log_dir/trace.json (Chrome trace format); a no-op when
    log_dir is None. Yields the profiler (None for the no-op)."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
