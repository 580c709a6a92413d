"""Profiling (counterpart of nerfstudio_thermal_tpu/utils/profiler.py).

Two profilers, chosen by the trainer's `profiler` setting:
- "basic": `time_function` (a decorator or a context) records the host
  wall time of each named span; `flush_profiler` prints the averages,
  slowest first, and `setup_profiler(True)` registers it to run at exit.
  The trainer times its train iteration, eval batch, eval image, eval-set
  pass and checkpoint saves.
- "xla" (the name the JAX package's config uses): `TraceProfiler`, a
  torch.profiler trace of the CPU and, where there is one, the CUDA
  activity after step 10 through step 15, written as a Chrome trace
  (`trace.json`, view it in Perfetto or chrome://tracing) under
  `<base_dir>/profiler_traces`.
"""

import atexit
import time
from collections import defaultdict
from contextlib import ContextDecorator
from pathlib import Path
from typing import Optional

import torch

PROFILER_ENABLED = False
_records = defaultdict(lambda: [0.0, 0])  # name -> [total seconds, count]
_registered = False


def setup_profiler(enabled: bool, log_dir: Optional[Path] = None) -> None:
    global PROFILER_ENABLED, _registered
    PROFILER_ENABLED = enabled
    if enabled and not _registered:
        atexit.register(flush_profiler)
        _registered = True


class _Span(ContextDecorator):
    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return _Span(self.name)  # one span per call, so calls may nest

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if PROFILER_ENABLED:
            rec = _records[self.name]
            rec[0] += time.perf_counter() - self._start
            rec[1] += 1
        return False


def time_function(name_or_func):
    """`@time_function` (named by the function's qualified name),
    `@time_function("name")` or `with time_function("name"):`."""
    if callable(name_or_func):
        return _Span(name_or_func.__qualname__)(name_or_func)
    return _Span(name_or_func)


def flush_profiler() -> None:
    """Print the average durations, slowest first."""
    if not _records:
        return
    print("\nProfiler results (avg duration):")
    rows = sorted(_records.items(), key=lambda kv: -kv[1][0] / max(kv[1][1], 1))
    for name, (total, count) in rows:
        print(f"  {name:50s} {total / max(count, 1) * 1e3:10.3f} ms x{count}")


class TraceProfiler:
    """torch.profiler over the steps after `start_step` through
    `start_step + num_steps`; the trace goes to
    <log_dir>/profiler_traces/trace.json when it stops."""

    def __init__(self, log_dir: Path, start_step: int = 10, num_steps: int = 5):
        self.log_dir = Path(log_dir) / "profiler_traces"
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof = None

    def step(self, step: int) -> None:
        """Called after each training step."""
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        elif step >= self.stop_step:
            self.close()

    def close(self) -> None:
        """Stop a running trace and write it."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._prof.export_chrome_trace(str(self.log_dir / "trace.json"))
        print(f"wrote a profiler trace to {self.log_dir / 'trace.json'}")
        self._prof = None
