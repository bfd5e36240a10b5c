"""torch.profiler integration: the device-level traces beside the phase
wall-clocks of utils/timings (the reference's timing taxonomy and bench
scripts, SURVEY.md §5.1).

Counterpart of whisper_tpu/utils/profiling.py, which wraps jax.profiler.
Here a trace records the CPU activity and, when a CUDA device is present,
the CUDA kernels (every hand-written kernel appears under its own name,
e.g. attn_tc), and is written as a Chrome trace viewable in Perfetto or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Context manager: capture a torch.profiler trace into `log_dir` as
    trace-<pid>-<ms>.json (no-op when log_dir is falsy, so callers can
    thread a CLI flag straight through)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()      # the traced kernels have ended
    name = f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)
