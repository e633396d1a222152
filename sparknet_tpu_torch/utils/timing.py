"""Timing: Caffe util/benchmark.cpp's Timer, a step-rate tracker and a
torch.profiler context (the port of sparknet_tpu/utils/timing.py).

PyTorch returns before the card finishes, so a host clock read without
a synchronize measures the enqueue: ``Timer.stop`` synchronizes the
device of the tensor it is given (``torch.cuda.synchronize``) before it
reads the clock, as Caffe's Timer used CUDA events.
"""

import contextlib
import time

import numpy as np


def _sync(value):
    """Wait for the device work behind ``value`` (a tensor or a device):
    a CUDA synchronize on a card, nothing on the CPU."""
    import torch
    dev = value.device if isinstance(value, torch.Tensor) else \
        torch.device(value)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Timer:
    """Start/Stop/MilliSeconds like benchmark.cpp:26-142."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self, sync=None):
        """sync: an optional tensor (or device) whose card work must end
        before the clock is read."""
        if sync is not None:
            _sync(sync)
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None
        return self

    def milliseconds(self):
        return self._elapsed * 1e3

    def seconds(self):
        return self._elapsed


class StepTimer:
    """Rolling images/sec and step-time statistics of a training loop."""

    def __init__(self, window=20):
        self.window = window
        self.times = []
        self._last = None

    def tick(self, batch_size=None):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append((now - self._last, batch_size or 0))
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def step_ms(self):
        if not self.times:
            return float("nan")
        return float(np.mean([t for t, _ in self.times])) * 1e3

    def images_per_sec(self):
        ts = [(t, b) for t, b in self.times if b]
        if not ts:
            return float("nan")
        return sum(b for _, b in ts) / sum(t for t, _ in ts)


@contextlib.contextmanager
def torch_profile(log_dir, cuda=None):
    """torch.profiler over a block, its Chrome trace written to
    ``log_dir``/torch.trace.json (view in chrome://tracing or Perfetto).
    ``cuda``: record the card's kernels (default: when a card exists)."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "torch.trace.json"))
