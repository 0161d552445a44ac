"""Tracing and timing helpers — the port of decnet_tpu/utils/profiling.py.

`device_trace` records a torch.profiler trace (the card's kernels too, on
a machine with one) and writes it as a Chrome trace; `annotate` names a
range in it, and on the card also an NVTX range; `Timer` is JAX's
synchronised timer, waiting for the device a result lives on before it
reads the clock."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the CPU, and the card's activity where there is
    one) and write its Chrome trace to `<logdir>/trace.json`.  Yields the
    profiler, whose `key_averages()` sums the events by name."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in the profiler's trace (and an NVTX range on the
    card, for tools that read those)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(result) -> None:
    """Wait for the devices of the tensors in `result` (nested lists,
    tuples and dicts) to finish the work queued for them."""
    seen = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda" and x.device not in seen:
                seen.add(x.device)
                torch.cuda.synchronize(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(result)


class Timer:
    """Synchronised wall-clock timing with running statistics."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, result=None) -> Iterator[None]:
        """Time the block; `result`'s devices are waited for at its end
        (pass the tensors the block fills)."""
        t0 = time.perf_counter()
        yield
        if result is not None:
            _sync(result)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """fn(*args, **kwargs), timed until its result is ready."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self, skip_first: bool = True) -> Dict[str, float]:
        """Mean seconds per name, without the first call (the warm-up)
        when there are more."""
        out = {}
        for k, v in self.times.items():
            vals = v[1:] if skip_first and len(v) > 1 else v
            out[k] = sum(vals) / len(vals)
        return out

    def report(self) -> str:
        return "\n".join(f"{k:32s} {v * 1000:9.2f} ms"
                         for k, v in self.summary().items())
