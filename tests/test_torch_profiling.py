"""The port's tracing and timing helpers (`utils/profiling.py`) on the CPU:
`Timer` as tests/test_utils_aux.py::test_timer_reports holds JAX's, and
`annotate`'s names in the trace `device_trace` writes and in its sums."""
import json
import os

import torch

from decnet_tpu_torch.utils.profiling import (TRACE_FILE, Timer, annotate,
                                              device_trace)


def test_timer_reports():
    t = Timer()
    x = torch.ones(8, 8)
    for _ in range(3):
        t.timed("matmul", lambda: x @ x)
    with t.measure("add", result=[x + 1]):
        pass
    s = t.summary()
    assert "matmul" in s and s["matmul"] >= 0
    assert len(t.times["matmul"]) == 3
    assert s["add"] == t.times["add"][0]      # one call: nothing skipped
    assert "matmul" in t.report() and "add" in t.report()
    assert t.summary(skip_first=False)["matmul"] == sum(
        t.times["matmul"]) / 3


def test_annotate_names_in_the_trace(tmp_path):
    x = torch.randn(32, 32)
    with device_trace(str(tmp_path)) as prof:
        with annotate("decnet_outer"):
            with annotate("decnet_inner"):
                (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"decnet_outer", "decnet_inner"} <= names
    with open(os.path.join(tmp_path, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    traced = {e.get("name") for e in events}
    assert {"decnet_outer", "decnet_inner", "aten::mm"} <= traced
