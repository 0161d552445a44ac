"""The port's bench (decnet_tpu_torch/cli/bench.py) on the CPU: one JSON
line with the root bench.py's keys, the refusal to run without a card by
default, and its faithful variant (the faithful weights repacked to
s2d_stages 2) against its faithful_nhwc variant at bench.py's CPU shape."""
import ast
import json
import os

import pytest
import torch

from decnet_tpu_torch.cli import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_bench_keys():
    """The keys of the JSON line the root bench.py prints (its `out` dict
    and the keys it adds when it knows the chip's peak)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "out"
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and \
                getattr(node.value, "id", None) == "out" and \
                isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys


def test_cpu_bench_prints_bench_py_keys(capsys):
    want = jax_bench_keys()
    assert {"metric", "value", "unit", "vs_baseline", "mfu_ref_pct",
            "faithful_pairs_per_sec", "faithful_nhwc_pairs_per_sec",
            "flops_per_pair_G", "device_kind"} <= want
    result = bench.main(["--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    # the peak (and with it the mfu keys) is known for the H100 only
    assert want - {"mfu_ref_pct", "mfu_packed_pct"} <= set(rec)
    assert "mfu_ref_pct" not in rec and rec["device_kind"] == "cpu"
    assert rec["metric"] == "pairs_per_sec" and rec["value"] > 0
    assert "54x108" in rec["unit"] and "backend=cpu" in rec["unit"]
    assert list(result["variants"]) == ["faithful_nhwc"]
    run = result["variants"]["faithful_nhwc"]
    assert len(run["rounds_pairs_per_sec"]) == 2 and run["forwards"] == 4
    # the timed model's first prediction, on the inputs as made
    assert run["pred"].shape == (1, 54, 108)
    assert torch.isfinite(run["pred"]).all()
    assert rec["flops_per_pair_G"] > 0
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert bench.peak_tflops("NVIDIA H100 PCIe") is None


def test_bench_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main([])


def test_faithful_variant_equals_faithful_nhwc():
    """The repacked variant (s2d, s2d_stages 2) serves the faithful
    weights: the same final disparity within 2e-4 px (f32, bench.py's CPU
    shape and inputs), and the s2d variant is another model."""
    inputs = bench.make_inputs(**{k: bench.CPU[k] for k in ("H", "W",
                                                            "batch")},
                               device="cpu")[:4]
    preds = {}
    for mode in bench.VARIANTS:
        model = bench.build_variant(mode, "float32", "cpu")
        assert model.cfg.s2d_fine == (mode != "faithful_nhwc")
        with torch.inference_mode():
            preds[mode] = model(*inputs)["preds"][-1]
    torch.testing.assert_close(preds["faithful"], preds["faithful_nhwc"],
                               rtol=0, atol=2e-4)
    assert (preds["s2d"] - preds["faithful_nhwc"]).abs().max() > 1e-2
