"""The port's whole DecNet forward against decnet_tpu's for the paths this
slice adds — the space-to-depth full-resolution stage (`s2d_fine`), the
prior-windowed matching (`match_window`), learned detail masks
(`use_detail`, fixed and quantile) and the sparse ablation — on random
initialisation carried by the weight bridge, in f32 on the CPU.

The input is a stereo pair, a random texture seen shifted by 6 px, with
random masks (for the paths without learned detail).  The untrained detail
heads' logits saturate the f32 sigmoid at 1.0, where the strict cut keeps
no pixel (tests/test_torch_s2d_layers.py checks that tie); their last
conv's kernel is scaled by 0.05 in the weights both packages get, so the
masks have their target density.

Tolerance 1e-3 px on disparities, as tests/test_torch_model.py; masks and
candidate availability exact; the variance 1e-4 relative.  With the full
band (no window) at stage 3, the variance of a near-flat softmax over 54
candidates (~340 px^2) carries ~2.4e-3 px^2 of f32 summation-order noise,
which the untrained SoftAttentionS2D carries into 3 of 4374 final
disparities at up to 2.1e-3 px (measured); with JAX's own matching outputs
put in its place the port's model agrees to 3.1e-4 px.  So the full-band
s2d case is held at 1e-3 px in two parts: the matching outputs against
JAX's, then the model around them with JAX's matching outputs;
tests/test_torch_s2d_checkpoints.py holds the whole full-band s2d forward
to 1e-3 px on trained weights (ckpt_stressor_r5)."""
import functools

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.models import decnet as tdecnet
from decnet_tpu_torch.weights import load_flax_variables
from tests.test_torch_layers import nchw
from tests.test_torch_model import DISP_TOL, assert_warp_inputs_in_range

H, W, MAX_DISP, SHIFT = 54, 81, 54, 6
BASE = dict(max_disp=MAX_DISP, base_channels=4, num_stage=4, down_scale=3,
            cost_func="cor", skip_stage_id=4, match_temp=3.0,
            match_temp_learned=True, cand_fallback=True)
CASES = {
    "s2d": dict(s2d_fine=True, s2d_stages=1, use_detail=False,
                match_window=0),
    "s2d_window": dict(s2d_fine=True, s2d_stages=1, use_detail=False,
                       match_window=12),
    "s2d_window_quantile_detail": dict(
        s2d_fine=True, s2d_stages=1, use_detail=True, thold_mode="quantile",
        detail_density=0.25, match_window=12),
    "window_fixed_detail": dict(s2d_fine=False, use_detail=True, thold=0.5,
                                match_window=12),
}
EXACT = ("masks_used", "cand")
KEYS = ("preds", "dense", "sparse", "sparse_raw", "fusion", "var", "cand",
        "masks_used", "soft_mask", "residual", "left_details",
        "right_details")


def inputs():
    rng = np.random.RandomState(0)
    tex = rng.rand(1, H, W + SHIFT, 3).astype(np.float32)
    left, right = tex[:, :, :W].copy(), tex[:, :, SHIFT:].copy()
    lmasks, rmasks = [], []
    for s in (9, 3, 1):
        lmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
        rmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
    return left, right, lmasks, rmasks


@functools.lru_cache(maxsize=None)
def jax_twin(case):
    """(JAX config, port config, variables, JAX model, jitted apply) of a
    case, made once per case."""
    kw = dict(BASE, **CASES[case])
    jcfg = JaxConfig(**kw, dtype="float32", matching_impl="xla")
    tcfg = ModelConfig(**kw, dtype="float32")
    left, right, lm, rm = inputs()
    jm = get_model("decnet", jcfg)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), left, right, lm, rm)
    v = {c: jax.tree_util.tree_map(np.array, t) for c, t in v.items()}
    for name, tree in v["params"].items():
        if name.startswith("detail_"):
            tree["head1"]["Conv_0"]["kernel"] *= 0.05
    return jcfg, tcfg, v, jax.jit(jm.apply,
                                  static_argnames=("ablate_sparse",))


def port_forward(tcfg, v, **kw):
    left, right, lm, rm = inputs()
    model = DecNet(tcfg)
    load_flax_variables(model, v)
    with torch.no_grad():
        return model.eval()(nchw(left), nchw(right),
                            [torch.from_numpy(m) for m in lm],
                            [torch.from_numpy(m) for m in rm], **kw)


def assert_outputs_match(got, want, keys=KEYS):
    for key in keys:
        assert len(got[key]) == len(want[key]), key
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w),
                rtol=1e-4 if key == "var" else 0,
                atol=0 if key in EXACT else DISP_TOL,
                err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("case", ["s2d_window", "s2d_window_quantile_detail",
                                  "window_fixed_detail"])
def test_forward_matches_jax(case):
    _, tcfg, v, apply = jax_twin(case)
    want = apply(v, *inputs())
    got = port_forward(tcfg, v)
    assert_warp_inputs_in_range(got, MAX_DISP)
    assert_outputs_match(got, want)
    # the masks are neither empty nor full
    for m in got["masks_used"]:
        assert 0.05 < float(m.mean()) < 0.95
    if tcfg.use_detail:
        assert len(got["left_details"]) == 3
        if tcfg.thold_mode == "quantile":
            for m in got["masks_used"]:
                assert abs(float(m.mean()) - 0.25) < 0.1


def test_ablate_sparse_matches_jax():
    """fused = dense at every fine stage, in both packages."""
    _, tcfg, v, apply = jax_twin("s2d_window_quantile_detail")
    want = apply(v, *inputs(), ablate_sparse=True)
    got = port_forward(tcfg, v, ablate_sparse=True)
    assert_outputs_match(got, want)
    for fused, dense in zip(got["fusion"], got["dense"]):
        assert torch.equal(fused, dense)
    full = port_forward(tcfg, v)
    assert (full["preds"][-1] - got["preds"][-1]).abs().max() > 1e-2


def test_s2d_full_band_matches_jax(monkeypatch):
    """The full-band s2d case: the port's matching outputs against JAX's,
    then the port's model with JAX's matching outputs put in (see the
    module docstring)."""
    _, tcfg, v, apply = jax_twin("s2d")
    want = apply(v, *inputs())
    got = port_forward(tcfg, v)
    assert_warp_inputs_in_range(got, MAX_DISP)
    assert_outputs_match(got, want, ("sparse_raw", "var", "cand",
                                     "masks_used"))
    for key in KEYS:
        if key not in ("fusion", "soft_mask", "residual", "preds"):
            continue
        for i, (g, w) in enumerate(zip(got[key][:2], want[key][:2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=DISP_TOL, err_msg=f"{key}[{i}]")

    real = tdecnet.sparse_matching_with_var
    calls = []

    def jax_matching(*args, **kw):
        real(*args, **kw)
        i = len(calls)
        calls.append(i)
        return (torch.from_numpy(np.array(want["sparse_raw"][i])),
                torch.from_numpy(np.array(want["var"][i])))
    monkeypatch.setattr(tdecnet, "sparse_matching_with_var", jax_matching)
    got = port_forward(tcfg, v)
    assert calls == [0, 1, 2]
    assert_outputs_match(got, want)


def test_learned_detail_needs_no_masks():
    """With use_detail the heads make the masks: the forward takes none."""
    _, tcfg, v, _ = jax_twin("s2d_window_quantile_detail")
    left, right, _, _ = inputs()
    model = DecNet(tcfg)
    load_flax_variables(model, v)
    with torch.no_grad():
        out = model.eval()(nchw(left), nchw(right))
        ref = port_forward(tcfg, v)
    for a, b in zip(out["preds"], ref["preds"]):
        assert torch.equal(a, b)
