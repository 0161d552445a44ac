"""The port's DecNet with the 1/3-res stage in s2d form too
(`s2d_fine`, `s2d_stages` 2: the extractor's `s2d_mid` and the stage-2
packed heads, RefinementS2D's 5-tap phase-mixing conv among them) against
decnet_tpu's, in f32 on the CPU, at tests/test_repack.py's shapes (54x54,
base 4, max_disp 54).  The weights are the port's fresh initialisation
from a seed, carried to the JAX model by the weight bridge (which holds
the two trees to the same names and shapes); JAX's own jitted init would
cost ~25 s of compilation a case.

Both cases run the flagship configuration's matching (window 12,
cand_fallback), with masks from the caller and with learned quantile
detail masks (the flagship's).  As in tests/test_torch_s2d_model.py the
detail heads' last kernel is scaled by 0.05 in the weights both packages
get, so their masks have the target density.  Tolerance 1e-3 px on
disparities; masks and candidate availability exact; the variance 1e-4
relative."""
import functools

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.nn.heads import RefinementS2D, SoftAttentionS2D
from decnet_tpu_torch.weights import load_flax_variables, variables_from_model
from tests.test_torch_layers import nchw
from tests.test_torch_model import assert_warp_inputs_in_range
from tests.test_torch_s2d_model import KEYS, assert_outputs_match

H, W, MAX_DISP, SHIFT = 54, 54, 54, 6
BASE = dict(max_disp=MAX_DISP, base_channels=4, num_stage=4, down_scale=3,
            cost_func="cor", skip_stage_id=4, s2d_fine=True, s2d_stages=2,
            match_window=12, cand_fallback=True)
CASES = {
    "masks": dict(use_detail=False),
    "quantile_detail": dict(use_detail=True, thold_mode="quantile",
                            detail_density=0.25),
}


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
def jax_run(case):
    """(port config, variables, JAX outputs) of a case, made once."""
    kw = dict(BASE, **CASES[case])
    tcfg = ModelConfig(**kw, dtype="float32")
    torch.manual_seed(0)
    v = variables_from_model(DecNet(tcfg))
    for name, tree in v["params"].items():
        if name.startswith("detail_"):
            tree["head1"]["Conv_0"]["kernel"] *= 0.05
    jm = get_model("decnet", JaxConfig(**kw, dtype="float32",
                                       matching_impl="xla"))
    want = jax.jit(jm.apply)(v, *inputs())
    return tcfg, v, want


def port_forward(tcfg, v):
    left, right, lm, rm = inputs()
    model = DecNet(tcfg)
    load_flax_variables(model, v)
    with torch.no_grad():
        return model, model.eval()(nchw(left), nchw(right),
                                   [torch.from_numpy(m) for m in lm],
                                   [torch.from_numpy(m) for m in rm])


@pytest.mark.parametrize("case", sorted(CASES))
def test_s2d_stages_2_forward_matches_jax(case):
    tcfg, v, want = jax_run(case)
    model, got = port_forward(tcfg, v)
    # stages 2 and 3 run the packed heads, stage 1 the faithful ones;
    # stage 2's Refinement twin carries the 5-tap phase-mixing conv
    assert isinstance(model.refine_1, RefinementS2D)
    assert isinstance(model.soft_att_1, SoftAttentionS2D)
    assert not isinstance(model.refine_0, RefinementS2D)
    c2 = model.refine_1.c2.conv
    assert (c2.kernel_size, c2.dilation) == ((5, 5), (1, 1))
    assert model.refine_1.c4.conv.dilation == (2, 2)
    assert model.feature_extractor.out_channels == [108, 36, 108, 36]
    assert got["left_feats"][2].shape == (1, 108, H // 9, W // 9)
    assert_warp_inputs_in_range(got, MAX_DISP)
    assert_outputs_match(got, want, KEYS if tcfg.use_detail else
                         [k for k in KEYS if "details" not in k])
    for m in got["masks_used"]:
        assert 0.05 < float(m.mean()) < 0.95
