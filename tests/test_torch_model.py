"""The port's whole faithful DecNet forward against decnet_tpu's, in f32 on
the CPU, with identical weights (carried by the weight bridge) and identical
detail masks fed to both.

JAX runs its XLA matching and its unclipped XLA warp off the TPU; the port
runs the plain versions of its kernels, whose warp clips disparities to
[-16, max_disp] as the TPU kernel does.  The two agree while the disparities
a Refinement warps by stay in that range, which each test asserts.
Tolerance 1e-3 px on disparities: a few hundred f32 convolutions in
different summation orders move the soft-argmin and the sparse expectation
by ~1e-5 px; 1e-3 leaves room and still catches any wrong tap, channel
order or mask."""
import json
import os

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu_torch.config import ModelConfig, load_config
from decnet_tpu_torch.data import io as tio
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.ops.detail import detail_masks
from decnet_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from tests.test_torch_layers import nchw

CKPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "runs",
                    "ckpt_faithful")
DISP_TOL = 1e-3
NEG_MARGIN = 16

FAITHFUL_SMALL = dict(max_disp=54, base_channels=4, num_stage=4,
                      down_scale=3, cost_func="cor", skip_stage_id=4,
                      use_detail=False, match_temp=3.0,
                      match_temp_learned=True, match_window=0,
                      cand_fallback=True)


def template(jcfg, left, right, lmasks, rmasks):
    """The JAX model's variable tree, shapes only (tracing, no compile)."""
    return jax.eval_shape(get_model("decnet", jcfg).init,
                          jax.random.PRNGKey(0), left, right, lmasks, rmasks)


def flat_paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def run_both(jcfg, tcfg, variables, left, right, lmasks, rmasks):
    want = jax.jit(get_model("decnet", jcfg).apply)(variables, left, right,
                                                    lmasks, rmasks)
    tmodel = DecNet(tcfg)
    n = load_flax_variables(tmodel, variables)
    with torch.no_grad():
        got = tmodel.eval()(nchw(left), nchw(right),
                            [torch.from_numpy(m) for m in lmasks],
                            [torch.from_numpy(m) for m in rmasks])
    return want, got, n


def assert_warp_inputs_in_range(got, max_disp, scale=3, ns=4):
    for i, fused in enumerate(got["fusion"]):
        d = max_disp // scale ** (ns - 2 - i)
        f = fused.numpy()
        assert f.min() >= -NEG_MARGIN and f.max() <= d, (i, f.min(), f.max())


def test_faithful_forward_matches_jax():
    rng = np.random.RandomState(0)
    H, W = 54, 81
    left = rng.rand(1, H, W, 3).astype(np.float32)
    right = rng.rand(1, H, W, 3).astype(np.float32)
    lmasks, rmasks = [], []
    for s in (9, 3, 1):
        lmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
        rmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
    jcfg = JaxConfig(**FAITHFUL_SMALL, dtype="float32", matching_impl="xla")
    tcfg = ModelConfig(**FAITHFUL_SMALL, dtype="float32")
    # a freshly initialised JAX model (He-normal kernels, batch norm at its
    # initial statistics; tests/test_torch_layers.py exercises non-trivial
    # statistics, the checkpoint test below trained ones)
    variables = jax.jit(get_model("decnet", jcfg).init)(
        jax.random.PRNGKey(0), left, right, lmasks, rmasks)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want, got, _ = run_both(jcfg, tcfg, variables, left, right, lmasks,
                            rmasks)

    assert_warp_inputs_in_range(got, 54)
    np.testing.assert_allclose(got["preds"][-1].numpy(),
                               np.asarray(want["preds"][-1]), rtol=0,
                               atol=DISP_TOL)
    for s in range(4):
        np.testing.assert_allclose(got["preds"][s].numpy(),
                                   np.asarray(want["preds"][s]), rtol=0,
                                   atol=DISP_TOL, err_msg=f"preds[{s}]")
    for key in ("dense", "sparse", "sparse_raw", "fusion", "var", "cand",
                "masks_used", "soft_mask", "residual"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            # var is a second moment (~d^2): the same 1e-3 px noise in the
            # expectation shows up multiplied by ~2 d, so 1e-4 relative
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-4 if key == "var" else 0,
                                       atol=DISP_TOL,
                                       err_msg=f"{key}[{i}]")
    # the sparse branch really matched something on every stage
    for raw, lm in zip(got["sparse_raw"], lmasks):
        assert (raw.numpy()[lm != 0] != 0).any()


def test_faithful_checkpoint_through_bridge():
    path = os.path.join(CKPT, "params.npz")
    assert len(state_dict_from_flax(path)) == 374
    with open(os.path.join(CKPT, "config.json")) as f:
        model_cfg = json.load(f)["model"]
    model_cfg.update(dtype="float32", matching_impl="xla")
    jcfg = JaxConfig(**model_cfg)
    tcfg = load_config(CKPT, dtype="float32")

    rng = np.random.RandomState(2)
    tex = rng.rand(1, 54, 60, 3).astype(np.float32)
    right01 = tex[:, :, 6:]                       # left = right shifted by 6
    left01 = tex[:, :, :54]
    masks = [detail_masks(nchw(im), 3, 3, 0.3) for im in (left01, right01)]
    lmasks, rmasks = ([m.numpy() for m in ms] for ms in masks)
    left = tio.normalize_image(nchw(left01)).numpy().transpose(0, 2, 3, 1)
    right = tio.normalize_image(nchw(right01)).numpy().transpose(0, 2, 3, 1)

    # the snapshot, nested as flax nests it, must fill the JAX model's tree
    with np.load(path) as z:
        flat = {tuple(p[2:-2] for p in k.split("/")): z[k] for k in z.files}
    tree = template(jcfg, left, right, lmasks, rmasks)
    assert set(flat) == set(flat_paths(tree))
    variables = {}
    for p, v in flat.items():
        node = variables
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = v
    want, got, n = run_both(jcfg, tcfg, variables, left, right, lmasks,
                            rmasks)
    assert n == 374
    assert_warp_inputs_in_range(got, tcfg.max_disp)
    for s in range(4):
        np.testing.assert_allclose(got["preds"][s].numpy(),
                                   np.asarray(want["preds"][s]), rtol=0,
                                   atol=DISP_TOL, err_msg=f"preds[{s}]")


def test_config_refuses_unported_paths():
    # learned detail, s2d with one or two packed stages and windowed
    # matching are ported (tests/test_torch_s2d_model.py,
    # tests/test_torch_s2d_mid.py); the extractor packs no third level.
    # The skip builds (tests/test_torch_model_knobs.py holds it to JAX)
    ModelConfig(use_detail=True, s2d_fine=True, match_window=12)
    ModelConfig(s2d_fine=True, s2d_stages=2)
    with pytest.raises(ValueError):
        ModelConfig(s2d_fine=True, s2d_stages=3)
    assert ModelConfig(skip_stage_id=3).skip_stage_id == 3
    with pytest.raises(ValueError):
        ModelConfig(thold_mode="median")
    cfg = load_config(CKPT)
    assert (cfg.max_disp, cfg.base_channels, cfg.dtype) == (216, 8,
                                                            "bfloat16")
    assert cfg.match_temp_learned and cfg.cand_fallback
