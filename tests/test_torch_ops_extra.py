"""The stateless ops the model's shipped forward does not reach
(decnet_tpu_torch/ops/): the general cost volume with the three costs,
the uniform one with cat and ssd, the adaptive disparity samples, the
normalised grid sample, the per-hypothesis warp, the occlusion mask, the
average pool and the on-device wavelet detail masks — each against its
decnet_tpu twin on the same numpy inputs, in f32 on the CPU.

JAX lays maps out NHWC and volumes (B,S,H,W,C), the port NCHW and
(B,C,S,H,W); the transposes live here.  Tolerance 1e-5 (the same f32
operations, in other orders in places); masks and occlusion exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from decnet_tpu.ops import cost_volume as jcv
from decnet_tpu.ops import detail as jdetail
from decnet_tpu.ops import occlusion as jocc
from decnet_tpu.ops import regression as jreg
from decnet_tpu.ops import resize as jresize
from decnet_tpu.ops import warp as jwarp
from decnet_tpu_torch.ops import cost_volume as tcv
from decnet_tpu_torch.ops import detail as tdetail
from decnet_tpu_torch.ops import occlusion as tocc
from decnet_tpu_torch.ops import regression as treg
from decnet_tpu_torch.ops import resize as tresize
from decnet_tpu_torch.ops import warp as twarp
from tests.test_torch_layers import nchw

TOL = 1e-5


def feats(seed, B=2, H=6, W=13, C=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, C).astype(np.float32), rng)


def volume_to_jax(t):
    """(B,C,S,H,W) -> (B,S,H,W,C)."""
    return t.numpy().transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("cost_func", ["cor", "cat", "ssd"])
def test_build_cost_volume(cost_func):
    left, right, rng = feats(0)
    samples = (rng.rand(2, 4, 6, 13) * 9 - 1).astype(np.float32)
    want = jcv.build_cost_volume(left, right, samples, cost_func)
    got = tcv.build_cost_volume(nchw(left), nchw(right),
                                torch.from_numpy(samples), cost_func)
    np.testing.assert_allclose(volume_to_jax(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cost_func", ["cat", "ssd"])
def test_build_cost_volume_uniform(cost_func):
    left, right, _ = feats(1)
    want = jcv.build_cost_volume_uniform(left, right, 5, cost_func)
    got = tcv.build_cost_volume_uniform(nchw(left), nchw(right), 5,
                                        cost_func)
    assert got.shape[1] == (6 if cost_func == "cat" else 3)
    np.testing.assert_allclose(volume_to_jax(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,samp_num,step", [(3, 12, 1.0), (5, 6, 2.0)])
def test_adaptive_disp_samples(k, samp_num, step):
    rng = np.random.RandomState(2)
    disp = (rng.rand(2, 7, 11) * 30).astype(np.float32)
    want = jreg.adaptive_disp_samples(disp, 24, step, samp_num, k)
    got = treg.adaptive_disp_samples(torch.from_numpy(disp), 24, step,
                                     samp_num, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_grid_sample_normalized():
    img, _, rng = feats(3)
    grid = (rng.rand(2, 5, 7, 2) * 2.4 - 1.2).astype(np.float32)
    want = jwarp.grid_sample_normalized(img, grid)        # (B,5,7,C)
    got = twarp.grid_sample_normalized(nchw(img), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=TOL, atol=TOL)
    # and torch's own sampler, the reference's
    ref = F.grid_sample(nchw(img), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


def test_warp_volume_by_disparity():
    img, _, rng = feats(4)
    samples = (rng.rand(2, 3, 6, 13) * 8).astype(np.float32)
    want = jwarp.warp_volume_by_disparity(img, samples)
    got = twarp.warp_volume_by_disparity(nchw(img),
                                         torch.from_numpy(samples))
    np.testing.assert_allclose(volume_to_jax(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_occlusion_mask():
    rng = np.random.RandomState(5)
    disp = np.round(rng.rand(2, 6, 20) * 10).astype(np.float32)
    want = np.asarray(jocc.occlusion_mask(disp))
    got = tocc.occlusion_mask(torch.from_numpy(disp)).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert 0 < want.mean() < 1


def test_avg_pool():
    x, _, _ = feats(6, H=6, W=12, C=4)
    want = jresize.avg_pool(x, 3)
    got = tresize.avg_pool(nchw(x), 3)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", [(32, 48), (27, 45)], ids=["even", "odd"])
def test_wavelet_detail_masks(hw):
    rng = np.random.RandomState(7)
    img = rng.rand(2, *hw, 3).astype(np.float32)
    img[:, hw[0] // 3:hw[0] // 2] *= 0.2           # some structure
    want = jdetail.wavelet_detail_masks(jnp.asarray(img), levels=3)
    got = tdetail.wavelet_detail_masks(nchw(img), levels=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0 < float(got[-1].mean()) < 1
