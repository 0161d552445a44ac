"""The port's disparity warps against the JAX package: the plain version of
the CUDA kernel `decnet_tpu_torch/csrc/warp.cu` against the Pallas warp
(interpret mode) and the XLA reference warp, and the port's reference warp
and stage-0 volume warp against theirs.

Inputs are made with numpy from a seed; JAX takes NHWC, the port NCHW (the
transposes live here).  Tolerance atol 1e-5 in f32: the versions compute
the same bilinear taps from the same f32 sample positions, but Pallas sums
the taps as a matrix product, so sums differ in the last bits."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.ops import warp as jwarp
from decnet_tpu.ops.pallas import warp as jpwarp
from decnet_tpu_torch.ops import warp as twarp
from decnet_tpu_torch.ops.kernels import warp as tkwarp

ATOL = 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


def make(seed, shape, max_disp):
    rng = np.random.RandomState(seed)
    B, H, W, C = shape
    img = rng.randn(*shape).astype(np.float32)
    disp = (rng.rand(B, H, W) * (max_disp + 16) - 16).astype(np.float32)
    # the ends of the clip range and just inside them
    disp[:, 0, :4] = [-16.0, -15.7, max_disp - 0.3, float(max_disp)]
    return img, disp


@pytest.mark.parametrize("shape,max_disp", [((1, 6, 40, 4), 12),
                                            ((2, 9, 130, 8), 24),
                                            ((1, 5, 300, 3), 72)])
def test_warp_plain_matches_pallas(shape, max_disp):
    img, disp = make(0, shape, max_disp)
    # beyond the clip range on one row: both versions clip
    disp[:, -1, :2] = [-40.0, max_disp + 9.5]
    want = np.asarray(jpwarp.warp_by_disparity_fast(img, disp, max_disp))
    got = tkwarp.warp_plain(nchw(img), torch.from_numpy(disp), max_disp)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,max_disp", [((1, 6, 40, 4), 12),
                                            ((2, 9, 130, 8), 24)])
def test_warp_plain_matches_reference_in_range(shape, max_disp):
    img, disp = make(1, shape, max_disp)
    want = np.asarray(jwarp.warp_by_disparity(img, disp))
    got = tkwarp.warp_plain(nchw(img), torch.from_numpy(disp), max_disp)
    # the reference reaches the position through a normalised grid (three
    # more f32 roundings, a few ulps of x ~ W); with unit-variance features
    # that moves the sample by ~1e-5: atol 1e-4, as the JAX package's own
    # Pallas-vs-reference warp test allows
    np.testing.assert_allclose(to_nhwc(got), want, rtol=0, atol=1e-4)
    # the wrapper runs the plain version on CPU tensors, launching nothing
    before = tkwarp.warp.launches
    again = tkwarp.warp(nchw(img), torch.from_numpy(disp), max_disp)
    assert tkwarp.warp.launches == before
    assert torch.equal(again, got)


def test_warp_border_rows_halved():
    """align_corners=False: the top and bottom rows mix with the zero
    border (weight 0.5), as torch grid_sample does."""
    img = np.ones((1, 5, 30, 2), np.float32)
    disp = np.zeros((1, 5, 30), np.float32)
    got = to_nhwc(tkwarp.warp_plain(nchw(img), torch.from_numpy(disp), 8))
    assert abs(got[0, 0, 15, 0] - 0.5) < 1e-6
    assert abs(got[0, 2, 15, 0] - 1.0) < 1e-6


def test_warp_by_disparity_matches_jax():
    img, disp = make(2, (2, 7, 33, 5), 20)
    disp[:, 1, :3] = [-30.0, 45.0, 33.5]      # unclipped reference warp
    want = np.asarray(jwarp.warp_by_disparity(img, disp))
    got = twarp.warp_by_disparity(nchw(img), torch.from_numpy(disp))
    np.testing.assert_allclose(to_nhwc(got), want, rtol=0, atol=ATOL)


def test_grid_sample_bilinear_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.randn(2, 6, 9, 3).astype(np.float32)
    x = (rng.rand(2, 4, 5) * 13 - 2).astype(np.float32)
    y = (rng.rand(2, 4, 5) * 10 - 2).astype(np.float32)
    want = np.asarray(jwarp.grid_sample_bilinear(img, x, y))   # (B,4,5,C)
    got = twarp.grid_sample_bilinear(nchw(img), torch.from_numpy(x),
                                     torch.from_numpy(y))      # (B,C,4,5)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,max_disp", [((1, 2, 2, 6), 8),
                                            ((2, 3, 7, 4), 5)])
def test_warp_volume_uniform_matches_jax(shape, max_disp):
    rng = np.random.RandomState(4)
    img = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jwarp.warp_volume_uniform(jnp.asarray(img), max_disp))
    got = twarp.warp_volume_uniform(nchw(img), max_disp)      # (B,C,S,H,W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        twarp._affine_tap_matrix(5, 7, np.linspace(-1.5, 7.5, 5)),
        jwarp._affine_tap_matrix(5, 7, np.linspace(-1.5, 7.5, 5)))
