"""The port's space-to-depth layout helpers, s2d feature pyramid, the s2d
and learned-detail heads, the windowed candidate availability and the
detail binarisation against their JAX twins, on the CPU in f32.

Tolerances as tests/test_torch_layers.py: exact for index shuffles, the
availability and the binarisation (the same comparisons of the same f32
values); 1e-5 for one conv unit; 1e-4 for stacks of convs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import decnet as jdecnet
from decnet_tpu.models import repack as jrepack
from decnet_tpu.nn import feature as jfeature
from decnet_tpu.nn import heads as jheads
from decnet_tpu.nn import layers as jlayers
from decnet_tpu.ops import matching as jmatching
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import decnet as tdecnet
from decnet_tpu_torch.models import repack as trepack
from decnet_tpu_torch.nn import feature as tfeature
from decnet_tpu_torch.nn import heads as theads
from decnet_tpu_torch.nn import layers as tlayers
from decnet_tpu_torch.ops import matching as tmatching
from tests.test_torch_layers import (STACK_TOL, UNIT_TOL, nchw, nhwc, rand,
                                     twin)


def test_space_to_depth_is_phase_major():
    """Channel (i*r + j)*C + c, as the JAX package orders it; torch's
    pixel_unshuffle (c*r*r + i*r + j) differs for C > 1."""
    x = rand(0, 2, 6, 9, 4)
    got = tlayers.space_to_depth(nchw(x), 3)
    np.testing.assert_array_equal(nhwc(got),
                                  np.asarray(jlayers.space_to_depth(x, 3)))
    unshuffled = torch.nn.functional.pixel_unshuffle(nchw(x), 3)
    assert got.shape == unshuffled.shape and not torch.equal(got, unshuffled)
    # channel 1 holds phase (0, 0) of input channel 1 here, phase (0, 1) of
    # channel 0 there
    assert torch.equal(got[:, 1], nchw(x)[:, 1, ::3, ::3])
    assert torch.equal(unshuffled[:, 1], nchw(x)[:, 0, ::3, 1::3])
    one = nchw(x[..., :1])
    assert torch.equal(tlayers.space_to_depth(one, 3),
                       torch.nn.functional.pixel_unshuffle(one, 3))
    back = tlayers.depth_to_space(got, 3)
    assert torch.equal(back, nchw(x))
    s = rand(1, 2, 2, 3, 36)
    np.testing.assert_array_equal(
        nhwc(tlayers.depth_to_space(nchw(s), 3)),
        np.asarray(jlayers.depth_to_space(s, 3)))


def test_plane_s2d_round_trip():
    m = rand(2, 2, 6, 9)
    got = tlayers.plane_to_s2d(torch.from_numpy(m), 3)
    np.testing.assert_array_equal(nhwc(got),
                                  np.asarray(jlayers.plane_to_s2d(m, 3)))
    np.testing.assert_array_equal(
        tlayers.s2d_to_plane(got, 3).numpy(),
        np.asarray(jlayers.s2d_to_plane(jlayers.plane_to_s2d(m, 3), 3)))
    assert torch.equal(tlayers.s2d_to_plane(got, 3), torch.from_numpy(m))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 9])
def test_packed_geometry(d):
    assert trepack.packed_geometry(d, 3) == jrepack.packed_geometry(d, 3)


def test_s2d_feature_extractor():
    x = np.random.RandomState(6).rand(1, 54, 81, 3).astype(np.float32)
    fm = jfeature.FeatureExtractor(base_channels=4, s2d_last=True)
    v, tm = twin(fm, tfeature.FeatureExtractor(4, s2d_last=True), x)
    want = fm.apply(v, x)
    with torch.no_grad():
        got = tm(nchw(x))
    assert [tuple(g.shape[1:]) for g in got] == [
        (108, 2, 3), (36, 6, 9), (12, 18, 27), (36, 18, 27)]
    for s, g in enumerate(got):
        np.testing.assert_allclose(nhwc(g), np.asarray(want[f"stage{s}"]),
                                   rtol=0, atol=STACK_TOL,
                                   err_msg=f"stage{s}")


def test_dynamic_upsampling_s2d():
    disp = np.random.RandomState(8).rand(1, 3, 4).astype(np.float32) * 5
    fea = rand(9, 1, 3, 4, 36)                    # s2d features, 9 x 4
    fm = jheads.DynamicUpsampling(3, pre_unfolded=True, out_s2d=True)
    v, tm = twin(fm, theads.DynamicUpsampling(36, 3, pre_unfolded=True,
                                              out_s2d=True), disp, fea)
    want = np.asarray(fm.apply(v, disp, fea))
    with torch.no_grad():
        got = nhwc(tm(torch.from_numpy(disp), nchw(fea)))
    assert got.shape == (1, 3, 4, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)


def test_soft_attention_s2d():
    fea = rand(10, 1, 6, 7, 36)
    planes = [rand(11 + i, 1, 6, 7, 9) for i in range(4)]
    fm = jheads.SoftAttentionS2D(3, hidden=36)
    v, tm = twin(fm, theads.SoftAttentionS2D(72, 3, hidden=36), fea, planes)
    want = np.asarray(fm.apply(v, fea, planes))
    with torch.no_grad():
        got = nhwc(tm(nchw(fea), [nchw(p) for p in planes]))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_refinement_s2d():
    """The stage-3 schedule (dilations 3/6/9 packed to 1/2/3): the right
    features warped at full resolution, then s2d-packed."""
    r, C, h, w, max_disp = 3, 4, 4, 10, 12
    left = rand(12, 1, h, w, r * r * C)
    right_full = rand(13, 1, h * r, w * r, C)
    disp_full = (np.random.RandomState(14).rand(1, h * r, w * r)
                 * (max_disp + 8) - 8).astype(np.float32)
    disp_s2d = np.asarray(jlayers.plane_to_s2d(disp_full, r))
    kern, dil = [3] * 7, [1] * 7
    for ci, d in zip((0, 2, 4), (3, 6, 9)):
        kern[ci], dil[ci] = jrepack.packed_geometry(d, r)
    rows = right_full.transpose(0, 1, 3, 2)      # (B,H,C,W) rows-form
    fm = jheads.RefinementS2D(r, hidden=36, kernels=tuple(kern),
                              dilations=tuple(dil))
    v, tm = twin(fm, theads.RefinementS2D(2 * r * r * C + r * r, r,
                                          hidden=36, kernels=kern,
                                          dilations=dil),
                 left, rows, disp_s2d, disp_full)
    want_pred, want_res = fm.apply(v, left, rows, disp_s2d, disp_full,
                                   max_disp=max_disp)
    with torch.no_grad():
        got_pred, got_res = tm(nchw(left), nchw(right_full),
                               nchw(disp_s2d), torch.from_numpy(disp_full),
                               max_disp)
    np.testing.assert_allclose(nhwc(got_res), np.asarray(want_res), rtol=0,
                               atol=STACK_TOL)
    np.testing.assert_allclose(nhwc(got_pred), np.asarray(want_pred),
                               rtol=0, atol=STACK_TOL)


def test_detail_heads():
    cur, pre = rand(15, 1, 6, 9, 12), rand(16, 1, 2, 3, 36)
    fm = jheads.DetailHead()
    v, tm = twin(fm, theads.DetailHead(36, 12), cur, pre)
    want = np.asarray(fm.apply(v, cur, pre)[0])
    with torch.no_grad():
        got = tm(nchw(cur), nchw(pre)).numpy()
    assert got.shape == (1, 6, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)

    cur_s2d, pre = rand(17, 1, 6, 9, 36), rand(18, 1, 6, 9, 12)
    fm = jheads.DetailHeadS2D(3)
    v, tm = twin(fm, theads.DetailHeadS2D(12, 36, 3), cur_s2d, pre)
    want = np.asarray(fm.apply(v, cur_s2d, pre)[0])
    with torch.no_grad():
        got = nhwc(tm(nchw(cur_s2d), nchw(pre)))
    assert got.shape == (1, 6, 9, 9)
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)


@pytest.mark.parametrize("max_disp,window", [(27, 2), (27, 4), (9, 12)])
def test_candidate_availability_windowed(max_disp, window):
    rng = np.random.RandomState(window)
    tm = (rng.rand(2, 5, 40) < 0.15).astype(np.float32)
    # centres off the band on both sides, on integers and half-integers
    center = (rng.rand(2, 5, 40) * (max_disp + 2 * window) - window)
    center[:, 0] = np.round(center[:, 0])
    center[:, 1] = np.floor(center[:, 1]) + 0.5
    center = center.astype(np.float32)
    want = np.asarray(jmatching.candidate_availability_windowed(
        tm, max_disp, center, window))
    got = tmatching.candidate_availability_windowed(
        torch.from_numpy(tm), max_disp, torch.from_numpy(center), window)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def _configs(**kw):
    return JaxConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("mode", ["fixed", "quantile"])
def test_binarise_detail(mode):
    rng = np.random.RandomState(3)
    jc, tc = _configs(thold=0.6, thold_mode=mode, detail_density=0.25)
    for shape in ((2, 9, 12), (2, 9, 4, 5)):     # plane and s2d plane forms
        d = rng.rand(*shape).astype(np.float32)
        want = np.asarray(jdecnet.binarise_detail(jnp.asarray(d), jc))
        got = tdecnet.binarise_detail(torch.from_numpy(d), tc).numpy()
        np.testing.assert_array_equal(got, want)
    l, r = (rng.rand(2, 9, 12).astype(np.float32) for _ in range(2))
    r[1] *= 0.5                                   # the pair shares a cut
    want = jdecnet.binarise_detail_pair(jnp.asarray(l), jnp.asarray(r), jc)
    got = tdecnet.binarise_detail_pair(torch.from_numpy(l),
                                       torch.from_numpy(r), tc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if mode == "quantile":
        # the pooled density is the target, not each view's
        assert abs(float(got[0].mean() + got[1].mean()) / 2 - 0.25) < 0.01
        assert float(got[1][1].mean()) < float(got[0][1].mean())


@pytest.mark.parametrize("mode", ["fixed", "quantile"])
def test_binarise_detail_tied_map_is_empty(mode):
    """A saturated (tied) map: the strict > keeps no pixel, in both
    packages, in both modes (fixed: the tie sits on thold)."""
    jc, tc = _configs(thold=0.9, thold_mode=mode)
    d = np.full((2, 6, 9), 0.9 if mode == "fixed" else 1.0, np.float32)
    want = np.asarray(jdecnet.binarise_detail_pair(
        jnp.asarray(d), jnp.asarray(d), jc)[0])
    got = tdecnet.binarise_detail_pair(torch.from_numpy(d),
                                       torch.from_numpy(d), tc)[0].numpy()
    assert want.sum() == 0
    np.testing.assert_array_equal(got, want)


def test_quantile_linear_matches_jnp_quantile():
    rng = np.random.RandomState(4)
    x = rng.rand(3, 1001).astype(np.float32)
    x[0, :500] = 0.5                              # ties around the cut
    for q in (0.75, 0.5, 0.9, 0.0, 1.0):
        want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=1))
        got = tdecnet.quantile_linear(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(got, want)
