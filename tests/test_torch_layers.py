"""The port's layers, feature pyramid, heads and stateless ops against
their flax/JAX twins, with the flax parameters carried across by the weight
bridge (`decnet_tpu_torch/weights.py`).

Inputs and batch-norm statistics are made with numpy from a seed; JAX takes
NHWC (volumes NDHWC), the port NCHW (NCDHW) — the transposes live here.
Everything runs in f32.  Tolerances: exact where both sides do the same
arithmetic (index shuffles, tap matrices); 1e-5 for one conv unit and the
elementwise ops (XLA and PyTorch sum a convolution's terms in different
orders); 1e-4 for the stacks of 7-30 convs (those differences accumulate)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.nn import feature as jfeature
from decnet_tpu.nn import heads as jheads
from decnet_tpu.nn import layers as jlayers
from decnet_tpu.ops import cost_volume as jcv
from decnet_tpu.ops import detail as jdetail
from decnet_tpu.ops import regression as jreg
from decnet_tpu.ops import resize as jresize
from decnet_tpu_torch.nn import feature as tfeature
from decnet_tpu_torch.nn import heads as theads
from decnet_tpu_torch.nn import layers as tlayers
from decnet_tpu_torch.ops import cost_volume as tcv
from decnet_tpu_torch.ops import detail as tdetail
from decnet_tpu_torch.ops import regression as treg
from decnet_tpu_torch.ops import resize as tresize
from decnet_tpu_torch.weights import load_flax_variables

UNIT_TOL = 1e-5
STACK_TOL = 1e-4


def nchw(x):
    """NHWC (or NDHWC) numpy -> channels-second torch tensor."""
    x = np.asarray(x)
    perm = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    return torch.from_numpy(np.ascontiguousarray(x.transpose(perm)))


def nhwc(t):
    """Channels-second torch tensor -> channels-last numpy."""
    t = t.detach().numpy()
    return t.transpose((0,) + tuple(range(2, t.ndim)) + (1,))


def randomized(variables, seed):
    """numpy copy of flax variables with non-trivial batch-norm affine and
    statistics, so the folding is exercised."""
    rng = np.random.RandomState(seed)

    def walk(tree, coll, name):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, coll, k)
                continue
            v = np.array(v, np.float32)
            if name == "BatchNorm_0":
                if coll == "batch_stats" and k == "mean":
                    v = rng.randn(*v.shape).astype(np.float32) * 0.2
                elif coll == "batch_stats" and k == "var":
                    v = 0.5 + rng.rand(*v.shape).astype(np.float32)
                elif k == "scale":
                    v = 1.0 + 0.2 * rng.randn(*v.shape).astype(np.float32)
                elif k == "bias":
                    v = 0.1 * rng.randn(*v.shape).astype(np.float32)
            out[k] = v
        return out

    return {c: walk(t, c, c) for c, t in variables.items()}


def twin(flax_module, port_module, *inputs, seed=0):
    """Init the flax module on `inputs`, randomize, load the port module
    through the bridge; returns (flax variables, port module)."""
    v = flax_module.init(jax.random.PRNGKey(seed), *inputs)
    v = randomized(v, seed)
    load_flax_variables(port_module, v)
    return v, port_module.eval()


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("k,s,d,p,relu,bn", [(3, 1, 1, 1, True, True),
                                             (3, 3, 1, 1, True, True),
                                             (3, 1, 3, 3, True, True),
                                             (1, 1, 1, 0, False, True),
                                             (3, 1, 1, 1, False, False)])
def test_conv_unit(k, s, d, p, relu, bn):
    x = rand(0, 1, 9, 11, 5)
    fm = jlayers.ConvUnit(6, k, stride=s, dilation=d, padding=p, relu=relu,
                          bn=bn)
    v, tm = twin(fm, tlayers.ConvUnit(5, 6, k, stride=s, dilation=d,
                                      padding=p, relu=relu, bn=bn), x)
    want = np.asarray(fm.apply(v, x))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_deconv_unit():
    x = rand(1, 1, 4, 6, 7)
    fm = jlayers.DeconvUnit(5)
    v, tm = twin(fm, tlayers.DeconvUnit(7, 5), x)
    want = np.asarray(fm.apply(v, x))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == (1, 12, 18, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_conv3d_unit():
    x = rand(2, 1, 3, 5, 6, 7)
    fm = jlayers.Conv3dUnit(4)
    v, tm = twin(fm, tlayers.Conv3dUnit(7, 4), x)
    want = np.asarray(fm.apply(v, x))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_unfold_and_shuffle_helpers():
    x = rand(3, 2, 6, 9, 4)
    np.testing.assert_array_equal(
        nhwc(tlayers.unfold_nonoverlap(nchw(x), 3)),
        np.asarray(jlayers.unfold_nonoverlap(x, 3)))
    # channel order is torch's F.unfold(kernel=k, stride=k) order
    ref = torch.nn.functional.unfold(nchw(x), 3, stride=3).reshape(
        2, 36, 2, 3)
    assert torch.equal(tlayers.unfold_nonoverlap(nchw(x), 3), ref)
    d = rand(4, 2, 5, 7)
    np.testing.assert_array_equal(
        nhwc(tlayers.unfold3x3_replicate(torch.from_numpy(d))),
        np.asarray(jlayers.unfold3x3_replicate(d)))
    p = rand(5, 2, 4, 5, 9)
    np.testing.assert_array_equal(
        nhwc(tlayers.pixel_shuffle(nchw(p), 3)),
        np.asarray(jlayers.pixel_shuffle(p, 3)))
    assert torch.equal(tlayers.pixel_shuffle(nchw(p), 3),
                       torch.nn.functional.pixel_shuffle(nchw(p), 3))


def test_feature_extractor():
    x = np.random.RandomState(6).rand(1, 54, 81, 3).astype(np.float32)
    fm = jfeature.FeatureExtractor(base_channels=4)
    v, tm = twin(fm, tfeature.FeatureExtractor(4), x)
    want = fm.apply(v, x)
    with torch.no_grad():
        got = tm(nchw(x))
    assert [g.shape[1] for g in got] == [108, 36, 12, 4]
    for s, g in enumerate(got):
        np.testing.assert_allclose(nhwc(g), np.asarray(want[f"stage{s}"]),
                                   rtol=0, atol=STACK_TOL,
                                   err_msg=f"stage{s}")


def test_cost_reg_net():
    vol = rand(7, 1, 4, 3, 5, 6)                 # (B,S,H,W,C)
    fm = jheads.CostRegNet(6)
    v, tm = twin(fm, theads.CostRegNet(6), vol)
    want = np.asarray(fm.apply(v, vol))
    with torch.no_grad():
        got = tm(nchw(vol)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)


def test_dynamic_upsampling():
    disp = np.random.RandomState(8).rand(1, 3, 4).astype(np.float32) * 5
    fea = rand(9, 1, 9, 12, 4)
    fm = jheads.DynamicUpsampling(3)
    v, tm = twin(fm, theads.DynamicUpsampling(4, 3), disp, fea)
    want = np.asarray(fm.apply(v, disp, fea))
    with torch.no_grad():
        got = tm(torch.from_numpy(disp), nchw(fea)).numpy()
    assert got.shape == (1, 9, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=STACK_TOL)


def test_soft_attention():
    x = rand(10, 1, 6, 7, 8)
    fm = jheads.SoftAttention(4)
    v, tm = twin(fm, theads.SoftAttention(8, 4), x)
    want = np.asarray(fm.apply(v, x))
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_refinement(stage):
    lf, rf = rand(11, 1, 9, 30, 4), rand(12, 1, 9, 30, 4)
    max_disp = 12
    # inside the warp's clip range [-16, max_disp], where the JAX warp off
    # the TPU (unclipped) and the port's (clipped) agree
    disp = (np.random.RandomState(13).rand(1, 9, 30) * (max_disp + 8)
            - 8).astype(np.float32)
    fm = jheads.Refinement(4, stage_id=stage)
    v, tm = twin(fm, theads.Refinement(4, stage_id=stage), lf, rf, disp)
    want_pred, want_res = fm.apply(v, lf, rf, disp, max_disp=max_disp)
    with torch.no_grad():
        got_pred, got_res = tm(nchw(lf), nchw(rf), torch.from_numpy(disp),
                               max_disp)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res),
                               rtol=0, atol=STACK_TOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               rtol=0, atol=STACK_TOL)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("out_hw", [(6, 9), (36, 45)])
def test_interpolate(mode, out_hw):
    x = rand(14, 2, 12, 15, 3)
    want = np.asarray(jresize.interpolate(x, *out_hw, mode))
    got = nhwc(tresize.interpolate(nchw(x), *out_hw, mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_detail_masks():
    img = np.random.RandomState(16).rand(2, 54, 81, 3).astype(np.float32)
    want = jdetail.detail_masks(jnp.asarray(img), 3, 3, 0.3)
    timg = nchw(img)
    got = tdetail.detail_masks(timg, 3, 3, 0.3)
    norms = tdetail.detail_residuals(timg, 3, 3)[::-1]
    for g, w, n in zip(got, want, norms):
        g, w, n = g.numpy(), np.asarray(w), n.numpy()
        assert g.shape == w.shape
        # a binary mask may flip only where the normalised residual sits on
        # the threshold within f32 noise of the blur and resize sums
        flips = g != w
        assert not (flips & (np.abs(n - 0.3) > 1e-5)).any()
        assert flips.mean() < 1e-3


@pytest.mark.parametrize("max_disp", [2, 5])
def test_build_cost_volume_uniform(max_disp):
    left, right = rand(17, 1, 3, 7, 4), rand(18, 1, 3, 7, 4)
    want = np.asarray(jcv.build_cost_volume_uniform(
        jnp.asarray(left), jnp.asarray(right), max_disp, "cor"))
    got = nhwc(tcv.build_cost_volume_uniform(nchw(left), nchw(right),
                                             max_disp, "cor"))
    np.testing.assert_allclose(got, want, rtol=0, atol=UNIT_TOL)


def test_disparity_regression():
    cost = rand(19, 2, 8, 3, 5) * 3
    want = np.asarray(jreg.disparity_regression(
        cost, jreg.uniform_disp_samples(8, 2, 3, 5)))
    got = treg.disparity_regression(torch.from_numpy(cost),
                                    treg.uniform_disp_samples(8, 2, 3, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=UNIT_TOL)
