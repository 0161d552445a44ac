"""The port's sparse-matching backward (plain version of the CUDA kernels
in `decnet_tpu_torch/csrc/spamat_backward.cu`), its autograd Function, and
the differentiable warp, against the JAX package: the Pallas backward
kernels in interpret mode, the XLA backward scan and jax.vjp of the
custom_vjp ops.

Inputs are made with numpy from a seed; JAX takes NHWC (Pallas rows-form
(B,H,C,W)), the port NCHW (the transposes live here).  Tolerance rtol 1e-5,
atol 1e-5 in f32 on gradients normalised to unit scale: the versions sum
the same products over d (and Pallas over the band as a matrix product) in
different orders, which moves the last bits of each f32 sum."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.ops import matching as jmatching
from decnet_tpu.ops import warp as jwarp
from decnet_tpu.ops.pallas import spamat as jspamat
from decnet_tpu.ops.pallas import warp as jpwarp
from decnet_tpu_torch.ops import matching as tmatching
from decnet_tpu_torch.ops.kernels import spamat as tspamat
from decnet_tpu_torch.ops.kernels import warp as tkwarp

RTOL, ATOL = 1e-5, 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def make_inputs(seed, B, H, W, C, max_disp, density=0.5, no_cand_row=False,
                feat_scale=1.0):
    rng = np.random.RandomState(seed)
    ref = (rng.randn(B, H, W, C) * feat_scale).astype(np.float32)
    tar = (rng.randn(B, H, W, C) * feat_scale).astype(np.float32)
    rm = (rng.rand(B, H, W) < density).astype(np.float32)
    tm = (rng.rand(B, H, W) < density).astype(np.float32)
    if no_cand_row:
        # row 0: no right-view candidate at all; row 1: candidates only
        # right of column max_disp, so its leftmost queries have none
        tm[:, 0] = 0.0
        tm[:, 1, :max_disp + 2] = 0.0
        rm[:, :2] = 1.0
    center = (rng.rand(B, H, W) * max_disp).astype(np.float32)
    g = rng.randn(B, H, W).astype(np.float32)
    return ref, tar, rm, tm, center, g


def forward_residuals(ref, tar, rm, tm, max_disp, center, window):
    """out, sum_sim, max_cost as the JAX forward saves them."""
    kw = dict(center=center, window=window) if window else {}
    m, se, sed, _ = jmatching.matching_moments(ref, tar, rm, tm, max_disp,
                                               **kw)
    refm = rm != 0
    eps = jmatching.EPS
    out = np.asarray(jnp.where(refm, (eps + sed) / (eps + se), 0.0))
    sum_sim = np.asarray(jnp.where(refm, eps + se, 0.0))
    max_cost = np.asarray(jnp.where(refm, m, 0.0))
    return out, sum_sim, max_cost


def assert_grads_close(got, want, msg, tol=ATOL):
    """got/want same layout; normalised by the largest magnitude."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=tol, atol=tol, err_msg=msg)


CASES = [
    # (B, H, W, C, max_disp, window, no_cand_row, feat_scale)
    (1, 3, 40, 8, 8, 0, False, 1.0),
    (2, 4, 150, 4, 24, 0, True, 1.0),     # W not a multiple of 128, no cand
    (1, 3, 70, 6, 16, 3, False, 1.0),     # windowed
    (2, 4, 150, 4, 24, 2, True, 1.0),     # windowed, no-candidate queries
    (1, 3, 60, 8, 12, 0, False, 30.0),    # masked keys outscore max_cost:
    #                                       no NaN may come of exp overflow
]


@pytest.mark.parametrize("B,H,W,C,max_disp,window,no_cand,fs", CASES)
def test_backward_plain_matches_jax(B, H, W, C, max_disp, window, no_cand,
                                    fs):
    ref, tar, rm, tm, center, g = make_inputs(0, B, H, W, C, max_disp,
                                              no_cand_row=no_cand,
                                              feat_scale=fs)
    out, ss, mc = forward_residuals(ref, tar, rm, tm, max_disp, center,
                                    window)
    wkw = dict(center=center, window=window) if window else {}
    xla_ref, xla_tar = jmatching._spamat_bwd_xla(ref, tar, rm, tm, out, ss,
                                                 mc, g, max_disp, **wkw)
    rows = lambda x: x.transpose(0, 1, 3, 2)        # NHWC <-> rows-form
    pal_ref, pal_tar = jspamat.spamat_backward_rows(
        rows(ref), rows(tar), rm, tm, out, ss, mc, g, max_disp, **wkw)
    tkw = dict(center=torch.from_numpy(center), window=window) if window \
        else {}
    t = torch.from_numpy
    got_ref, got_tar = tspamat.spamat_backward_plain(
        nchw(ref), nchw(tar), t(rm), t(tm), t(out), t(ss), t(mc), t(g),
        max_disp, **tkw)
    for got, xla, pal, name in ((got_ref, xla_ref, pal_ref, "grad_ref"),
                                (got_tar, xla_tar, pal_tar, "grad_tar")):
        assert torch.isfinite(got).all(), name
        assert_grads_close(to_nhwc(got), xla, f"{name} vs XLA")
        # at feature scale 30 the scores reach ~7e3, whose f32 rounding
        # (~5e-4) differs between the matrix-product sum of Pallas and the
        # channel loop; exp turns that into ~5e-4 relative on e: 1e-3 there
        assert_grads_close(to_nhwc(got), rows(np.asarray(pal)),
                           f"{name} vs Pallas", ATOL if fs == 1.0 else 1e-3)
    # zero at inactive queries and at masked-out keys
    assert (got_ref.numpy().transpose(0, 2, 3, 1)[rm == 0] == 0).all()
    assert (got_tar.numpy().transpose(0, 2, 3, 1)[tm == 0] == 0).all()
    assert np.abs(to_nhwc(got_ref)).max() > 0


@pytest.mark.parametrize("window", [0, 3])
def test_matching_function_grads_match_jax_vjp(window):
    B, H, W, C, D = 2, 3, 50, 6, 16
    ref, tar, rm, tm, center, g = make_inputs(3, B, H, W, C, D,
                                              no_cand_row=True)
    gv = np.random.RandomState(4).randn(B, H, W).astype(np.float32)
    if window:
        fn = lambda r, t: jmatching.sparse_matching_with_var_windowed(
            r, t, rm, tm, center, D, window, "xla")
    else:
        fn = lambda r, t: jmatching.sparse_matching_with_var(r, t, rm, tm, D,
                                                             "xla")
    (w_out, w_var), vjp = jax.vjp(fn, jnp.asarray(ref), jnp.asarray(tar))
    w_gref, w_gtar = vjp((g, gv))

    r, t = nchw(ref).requires_grad_(), nchw(tar).requires_grad_()
    tkw = dict(center=torch.from_numpy(center), window=window) if window \
        else {}
    out, var = tmatching.sparse_matching_with_var(
        r, t, torch.from_numpy(rm), torch.from_numpy(tm), D, **tkw)
    assert not var.requires_grad        # the variance carries no gradient
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(w_out),
                               rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(g)).sum().backward()
    assert_grads_close(to_nhwc(r.grad), w_gref, "grad_ref")
    assert_grads_close(to_nhwc(t.grad), w_gtar, "grad_tar")


def test_matching_use_kernel_false_is_the_plain_path_on_cpu():
    ref, tar, rm, tm, _, g = make_inputs(5, 1, 2, 40, 4, 8)
    grads = []
    for use_kernel in (True, False):
        r = nchw(ref).requires_grad_()
        out, _ = tmatching.sparse_matching_with_var(
            r, nchw(tar), torch.from_numpy(rm), torch.from_numpy(tm), 8,
            use_kernel=use_kernel)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append(r.grad)
    assert torch.equal(*grads)


def test_learned_temperature_gradient_matches_jax():
    B, H, W, C, D = 1, 3, 40, 6, 12
    ref, tar, rm, tm, _, g = make_inputs(6, B, H, W, C, D)
    logt0 = np.float32(np.log(3.0))

    def jloss(logt):
        q = ref * jnp.exp(logt)
        out, _ = jmatching.sparse_matching_with_var(q, tar, rm, tm, D, "xla")
        return jnp.sum(out * g)

    want = float(jax.grad(jloss)(jnp.float32(logt0)))
    logt = torch.tensor(logt0, requires_grad=True)
    q = nchw(ref) * torch.exp(logt)
    out, _ = tmatching.sparse_matching_with_var(
        q, nchw(tar), torch.from_numpy(rm), torch.from_numpy(tm), D)
    (out * torch.from_numpy(g)).sum().backward()
    assert want != 0.0
    np.testing.assert_allclose(float(logt.grad), want, rtol=1e-4)


def test_warp_function_grads_match_jax_vjp():
    rng = np.random.RandomState(7)
    B, H, W, C, D = 2, 6, 40, 5, 24
    img = rng.randn(B, H, W, C).astype(np.float32)
    disp = (rng.rand(B, H, W) * (D + 16) - 16).astype(np.float32)
    gout = rng.randn(B, H, W, C).astype(np.float32)
    out, vjp = jax.vjp(lambda i, d: jpwarp.warp_by_disparity_fast(i, d, D),
                       img, disp)
    w_gimg, w_gdisp = vjp(gout)
    f = nchw(img).requires_grad_()
    d = torch.from_numpy(disp).requires_grad_()
    got = tkwarp.warp_with_grad(f, d, D)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(out), atol=ATOL)
    (got * nchw(gout)).sum().backward()
    assert_grads_close(to_nhwc(f.grad), w_gimg, "grad image")
    assert_grads_close(d.grad.numpy(), w_gdisp, "grad disparity")
    # the backward is the unclipped reference warp's VJP
    _, ref_vjp = jax.vjp(jwarp.warp_by_disparity, img, disp)
    assert_grads_close(d.grad.numpy(), ref_vjp(gout)[1], "vs XLA warp")


def test_backward_wrapper_uses_plain_version_on_cpu():
    ref, tar, rm, tm, center, g = make_inputs(8, 1, 2, 30, 4, 6)
    out, ss, mc = forward_residuals(ref, tar, rm, tm, 6, center, 0)
    t = torch.from_numpy
    args = (nchw(ref), nchw(tar), t(rm), t(tm), t(out), t(ss), t(mc), t(g),
            6)
    before = (tspamat.spamat_dref.launches, tspamat.spamat_dtar.launches)
    got = tspamat.spamat_backward(*args)
    want = tspamat.spamat_backward_plain(*args)
    assert (tspamat.spamat_dref.launches,
            tspamat.spamat_dtar.launches) == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_backward_wrappers_refuse_other_devices():
    x = torch.empty(1, 4, 2, 8, device="meta")
    m = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tspamat.spamat_backward(x, x, m, m, m, m, m, m, 4)
    xc = torch.zeros(1, 4, 2, 8)
    mc = torch.zeros(1, 2, 8)
    for kernel in (tspamat.spamat_dref, tspamat.spamat_dtar):
        with pytest.raises(ValueError):
            kernel(xc, xc, mc, mc, mc, mc, 4)
