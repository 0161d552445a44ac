"""The port's sparse-matching moments (plain version of the CUDA kernel
`decnet_tpu_torch/csrc/spamat_moments.cu`) against the JAX package: the
Pallas kernel in interpret mode and the XLA scan.

Inputs are made with numpy from a seed; JAX takes NHWC features, the port
NCHW (the transposes live here).  Tolerance rtol 1e-5, atol 1e-5 in f32:
the three versions take the max and sums in different orders (two-pass
softmax in Pallas, online rescaling in the scan), which moves the last few
bits of each f32 accumulator and nothing more."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.ops import matching as jmatching
from decnet_tpu.ops.pallas import spamat as jspamat
from decnet_tpu_torch.ops import matching as tmatching
from decnet_tpu_torch.ops.kernels import spamat as tspamat

RTOL, ATOL = 1e-5, 1e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def make_inputs(seed, B, H, W, C, max_disp, density=0.5, no_cand_row=False):
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    tar = rng.randn(B, H, W, C).astype(np.float32)
    rm = (rng.rand(B, H, W) < density).astype(np.float32)
    tm = (rng.rand(B, H, W) < density).astype(np.float32)
    if no_cand_row:
        # row 0: no right-view candidate anywhere -> sentinel output 1.0;
        # row 1: candidates only right of column max_disp, so the leftmost
        # queries of that row have none either
        tm[:, 0] = 0.0
        tm[:, 1, :max_disp + 2] = 0.0
        rm[:, :2] = 1.0
    center = (rng.rand(B, H, W) * max_disp).astype(np.float32)
    return ref, tar, rm, tm, center


CASES = [
    # (B, H, W, C, max_disp, window, no_cand_row)
    (1, 3, 40, 8, 8, 0, False),
    (2, 4, 150, 4, 24, 0, True),      # W not a multiple of the 128 tile
    (1, 3, 300, 5, 60, 0, True),      # several tiles, band crosses tiles
    (1, 3, 70, 6, 16, 3, False),      # windowed
    (2, 4, 150, 4, 24, 2, True),      # windowed, no-candidate queries
]


@pytest.mark.parametrize("B,H,W,C,max_disp,window,no_cand", CASES)
def test_moments_plain_matches_jax(B, H, W, C, max_disp, window, no_cand):
    ref, tar, rm, tm, center = make_inputs(0, B, H, W, C, max_disp,
                                           no_cand_row=no_cand)
    kw = dict(center=center, window=window) if window else {}
    want_pallas = jspamat.moments(ref, tar, rm, tm, max_disp, **kw)
    want_xla = jmatching.matching_moments(ref, tar, rm, tm, max_disp, **kw)
    tkw = dict(center=torch.from_numpy(center), window=window) if window \
        else {}
    got = tspamat.moments_plain(nchw(ref), nchw(tar), torch.from_numpy(rm),
                                torch.from_numpy(tm), max_disp, **tkw)
    active = rm != 0
    for name, g, wp, wx in zip(("m", "se", "sed", "sed2"), got, want_pallas,
                               want_xla):
        g = g.numpy()[active]
        np.testing.assert_allclose(g, np.asarray(wp)[active], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(g, np.asarray(wx)[active], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} vs XLA")


@pytest.mark.parametrize("B,H,W,C,max_disp", [(1, 3, 40, 8, 8),
                                              (2, 4, 150, 4, 24)])
def test_sparse_matching_with_var_matches_jax(B, H, W, C, max_disp):
    ref, tar, rm, tm, _ = make_inputs(1, B, H, W, C, max_disp,
                                      no_cand_row=True)
    want_out, want_var = jmatching.sparse_matching_with_var(
        ref, tar, rm, tm, max_disp, "xla")
    got_out, got_var = tmatching.sparse_matching_with_var(
        nchw(ref), nchw(tar), torch.from_numpy(rm), torch.from_numpy(tm),
        max_disp)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=RTOL, atol=ATOL)
    # the variance cancels sed2 - 2 out sed + out^2 se (terms ~ d^2 se), so
    # f32 rounding of the moments shows up scaled by max_disp^2
    np.testing.assert_allclose(got_var.numpy(), np.asarray(want_var),
                               rtol=RTOL, atol=ATOL * max_disp ** 2)
    # queries with no candidate output exactly the sentinel 1.0
    cand = np.asarray(jmatching.candidate_availability(jnp.asarray(tm),
                                                       max_disp))
    sentinel = (rm != 0) & (cand == 0)
    assert sentinel.any()
    assert (got_out.numpy()[sentinel] == 1.0).all()
    assert (got_out.numpy()[rm == 0] == 0.0).all()


@pytest.mark.parametrize("max_disp", [1, 7, 24])
def test_candidate_availability_matches_jax(max_disp):
    rng = np.random.RandomState(max_disp)
    tm = (rng.rand(2, 5, 60) < 0.1).astype(np.float32)
    want = np.asarray(jmatching.candidate_availability(jnp.asarray(tm),
                                                       max_disp))
    got = tmatching.candidate_availability(torch.from_numpy(tm), max_disp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_moments_wrapper_uses_plain_version_on_cpu():
    ref, tar, rm, tm, _ = make_inputs(2, 1, 2, 30, 4, 6)
    args = (nchw(ref), nchw(tar), torch.from_numpy(rm), torch.from_numpy(tm),
            6)
    before = tspamat.moments.launches
    got = tspamat.moments(*args)
    want = tspamat.moments_plain(*args)
    assert tspamat.moments.launches == before      # no kernel on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_moments_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 2, 8, device="meta")
    m = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        tspamat.moments(x, x, m, m, 4)
