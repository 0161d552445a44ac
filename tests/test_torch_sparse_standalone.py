"""SpaMat and SpaVar on their own (decnet_tpu_torch/ops/matching.py::
sparse_matching, sparse_var) against decnet_tpu's custom_vjp ops on their
XLA path: the forward, the gradients of both feature maps and SpaVar's
disparity gradient, default and with full_grad, in f32 on the CPU.

The port runs the plain versions of the moments and dRef/dTar kernels
here; tests/test_torch_backward.py holds those against the Pallas kernels
in interpret mode.  Tolerances as there: 1e-5 on gradients normalised to
unit scale, 1e-5 relative on outputs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.ops import matching as jmatching
from decnet_tpu_torch.ops import matching as tmatching
from tests.test_torch_backward import (assert_grads_close, make_inputs,
                                       nchw, to_nhwc)

B, H, W, C, D = 2, 5, 24, 8, 9


def jax_grads(fn, args, g, argnums):
    out, vjp = jax.vjp(fn, *args)
    return np.asarray(out), vjp(jnp.asarray(g))


@pytest.mark.parametrize("no_cand", [False, True], ids=["dense", "no_cand"])
def test_sparse_matching_matches_jax(no_cand):
    ref, tar, rm, tm, _, g = make_inputs(3, B, H, W, C, D,
                                         no_cand_row=no_cand)
    fn = lambda r, t: jmatching.sparse_matching(r, t, rm, tm, D, "xla")
    want, (gr, gt) = jax_grads(fn, (ref, tar), g, (0, 1))
    tr = nchw(ref).requires_grad_()
    tt = nchw(tar).requires_grad_()
    out = tmatching.sparse_matching(tr, tt, torch.from_numpy(rm),
                                    torch.from_numpy(tm), D)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    # 0 where ref_mask == 0; the 1.0 sentinel where no candidate exists
    assert (out.detach().numpy()[rm == 0] == 0).all()
    if no_cand:
        assert (out.detach().numpy()[:, 0][rm[:, 0] != 0] == 1.0).all()
    out.backward(torch.from_numpy(g))
    assert_grads_close(to_nhwc(tr.grad), np.asarray(gr), "ref")
    assert_grads_close(to_nhwc(tt.grad), np.asarray(gt), "tar")


@pytest.mark.parametrize("full_grad", [False, True],
                         ids=["default", "full_grad"])
def test_sparse_var_matches_jax(full_grad):
    ref, tar, rm, tm, center, g = make_inputs(4, B, H, W, C, D,
                                              no_cand_row=True)
    disp = center
    fn = lambda r, t, d: jmatching.sparse_var(r, t, rm, tm, d, D, "xla",
                                              full_grad)
    want, (gr, gt, gd) = jax_grads(fn, (ref, tar, disp), g, (0, 1, 2))
    tr = nchw(ref).requires_grad_()
    tt = nchw(tar).requires_grad_()
    td = torch.from_numpy(disp).requires_grad_()
    out = tmatching.sparse_var(tr, tt, torch.from_numpy(rm),
                               torch.from_numpy(tm), td, D,
                               full_grad=full_grad)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-4)
    assert (out.detach().numpy()[rm == 0] == 0).all()
    out.backward(torch.from_numpy(g))
    assert_grads_close(td.grad.numpy(), np.asarray(gd), "disparity")
    if full_grad:
        assert np.abs(np.asarray(gr)).max() > 0
        assert_grads_close(to_nhwc(tr.grad), np.asarray(gr), "ref")
        assert_grads_close(to_nhwc(tt.grad), np.asarray(gt), "tar")
    else:
        assert not tr.grad.any() and not tt.grad.any()
        assert not np.asarray(gr).any() and not np.asarray(gt).any()


def test_sparse_var_at_sparse_matching_is_the_fused_variance():
    """SpaVar around SpaMat's output is the model's fused variance (the
    moment identity the fused op relies on)."""
    ref, tar, rm, tm, _, _ = make_inputs(5, B, H, W, C, D)
    args = [nchw(ref), nchw(tar), torch.from_numpy(rm), torch.from_numpy(tm)]
    out = tmatching.sparse_matching(*args, D)
    var = tmatching.sparse_var(*args, out, D)
    fused_out, fused_var = tmatching.sparse_matching_with_var(*args, D)
    torch.testing.assert_close(out, fused_out, rtol=0, atol=0)
    torch.testing.assert_close(var, fused_var, rtol=1e-5, atol=1e-4)
