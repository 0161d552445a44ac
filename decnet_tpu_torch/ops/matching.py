"""Masked sparse stereo matching and its variance, with the analytic
backward — the port of decnet_tpu/ops/matching.py:115-166, :215-372,
:384-433 and the windowed twin :590-620.

For each left pixel with ref_mask != 0 the disparity band of right pixels
with tar_mask != 0 is scored by a feature dot product; the output is the
softmax-weighted expected disparity and the variance around it, from one
pass of `ops/kernels/spamat.moments`; the backward is
`ops/kernels/spamat.spamat_backward` (the dRef and dTar kernels).  EPS
semantics follow the reference (SM_kernel.cu:45, :100-124): the max is
clamped to >= 1e-6 and both accumulators carry +1e-6, so a query with no
candidate outputs exactly 1.0.
`sparse_matching_with_var` is the model's fused pair; `sparse_matching`
(SpaMat) and `sparse_var` (SpaVar, around a given disparity) are the
reference's two ops on their own, over the same moments.  SpaVar's feature
gradients (`full_grad`) are a loop over d in plain PyTorch on every
device, as the JAX package computes them in XLA.
Features are NCHW, masks (B,H,W).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.kernels import spamat
from decnet_tpu_torch.ops.kernels.spamat import EPS


def candidate_availability(tar_mask: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """1.0 where the band [x - max_disp + 1, x] holds a right pixel with
    tar_mask != 0, else 0.0: a trailing-window max, (B,H,W) f32."""
    B, H, W = tar_mask.shape
    m = (tar_mask != 0).float().reshape(B * H, 1, W)
    m = F.max_pool1d(F.pad(m, (max_disp - 1, 0)), max_disp, stride=1)
    return m.reshape(B, H, W)


def candidate_availability_windowed(tar_mask: torch.Tensor, max_disp: int,
                                    center: torch.Tensor,
                                    window: int) -> torch.Tensor:
    """`candidate_availability` of the windowed scan: 1.0 where some d with
    |d - center| <= window and 0 <= d <= min(max_disp - 1, x) has
    tar_mask[x - d] != 0, else 0.0.  The integer d range is
    [ceil(center - window), floor(center + window)] cut to the band; its
    source columns are counted by a prefix sum and two gathers."""
    m = (tar_mask != 0).float()
    W = m.shape[-1]
    xs = torch.arange(W, device=m.device)
    cf = center.float()
    d_lo = torch.clamp(torch.ceil(cf - window).int(), min=0)
    d_hi = torch.minimum(torch.floor(cf + window).int(),
                         torch.clamp(xs, max=max_disp - 1).int())
    nonempty = d_hi >= d_lo
    p_hi = torch.clamp(xs - d_lo, 0, W - 1).long()   # largest source column
    p_lo = (xs - d_hi).long()                        # smallest source column
    S = torch.cumsum(m, dim=-1)
    cnt_hi = torch.gather(S, -1, p_hi)
    cnt_lo = torch.where(p_lo > 0, torch.gather(
        S, -1, torch.clamp(p_lo - 1, 0, W - 1)), 0.0)
    return (nonempty & (cnt_hi - cnt_lo > 0.5)).float()


class _SparseMatchingWithVar(torch.autograd.Function):
    """Forward: the moments, then (out, var); saves ref, tar, the masks,
    center, out, sum_sim = where(refm, EPS + se, 0) and
    max_cost = where(refm, m, 0).  Backward: `spamat_backward` with the
    gradient of `out` only -- the variance gets none (the reference
    computes it under no_grad), and neither do the masks or center."""

    @staticmethod
    def forward(ctx, ref, tar, ref_mask, tar_mask, center, max_disp, window,
                use_kernel):
        moments = spamat.moments if use_kernel else spamat.moments_plain
        m, se, sed, sed2 = moments(ref, tar, ref_mask, tar_mask, max_disp,
                                   center, window)
        refm = ref_mask != 0
        out = torch.where(refm, (EPS + sed) / (EPS + se), 0.0)
        svar = sed2 - 2.0 * out * sed + out * out * se
        var = torch.where(refm, (EPS + svar) / (EPS + se), 0.0)
        sum_sim = torch.where(refm, EPS + se, 0.0)
        max_cost = torch.where(refm, m, 0.0)
        ctx.save_for_backward(ref, tar, ref_mask, tar_mask, center, out,
                              sum_sim, max_cost)
        ctx.cfg = (max_disp, window, use_kernel)
        ctx.mark_non_differentiable(var)
        return out, var

    @staticmethod
    def backward(ctx, g_out, _g_var):
        ref, tar, ref_mask, tar_mask, center, out, sum_sim, max_cost = \
            ctx.saved_tensors
        max_disp, window, use_kernel = ctx.cfg
        backward = (spamat.spamat_backward if use_kernel
                    else spamat.spamat_backward_plain)
        gref, gtar = backward(ref, tar, ref_mask, tar_mask, out, sum_sim,
                              max_cost, g_out.contiguous(), max_disp, center,
                              window)
        return gref, gtar, None, None, None, None, None, None


def sparse_matching_with_var(ref: torch.Tensor, tar: torch.Tensor,
                             ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                             max_disp: int,
                             center: Optional[torch.Tensor] = None,
                             window: int = 0, use_kernel: bool = True,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(expected disparity, variance), each (B,H,W) f32, zero where
    ref_mask == 0; differentiable with respect to ref and tar through the
    expected disparity.  The variance uses the moment identity
    sum e (d - out)^2 = sed2 - 2 out sed + out^2 se.

    With `center` and window > 0 only |d - center| <= window is scanned (the
    twin of sparse_matching_with_var_windowed).  `use_kernel` (default)
    runs the kernel wrappers forward and backward -- the CUDA kernels on a
    card, their plain versions on CPU tensors; False runs the plain
    versions on any device, which is how a card run holds the kernel path
    against the plain one."""
    if center is None or window <= 0:
        center, window = None, 0
    return _SparseMatchingWithVar.apply(ref, tar, ref_mask, tar_mask, center,
                                        int(max_disp), int(window),
                                        bool(use_kernel))


def _masks(ref_mask, tar_mask):
    return ref_mask.float().contiguous(), tar_mask.float().contiguous()


def sparse_matching(ref: torch.Tensor, tar: torch.Tensor,
                    ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                    max_disp: int, use_kernel: bool = True) -> torch.Tensor:
    """SpaMat (decnet_tpu/ops/matching.py::sparse_matching): the expected
    disparity (B,H,W) f32, 0 where ref_mask == 0 and 1.0 where the band
    holds no candidate; differentiable with respect to ref and tar.  It is
    the fused pair's first output, whose backward is SpaMat's."""
    ref_mask, tar_mask = _masks(ref_mask, tar_mask)
    return sparse_matching_with_var(ref.contiguous(), tar.contiguous(),
                                    ref_mask, tar_mask, max_disp,
                                    use_kernel=use_kernel)[0]


def spavar_backward_feats(ref: torch.Tensor, tar: torch.Tensor,
                          ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                          disparity: torch.Tensor, out: torch.Tensor,
                          sum_sim: torch.Tensor, max_cost: torch.Tensor,
                          g: torch.Tensor, max_disp: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SpaVar's feature gradients (decnet_tpu/ops/matching.py::
    _spavar_bwd_feats_xla): the dRef/dTar sums of `spamat_backward_plain`
    with the query weight e * ((d - disparity)^2 - out) in place of
    e * (d - out), as a loop over d in f32."""
    B, C, H, W = ref.shape
    dp = max_disp - 1
    ref32 = ref.float()
    tarp = F.pad(tar.float(), (dp, 0))
    okp = F.pad((tar_mask != 0).float(), (dp, 0))
    refm = ref_mask != 0
    w = spamat.query_weight(g, ref_mask, sum_sim)
    disparity, out = disparity.float(), out.float()
    max_cost = max_cost.float()
    gref = torch.zeros_like(ref32)
    gtarp = torch.zeros_like(tarp)
    for d in range(max_disp):
        lo = dp - d
        tar_d = tarp[..., lo:lo + W]
        ok = (okp[..., lo:lo + W] > 0) & refm
        s = (ref32 * tar_d).sum(dim=1)
        e = torch.where(ok, torch.exp(s - max_cost), 0.0)
        coef = (e * ((d - disparity) ** 2 - out) * w)[:, None]
        gref += coef * tar_d
        gtarp[..., lo:lo + W] += coef * ref32
    gref = gref * refm[:, None]
    gtar = gtarp[..., dp:] * (tar_mask != 0)[:, None]
    return gref.to(ref.dtype), gtar.to(tar.dtype)


class _SparseVar(torch.autograd.Function):
    """SpaVar: out = (EPS + sum e (d - disparity)^2) / (EPS + se) where
    ref_mask != 0, else 0, from the moments; the disparity's gradient
    -2 g (sed - disparity se) / sum_sim; the features' gradients zero, or
    `spavar_backward_feats` with full_grad."""

    @staticmethod
    def forward(ctx, ref, tar, ref_mask, tar_mask, disparity, max_disp,
                full_grad, use_kernel):
        moments = spamat.moments if use_kernel else spamat.moments_plain
        m, se, sed, sed2 = moments(ref, tar, ref_mask, tar_mask, max_disp)
        refm = ref_mask != 0
        sum_sim = torch.where(refm, EPS + se, 0.0)
        max_cost = torch.where(refm, m, 0.0)
        disp = disparity.float()
        svar = sed2 - 2.0 * disp * sed + disp * disp * se
        out = torch.where(refm, (EPS + svar) / (EPS + se), 0.0)
        ctx.save_for_backward(ref, tar, ref_mask, tar_mask, disparity, out,
                              sum_sim, max_cost, sed, se)
        ctx.cfg = (max_disp, full_grad)
        return out

    @staticmethod
    def backward(ctx, g):
        (ref, tar, ref_mask, tar_mask, disparity, out, sum_sim, max_cost,
         sed, se) = ctx.saved_tensors
        max_disp, full_grad = ctx.cfg
        refm = ref_mask != 0
        inv_ss = torch.where(refm, 1.0 / torch.where(refm, sum_sim, 1.0),
                             0.0)
        acc = sed - disparity.float() * se
        gdisp = (-2.0 * g * acc * inv_ss).to(disparity.dtype)
        if full_grad:
            gref, gtar = spavar_backward_feats(
                ref, tar, ref_mask, tar_mask, disparity, out, sum_sim,
                max_cost, g, max_disp)
        else:
            # the reference runs SpaVar under no_grad
            gref, gtar = torch.zeros_like(ref), torch.zeros_like(tar)
        return gref, gtar, None, None, gdisp, None, None, None


def sparse_var(ref: torch.Tensor, tar: torch.Tensor, ref_mask: torch.Tensor,
               tar_mask: torch.Tensor, disparity: torch.Tensor,
               max_disp: int, full_grad: bool = False,
               use_kernel: bool = True) -> torch.Tensor:
    """SpaVar (decnet_tpu/ops/matching.py::sparse_var): the softmax-
    weighted variance of the band around `disparity` (B,H,W), f32, 0 where
    ref_mask == 0.  Differentiable with respect to `disparity`, and to the
    features only with `full_grad` (their gradients are zero otherwise, as
    torch.no_grad gives the reference's model).  The moments go through
    the kernel wrapper with `use_kernel` (default)."""
    ref_mask, tar_mask = _masks(ref_mask, tar_mask)
    return _SparseVar.apply(ref.contiguous(), tar.contiguous(), ref_mask,
                            tar_mask, disparity, int(max_disp),
                            bool(full_grad), bool(use_kernel))
