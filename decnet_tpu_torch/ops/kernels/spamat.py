"""Sparse matching, forward moments and backward: the CUDA kernels
`csrc/spamat_moments.cu`, `csrc/spamat_backward.cu` (dRef) and
`csrc/spamat_dtar.cu`, their launch plans, and their plain PyTorch
versions.

Port of decnet_tpu/ops/pallas/spamat.py::_moments_kernel (the TPU kernel)
and of its XLA twin decnet_tpu/ops/matching.py::matching_moments (:67-112),
whose loop over d `moments_plain` reproduces.  For each query with
ref_mask != 0 they compute, over the band d in [0, max_disp) of keys
tar[..., w - d] with tar_mask != 0 (and |d - center| <= window when
window > 0), the masked-softmax moments

    m = max(max_d s(d), 1e-6),  se = sum e,  sed = sum e*d,  sed2 = sum e*d^2

with e = exp(s(d) - m) and s(d) the feature dot product.  A query with no
candidate gets se = sed = sed2 = 0.  Queries with ref_mask == 0 may hold any
value: every consumer gates by ref_mask.

The backward is the port of decnet_tpu/ops/pallas/spamat.py::_dref_kernel
and ::_dtar_kernel (the TPU kernels) and of their XLA twin
decnet_tpu/ops/matching.py::_spamat_bwd_xla (:178-211), whose loop over d
`spamat_backward_plain` reproduces.  With w = g / sum_sim on queries with
ref_mask != 0 (0 elsewhere) and e(q,k) = exp(s(q,k) - max_cost[q]) over the
candidate pairs of the forward:

    grad_ref[q] = w[q] * sum_k e(q,k) * (d - out[q]) * tar[k]
    grad_tar[k] = sum_q e(q,k) * (d - out[q]) * w[q] * ref[q],  k unmasked

Features are NCHW (B,C,H,W), bf16 or f32 (scores accumulate in f32); masks,
center and the per-query maps are (B,H,W) f32; the moments are (B,H,W) f32
and the gradients come back in the features' dtype.

The launch geometry of the three kernels lives here, where the CPU tests
reach it: `moments_plan`, `dref_plan` and `dtar_plan` pick the columns a
block owns, its threads and its shared memory; `ops/kernels/staging.py`
mirrors their cp.async staging (csrc/staging.cuh) granule by granule.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from decnet_tpu_torch.ops.kernels import build
from decnet_tpu_torch.ops.kernels.staging import (GRAN_BYTES, MAP_GE,
                                                  MAX_THREADS, MIN_THREADS,
                                                  SMEM_BUDGET, SMEM_MAX,
                                                  TARGET_BLOCKS, align16,
                                                  aligned, row_stride)

EPS = 1e-6
_NEG = -3.0e38  # the reference's stand-in for -inf

# spamat_moments: 5 inputs, 4 outputs, B, C, H, W, max_disp, window,
# is_bf16, then the plan's tile, span, threads, lanes, smem, and the stream
_SIGNATURES = {"spamat_moments": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
               + [ctypes.c_void_p]}
# spamat_dref and spamat_dtar: 7 inputs, 1 output, B, C, H, W, max_disp,
# window, is_bf16, then the plan's tile, span, threads, lanes, smem, and the
# stream
_BWD_SIGNATURES = {name: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12
                   + [ctypes.c_void_p]
                   for name in ("spamat_dref", "spamat_dtar")}
MAX_DREF_CHANNELS = 72  # dRef's chunk lanes are a compile-time count, one
#                         instance per model stage: C <= 8, 24, 72

LANE_CHANNELS = 8         # channels a lane holds in dRef and dTar: one chunk
MAX_MOMENTS_CHANNELS = 72  # the moments kernel keeps a query's features
#                            in registers: one instance for C <= 8, 24, 72
MIN_TILE = 32             # a block keeps at least this many columns


@dataclasses.dataclass(frozen=True)
class Plan:
    """A kernel's launch: `segs` blocks per (b, h) row, each owning `tile`
    columns (queries for the moments and dRef, keys for dTar) and a window
    of `span` columns of the other side, with `threads` threads in groups
    of `lanes` per owned column and `smem` bytes of dynamic shared
    memory."""
    tile: int
    segs: int
    span: int
    threads: int
    lanes: int
    smem: int


def _smem(C, H, W, tile, span, esize, tile_maps, span_maps, key_vecs=0):
    """Shared bytes of a block: the staged feature rows of its `tile`
    owned columns and of its `span`-column window, the window's features
    slot-major, `tile_maps` / `span_maps` staged f32 maps, `key_vecs`
    16-byte values per window column, and the slot and queue lists."""
    ge, cp = GRAN_BYTES // esize, -(-C // 8) * 8
    return (align16(esize * C * row_stride(tile, ge, H * W))
            + align16(esize * C * row_stride(span, ge, H * W))
            + align16(esize * cp * span)
            + tile_maps * align16(4 * row_stride(tile, MAP_GE, 0))
            + span_maps * align16(4 * row_stride(span, MAP_GE, 0))
            + align16(16 * key_vecs * span) + align16(4 * (span + 1))
            + align16(4 * span) + align16(4 * tile))


def _plan(B, H, W, D, smem_fn, lanes):
    rows = B * H
    segs = max(1, min(-(-TARGET_BLOCKS // rows), W // MIN_TILE))
    while True:
        tile = -(-W // segs)
        span = min(tile + D - 1, W)
        smem = smem_fn(tile, span)
        if smem <= SMEM_BUDGET or tile == 1:
            break
        segs += 1
    segs = -(-W // tile)
    if smem > SMEM_MAX:
        raise ValueError(f"no plan fits in {SMEM_MAX} bytes of shared "
                         f"memory (W={W}, D={D}): {smem} at tile {tile}")
    threads = min(MAX_THREADS,
                  max(MIN_THREADS, -(-tile * lanes // 32) * 32))
    return Plan(tile, segs, span, threads, lanes, smem)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def candidate_lanes(D: int, cap: int = 32) -> int:
    """Lanes that share one query's (or key's) band: a power of two near
    D / 32, so that at ~20% density each walks a few candidates, at most
    `cap`."""
    return min(cap, _pow2_at_least(-(-D // 32)))


def moments_plan(B: int, C: int, H: int, W: int, D: int,
                 esize: int) -> Plan:
    """The moments kernel's launch for (B,C,H,W) features of `esize`
    bytes: whole rows unless B*H rows leave fewer than TARGET_BLOCKS
    blocks or a row overflows SMEM_BUDGET; `candidate_lanes(D)` lanes per
    query."""
    return _plan(B, H, W, D,
                 lambda t, s: _smem(C, H, W, t, s, esize, 2, 1),
                 candidate_lanes(D))


def dtar_lanes(C: int, D: int) -> int:
    """Lanes per key in dTar: a power of two of chunk lanes (each owns 8
    channels) times the candidate lanes that fit in a warp."""
    chunk = _pow2_at_least(-(-C // LANE_CHANNELS))
    if chunk > 32:
        raise ValueError(f"C={C} needs more than a warp per key")
    return chunk * candidate_lanes(D, 32 // chunk)


def dtar_plan(B: int, C: int, H: int, W: int, D: int, esize: int) -> Plan:
    """The dTar kernel's launch, tiled as `moments_plan` over key columns,
    with `dtar_lanes(C, D)` lanes per key."""
    return _plan(B, H, W, D,
                 lambda t, s: _smem(C, H, W, t, s, esize, 1, 4, 1),
                 dtar_lanes(C, D))


def dref_lanes(C: int, D: int) -> int:
    """Lanes per query in dRef: the chunk lanes of C's instance (C <= 8,
    24, 72: 1, 4, 16 lanes of 8 channels) times the candidate lanes that
    fit in a warp."""
    if C > MAX_DREF_CHANNELS:
        raise ValueError(f"dRef takes C <= {MAX_DREF_CHANNELS}, got {C}")
    bound = next(ct for ct in (8, 24, MAX_DREF_CHANNELS) if C <= ct)
    chunk = _pow2_at_least(-(-bound // LANE_CHANNELS))
    return chunk * candidate_lanes(D, 32 // chunk)


def dref_plan(B: int, C: int, H: int, W: int, D: int, esize: int) -> Plan:
    """The dRef kernel's launch, tiled as `moments_plan` over query
    columns (the key window [q0 - D + 1, q1) staged beside them), with
    `dref_lanes(C, D)` lanes per query."""
    return _plan(B, H, W, D,
                 lambda t, s: _smem(C, H, W, t, s, esize, 4, 1),
                 dref_lanes(C, D))


Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def moments_plain(ref: torch.Tensor, tar: torch.Tensor,
                  ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                  max_disp: int, center: Optional[torch.Tensor] = None,
                  window: int = 0) -> Moments:
    """The moments as an online softmax over d = 0..max_disp-1, in f32."""
    W = ref.shape[-1]
    ref = ref.float()
    tarp = F.pad(tar.float(), (max_disp - 1, 0))
    okp = F.pad((tar_mask != 0).float(), (max_disp - 1, 0))
    m = torch.full(ref_mask.shape, _NEG, dtype=torch.float32,
                   device=ref.device)
    se = torch.zeros_like(m)
    sed = torch.zeros_like(m)
    sed2 = torch.zeros_like(m)
    for d in range(max_disp):
        lo = max_disp - 1 - d
        tar_d = tarp[..., lo:lo + W]
        ok = okp[..., lo:lo + W] > 0
        if window > 0:
            ok = ok & ((d - center.float()).abs() <= window)
        s = torch.where(ok, (ref * tar_d).sum(dim=1), _NEG)
        m_new = torch.maximum(m, s)
        scale = torch.exp(m - m_new)
        e = torch.where(ok, torch.exp(s - m_new), 0.0)
        se = se * scale + e
        sed = sed * scale + e * d
        sed2 = sed2 * scale + e * d * d
        m = m_new
    m_fin = torch.clamp(m, min=EPS)
    r = torch.exp(m - m_fin)             # rescale to the clamped max
    return m_fin, se * r, sed * r, sed2 * r


def _check(ref, tar, maps, max_disp, window, max_channels=None):
    """Validate a kernel's features (B,C,H,W) and its f32 (B,H,W) maps
    (masks, per-query maps, center when window > 0)."""
    if ref.dtype not in (torch.float32, torch.bfloat16) or tar.dtype != ref.dtype:
        raise TypeError(f"features must share dtype f32 or bf16, got "
                        f"{ref.dtype}/{tar.dtype}")
    if ref.dim() != 4 or tar.shape != ref.shape:
        raise ValueError(f"ref/tar must be (B,C,H,W) of one shape, got "
                         f"{tuple(ref.shape)}/{tuple(tar.shape)}")
    B, C, H, W = ref.shape
    if max_channels is not None and (C > max_channels
                                     or ref.numel() >= 2 ** 31):
        raise ValueError(f"unsupported size C={C} (at most {max_channels}),"
                         f" {ref.numel()} values")
    for t in maps:
        if t is None or t.dtype != torch.float32 or t.shape != (B, H, W):
            raise ValueError(f"masks and per-query maps must be f32 "
                             f"(B,H,W)=({B},{H},{W})")
    for t in [ref, tar] + list(maps):
        if t.device != ref.device or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous on one device")
    if max_disp < 1 or window < 0:
        raise ValueError(f"bad max_disp {max_disp} / window {window}")


def moments(ref: torch.Tensor, tar: torch.Tensor, ref_mask: torch.Tensor,
            tar_mask: torch.Tensor, max_disp: int,
            center: Optional[torch.Tensor] = None,
            window: int = 0) -> Moments:
    """The moments: the CUDA kernel for CUDA tensors, `moments_plain` for
    CPU tensors.  Counts its kernel launches in `moments.launches`."""
    if ref.device.type == "cpu":
        return moments_plain(ref, tar, ref_mask, tar_mask, max_disp, center,
                             window)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    window = int(window) if center is not None else 0
    _check(ref, tar, [ref_mask, tar_mask] + ([center] if window > 0 else []),
           max_disp, window, MAX_MOMENTS_CHANNELS)
    B, C, H, W = ref.shape
    ref, tar, ref_mask, tar_mask, center = (
        aligned(t) for t in (ref, tar, ref_mask, tar_mask, center))
    plan = moments_plan(B, C, H, W, int(max_disp), ref.element_size())
    lib = build.load("spamat_moments", _SIGNATURES)
    out = torch.empty((4, B, H, W), dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        rc = lib.spamat_moments(
            ref.data_ptr(), tar.data_ptr(), ref_mask.data_ptr(),
            tar_mask.data_ptr(), center.data_ptr() if window > 0 else None,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), B, C, H, W, int(max_disp), window,
            int(ref.dtype == torch.bfloat16), plan.tile, plan.span,
            plan.threads, plan.lanes, plan.smem,
            torch.cuda.current_stream(ref.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spamat_moments launch failed: cudaError_t {rc} "
                           f"(B,C,H,W={B},{C},{H},{W}, max_disp={max_disp})")
    moments.launches += 1
    return out[0], out[1], out[2], out[3]


moments.launches = 0


def query_weight(g: torch.Tensor, ref_mask: torch.Tensor,
                 sum_sim: torch.Tensor) -> torch.Tensor:
    """w = g / sum_sim on queries with ref_mask != 0, else 0, in f32 (as
    g * (1 / sum_sim), the XLA twin's rounding)."""
    refm = ref_mask != 0
    inv_ss = torch.where(refm, 1.0 / torch.where(refm, sum_sim.float(), 1.0),
                         0.0)
    return g.float() * inv_ss


def spamat_backward_plain(ref: torch.Tensor, tar: torch.Tensor,
                          ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                          out: torch.Tensor, sum_sim: torch.Tensor,
                          max_cost: torch.Tensor, g: torch.Tensor,
                          max_disp: int, center: Optional[torch.Tensor] = None,
                          window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_ref, grad_tar) as a loop over d = 0..max_disp-1 in f32; the
    key side accumulates into a left-padded buffer, the mirror of the
    forward's shifted slices."""
    B, C, H, W = ref.shape
    dp = max_disp - 1
    ref32 = ref.float()
    tarp = F.pad(tar.float(), (dp, 0))
    okp = F.pad((tar_mask != 0).float(), (dp, 0))
    refm = ref_mask != 0
    w = query_weight(g, ref_mask, sum_sim)
    out = out.float()
    max_cost = max_cost.float()
    gref = torch.zeros_like(ref32)
    gtarp = torch.zeros_like(tarp)
    for d in range(max_disp):
        lo = dp - d
        tar_d = tarp[..., lo:lo + W]
        ok = (okp[..., lo:lo + W] > 0) & refm
        if window > 0:
            ok = ok & ((d - center.float()).abs() <= window)
        s = (ref32 * tar_d).sum(dim=1)
        e = torch.where(ok, torch.exp(s - max_cost), 0.0)
        coef = (e * (d - out) * w)[:, None]
        gref += coef * tar_d
        gtarp[..., lo:lo + W] += coef * ref32
    gref = gref * refm[:, None]
    gtar = gtarp[..., dp:] * (tar_mask != 0)[:, None]
    return gref.to(ref.dtype), gtar.to(tar.dtype)


def _launch_bwd(name, feats, maps, center, window, max_disp, out_like):
    """Launch `spamat_dref` or `spamat_dtar`: feats = (own side, other
    side), maps = (tar_mask, max_cost, out, w)."""
    if out_like.device.type != "cuda":
        raise ValueError(f"{name} is a CUDA kernel; got a tensor on "
                         f"{out_like.device}")
    window = int(window) if center is not None else 0
    is_dref = name == "spamat_dref"
    _check(feats[0], feats[1], list(maps) + ([center] if window > 0 else []),
           max_disp, window, MAX_DREF_CHANNELS if is_dref else None)
    B, C, H, W = feats[0].shape
    feats, maps = [aligned(t) for t in feats], [aligned(t) for t in maps]
    center = aligned(center)
    p = (dref_plan if is_dref else dtar_plan)(B, C, H, W, int(max_disp),
                                              out_like.element_size())
    lib = build.load("spamat_backward" if is_dref else "spamat_dtar",
                     {name: _BWD_SIGNATURES[name]})
    grad = torch.empty_like(out_like)
    with torch.cuda.device(out_like.device):
        rc = getattr(lib, name)(
            feats[0].data_ptr(), feats[1].data_ptr(),
            *(t.data_ptr() for t in maps),
            center.data_ptr() if window > 0 else None, grad.data_ptr(),
            B, C, H, W, int(max_disp), window,
            int(out_like.dtype == torch.bfloat16), p.tile, p.span, p.threads,
            p.lanes, p.smem,
            torch.cuda.current_stream(out_like.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc} "
                           f"(B,C,H,W={B},{C},{H},{W}, max_disp={max_disp})")
    return grad


def spamat_dref(ref, tar, tar_mask, max_cost, out, w, max_disp, center=None,
                window=0):
    """grad_ref by the CUDA kernel (CUDA tensors only); `w` is
    `query_weight(...)`.  Counts its launches in `spamat_dref.launches`."""
    grad = _launch_bwd("spamat_dref", (ref, tar), (tar_mask, max_cost, out, w),
                       center, window, max_disp, ref)
    spamat_dref.launches += 1
    return grad


def spamat_dtar(ref, tar, tar_mask, max_cost, out, w, max_disp, center=None,
                window=0):
    """grad_tar by the CUDA kernel (CUDA tensors only), zero at masked-out
    keys.  Counts its launches in `spamat_dtar.launches`."""
    grad = _launch_bwd("spamat_dtar", (tar, ref), (tar_mask, max_cost, out, w),
                       center, window, max_disp, tar)
    spamat_dtar.launches += 1
    return grad


spamat_dref.launches = 0
spamat_dtar.launches = 0


def spamat_backward(ref: torch.Tensor, tar: torch.Tensor,
                    ref_mask: torch.Tensor, tar_mask: torch.Tensor,
                    out: torch.Tensor, sum_sim: torch.Tensor,
                    max_cost: torch.Tensor, g: torch.Tensor, max_disp: int,
                    center: Optional[torch.Tensor] = None, window: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grad_ref, grad_tar): the dRef and dTar CUDA kernels for CUDA
    tensors, `spamat_backward_plain` for CPU tensors."""
    if ref.device.type == "cpu":
        return spamat_backward_plain(ref, tar, ref_mask, tar_mask, out,
                                     sum_sim, max_cost, g, max_disp, center,
                                     window)
    if ref.device.type != "cuda":
        raise ValueError(f"unsupported device {ref.device}")
    w = query_weight(g, ref_mask, sum_sim).contiguous()
    return (spamat_dref(ref, tar, tar_mask, max_cost, out, w, max_disp,
                        center, window),
            spamat_dtar(ref, tar, tar_mask, max_cost, out, w, max_disp,
                        center, window))
