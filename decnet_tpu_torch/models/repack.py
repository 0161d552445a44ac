"""Exact space-to-depth repacking of faithful (reference-form) weights — the
port of decnet_tpu/models/repack.py.

The s2d model variant (`s2d_fine`, `s2d_stages` 1 or 2) is the exact
packed twin of the faithful graph:
  - a full-res 3x3 conv, dilation d, equals a 1/r-res conv over the s2d
    form with a block-structured (r*r*Cin, r*r*Cout) kernel: 3 taps at
    dilation d/r when d is a multiple of r (phase-diagonal), else
    2*ceil(d/r) + 1 taps at dilation 1 (phase mixing);
  - a stride-r 3x3 conv from full res equals a stride-1 3x3 conv on the
    s2d form;
  - a k=r / s=r transposed conv equals a 1x1 conv to r*r*Cout channels;
  - batch-norm and bias vectors tile r*r times over the (phase)*C + c
    channel layout.
So faithful weights map onto the s2d model with the same outputs up to
summation order (`repack_faithful_to_s2d`, `s2d_exec`).  Every transform
is a copy, tile or permutation of faithful entries, so the whole map is
one gather (`repack_linear`): applied to the faithful model's tensors with
torch indexing, it runs the s2d model on them with the gradients landing
on the faithful parameters.  That is valid for frozen batch norm only
(`train.packed_exec`): a packed BN would collect per-phase statistics.

The numpy functions work on the JAX package's nested variables trees
(`weights.py::variables_from_model` / `load_flax_variables`), in flax
names and layouts (HWIO kernels), so their output can be compared with
JAX's array for array."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from decnet_tpu_torch.nn.heads import Refinement

# ---------------------------------------------------------------- kernels


def packed_geometry(d: int, r: int) -> Tuple[int, int]:
    """(packed kernel extent E, packed dilation pd) of a full-res 3-tap
    conv with dilation d over the r-packed grid: taps at {-d, 0, d} land on
    packed offsets {-ceil(d/r)..ceil(d/r)}; when d is a multiple of r they
    stay phase-diagonal and compress to a 3-tap conv with dilation d/r."""
    if d > 1 and d % r == 0:
        return 3, d // r
    return 2 * ((d + r - 1) // r) + 1, 1


def pack_conv3x3(K: np.ndarray, r: int, dilation: int = 1,
                 in_perm: Optional[np.ndarray] = None) -> np.ndarray:
    """Full-res 3x3 conv kernel (3,3,Cin,Cout), dilation d, SAME padding ->
    packed s2d kernel (E,E,r*r*Cin,r*r*Cout), applied with dilation pd and
    padding pd*(E-1)//2, (E, pd) = packed_geometry(d, r).  Channels are
    interleaved, (i*r + j)*C + c (`nn/layers.py::space_to_depth`).
    `in_perm[k]` is the interleaved index the provided input channel k
    carries (for graphs that concatenate per-tensor s2d blocks)."""
    kh, kw, Cin, Cout = K.shape
    assert (kh, kw) == (3, 3)
    d = dilation
    E, pd = packed_geometry(d, r)
    c0 = (E - 1) // 2
    KP = np.zeros((E, E, r * r * Cin, r * r * Cout), K.dtype)
    for io in range(r):
        for jo in range(r):
            for ty in range(3):
                for tx in range(3):
                    qy, ii = divmod(io + (ty - 1) * d, r)
                    qx, jj = divmod(jo + (tx - 1) * d, r)
                    assert qy % pd == 0 and qx % pd == 0
                    KP[qy // pd + c0, qx // pd + c0,
                       (ii * r + jj) * Cin:(ii * r + jj + 1) * Cin,
                       (io * r + jo) * Cout:(io * r + jo + 1) * Cout] \
                        = K[ty, tx]
    if in_perm is not None:
        KP = KP[:, :, in_perm, :]
    return KP


def pack_conv3x3_stride(K: np.ndarray, r: int) -> np.ndarray:
    """Full-res 3x3 stride-r conv (padding 1) -> stride-1 3x3 conv on the
    s2d form, (3,3,r*r*Cin,Cout); the output is not phase-expanded."""
    kh, kw, Cin, Cout = K.shape
    assert (kh, kw) == (3, 3)
    KP = np.zeros((3, 3, r * r * Cin, Cout), K.dtype)
    for ty in range(3):
        for tx in range(3):
            qy, ii = divmod(ty - 1, r)
            qx, jj = divmod(tx - 1, r)
            KP[qy + 1, qx + 1,
               (ii * r + jj) * Cin:(ii * r + jj + 1) * Cin, :] = K[ty, tx]
    return KP


def pack_conv1x1(K: np.ndarray, r: int) -> np.ndarray:
    """1x1 conv -> phase-diagonal 1x1 conv, (1,1,r*r*Cin,r*r*Cout)."""
    _, _, Cin, Cout = K.shape
    KP = np.zeros((1, 1, r * r * Cin, r * r * Cout), K.dtype)
    for p in range(r * r):
        KP[0, 0, p * Cin:(p + 1) * Cin, p * Cout:(p + 1) * Cout] = K[0, 0]
    return KP


def deconv_to_1x1(K: np.ndarray, r: int) -> np.ndarray:
    """k=r / s=r transposed-conv kernel (r,r,Cin,Cout) as flax stores it
    (a correlation over the stride-dilated input, so output phase (i, j)
    sees tap (r-1-i, r-1-j)) -> 1x1 conv (1,1,Cin,r*r*Cout) emitting the
    s2d form of the upsampled map."""
    kh, kw, Cin, Cout = K.shape
    assert (kh, kw) == (r, r)
    KP = np.zeros((1, 1, Cin, r * r * Cout), K.dtype)
    for i in range(r):
        for j in range(r):
            KP[0, 0, :, (i * r + j) * Cout:(i * r + j + 1) * Cout] = \
                K[r - 1 - i, r - 1 - j]
    return KP


def tile_vec(v: np.ndarray, r: int) -> np.ndarray:
    """Per-channel vector (C,) -> (r*r*C,) over the (phase)*C + c layout."""
    return np.tile(v, r * r)


def concat_blocks_perm(channels: Sequence[int], r: int) -> np.ndarray:
    """in_perm for a graph that provides concat([s2d(x1), s2d(x2), ...])
    (per-tensor blocks) to a kernel packed for s2d(concat([x1, x2, ...]))
    (interleaved): in_perm[provided] = interleaved."""
    Ctot = int(np.sum(channels))
    perm = np.zeros(r * r * Ctot, np.int64)
    base = off = 0
    for C in channels:
        for p in range(r * r):
            for c in range(C):
                perm[base + p * C + c] = p * Ctot + off + c
        base += r * r * C
        off += C
    return perm


def unfold_to_s2d_perm(C: int, r: int, lead: int = 0) -> np.ndarray:
    """in_perm for DynamicUpsampling's w0: the faithful graph feeds
    concat([disp (lead channels), unfold_nonoverlap(fea)]) in torch's
    channel-major patch order (c*r*r + p), the s2d graph concat([disp,
    s2d(fea)]) in (p*C + c): in_perm[provided] = faithful index."""
    perm = np.arange(lead + r * r * C, dtype=np.int64)
    for p in range(r * r):
        for c in range(C):
            perm[lead + p * C + c] = lead + c * r * r + p
    return perm


# ---------------------------------------------------------------- tree ops


def _get(tree: Dict, path: Sequence[str]):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict, path: Sequence[str], value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _del(tree: Dict, path: Sequence[str]):
    for k in path[:-1]:
        tree = tree[k]
    del tree[path[-1]]


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


class _Repacker:
    """Transforms one faithful variables tree into the s2d twin's."""

    def __init__(self, variables, r: int):
        self.r = r
        self.params = _to_np(variables["params"])
        self.stats = _to_np(variables.get("batch_stats", {}))

    def conv_unit(self, path: List[str], kind: str, dilation: int = 1,
                  in_perm: Optional[np.ndarray] = None,
                  rename: Optional[List[str]] = None,
                  src_conv: str = "Conv_0"):
        """Repack one conv unit in place (or move it to `rename`); kind is
        pack33 | pack33_stride | pack11 | deconv11 | perm_only."""
        r = self.r
        p = _get(self.params, path)
        try:
            s = _get(self.stats, path)
        except KeyError:
            s = None
        conv = p[src_conv]
        K = conv["kernel"]
        if kind == "pack33":
            K2 = pack_conv3x3(K, r, dilation, in_perm)
        elif kind == "pack33_stride":
            K2 = pack_conv3x3_stride(K, r)
        elif kind == "pack11":
            K2 = pack_conv1x1(K, r)
        elif kind == "deconv11":
            K2 = deconv_to_1x1(K, r)
        elif kind == "perm_only":
            K2 = K[:, :, in_perm, :]
        else:
            raise ValueError(kind)
        out = {"Conv_0": {"kernel": K2}}
        expand = kind in ("pack33", "pack11", "deconv11")

        def vec(v):
            return tile_vec(v, r) if expand else v
        if "bias" in conv:
            out["Conv_0"]["bias"] = vec(conv["bias"])
        if "BatchNorm_0" in p:
            out["BatchNorm_0"] = {k: vec(v)
                                  for k, v in p["BatchNorm_0"].items()}
        dst = rename or path
        _del(self.params, path)
        _set(self.params, dst, out)
        if s is not None and "BatchNorm_0" in s:
            _del(self.stats, path)
            _set(self.stats, dst, {"BatchNorm_0": {
                k: vec(v) for k, v in s["BatchNorm_0"].items()}})

    def result(self) -> Dict:
        out = {"params": self.params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


def _repack_stage_heads(rp: _Repacker, stage: int, C: int,
                        dils: Sequence[int]):
    """One fine stage's heads (dyn_up / soft_att / refine / detail, index
    stage - 1) from faithful form onto the packed twins.  C is the stage's
    faithful channel count, dils its Refinement dilations."""
    r = rp.r
    hid = stage - 1
    rp.conv_unit([f"dyn_up_{hid}", "w0"], "perm_only",
                 in_perm=unfold_to_s2d_perm(C, r, lead=1))
    sa = f"soft_att_{hid}"
    rp.conv_unit([sa, "c0"], "pack33",
                 in_perm=concat_blocks_perm([C, 1, 1, 1, 1], r))
    rp.conv_unit([sa, "c1"], "pack33")
    rp.conv_unit([sa, "c2"], "pack33")
    rf = f"refine_{hid}"
    d1, d2, d3 = dils
    rp.conv_unit([rf, "c0"], "pack33", dilation=d1,
                 in_perm=concat_blocks_perm([C, C, 1], r))
    rp.conv_unit([rf, "c1"], "pack33")
    rp.conv_unit([rf, "c2"], "pack33", dilation=d2)
    rp.conv_unit([rf, "c3"], "pack33")
    rp.conv_unit([rf, "c4"], "pack33", dilation=d3)
    rp.conv_unit([rf, "c5"], "pack33")
    rp.conv_unit([rf, "c6"], "pack33")
    dt = f"detail_{hid}"
    if dt in rp.params:
        rp.conv_unit([dt, "deconv0"], "deconv11", src_conv="ConvTranspose_0")
        rp.conv_unit([dt, "deconv1"], "pack33")
        rp.conv_unit([dt, "sub0"], "pack33")
        rp.conv_unit([dt, "sub1"], "pack33")
        rp.conv_unit([dt, "head0"], "pack33")
        rp.conv_unit([dt, "head1"], "pack11")


def repack_faithful_to_s2d(variables, cfg, stages: int = 1) -> Dict:
    """Faithful (s2d_fine False) DecNet variables -> the variables of the
    s2d variant (s2d_fine True, s2d_stages `stages`) of the same
    ModelConfig with the same outputs at inference.  stages=2 also packs
    the 1/3-res stage's heads.  Not for batch-statistic training."""
    if getattr(cfg, "norm", "bn") != "bn":
        raise ValueError("the repack assumes batch norm")
    r = int(cfg.down_scale)
    C = int(cfg.base_channels)
    last = int(cfg.num_stage) - 1          # the full-res stage
    rp = _Repacker(variables, r)
    fe = ["feature_extractor"]
    # the extractor's full-res level -> its s2d twin
    rp.conv_unit(fe + ["conv0_0"], "pack33")
    rp.conv_unit(fe + ["conv0_1"], "pack33")
    rp.conv_unit(fe + ["conv1_0"], "pack33_stride")
    rp.conv_unit(fe + ["trans0"], "pack11")
    rp.conv_unit(fe + ["deconv1", "deconv"], "deconv11",
                 rename=fe + ["deconv1_s2d"], src_conv="ConvTranspose_0")
    rp.conv_unit(fe + ["deconv1", "conv_0"], "pack33",
                 in_perm=concat_blocks_perm([C, C], r),
                 rename=fe + ["deconv1_c0"])
    rp.conv_unit(fe + ["deconv1", "conv_1"], "pack33",
                 rename=fe + ["deconv1_c1"])
    _del(rp.params, fe + ["deconv1"])
    try:
        _del(rp.stats, fe + ["deconv1"])
    except KeyError:
        pass
    _repack_stage_heads(rp, last, C, Refinement.DILATIONS[last])
    if stages >= 2:
        repack_stage2_heads(rp, cfg)
    return rp.result()


def repack_stage2_heads(rp: _Repacker, cfg):
    """Pack the 1/3-res stage's heads in place, on a faithful tree or on an
    s2d_stages 1 tree (whose stage-2 heads are faithful-form).  The
    extractor needs no change: its s2d_mid output is a reshape."""
    ns = int(cfg.num_stage)
    stage = ns - 2
    C = int(cfg.base_channels) * int(cfg.down_scale) ** (ns - 1 - stage)
    _repack_stage_heads(rp, stage, C, Refinement.DILATIONS[stage])


def _s2d_config(cfg_model, stages: int):
    return dataclasses.replace(cfg_model, s2d_fine=True, s2d_stages=stages)


def s2d_exec(variables, cfg_model, stages: int = 1):
    """(model, variables) for the exact s2d execution of a checkpoint: a
    fresh s2d DecNet on the CPU and its variables.
      - faithful cfg (s2d_fine False): the full repack (stage 2 too when
        stages=2);
      - s2d cfg with s2d_stages 1 and stages=2: only the stage-2 heads."""
    from decnet_tpu_torch.models.decnet import DecNet
    cfg_s = _s2d_config(cfg_model, stages)
    if cfg_model.s2d_fine:
        if cfg_model.s2d_stages != 1 or stages != 2:
            raise ValueError("s2d checkpoint: only the stage-2-packing "
                             "upgrade applies")
        rp = _Repacker(variables, int(cfg_model.down_scale))
        repack_stage2_heads(rp, cfg_model)
        return DecNet(cfg_s), rp.result()
    return DecNet(cfg_s), repack_faithful_to_s2d(variables, cfg_model,
                                                 stages)


def s2d_exec_model(model, stages: int = 1):
    """`s2d_exec` of a loaded DecNet: its s2d twin filled with the
    repacked weights, on the model's device, in eval mode, with the same
    `use_kernels` (the CLIs' --exec_s2d)."""
    from decnet_tpu_torch.weights import (load_flax_variables,
                                          variables_from_model)
    twin, variables = s2d_exec(variables_from_model(model), model.cfg,
                               stages)
    load_flax_variables(twin, variables)
    twin.use_kernels = model.use_kernels
    dev = next(model.parameters()).device
    return twin.to(dev).eval()


def repack_linear(model, stages: int = 1
                  ) -> Tuple[torch.nn.Module,
                             Callable[[torch.nn.Module],
                                      Dict[str, torch.Tensor]]]:
    """The differentiable twin of `repack_faithful_to_s2d` for a faithful
    DecNet.  The numpy repacker runs once on index arrays (each of the
    model's values numbered from 1; 0 is a structural zero), which yields
    the whole transform as one gather map.  Returns (s2d_model, apply_fn):
    the s2d DecNet on the model's device, and apply_fn(model) -> its
    state (every parameter and buffer) gathered from the faithful model's
    tensors with torch indexing, so gradients taken through
    `torch.func.functional_call(s2d_model, apply_fn(model), ...)` land on
    the faithful parameters (the backward of a gather is a scatter-add,
    over the values each packed entry takes, not its structural zeros).
    Valid for frozen batch norm only (`train.packed_exec`)."""
    from decnet_tpu_torch.weights import (flax_arrays_from_state,
                                          nest_variables, state_from_flax)
    if model.cfg.s2d_fine:
        raise ValueError("repack_linear takes a faithful model "
                         "(s2d_fine False)")
    keys = list(model.state_dict().keys())
    tensors = model.state_dict(keep_vars=True)
    numbered, off = {}, 1
    for k in keys:
        n = tensors[k].numel()
        numbered[k] = np.arange(off, off + n, dtype=np.int64).reshape(
            tuple(tensors[k].shape))
        off += n
    packed = repack_faithful_to_s2d(
        nest_variables(flax_arrays_from_state(model, numbered)), model.cfg,
        stages)
    from decnet_tpu_torch.models.decnet import DecNet
    dev = next(model.parameters()).device
    twin = DecNet(_s2d_config(model.cfg, stages),
                  use_kernels=model.use_kernels).to(dev).eval()
    want = twin.state_dict()
    index = state_from_flax(packed)
    if set(index) != set(want) or any(
            np.shape(index[k]) != tuple(want[k].shape) for k in want):
        raise KeyError("repack_linear: the gather map does not fill the s2d "
                       "model's tensors")
    # one gather for the whole s2d state, laid out flat tensor after
    # tensor: the positions that take a faithful value and the indices of
    # those values.  The structural zeros are left out, so the backward
    # scatter-adds only real duplicates (a tiled vector, a kernel tap
    # packed at several phases), not millions of zeros onto one index;
    # and one gather, one scatter and one split keep the backward to a
    # handful of launches
    names = list(want)
    shapes = [tuple(want[k].shape) for k in names]
    flat_idx = np.concatenate([np.asarray(index[k]).reshape(-1)
                               for k in names])
    pos = np.flatnonzero(flat_idx)
    pos_t = torch.from_numpy(pos).to(dev)
    src_t = torch.from_numpy(flat_idx[pos] - 1).to(dev)
    sizes = [int(np.prod(sh)) for sh in shapes]

    def apply_fn(faithful) -> Dict[str, torch.Tensor]:
        ts = faithful.state_dict(keep_vars=True)
        flat = torch.cat([ts[k].reshape(-1).float() for k in keys])
        vals = flat.new_zeros(flat_idx.size).index_copy(
            0, pos_t, flat.index_select(0, src_t))
        return {k: v.view(sh) for k, sh, v in
                zip(names, shapes, torch.split(vals, sizes))}

    return twin, apply_fn
