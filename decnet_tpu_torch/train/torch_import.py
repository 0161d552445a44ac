"""Reference PyTorch checkpoint import — the port of
decnet_tpu/train/torch_import.py.

The reference model's state_dict (its loading convention:
`checkpoint['model_state']` when present, every "module." removed from
the names) is mapped by `build_name_map` onto the flax variable paths of
DecNet, in the flax layouts; `weights.load_flax_variables` then fills the
port's modules from them, as from a `params.npz`.  So the reference's
names pass through the same two maps as in the JAX package.  The port's
map also places DecNet-TPU's learned matching temperatures
(`match_logt_<i>`), which no reference checkpoint holds.

Layout conversions (torch -> flax):
  Conv2d   weight (O,I,kh,kw)      -> kernel (kh,kw,I,O)
  Conv3d   weight (O,I,kd,kh,kw)   -> kernel (kd,kh,kw,I,O)
  ConvTranspose2d weight (I,O,kh,kw) -> ConvTranspose kernel (kh,kw,I,O),
           spatial dims flipped
  BatchNorm weight/bias -> params scale/bias; running_mean/var -> batch_stats

The file is read with torch.load(weights_only=True): tensors and plain
containers only.  The JAX package passes weights_only=False, which runs
any code the pickle names (ROADMAP.md section 3)."""
from __future__ import annotations

import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from decnet_tpu_torch.weights import (_parse_key, flax_arrays_from_model,
                                      load_flax_variables)

Path = Tuple[str, ...]


def conv2d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def conv3d_kernel(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 4, 1, 0))


def conv_transpose2d_kernel(w: np.ndarray) -> np.ndarray:
    # torch (I,O,kh,kw); flax ConvTranspose expects (kh,kw,I,O) and computes
    # the adjoint of a *correlation*, while torch's ConvTranspose2d is the
    # adjoint of torch's correlation conv => spatial flip needed.
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1].copy()


def _convunit_entries(tpath: str, fpath: Tuple[str, ...],
                      kind: str = "conv2d"):
    """(torch_name, flax_path, converter, collection) entries for one
    Conv/Deconv unit (conv + optional BN)."""
    conv_kernel = {"conv2d": conv2d_kernel, "conv3d": conv3d_kernel,
                   "deconv2d": conv_transpose2d_kernel}[kind]
    conv_name = {"conv2d": "Conv_0", "conv3d": "Conv_0",
                 "deconv2d": "ConvTranspose_0"}[kind]
    out = [
        (f"{tpath}.conv.weight", fpath + (conv_name, "kernel"), conv_kernel,
         "params"),
        (f"{tpath}.conv.bias", fpath + (conv_name, "bias"), None, "params"),
        (f"{tpath}.bn.weight", fpath + ("BatchNorm_0", "scale"), None,
         "params"),
        (f"{tpath}.bn.bias", fpath + ("BatchNorm_0", "bias"), None, "params"),
        (f"{tpath}.bn.running_mean", fpath + ("BatchNorm_0", "mean"), None,
         "batch_stats"),
        (f"{tpath}.bn.running_var", fpath + ("BatchNorm_0", "var"), None,
         "batch_stats"),
    ]
    return out


def build_name_map(num_stage: int = 4) -> List:
    """Entries (torch_name, flax_path, converter, collection) for the shipped
    SparseDenseNetRefinementMask architecture, and the learned matching
    temperatures (`match_logt_<i>`)."""
    E: List = []
    fe = "feature_extractor"

    def seq(tbase, names, kind="conv2d"):
        for i, n in enumerate(names):
            E.extend(_convunit_entries(f"{tbase}.{i}", (fe, n), kind))

    # encoder (submodule.py:255-304)
    seq(f"{fe}.conv0", ["conv0_0", "conv0_1"])
    seq(f"{fe}.conv1", ["conv1_0", "conv1_1", "conv1_2"])
    seq(f"{fe}.conv2", ["conv2_0", "conv2_1", "conv2_2"])
    E.extend(_convunit_entries(f"{fe}.conv3_1", (fe, "conv3_1")))
    seq(f"{fe}.conv3_2", ["conv3_2a", "conv3_2b"])
    for i in range(4):
        E.extend(_convunit_entries(
            f"{fe}.addition_ctx_collection.0.stages.c{i}",
            (fe, "aspp", f"c{i}")))
    E.extend(_convunit_entries(f"{fe}.addition_ctx_collection.1",
                               (fe, "ctx_fuse")))
    E.extend(_convunit_entries(f"{fe}.addition_fusion", (fe, "fusion")))
    for i in range(3):
        E.extend(_convunit_entries(f"{fe}.addition_trans{i}",
                                   (fe, f"trans{i}")))
    for d in (1, 2, 3):
        E.extend(_convunit_entries(f"{fe}.deconv{d}.deconv",
                                   (fe, f"deconv{d}", "deconv"), "deconv2d"))
        for j in range(2):
            E.extend(_convunit_entries(f"{fe}.deconv{d}.conv.{j}",
                                       (fe, f"deconv{d}", f"conv_{j}")))

    # cost regularizer (submodule.py:608-662)
    cr = "cost_reg"
    for j in range(2):
        E.extend(_convunit_entries(f"cost_regularizer.conv0.{j}",
                                   (cr, f"conv0_{j}"), "conv3d"))
    for j in range(3):
        E.extend(_convunit_entries(f"cost_regularizer.conv1.{j}",
                                   (cr, f"conv1_{j}"), "conv3d"))
    for j in range(3):
        E.extend(_convunit_entries(f"cost_regularizer.conv2.{j}",
                                   (cr, f"conv2_{j}"), "conv3d"))
    E.append(("cost_regularizer.conv_pre.weight", (cr, "conv_pre", "kernel"),
              conv3d_kernel, "params"))

    # per-fine-stage heads
    for i in range(num_stage - 1):
        dd = f"detail_{i}"
        E.extend(_convunit_entries(f"detail_detection.{i}.deconv.0",
                                   (dd, "deconv0"), "deconv2d"))
        E.extend(_convunit_entries(f"detail_detection.{i}.deconv.1",
                                   (dd, "deconv1")))
        E.extend(_convunit_entries(f"detail_detection.{i}.conv_sub.0",
                                   (dd, "sub0")))
        E.extend(_convunit_entries(f"detail_detection.{i}.conv_sub.1",
                                   (dd, "sub1")))
        E.extend(_convunit_entries(f"detail_detection.{i}.conv.0",
                                   (dd, "head0")))
        E.extend(_convunit_entries(f"detail_detection.{i}.conv.1",
                                   (dd, "head1")))
        for j in range(3):
            E.extend(_convunit_entries(
                f"dynamic_upsampling.{i}.weight_learning.{j}",
                (f"dyn_up_{i}", f"w{j}")))
            E.extend(_convunit_entries(f"soft_attention.{i}.conv.{j}",
                                       (f"soft_att_{i}", f"c{j}")))
        for j in range(7):
            E.extend(_convunit_entries(f"refinement.{i}.conv.{j}",
                                       (f"refine_{i}", f"c{j}")))
    # DecNet-TPU's learned matching temperatures, under their own names: a
    # reference checkpoint has none (its import is the JAX package's), a
    # reference-form export of a DecNet-TPU checkpoint carries them
    for i in range(num_stage - 1):
        E.append((f"match_logt_{i}", (f"match_logt_{i}",), None, "params"))
    return E


def convert_state_dict(state: Mapping[str, np.ndarray],
                       flat: Mapping[Path, np.ndarray], num_stage: int = 4
                       ) -> Tuple[Dict[Path, np.ndarray], Dict]:
    """Copy every reference tensor the name map places into a copy of the
    flax arrays `flat` ({(collection, module, ..., leaf): array}, the
    template whose other arrays are kept).

    `state`: {name: array}, "module." already removed.  Returns the new
    flat arrays and the import report {"copied": n, "missing": [(name,
    flax path) the map gives but the template lacks], "unmatched":
    [reference names no entry used]}, as the JAX package's."""
    out = dict(flat)
    used = set()
    copied = 0
    missing = []
    for tname, fpath, conv, coll in build_name_map(num_stage):
        if tname not in state:
            continue
        key = (coll,) + tuple(fpath)
        if key not in out:
            missing.append((tname, key))
            continue
        w = np.asarray(state[tname], np.float32)
        if conv is not None:
            w = conv(w)
        if w.shape != out[key].shape:
            raise ValueError(f"shape mismatch {tname} {w.shape} -> "
                             f"{key} {out[key].shape}")
        out[key] = w
        used.add(tname)
        copied += 1
    unmatched = sorted(set(state) - used)
    return out, {"copied": copied, "missing": missing,
                 "unmatched": unmatched}


def read_reference_state(path: str) -> Dict[str, np.ndarray]:
    """The reference state_dict of a `.pkl` checkpoint as numpy arrays:
    `checkpoint['model_state']` when present, else the checkpoint itself,
    with every "module." removed from the names."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: the checkpoint holds objects other than tensors and "
            f"plain containers, which torch.load(weights_only=True) refuses "
            f"to unpickle (unpickling them would run their code); save its "
            f"state_dict alone, e.g. torch.save({{'model_state': sd}}, "
            f"path). torch says: {str(e).splitlines()[0]}") from e
    state = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else ckpt
    if not isinstance(state, Mapping):
        raise ValueError(f"{path}: no state_dict in the checkpoint "
                         f"(a {type(state).__name__})")
    bad = [k for k, v in state.items() if not isinstance(v, torch.Tensor)]
    if bad:
        raise ValueError(f"{path}: state_dict entries that are not tensors: "
                         f"{bad[:5]}")
    return {k.replace("module.", ""): v.detach().float().numpy()
            for k, v in state.items()}


def _nest(flat: Mapping[Path, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        cur = tree
        for k in key[:-1]:
            cur = cur.setdefault(k, {})
        cur[key[-1]] = v
    return tree


def load_reference_checkpoint(path: str, model: torch.nn.Module,
                              num_stage: int = 4) -> Dict:
    """Fill `model` from a reference `.pkl` checkpoint: the mapped tensors
    replace the model's own, every other tensor keeps its value.  Prints
    and returns the import report."""
    flat = {_parse_key(k): v
            for k, v in flax_arrays_from_model(model).items()}
    arrays, report = convert_state_dict(read_reference_state(path), flat,
                                        num_stage)
    load_flax_variables(model, _nest(arrays))
    print(f"reference import from {path}: copied {report['copied']}, "
          f"missing {len(report['missing'])}, unmatched "
          f"{len(report['unmatched'])}", flush=True)
    return report
