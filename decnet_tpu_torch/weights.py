"""Weight bridge both ways: the flax variables of decnet_tpu's DecNet <->
the port's state_dict, checkpoint loading, and warm starts.

Input is either a `params.npz` snapshot as decnet_tpu/train/checkpoint.py
writes it (flattened pytree, keys like
"['params']/['refine_2']/['c0']/['Conv_0']/['kernel']") or the nested
in-memory variables of a JAX model converted to numpy.  The bridge is
strict: every array must map onto a port parameter or buffer and every
port parameter or buffer must be filled, with matching shapes.
`warm_start` is the lenient twin for `--init_from`: it copies what
matches by key and shape and leaves the rest fresh.

Layouts:
  Conv          HWIO   -> OIHW
  Conv (3D)     DHWIO  -> OIDHW
  ConvTranspose HWIO   -> IOHW with the spatial dims flipped: the JAX layer
                is a correlation over the stride-dilated input with the
                kernel as stored, torch's ConvTranspose2d the adjoint of a
                correlation (the inverse of decnet_tpu/train/torch_import.py
                :33-37)
  BatchNorm     scale/bias -> weight/bias, batch_stats mean/var ->
                running_mean/running_var
  GroupNorm     scale/bias -> weight/bias (the `gn` norm)
  conv_pre      the `cat` cost's 1x1x1 Conv, DHWIO -> OIDHW, no bias
A model whose fine stages from skip_stage_id on have no heads takes a full
checkpoint: the arrays of those heads are left out (`skipped_heads`).
`flax_arrays_from_model` is the reverse: the model's state as the flat
flax-named numpy arrays `params.npz` holds (`variables_from_model` as the
nested tree, which `models/repack.py` transforms).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from decnet_tpu_torch.config import load_config
from decnet_tpu_torch.device import resolve_device
from decnet_tpu_torch.models.decnet import DecNet

_KEY_PART = re.compile(r"^\['([^']+)'\]$")
_MODULES = {"Conv_0": "conv", "ConvTranspose_0": "conv", "BatchNorm_0": "bn",
            "GroupNorm_0": "gn"}
_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias",
           ("params", "scale"): "weight",
           ("batch_stats", "mean"): "running_mean",
           ("batch_stats", "var"): "running_var"}
_CONV_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}
_NORM_MODULES = {"bn": "BatchNorm_0", "gn": "GroupNorm_0"}


def _parse_key(key: str) -> Tuple[str, ...]:
    parts = []
    for p in key.split("/"):
        m = _KEY_PART.match(p)
        if not m:
            raise KeyError(f"not a flattened flax key: {key!r}")
        parts.append(m.group(1))
    return tuple(parts)


def flatten_variables(tree: Mapping, prefix: Tuple[str, ...] = ()
                      ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested {collection: {module: ... {leaf: array}}} -> {path: array}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_variables(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def _convert(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """(port state_dict key, array in the port's layout) for one flax leaf."""
    collection, names = path[0], path[1:]
    if collection == "params" and len(names) == 1 \
            and names[0].startswith("match_logt_"):
        return names[0], arr
    if collection == "params" and names[-2:] == ("conv_pre", "kernel"):
        key = ".".join(names[:-1] + ("weight",))
        return key, np.ascontiguousarray(arr.transpose(4, 3, 0, 1, 2))
    if len(names) < 2 or names[-2] not in _MODULES \
            or (collection, names[-1]) not in _LEAVES:
        raise KeyError(f"no port parameter for flax variable {path}")
    module, leaf = names[-2], names[-1]
    if leaf == "kernel":
        if module == "ConvTranspose_0":
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"{path}: unexpected kernel rank {arr.ndim}")
    key = ".".join(names[:-2] + (_MODULES[module],
                                 _LEAVES[(collection, leaf)]))
    return key, np.ascontiguousarray(arr)


def _flat_arrays(variables: Union[str, Mapping]
                 ) -> Dict[Tuple[str, ...], np.ndarray]:
    """{flax path: array} of a `params.npz` path or of nested variables."""
    if isinstance(variables, (str, os.PathLike)):
        with np.load(variables) as z:
            return {_parse_key(k): z[k] for k in z.files}
    return flatten_variables(variables)


def state_from_flax(variables: Union[str, Mapping]
                    ) -> Dict[str, np.ndarray]:
    """{port state_dict key: array in the port's layout} from a
    `params.npz` path or nested flax variables, dtypes kept."""
    sd = {}
    for path, arr in _flat_arrays(variables).items():
        key, arr = _convert(path, arr)
        if key in sd:
            raise KeyError(f"two flax variables map onto {key}")
        sd[key] = arr
    return sd


def state_dict_from_flax(variables: Union[str, Mapping]
                         ) -> Dict[str, torch.Tensor]:
    """The port's state_dict (f32 CPU tensors) from a `params.npz` path or
    from nested flax variables."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in state_from_flax(variables).items()}


def _flax_key(path: Tuple[str, ...]) -> str:
    return "/".join(f"['{p}']" for p in path)


def flax_arrays_from_model(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's parameters and batch-norm statistics as f32 numpy arrays
    under flattened flax keys ("['params']/['refine_2']/['c0']/['Conv_0']/
    ['kernel']"), in the JAX layouts: the inverse of `_convert`."""
    return flax_arrays_from_state(model, {
        k: t.detach().float().cpu().numpy()
        for k, t in model.state_dict().items()})


def flax_arrays_from_state(model: torch.nn.Module,
                           state: Mapping[str, np.ndarray]
                           ) -> Dict[str, np.ndarray]:
    """`state` ({port state_dict key: array} of `model`'s keys and
    shapes, any dtype) under flattened flax keys in the JAX layouts."""
    transposed = {name for name, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    arrays = {}
    for key, arr in state.items():
        names = key.split(".")
        if len(names) == 1 and names[0].startswith("match_logt_"):
            arrays[_flax_key(("params", names[0]))] = arr
            continue
        module, leaf = names[-2], names[-1]
        if module == "conv_pre":
            path = ("params",) + tuple(names[:-1]) + ("kernel",)
            arrays[_flax_key(path)] = np.ascontiguousarray(
                arr.transpose(2, 3, 4, 1, 0))
            continue
        if module == "conv":
            is_t = ".".join(names[:-1]) in transposed
            collection, flax_leaf = _CONV_LEAVES[leaf]
            flax_module = "ConvTranspose_0" if is_t else "Conv_0"
            if leaf == "weight":
                if is_t:
                    arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
                elif arr.ndim == 4:
                    arr = arr.transpose(2, 3, 1, 0)
                else:
                    arr = arr.transpose(2, 3, 4, 1, 0)
        elif module in _NORM_MODULES:
            collection, flax_leaf = _BN_LEAVES[leaf]
            flax_module = _NORM_MODULES[module]
        else:
            raise KeyError(f"no flax variable for port tensor {key}")
        path = (collection,) + tuple(names[:-2]) + (flax_module, flax_leaf)
        arrays[_flax_key(path)] = np.ascontiguousarray(arr)
    return arrays


def nest_variables(arrays: Mapping[str, np.ndarray]) -> Dict:
    """Flattened flax keys -> the nested {collection: {module: ...}} tree
    (the JAX package's variables, as numpy arrays)."""
    tree: Dict = {}
    for key, arr in arrays.items():
        path = _parse_key(key)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return tree


def variables_from_model(model: torch.nn.Module) -> Dict:
    """The model's state as the JAX package's nested variables tree (f32
    numpy arrays, flax names and layouts)."""
    return nest_variables(flax_arrays_from_model(model))


def load_flax_variables(model: torch.nn.Module,
                        variables: Union[str, Mapping]) -> int:
    """Fill `model` from flax variables; strict both ways, but for the
    arrays of the heads a DecNet skips (`DecNet.skipped_heads`), which are
    left out.  Returns the number of arrays consumed."""
    sd = state_dict_from_flax(variables)
    skipped = model.skipped_heads() if isinstance(model, DecNet) else ()
    if skipped:
        sd = {k: v for k, v in sd.items() if not k.startswith(skipped)}
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: {len(missing)} port tensors "
                       f"unfilled (e.g. {missing[:3]}), {len(extra)} arrays "
                       f"unused (e.g. {extra[:3]})")
    for k, v in sd.items():
        if tuple(want[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != "
                             f"port shape {tuple(want[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return len(sd)


def warm_start(model: torch.nn.Module, variables: Union[str, Mapping]
               ) -> Dict[str, Tuple[int, int]]:
    """Fill what matches, keep the rest fresh: the port of decnet_tpu's
    `CheckpointManager.restore_partial` for a `params.npz` (or nested flax
    variables).

    Every port parameter or buffer whose flax key is in `variables` and
    whose shape after the layout conversion matches is copied in place;
    every other tensor keeps its value.  Arrays the port has no tensor for
    (or of another shape) are ignored and counted.  Prints JAX's summary
    lines and returns {"params" | "batch_stats": (restored, fresh)}."""
    want = model.state_dict()
    found, unused = {}, 0
    for path, arr in _flat_arrays(variables).items():
        try:
            key, arr = _convert(path, arr)
        except (KeyError, ValueError):
            unused += 1
            continue
        if key in want and tuple(want[key].shape) == arr.shape:
            found[key] = torch.from_numpy(np.array(arr, np.float32))
        else:
            unused += 1
    with torch.no_grad():
        for key, t in found.items():
            want[key].copy_(t)      # state_dict tensors share the storage
    counts = {}
    for label in ("params", "batch_stats"):
        keys = [k for k in want if k.endswith(("running_mean", "running_var"))
                == (label == "batch_stats")]
        hits = sum(k in found for k in keys)
        counts[label] = (hits, len(keys) - hits)
        print(f"warm-start {label}: {hits} restored, {len(keys) - hits} "
              f"fresh-initialised")
    print(f"warm-start: {unused} checkpoint arrays unused")
    return counts


def load_checkpoint(ckpt_dir: str, device="cuda", **overrides) -> DecNet:
    """DecNet built from `<ckpt_dir>/config.json` (model fields in
    `overrides` win, e.g. dtype="float32") and filled from
    `<ckpt_dir>/params.npz`, in eval mode on `device`."""
    dev = resolve_device(device)
    model = DecNet(load_config(ckpt_dir, **overrides))
    load_flax_variables(model, os.path.join(ckpt_dir, "params.npz"))
    return model.to(dev).eval()
