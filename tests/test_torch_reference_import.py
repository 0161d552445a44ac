"""The port's reference checkpoint import (decnet_tpu_torch/train/
torch_import.py, `train/checkpoint.py::load_torch_checkpoint`) against
decnet_tpu's `load_reference_checkpoint`, on a reference-form state dict
synthesised from a tiny model's variable tree as
tests/test_torch_import.py::_synthetic_model_and_state builds it (every
mapped name in the torch layout), with batch-norm statistics that keep the
forward finite.

Both imports of the same `.pkl` must give the same variables, the same
report, and disparities within 1e-3 px (f32, CPU; the forwards' summation
orders differ by ~1e-5 px)."""
import argparse

import jax
import numpy as np
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu.train import torch_import as jti
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train.checkpoint import load_torch_checkpoint
from decnet_tpu_torch.weights import flax_arrays_from_model
from tests.test_torch_layers import nchw
from tests.test_torch_model import FAITHFUL_SMALL, flat_paths

DISP_TOL = 1e-3
H, W = 54, 81
# torch layout of a flax kernel: the inverse of each converter
TO_TORCH = {jti.conv2d_kernel: lambda k: k.transpose(3, 2, 0, 1),
            jti.conv3d_kernel: lambda k: k.transpose(4, 3, 0, 1, 2),
            jti.conv_transpose2d_kernel:
                lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1)}


def inputs(rng):
    left = rng.rand(1, H, W, 3).astype(np.float32)
    right = rng.rand(1, H, W, 3).astype(np.float32)
    lm, rm = [], []
    for s in (9, 3, 1):
        lm.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
        rm.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
    return left, right, lm, rm


def reference_state(variables, rng):
    """{reference name: torch-layout array} for every name the map places
    in `variables`: kernels from the JAX initialisation (He-normal),
    batch-norm scale ~1, bias and mean ~0, var in [0.5, 2]."""
    flat = {(c,) + p: np.asarray(v) for c in ("params", "batch_stats")
            for p, v in flat_paths(variables[c]).items()}
    state = {}
    for tname, fpath, conv, coll in jti.build_name_map(4):
        key = (coll,) + tuple(fpath)
        if key not in flat:
            continue
        v = flat[key]
        if conv is not None:
            v = TO_TORCH[conv](v)
        elif tname.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, v.shape)
        elif tname.endswith("bn.weight"):
            v = 1 + 0.1 * rng.randn(*v.shape)
        else:
            v = 0.1 * rng.randn(*v.shape)
        state[tname] = np.array(v, np.float32, order="C")
    return state


def save_pkl(path, state, prefix="module.", wrap=True, **extra):
    sd = {prefix + k: torch.from_numpy(v) for k, v in state.items()}
    torch.save({"model_state": sd, **extra} if wrap else sd, path)
    return str(path)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    left, right, lm, rm = inputs(rng)
    jcfg = JaxConfig(**FAITHFUL_SMALL, dtype="float32", matching_impl="xla")
    model = get_model("decnet", jcfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), left, right, lm, rm))
    return dict(jcfg=jcfg, model=model, variables=variables,
                state=reference_state(variables, rng),
                batch=(left, right, lm, rm))


def port_import(path):
    torch.manual_seed(1)
    model = DecNet(ModelConfig(**FAITHFUL_SMALL, dtype="float32"))
    report = load_torch_checkpoint(path, model)
    return model.eval(), report


def test_import_and_forward_match_jax(case, tmp_path):
    path = save_pkl(tmp_path / "ref.pkl", case["state"])
    out = jti.load_reference_checkpoint(path, case["variables"])
    jrep = out.pop("_import_report")
    model, rep = port_import(path)
    assert rep == jrep and rep["copied"] == len(case["state"])
    assert not rep["missing"] and not rep["unmatched"]
    # the same variables: every array the port holds is JAX's
    arrays = flax_arrays_from_model(model)
    flat = {(c,) + p: v for c in ("params", "batch_stats")
            for p, v in flat_paths(out[c]).items()}
    assert len(arrays) == len(flat)
    for k, v in arrays.items():
        key = tuple(p[2:-2] for p in k.split("/"))
        np.testing.assert_array_equal(v, np.asarray(flat[key], np.float32),
                                      err_msg=k)
    left, right, lm, rm = case["batch"]
    want = jax.jit(case["model"].apply)(out, left, right, lm, rm)
    with torch.no_grad():
        got = model(nchw(left), nchw(right), [torch.from_numpy(m) for m in lm],
                    [torch.from_numpy(m) for m in rm])
    for s in range(4):
        g, w = got["preds"][s].numpy(), np.asarray(want["preds"][s])
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=DISP_TOL,
                                   err_msg=f"preds[{s}]")


def test_import_reports_equal_jax(case, tmp_path):
    """Unmatched names (BN's num_batches_tracked, a name of no module) and
    missing ones (the detail heads the faithful model lacks)."""
    state = dict(case["state"])
    state["feature_extractor.conv0.0.bn.num_batches_tracked"] = \
        np.zeros((), np.float32)
    state["extra_head.weight"] = np.ones(3, np.float32)
    detail = [t for t, f, c, coll in jti.build_name_map(4)
              if t.startswith("detail_detection.0.conv.0.bn")]
    for t in detail:
        state[t] = np.ones(1, np.float32)
    path = save_pkl(tmp_path / "ref.pkl", state)
    jrep = jti.load_reference_checkpoint(path, case["variables"])[
        "_import_report"]
    _, rep = port_import(path)
    assert rep == jrep
    # a missing name is also unused, so unmatched too (as in JAX)
    assert rep["unmatched"] == sorted(
        ["feature_extractor.conv0.0.bn.num_batches_tracked",
         "extra_head.weight"] + detail)
    assert sorted(t for t, _ in rep["missing"]) == sorted(detail)


@pytest.mark.parametrize("prefix,wrap", [("", False), ("module.", False),
                                         ("", True)])
def test_prefix_and_wrapper_handled(case, tmp_path, prefix, wrap):
    ref = save_pkl(tmp_path / "a.pkl", case["state"])
    other = save_pkl(tmp_path / "b.pkl", case["state"], prefix, wrap)
    a, b = port_import(ref)[0].state_dict(), port_import(other)[0].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_non_tensor_objects_refused(case, tmp_path):
    path = save_pkl(tmp_path / "ref.pkl", case["state"],
                    args=argparse.Namespace(lr=1e-3))
    with pytest.raises(ValueError, match="plain containers"):
        port_import(path)
    # plain containers of numbers and tensors load
    port_import(save_pkl(tmp_path / "ok.pkl", case["state"], epoch=3,
                         optimizer_state={"lr": [1e-3]}))
