"""The model configurations beyond the faithful one — the `cat` and `ssd`
costs, the `gn` norm, 1 to 3 stages and the bicubic skip of fine stages
(decnet_tpu_torch/config.py) — against decnet_tpu's DecNet in f32 on the
CPU, with the same weights carried across by the weight bridge.

The weights are drawn from a seed in numpy for the JAX model's own
variable tree (He-scaled kernels, the last ones of the Refinement and of the soft
attention scaled down, norm scales
and biases and batch-norm statistics away from their initial values, so that a transposed kernel or
a swapped norm parameter shows), then nested for JAX and loaded into the
port by `weights.load_flax_variables`.  Tolerance 1e-3 px on every stage's
prediction, as tests/test_torch_model.py holds the faithful model.  The
skip runs JAX's full tree with its per-call `skip_stage_id` and the port's
model built for the skip, which leaves the skipped heads' arrays out."""
import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.weights import (flax_arrays_from_model,
                                      load_flax_variables, nest_variables)
from tests.test_torch_layers import nchw
from tests.test_torch_model import (DISP_TOL, assert_warp_inputs_in_range,
                                    flat_paths)

H, W = 54, 81
SMALL = dict(max_disp=54, base_channels=4, down_scale=3, use_detail=False)


def inputs(ns, seed=0):
    """(left, right) NHWC in [0,1] and random masks per fine stage."""
    rng = np.random.RandomState(seed)
    left = rng.rand(1, H, W, 3).astype(np.float32)
    right = np.roll(left, -4, axis=2) + 0.05 * rng.rand(1, H, W, 3).astype(
        np.float32)
    lmasks, rmasks = [], []
    for stage in range(1, ns):
        s = 3 ** (ns - 1 - stage)
        lmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
        rmasks.append((rng.rand(1, H // s, W // s) < 0.3).astype(np.float32))
    return left, right, lmasks, rmasks


def seeded_variables(jcfg, args, seed=1):
    """Values from a seed for every leaf of the JAX model's variables."""
    tree = jax.eval_shape(get_model("decnet", jcfg).init,
                          jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in sorted(flat_paths(tree).items()):
        shape, name = leaf.shape, path[-1]
        if name == "kernel":
            fan_out = int(np.prod(shape[:-2])) * shape[-1]
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_out)
            if path[-3] == "c6":
                # small residuals keep the Refinement's disparities inside
                # the port's warp range (tests/test_torch_model.py)
                v *= 0.05
            if path[-4].startswith("soft_att") and path[-3] == "c2":
                # a flatter soft mask: fusion = dense + soft * (sparse -
                # dense) multiplies the mask's f32 noise (from the variance,
                # ~d^2) by the branches' gap, tens of px at random weights
                v *= 0.2
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.8, 1.25, shape)
        elif name in ("bias", "mean"):
            v = 0.05 * rng.randn(*shape)
        else:                                   # match_logt_i
            v = np.zeros(shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = np.asarray(v, np.float32)
    return out


def run_both(jcfg, tcfg, variables, args, skip=None):
    want = jax.jit(lambda v, *a: get_model("decnet", jcfg).apply(
        v, *a, skip_stage_id=skip))(variables, *args)
    model = DecNet(tcfg)
    n = load_flax_variables(model, variables)
    left, right, lmasks, rmasks = args
    with torch.no_grad():
        got = model.eval()(nchw(left), nchw(right),
                           [torch.from_numpy(m) for m in lmasks],
                           [torch.from_numpy(m) for m in rmasks])
    return want, got, n


CASES = {
    "cat": dict(cost_func="cat"),
    "ssd": dict(cost_func="ssd"),
    "gn": dict(norm="gn"),
    "ns3": dict(num_stage=3),
    "ns2": dict(num_stage=2),
    "ns1": dict(num_stage=1),
    "skip3": dict(skip_stage_id=3),
    "skip2": dict(skip_stage_id=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    knobs = dict(dict(SMALL, num_stage=4), **CASES[case])
    ns, skip = knobs["num_stage"], knobs.pop("skip_stage_id", None)
    args = inputs(ns)
    jcfg = JaxConfig(**knobs, dtype="float32", matching_impl="xla")
    # the skip: JAX's full tree with its per-call skip, the port's model
    # built for the skip taking the full tree
    variables = seeded_variables(jcfg, args)
    tcfg = ModelConfig(**knobs, dtype="float32",
                       **({} if skip is None else {"skip_stage_id": skip}))
    want, got, n = run_both(jcfg, tcfg, variables, args, skip)
    assert n == len(DecNet(tcfg).state_dict())
    assert len(got["preds"]) == len(want["preds"]) == ns
    fine = [s for s in range(1, ns) if skip is None or s < skip]
    assert len(got["fusion"]) == len(fine)
    if fine:
        assert_warp_inputs_in_range(got, knobs["max_disp"], ns=ns)
    for s in range(ns):
        assert got["preds"][s].shape == tuple(want["preds"][s].shape)
        np.testing.assert_allclose(got["preds"][s].numpy(),
                                   np.asarray(want["preds"][s]), rtol=0,
                                   atol=DISP_TOL, err_msg=f"preds[{s}]")
    for key in ("dense", "sparse", "fusion"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=DISP_TOL, err_msg=f"{key}[{i}]")


@pytest.mark.parametrize("knobs", [dict(cost_func="cat"), dict(norm="gn"),
                                   dict(num_stage=2)],
                         ids=["cat", "gn", "ns2"])
def test_bridge_round_trip(knobs):
    """The port's own tensors under flax names fill the JAX model's tree
    exactly and come back unchanged."""
    cfg = dict(SMALL, **knobs)
    args = inputs(cfg.get("num_stage", 4))
    jcfg = JaxConfig(**cfg, dtype="float32", matching_impl="xla")
    tree = jax.eval_shape(get_model("decnet", jcfg).init,
                          jax.random.PRNGKey(0), *args)
    torch.manual_seed(0)
    model = DecNet(ModelConfig(**cfg, dtype="float32"))
    arrays = flax_arrays_from_model(model)
    nested = nest_variables(arrays)
    shapes = {p: v.shape for p, v in flat_paths(tree).items()}
    assert {p: v.shape for p, v in flat_paths(nested).items()} == shapes
    twin = DecNet(ModelConfig(**cfg, dtype="float32"))
    load_flax_variables(twin, nested)
    for k, v in model.state_dict().items():
        assert torch.equal(twin.state_dict()[k], v), k


@pytest.mark.parametrize("knob", [dict(norm="gn"), dict(cost_func="cat")],
                         ids=["gn", "cat"])
def test_first_train_step_matches_jax(knob):
    """One train step of the small faithful recipe of
    tests/test_torch_train_step.py with the knob set, from the same JAX
    initialisation: the loss and its terms within 1e-5 relative, the
    gradients within 1e-3 of JAX's relative to their norm (the tolerances
    and their reasons are that module's)."""
    import copy
    from decnet_tpu.train.state import create_train_state as jax_state
    from decnet_tpu.train.step import make_train_step
    from decnet_tpu_torch.train import step as tstep
    from tests import test_torch_train_step as ts
    from tests.test_torch_model import FAITHFUL_SMALL
    jcfg, tcfg = ts.configs()
    small = dict(FAITHFUL_SMALL, **knob)
    jcfg.model = JaxConfig(**small, dtype="float32", matching_impl="xla")
    tcfg.model = ModelConfig(**small, dtype="float32")
    batch = ts.make_batch(1)
    model, variables = ts.init_variables(jcfg, batch)
    jst = jax_state(model, variables, jcfg.train)
    jst, jlogs = make_train_step(model, jcfg, donate=False)(jst, batch)
    tst = ts.port_state(tcfg, variables)
    tb = ts.torch_batch(batch)
    ts.assert_warp_inputs_in_range(copy.deepcopy(tst.model), tb,
                                   tcfg.model.max_disp)
    tlogs = tstep.train_step(tst, tb, tcfg)
    grads = {k: p.grad.clone() for k, p in tst.model.named_parameters()}
    ts.assert_first_step_matches(jst, {k: float(v) for k, v in jlogs.items()},
                                 {k: float(v) for k, v in tlogs.items()},
                                 grads)


@pytest.mark.parametrize("argv", [
    ["--num_stage", "3", "--cost_func", "cat", "--skip_stage_id", "2"],
    ["--cost_func", "ssd", "--set", "model.norm=gn", "--num_stage", "1"],
    ["--resume", "runs/ckpt_faithful", "--skip_stage_id", "3",
     "--set", "model.cost_func=cat"],
], ids=["flags", "set", "sidecar"])
def test_cli_takes_the_knobs_as_jax(argv):
    """The eval and demo CLIs' config (`cli/common.py`: the reference's
    flags, `--set`, then a checkpoint's sidecar with the flags re-applied)
    holds the knobs as JAX's CLI puts them."""
    import argparse
    import os
    from decnet_tpu.cli import common as jcommon
    from decnet_tpu_torch.cli import common as tcommon
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [os.path.join(root, a) if a.startswith("runs/") else a
            for a in argv]
    configs = []
    for common in (jcommon, tcommon):
        p = argparse.ArgumentParser()
        common.add_config_args(p)
        args = p.parse_args(argv)
        configs.append(common.apply_checkpoint_sidecar(
            common.build_config(args), args).model)
    want, got = configs
    for k in ("num_stage", "cost_func", "skip_stage_id", "norm",
              "max_disp", "base_channels"):
        assert getattr(got, k) == getattr(want, k), k
    DecNet(got)                      # and the port builds it
