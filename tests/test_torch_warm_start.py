"""The port's warm start (`weights.warm_start`, the train CLI's --init_from)
against decnet_tpu's `CheckpointManager.restore_partial`, on the CPU.

One JAX train state of the faithful small configuration is perturbed (so
that restored values differ from a fresh initialisation), one parameter is
removed and one reshaped, and it is written both as a `params.npz` (the
JAX package's `save_params`) and as an Orbax checkpoint.  The port warm
starts a fresh model from the npz: every matched tensor equals the JAX
value in the port's layout (exactly), the removed and the reshaped tensor
keep their fresh values, and the restored / fresh counts equal those that
`restore_partial` prints for the same checkpoint."""
import contextlib
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from decnet_tpu.cli.common import init_model_and_state
from decnet_tpu.config import Config as JaxConfig
from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.train.checkpoint import CheckpointManager, save_params
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.weights import state_dict_from_flax, warm_start
from tests.test_torch_model import FAITHFUL_SMALL

REMOVED = ("params", "refine_1", "c6", "Conv_0", "bias")
RESHAPED = ("params", "dyn_up_2", "w0", "Conv_0", "kernel")
_SUMMARY = re.compile(r"warm-start (\w+): (\d+) restored, (\d+) "
                      r"fresh-initialised")


def summaries(text):
    return {m.group(1): (int(m.group(2)), int(m.group(3)))
            for m in _SUMMARY.finditer(text)}


def edit(tree, path, fn):
    """A copy of nested dict `tree` with the leaf at `path` replaced by
    fn(leaf), or removed when fn returns None."""
    out = dict(tree)
    if len(path) == 1:
        new = fn(out[path[0]])
        if new is None:
            del out[path[0]]
        else:
            out[path[0]] = new
        return out
    out[path[0]] = edit(tree[path[0]], path[1:], fn)
    return out


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(npz path, JAX restore_partial's counts, the saved variables)."""
    root = tmp_path_factory.mktemp("warm")
    cfg = JaxConfig()
    cfg.model = JaxModelConfig(**FAITHFUL_SMALL, dtype="float32",
                               matching_impl="xla")
    _, state, _ = init_model_and_state(cfg, None)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.5),
        {"params": state.params, "batch_stats": state.batch_stats})
    variables = edit(variables, REMOVED, lambda leaf: None)
    variables = edit(variables, RESHAPED,
                     lambda leaf: leaf.reshape(leaf.shape[0], -1, 1, 1))
    npz = str(root / "params.npz")
    save_params(npz, variables)
    mgr = CheckpointManager(str(root / "orbax"), keep=1)
    mgr.save(1, state.replace(params=variables["params"],
                              batch_stats=variables["batch_stats"]))
    _, fresh, _ = init_model_and_state(cfg, None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mgr.restore_partial(fresh)
    return npz, summaries(buf.getvalue()), variables


def test_warm_start_matches_restore_partial(checkpoint, capsys):
    npz, jax_counts, variables = checkpoint
    torch.manual_seed(0)
    model = DecNet(ModelConfig(**FAITHFUL_SMALL, dtype="float32"))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    counts = warm_start(model, npz)
    printed = summaries(capsys.readouterr().out)
    assert set(jax_counts) == {"params", "batch_stats"}
    assert printed == jax_counts == counts
    assert counts["params"][1] == 2 and counts["batch_stats"][1] == 0

    # the port's layout of every array the checkpoint holds, less the two
    # edited ones
    saved = state_dict_from_flax(edit(variables, RESHAPED, lambda leaf: None))
    kept = {"refine_1.c6.conv.bias", "dyn_up_2.w0.conv.weight"}
    got = model.state_dict()
    assert set(got) == set(saved) | kept
    for k, v in got.items():
        if k in kept:
            assert torch.equal(v, fresh[k]), k
        else:
            assert torch.equal(v, saved[k]), k
            assert not torch.equal(v, fresh[k]), k


def test_train_cli_init_from_warm_starts(checkpoint, tmp_path, capsys):
    """--init_from loads the partial checkpoint into the f32 train state
    instead of refusing it."""
    npz, jax_counts, _ = checkpoint
    overrides = [f"model.{k}={v}" for k, v in FAITHFUL_SMALL.items()]
    overrides += ["model.dtype=float32", "data.on_device=true",
                  "train.batch_size=1",
                  "train.crop_h=54", "train.crop_w=54"]
    argv = ["--dataset", "synthetic", "--init_from", os.path.dirname(npz),
            "--ckpt_dir", str(tmp_path), "--steps", "1", "--device", "cpu"]
    for o in overrides:
        argv += ["--set", o]
    run = tcli.prepare(argv)
    assert summaries(capsys.readouterr().out) == jax_counts
    want = state_dict_from_flax(npz)["refine_0.c0.conv.weight"]
    got = run.state.model.state_dict()["refine_0.c0.conv.weight"]
    assert got.dtype == torch.float32 and torch.equal(got, want)
