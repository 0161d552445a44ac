"""Resumable training in the port, on the CPU with a tiny model of
ckpt_detail_r5's recipe (s2d, window, quantile detail heads, alpha):
`train/checkpoint.py::CheckpointManager`, `device_batch_stream(start_step=)`
and the train CLI's resume flow.

Bit-exact throughout: a resumed run redoes nothing and draws the batches
an unbroken run draws, so on one machine its parameters, batch-norm
statistics, optimizer state and step equal the unbroken run's bit for
bit.  The port's `params.npz` is read back by the JAX package's strict
`load_params` onto the JAX model's template with no array left over."""
import itertools
import json
import os

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.train import checkpoint as jckpt
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.data import device_synth as tsynth
from decnet_tpu_torch.train.checkpoint import (PARAMS_FILE, STATE_FILE,
                                               CheckpointManager)
from decnet_tpu_torch.weights import flax_arrays_from_model
from tests.test_torch_model import template

RUNS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "runs")
DETAIL = os.path.join(RUNS, "ckpt_detail_r5")
TINY = ["--set", "model.max_disp=54", "--set", "model.base_channels=4",
        "--set", "model.dtype=float32", "--set", "train.batch_size=1",
        "--set", "train.crop_h=54", "--set", "train.crop_w=81",
        "--set", "train.log_every=1", "--set", "train.warmup_steps=1",
        "--set", "train.freeze_bn_after=3", "--set", "train.keep_ckpts=2",
        "--set", "train.ckpt_every=1"]


def argv(ckpt_dir, steps=4, init_from=None):
    a = ["--config", os.path.join(DETAIL, "config.json"), "--dataset",
         "synthetic", "--ckpt_dir", str(ckpt_dir), "--steps", str(steps),
         "--device", "cpu"] + TINY
    return a + (["--init_from", init_from] if init_from else [])


def assert_same_state(a: tcli.Run, b: tcli.Run):
    assert a.state.step == b.state.step
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    assert set(sa) == set(sb)
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    oa, ob = (r.state.optimizer.state_dict() for r in (a, b))
    assert oa["param_groups"] == ob["param_groups"]
    assert set(oa["state"]) == set(ob["state"])
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """Four steps of an unbroken run."""
    r = tcli.prepare(argv(tmp_path_factory.mktemp("straight")))
    tcli.run(r)
    return r


def test_two_plus_resume_plus_two_equals_four_straight(straight, tmp_path,
                                                       capsys):
    first = tcli.prepare(argv(tmp_path))
    first.stream = itertools.islice(first.stream, 2)   # stopped at step 2
    tcli.run(first)
    assert first.state.step == 2
    assert CheckpointManager(str(tmp_path)).steps() == [1, 2]
    capsys.readouterr()
    resumed = tcli.prepare(argv(tmp_path))
    assert "Restored checkpoint step 2" in capsys.readouterr().out
    assert resumed.state.step == 2
    # the optimizer's moments came back with the parameters
    assert_same_state(first, resumed)
    tcli.run(resumed)
    assert resumed.state.step == 4
    assert_same_state(straight, resumed)
    # keep_ckpts 2: the two newest steps are kept
    assert CheckpointManager(str(tmp_path)).steps() == [3, 4]
    # the freeze-BN tail (freeze_bn_after 3) ran in both
    assert resumed.freeze_bn()


def test_restore_brings_back_every_part(straight, tmp_path):
    """A fresh state restored from the unbroken run's newest step equals
    that run's state; a directory with no step is refused."""
    fresh = tcli.prepare(argv(tmp_path))
    assert fresh.state.step == 0
    mgr = CheckpointManager(straight.cfg.train.ckpt_dir)
    assert mgr.latest_step() == 4
    for name in (PARAMS_FILE, STATE_FILE):
        assert os.path.isfile(os.path.join(mgr.directory, "4", name))
    mgr.restore(fresh.state)
    assert_same_state(straight, fresh)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh.state)


def test_stream_started_at_k_yields_batch_k():
    kw = dict(batch=1, h=27, w=54, max_disp=27, device="cpu")
    s0 = tsynth.device_batch_stream(7, **kw)
    batches = [next(s0) for _ in range(4)]
    s3 = tsynth.device_batch_stream(7, start_step=3, **kw)
    for want in batches[3:]:
        got = next(s3)
        assert set(got) == set(want)
        for k, v in want.items():
            vs, gs = (v, got[k]) if isinstance(v, list) else ([v], [got[k]])
            for a, b in zip(gs, vs):
                assert torch.equal(a, b), k


def test_init_from_is_ignored_when_resuming(straight, capsys):
    """A run whose --ckpt_dir holds a checkpoint resumes it: --init_from
    warm-starts nothing, and the stream goes on at the restored step."""
    capsys.readouterr()
    r = tcli.prepare(argv(straight.cfg.train.ckpt_dir, steps=6,
                          init_from=DETAIL))
    out = capsys.readouterr().out
    assert "Restored checkpoint step 4" in out and "warm-start" not in out
    assert_same_state(straight, r)
    want = next(tsynth.device_batch_stream(
        r.cfg.train.seed, batch=1, h=54, w=81, max_disp=54, device="cpu",
        levels=3, thold=r.cfg.data.mask_thold, start_step=4))
    assert torch.equal(next(r.stream)["gt"], want["gt"])
    # and on a fresh directory it does warm-start
    fresh = tcli.prepare(argv(os.path.join(straight.cfg.train.ckpt_dir,
                                           "fresh"), init_from=DETAIL))
    assert fresh.state.step == 0
    assert "warm-start params:" in capsys.readouterr().out


def test_port_checkpoint_loads_in_jax_with_no_leftover(straight):
    """The s2d + detail model's params.npz, of the newest step and of the
    serving snapshot, onto the JAX template by the strict `load_params`."""
    cfg = straight.cfg
    mcfg = dict(cfg.model.__dict__, matching_impl="xla")
    x = np.zeros((1, 54, 81, 3), np.float32)
    m = [np.zeros((1, 54 // s, 81 // s), np.float32) for s in (9, 3, 1)]
    tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  template(JaxModelConfig(**mcfg), x, x, m, m))
    arrays = flax_arrays_from_model(straight.state.model)
    for path in (os.path.join(cfg.train.ckpt_dir, "4", PARAMS_FILE),
                 os.path.join(cfg.train.ckpt_dir, PARAMS_FILE)):
        loaded = jckpt.load_params(path, tmpl)
        leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
        assert len(leaves) == len(arrays)
        for key, leaf in leaves:
            k = "/".join(str(p) for p in key)
            np.testing.assert_array_equal(np.asarray(leaf), arrays[k])
    assert any("detail_2" in k for k in arrays)


def test_params_snapshot_restored_as_jax_does(tmp_path, monkeypatch, capsys):
    """A --ckpt_dir holding only a params snapshot (`params.npz` +
    `meta.json`, as every runs/ckpt_*) is restored as JAX's
    `init_model_and_state` restores it (decnet_tpu/cli/common.py:115-131):
    its parameters and BN statistics, at its step, with a fresh optimizer
    whose schedule starts again (optax's count is 0); the stream starts at
    that step and the snapshot's file is left as it was.

    JAX's function jits the model's init only to build a template that
    the snapshot then overwrites; here that init is given as shapes and
    zeros (`jax.eval_shape`), which saves ~25 s of compilation and changes
    no restored value."""
    from decnet_tpu.cli import common as jcommon
    from decnet_tpu.config import Config as JaxFullConfig
    from decnet_tpu_torch.train.checkpoint import save_params
    snap = tmp_path / "snap"
    src = tcli.prepare(argv(tmp_path / "src"))
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for k, t in src.state.model.state_dict().items():
            noise = 0.01 * torch.randn(t.shape, generator=gen)
            t.add_(noise.abs() if k.endswith("running_var") else noise)
    save_params(str(snap), src.state.model, src.cfg)
    with open(snap / "meta.json", "w") as f:
        json.dump({"step": 2}, f)
    npz = snap / PARAMS_FILE
    before = npz.read_bytes()
    capsys.readouterr()

    run = tcli.prepare(argv(snap))
    assert f"Restored params snapshot (step 2) from {npz}" in \
        capsys.readouterr().out
    assert run.state.step == 2 and run.state.schedule_from == 2
    assert npz.read_bytes() == before
    assert not run.state.optimizer.state_dict()["state"]
    got = flax_arrays_from_model(run.state.model)
    with np.load(npz) as z:
        assert sorted(z.files) == sorted(got)
        for k in z.files:
            np.testing.assert_array_equal(got[k], z[k], err_msg=k)
    want = next(tsynth.device_batch_stream(
        run.cfg.train.seed, batch=1, h=54, w=81, max_disp=54, device="cpu",
        levels=3, thold=run.cfg.data.mask_thold, start_step=2))
    assert torch.equal(next(run.stream)["gt"], want["gt"])

    real_eval_shape = jax.eval_shape

    def shape_only(fn):
        return lambda *a, **k: jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), real_eval_shape(fn, *a,
                                                                  **k))
    monkeypatch.setattr(jax, "jit", shape_only)
    jcfg = JaxFullConfig.load(str(snap / "config.json"))
    _, state, _ = jcommon.init_model_and_state(jcfg, str(snap))
    monkeypatch.undo()
    assert int(state.step) == run.state.step
    counts = [int(c) for c in jax.tree_util.tree_leaves(state.opt_state)
              if np.ndim(c) == 0 and np.issubdtype(np.asarray(c).dtype,
                                                   np.integer)]
    assert counts and not any(counts)
    leaves = jax.tree_util.tree_flatten_with_path(
        {"params": state.params, "batch_stats": state.batch_stats})[0]
    assert len(leaves) == len(got)
    for key, leaf in leaves:
        k = "/".join(str(p) for p in key)
        np.testing.assert_array_equal(np.asarray(leaf), got[k], err_msg=k)
