"""The port's eval CLI (decnet_tpu_torch/cli/eval.py) against decnet_tpu's
on the same fixture suites and the same small checkpoint, on the CPU in
f32: per batch and mean EPE and loss_3 within 1e-3 (the two forwards
differ by ~1e-5 px: their convolutions sum in other orders, which no
pixel's 3 px test resolves on these fixtures; one pixel crossing it would
move loss_3 by 100 / pixels, ~0.01).  Also the submission mode, the
failure dump, --exec_s2d (a faithful checkpoint through its exact s2d
twin: the same EPE), the train CLI's host path for one step, its parser
against JAX's, and the demo's default checkpoint (none, as JAX's)."""
import json
import math
import os

import numpy as np
import pytest
import torch

from decnet_tpu.cli import eval as jax_eval
from decnet_tpu.train import metrics as jax_metrics
from decnet_tpu_torch.cli import eval as teval
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.data import io as tio
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train.checkpoint import save_params
from tests.test_torch_datasets import write_middlebury, write_packs

TOL = 1e-3
TINY = dict(max_disp=54, base_channels=4, num_stage=4, down_scale=3,
            dtype="float32", match_temp=3.0, match_temp_learned=True,
            cand_fallback=True)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny faithful checkpoint both packages read (config.json +
    params.npz in the flax layout)."""
    path = tmp_path_factory.mktemp("ckpt")
    cfg = Config()
    cfg.model = ModelConfig(**TINY)
    torch.manual_seed(0)
    save_params(str(path), DecNet(cfg.model), cfg)
    return str(path)


def run_jax(argv, monkeypatch):
    """JAX's eval CLI; returns each sample's (epe, loss_3) as its
    epe_and_d1 computed them."""
    seen = []
    real = jax_metrics.epe_and_d1

    def spy(pred, gt, max_disp):
        epe, d1 = real(pred, gt, max_disp)
        seen.append((float(epe), float(d1)))
        return epe, d1
    monkeypatch.setattr(jax_metrics, "epe_and_d1", spy)
    jax_eval.main(argv)
    return seen


def eval_argv(root, ckpt, dataset, split, out, batch):
    return ["--dataset", dataset, "--root", root, "--test_split", split,
            "--batch_size", str(batch), "--num_workers", "1",
            "--save2where", out, "--resume", ckpt]


@pytest.mark.parametrize("suite", ["sceneflow", "middlebury"])
def test_eval_cli_matches_jax(suite, ckpt, tmp_path, monkeypatch, capsys):
    root = str(tmp_path / "data")
    if suite == "sceneflow":
        write_packs(root, "test", n=4, masks=False)
        argv = eval_argv(root, ckpt, "sceneflow", "test",
                         str(tmp_path / "out"), 2)
        per_batch = 2
    else:
        # two scenes of different ndisp, batch 1: forwards at 54 and 108
        write_middlebury(root, ndisps=(50, 100, 100))
        os.remove(os.path.join(root, "MiddEval3H_processed", "trainingH",
                               "Motorcycle-0.91.pkl"))
        argv = eval_argv(root, ckpt, "middlebury", "eval_H",
                         str(tmp_path / "out"), 1)
        per_batch = 1
    want = run_jax(argv, monkeypatch)
    got = teval.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "MEAN EPE" in out
    n = len(want)
    assert n == per_batch * len(got["epe"]) and n >= 2
    want_epe = [np.mean([e for e, _ in want[i:i + per_batch]])
                for i in range(0, n, per_batch)]
    want_d1 = [np.mean([d for _, d in want[i:i + per_batch]])
               for i in range(0, n, per_batch)]
    np.testing.assert_allclose(got["epe"], want_epe, rtol=0, atol=TOL)
    np.testing.assert_allclose(got["d1"], want_d1, rtol=0, atol=TOL)
    np.testing.assert_allclose(got["mean_epe"], np.mean([e for e, _ in want]),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got["mean_d1"], np.mean([d for _, d in want]),
                               rtol=0, atol=TOL)
    if suite == "middlebury":
        assert got["max_disp"] == [54, 108]
    else:
        assert got["max_disp"] == [216, 216]


def test_eval_cli_submission_and_failure_dump(ckpt, tmp_path, monkeypatch):
    root = str(tmp_path / "data")
    write_packs(root, "test", n=2, masks=False)
    out = str(tmp_path / "out")
    argv = eval_argv(root, ckpt, "sceneflow", "test", out, 2) + [
        "--device", "cpu"]
    teval.main(argv + ["--is_eval", "0"])
    for name in ("0000", "0001"):
        png = tio.read_png(os.path.join(out, name + ".png"))
        # cropped back to the pack's 63x99 (padded to 81x108 for the model)
        assert png.dtype == np.uint16 and png.shape == (63, 99)
        assert png.max() > 0

    def broken(self, *a, **k):
        raise RuntimeError("planted fault")
    monkeypatch.setattr(DecNet, "forward", broken)
    with pytest.raises(RuntimeError, match="planted fault"):
        teval.main(argv)
    with np.load(os.path.join(out, "Errors", "batch0.npz")) as z:
        assert z["left"].shape == (2, 81, 108, 3) and z["gt"].shape == \
            (2, 81, 108)
        assert [z[f"lmask{i}"].shape for i in range(3)] == [
            (2, 9, 12), (2, 27, 36), (2, 81, 108)]


def test_eval_cli_refuses_exec_s2d(ckpt, tmp_path, capsys):
    """(Named for the refusal it checked while --exec_s2d was not ported;
    the name is kept so its record reads on across runs.)  --exec_s2d is
    no longer refused: the faithful checkpoint runs
    through its s2d twin (`models/repack.py::s2d_exec_model`) with the
    EPE and loss_3 of the faithful run within 1e-4 (the packed convs sum
    in another order)."""
    root = str(tmp_path / "data")
    write_packs(root, "test", n=2, masks=False)
    argv = eval_argv(root, ckpt, "sceneflow", "test", str(tmp_path / "o"),
                     2) + ["--device", "cpu"]
    plain = teval.main(argv)
    packed = teval.main(argv + ["--exec_s2d", "1"])
    assert len(packed["epe"]) == len(plain["epe"]) == 1
    np.testing.assert_allclose(packed["epe"], plain["epe"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(packed["d1"], plain["d1"], rtol=0, atol=1e-4)


def train_cli_argvs(tmp_path):
    """Argument lists both train CLIs take: the reference's flags, a JSON
    config with flags and overrides over it, and a YAML config."""
    yml = tmp_path / "cfg.yaml"
    yml.write_text("model:\n  max_disp: 54\n  use_detail: true\n"
                   "  thold_mode: quantile\nloss:\n  weights: [1, 1, 1, "
                   "0.5]\ntrain:\n  lr: 0.0005\n  batch_size: 2\n")
    faithful = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "runs", "ckpt_faithful", "config.json")
    head = ["--dataset", "synthetic", "--root", "unused"]
    return [head + ["--max_disp", "54", "--use_detail", "1", "--seed", "3"],
            head + ["--config", faithful, "--base_channels", "4", "--thold",
                    "0.5", "--down_func_name", "bilinear", "--num_stage",
                    "4", "--set", "train.batch_size=2", "--set",
                    "model.match_window=12"],
            head + ["--config", str(yml), "--down_scale", "3", "--set",
                    "model.detail_density=0.3"]]


def test_train_cli_takes_the_reference_flags_as_jax(tmp_path):
    """The port's train CLI builds, from each argument list, the Config
    JAX's train CLI builds (`add_config_args` + `build_config`), key for
    key of the port's schema (the dataset and root, which the port's
    config also records, aside)."""
    import argparse
    from decnet_tpu.cli import common as jcommon
    for argv in train_cli_argvs(tmp_path):
        p = argparse.ArgumentParser()
        jcommon.add_config_args(p)
        jargs, _ = p.parse_known_args(argv)
        want = jcommon.build_config(jargs).to_dict()
        got = tcli.build_config(tcli.parse_args(argv)).to_dict()
        got["data"].pop("dataset"), got["data"].pop("root")
        for section, d in got.items():
            for k, v in d.items():
                w = want[section][k]
                assert (list(v) if isinstance(v, tuple) else v) == (
                    list(w) if isinstance(w, tuple) else w), (argv,
                                                              section, k)
    cfg = tcli.build_config(tcli.parse_args(train_cli_argvs(tmp_path)[2]))
    assert cfg.model.use_detail and cfg.model.thold_mode == "quantile"
    assert cfg.loss.weights == (1, 1, 1, 0.5) and cfg.train.lr == 0.0005


def test_yaml_config_needs_pyyaml(tmp_path, monkeypatch):
    import builtins
    from decnet_tpu_torch.config import load_full_config
    yml = tmp_path / "c.yml"
    yml.write_text("train:\n  seed: 5\n")
    assert load_full_config(str(yml)).train.seed == 5
    real = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML"):
        load_full_config(str(yml))


def test_demo_default_checkpoint_is_none_as_jax(tmp_path, monkeypatch):
    """Without --resume the demo serves a fresh initialisation, as JAX's
    (decnet_tpu/cli/common.py:28 defaults --resume to none)."""
    import argparse
    from decnet_tpu.cli import common as jcommon
    from decnet_tpu_torch.cli import demo
    p = argparse.ArgumentParser()
    jcommon.add_config_args(p)
    assert p.parse_args([]).resume is None
    seen = []

    def stop(cfg, resume=None, device="cuda"):
        seen.append(resume)
        raise KeyboardInterrupt
    monkeypatch.setattr(demo, "init_model_and_state", stop)
    with pytest.raises(KeyboardInterrupt):
        demo.main(["--root", str(tmp_path), "--save2where",
                   str(tmp_path / "o"), "--device", "cpu"])
    assert seen == [None]


def test_train_cli_host_path_one_step(tmp_path, capsys):
    """cli.train --dataset sceneflow --set data.on_device=false: one step
    from the packs on the CPU, rc 0 (no exception), a finite loss and the
    loader's wait in the log line."""
    root = str(tmp_path / "data")
    write_packs(root, "train", n=4, masks=False)
    tcli.main(["--dataset", "sceneflow", "--root", root, "--device", "cpu",
               "--ckpt_dir", str(tmp_path / "run"), "--steps", "1",
               "--set", "data.on_device=false", "--set",
               "model.max_disp=54", "--set", "model.base_channels=4",
               "--set", "model.dtype=float32", "--set",
               "train.batch_size=2", "--set", "train.crop_h=54", "--set",
               "train.crop_w=81", "--set", "train.log_every=1", "--set",
               "data.num_workers=2"])
    logs = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(logs) == 1 and logs[0]["step"] == 1
    assert math.isfinite(logs[0]["loss"]) and logs[0]["loader_wait_s"] >= 0
    assert os.path.isfile(tmp_path / "run" / "1" / "params.npz")
    # cli.common resumes the run's newest step for serving; a directory of
    # numbered steps the port did not write (an Orbax one) is refused
    from decnet_tpu_torch.cli import common
    from decnet_tpu_torch.config import load_full_config
    cfg = load_full_config(str(tmp_path / "run"))
    model, step = common.init_model_and_state(cfg, str(tmp_path / "run"),
                                              device="cpu")
    want = torch.load(tmp_path / "run" / "1" / "train_state.pt",
                      weights_only=True)["step"]
    assert step == want == 1 and not model.training
    ref = DecNet(cfg.model)
    from decnet_tpu_torch.weights import load_flax_variables
    load_flax_variables(ref, str(tmp_path / "run" / "1" / "params.npz"))
    assert all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), ref.state_dict().values()))
    (tmp_path / "orbax" / "100" / "default").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Orbax"):
        common.init_model_and_state(cfg, str(tmp_path / "orbax"),
                                    device="cpu")


def test_clis_default_to_the_card(ckpt, tmp_path):
    """Without --device the eval, train and demo CLIs ask for the card,
    and raise where there is none instead of running on the CPU."""
    from decnet_tpu_torch.cli import demo
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs would run on it")
    root = str(tmp_path / "data")
    write_packs(root, "test", n=1, masks=False)
    (tmp_path / "scenes" / "s0").mkdir(parents=True)
    calls = [
        lambda: teval.main(eval_argv(root, ckpt, "sceneflow", "test",
                                     str(tmp_path / "out"), 1)),
        lambda: tcli.main(["--dataset", "sceneflow", "--root", root,
                           "--train_split", "test", "--set",
                           "data.on_device=false", "--ckpt_dir",
                           str(tmp_path / "run")]),
        lambda: demo.main(["--root", str(tmp_path / "scenes"),
                           "--save2where", str(tmp_path / "d"),
                           "--resume", ckpt])]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
