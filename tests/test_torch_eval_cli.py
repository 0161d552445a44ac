"""The port's eval CLI (decnet_tpu_torch/cli/eval.py) against decnet_tpu's
on the same fixture suites and the same small checkpoint, on the CPU in
f32: per batch and mean EPE and loss_3 within 1e-3 (the two forwards
differ by ~1e-5 px: their convolutions sum in other orders, which no
pixel's 3 px test resolves on these fixtures; one pixel crossing it would
move loss_3 by 100 / pixels, ~0.01).  Also the submission mode, the
failure dump, the refusal of --exec_s2d, and the train CLI's host path
for one step."""
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


def test_eval_cli_refuses_exec_s2d(ckpt, tmp_path):
    with pytest.raises(NotImplementedError, match="section 1, item 2"):
        teval.main(eval_argv(str(tmp_path), ckpt, "sceneflow", "test",
                             str(tmp_path), 1) + ["--exec_s2d", "1",
                                                  "--device", "cpu"])


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
