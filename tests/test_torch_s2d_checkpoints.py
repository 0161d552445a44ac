"""Every committed checkpoint through the port: its config is accepted,
the weight bridge maps every tensor both ways, and the trained s2d
checkpoints' forward equals decnet_tpu's in f32 on the CPU; then the
entry points that serve them (`cli/report_eval.py`, `cli/demo.py`) and
the train CLI's refusal of what is not trainable yet.

Tolerances: disparities 1e-3 px (tests/test_torch_model.py); the report's
EPEs are means of such disparities' errors, so 1e-3 px too, and its D1
(a share of pixels past 3 px) within 0.05 percentage points, under two
pixels of a 54x81 image (the smallest a report here averages over)."""
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu.ops.resize import interpolate as jinterpolate
from decnet_tpu.train.metrics import epe_and_d1 as jepe_and_d1
from decnet_tpu_torch.cli import demo
from decnet_tpu_torch.cli import report_eval
from decnet_tpu_torch.cli import train as tcli
from decnet_tpu_torch.config import load_config
from decnet_tpu_torch.data import io as tio
from decnet_tpu_torch.data.device_synth import device_batch_stream
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.nn.heads import RefinementS2D
from decnet_tpu_torch.ops.detail import detail_masks
from decnet_tpu_torch.weights import (flax_arrays_from_model,
                                      load_flax_variables)
from tests.test_torch_layers import nchw
from tests.test_torch_model import DISP_TOL, assert_warp_inputs_in_range

RUNS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "runs")
CKPTS = ("ckpt_faithful", "ckpt_flagship", "ckpt_stressor_r5",
         "ckpt_detail", "ckpt_detail_r5")
H, W = 54, 81
# the checkpoints' training crop and max_disp: there the trained models'
# disparities stay inside the warp's clip range [-16, max_disp], where the
# JAX warp off the TPU (unclipped) and the port's agree (at 162x243 with
# max_disp 108 stage 2 reaches 58 px against its 36 and the two differ)
REPORT_SHAPE = (162, 486, 216)


@pytest.fixture
def few_threads():
    """Two torch threads for the report's forwards at the training crop:
    the suite runs six workers at once, and more threads per worker only
    contend for the cores.  (The trained forwards' parity
    keeps torch's default: their 1e-3 px holds at its summation order.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ckpt(name):
    return os.path.join(RUNS, name)


def nested(path):
    """A params.npz as flax nests its variables."""
    variables = {}
    with np.load(path) as z:
        for k in z.files:
            node = variables
            parts = [p[2:-2] for p in k.split("/")]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[k]
    return variables


def jax_config(name, **kw):
    with open(os.path.join(ckpt(name), "config.json")) as f:
        model = json.load(f)["model"]
    model.update(dtype="float32", matching_impl="xla", **kw)
    return JaxConfig(**model)


@pytest.mark.parametrize("name", CKPTS)
def test_checkpoint_loads_with_no_leftover(name):
    """The sidecar is accepted and every array of params.npz fills one
    port tensor, every port tensor is filled (strict both ways), and the
    reverse bridge gives the arrays back bit for bit."""
    cfg = load_config(ckpt(name), dtype="float32")
    model = DecNet(cfg)
    path = os.path.join(ckpt(name), "params.npz")
    n = load_flax_variables(model, path)
    with np.load(path) as z:
        assert n == len(z.files) == len(model.state_dict())
        back = flax_arrays_from_model(model)
        assert set(back) == set(z.files)
        for k in z.files:
            np.testing.assert_array_equal(back[k], z[k], err_msg=k)


def stereo_inputs():
    """A textured pair seen 6 px apart, with the demo's masks."""
    rng = np.random.RandomState(2)
    tex = rng.rand(1, H, W + 6, 3).astype(np.float32)
    right01, left01 = tex[:, :, 6:], tex[:, :, :W]
    masks = [detail_masks(nchw(im), 3, 3, 0.3) for im in (left01, right01)]
    lmasks, rmasks = ([m.numpy() for m in ms] for ms in masks)
    left = tio.normalize_image(nchw(left01)).numpy().transpose(0, 2, 3, 1)
    right = tio.normalize_image(nchw(right01)).numpy().transpose(0, 2, 3, 1)
    return left, right, lmasks, rmasks


@pytest.mark.parametrize("name", ["ckpt_detail_r5", "ckpt_flagship",
                                  "ckpt_stressor_r5"])
def test_trained_s2d_forward_matches_jax(name):
    """s2d + window + quantile detail, s2d + window, s2d full band."""
    left, right, lmasks, rmasks = stereo_inputs()
    variables = nested(os.path.join(ckpt(name), "params.npz"))
    want = jax.jit(get_model("decnet", jax_config(name)).apply)(
        variables, left, right, lmasks, rmasks)
    model = DecNet(load_config(ckpt(name), dtype="float32"))
    load_flax_variables(model, variables)
    with torch.no_grad():
        got = model.eval()(nchw(left), nchw(right),
                           [torch.from_numpy(m) for m in lmasks],
                           [torch.from_numpy(m) for m in rmasks])
    assert_warp_inputs_in_range(got, model.cfg.max_disp)
    for key in ("preds", "dense", "sparse", "fusion", "residual",
                "left_details"):
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=DISP_TOL, err_msg=f"{key}[{i}]")
    for key in ("masks_used", "cand"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if model.cfg.use_detail:
        # the learned masks sit at the trained density
        assert abs(float(got["masks_used"][-1].mean()) - 0.25) < 0.05


def test_report_eval_matches_jax_metrics(few_threads):
    """The report of two tiny val batches equals the JAX script's
    arithmetic (scripts/report_eval.py) on the JAX model fed the same
    batches."""
    name, seed = "ckpt_detail_r5", 37
    h, w, max_disp = REPORT_SHAPE
    rep = report_eval.report(ckpt(name), h=h, w=w, max_disp=max_disp,
                             batch=1, batches=2, seed=seed, device="cpu")
    apply = jax.jit(get_model("decnet", jax_config(name, max_disp=max_disp))
                    .apply, static_argnames=("ablate_sparse",))
    variables = nested(os.path.join(ckpt(name), "params.npz"))
    stream = device_batch_stream(seed, val=True, batch=1, h=h, w=w,
                                 max_disp=max_disp, device="cpu")
    acc = {}
    for _ in range(2):
        b = next(stream)
        args = [b[k].numpy().transpose(0, 2, 3, 1) for k in ("left", "right")]
        args += [[m.numpy() for m in b[k]]
                 for k in ("left_masks", "right_masks")]
        gt = jnp.asarray(b["gt"].numpy())
        out = apply(variables, *args)
        abl = apply(variables, *args, ablate_sparse=True)

        def add(key, pred, g, md):
            acc.setdefault(key, []).append(
                [float(x) for x in jepe_and_d1(pred, g, md)])
        add("ablate_sparse_final", abl["preds"][-1], gt, max_disp)
        for i, pred in enumerate(out["preds"]):
            s = gt.shape[1] // pred.shape[1]
            add(f"stage{i}", pred, gt[:, ::s, ::s] / s if s > 1 else gt,
                max_disp // max(s, 1))
        coarse = out["preds"][0]
        up = jinterpolate(coarse * (gt.shape[1] / coarse.shape[1]),
                          gt.shape[1], gt.shape[2], "bicubic")
        add("up0_baseline", up, gt, max_disp)
        for k in ("dense", "fusion"):
            add(f"final_{k}", out[k][-1], gt, max_disp)
    for key, vals in acc.items():
        epe, d1 = np.mean(vals, axis=0)
        assert abs(rep[f"{key}_epe"] - epe) <= DISP_TOL, key
        assert abs(rep[f"{key}_d1"] - d1) <= 0.05, key
    per = [v[0] for v in acc["stage3"]]
    np.testing.assert_allclose(rep["final_epe_per_batch"], per, rtol=0,
                               atol=DISP_TOL)
    assert rep["final_epe_se"] == pytest.approx(
        np.std(rep["final_epe_per_batch"], ddof=1) / np.sqrt(2))
    assert rep["decomposition_win_epe"] == pytest.approx(
        rep["up0_baseline_epe"] - rep["stage3_epe"])
    assert rep["sparse_contribution_epe"] == pytest.approx(
        rep["ablate_sparse_final_epe"] - rep["stage3_epe"])
    assert (rep["batches"], rep["variant"], rep["shape"]) == (
        2, "default", [h, w, max_disp])
    assert rep["thold_mode"] == "quantile" and rep["step"] == 12000


def test_report_eval_cli_writes_json(tmp_path):
    out = tmp_path / "r.json"
    report_eval.main(["--ckpt", ckpt("ckpt_faithful"), "--h", "54", "--w",
                      "81", "--max_disp", "54", "--batch", "1", "--batches",
                      "2", "--variant", "legacy", "--json", str(out),
                      "--device", "cpu"])
    rep = json.loads(out.read_text())
    assert rep["variant"] == "legacy" and rep["dtype"] == "float32"
    for k in ("stage0_epe", "stage3_d1", "ablate_sparse_final_epe",
              "up0_baseline_d1", "final_dense_epe", "final_fusion_d1",
              "decomposition_win_epe", "sparse_contribution_epe"):
        assert np.isfinite(rep[k]), k


def test_demo_serves_learned_detail_checkpoint(tmp_path, monkeypatch):
    """The demo CLI serves ckpt_detail_r5 with no host masks: its heads
    make them."""
    from PIL import Image
    scene = tmp_path / "in" / "s0"
    scene.mkdir(parents=True)
    rng = np.random.RandomState(3)
    for fname in ("im0.png", "im1.png"):
        Image.fromarray((rng.rand(H, W, 3) * 255).astype(np.uint8)).save(
            scene / fname)
    seen = []
    real = demo.predict

    def spy(model, left, right, lmasks, rmasks, max_disp):
        seen.append((lmasks, rmasks))
        return real(model, left, right, lmasks, rmasks, max_disp)

    monkeypatch.setattr(demo, "predict", spy)
    out = tmp_path / "out"
    demo.main(["--root", str(tmp_path / "in"), "--save2where", str(out),
               "--resume", ckpt("ckpt_detail_r5"), "--max_disp", "54",
               "--device", "cpu"])
    assert seen == [(None, None)]
    with Image.open(out / "s0.png") as png:
        assert png.size == (W, H) and np.asarray(png).dtype == np.uint16


@pytest.mark.parametrize("name", ["ckpt_detail_r5", "ckpt_flagship",
                                  "ckpt_stressor_r5"])
def test_train_cli_refuses_untrainable_configs(name, tmp_path, capsys):
    """The s2d, window and detail recipes build a training run, warm
    started from their own checkpoint with every tensor restored; with
    s2d_stages 2 the 1/3-res stage trains packed too, and a third packed
    stage, which the extractor does not make, is refused."""
    argv = ["--config", os.path.join(ckpt(name), "config.json"),
            "--dataset", "synthetic", "--device", "cpu", "--ckpt_dir",
            str(tmp_path)]
    run = tcli.prepare(argv + ["--init_from", ckpt(name)])
    cfg = run.cfg.model
    assert cfg.s2d_fine and run.state.step == 0
    assert (cfg.use_detail, cfg.match_window > 0) == {
        "ckpt_detail_r5": (True, True), "ckpt_flagship": (False, True),
        "ckpt_stressor_r5": (False, False)}[name]
    assert re.search(r"warm-start params: \d+ restored, 0 fresh",
                     capsys.readouterr().out)
    run2 = tcli.prepare(argv + ["--set", "model.s2d_stages=2"])
    assert isinstance(run2.state.model.refine_1, RefinementS2D)
    with pytest.raises(ValueError, match="s2d_stages"):
        tcli.prepare(argv + ["--set", "model.s2d_stages=3"])
