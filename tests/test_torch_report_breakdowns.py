"""The port's accuracy report (`cli/report_eval.py`) against JAX's script
(`scripts/report_eval.py`, run as it is through `runpy` with its batch
stream and model loader replaced in this test: the stream yields this
test's batches, the loader builds JAX's model from the port's checkpoint
file), on the same batches and weights (fresh tiny models: base_channels
4, max_disp 54), B=1 of 54x81, 2 batches, f32 on the CPU.

Every key of the script's JSON is in the port's report, within 1e-3 (its
values are rounded to 4 places), null where the script's is null:
  * the faithful form with the batch's masks (30% dense): every breakdown
    has pixels, and the fractions, the oracle and the density are sound;
  * learned detail heads whose sidecar says thold 0.5, where the script's
    --thold (default 0.9) overrides it: a fresh head's maps lie within
    2e-4 of 0.5, so no pixel passes and every breakdown at the mask pixels
    is null on both sides (at 0.5 some would pass);
  * a checkpoint without config.json (the default model, base_channels
    8, in s2d form), described by `--s2d --use_detail`, binarised by
    `--thold_mode quantile --detail_density 0.3`."""
import json
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch

import decnet_tpu.cli.common as jcommon
import decnet_tpu.data.device_synth as jsynth
from decnet_tpu.models import get_model
from decnet_tpu_torch.cli import report_eval
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train.checkpoint import save_params
from decnet_tpu_torch.weights import nest_variables

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts", "report_eval.py")
B, H, W, MAX_DISP, BATCHES = 1, 54, 81, 54, 2
TOL = 1e-3
MODEL = dict(max_disp=MAX_DISP, base_channels=4, num_stage=4, down_scale=3,
             dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batches(seed=5):
    """Random normalised views, a ground truth of smooth planes with thin
    bars (pixels a 1/27 scale loses) and 30%-dense masks, NHWC as JAX's
    stream yields them."""
    r = np.random.RandomState(seed)
    out = []
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(BATCHES):
        gt = 5 + 20 * r.rand() + xs * r.rand() * 0.2 + ys * r.rand() * 0.2
        for _ in range(4):
            c = r.randint(2, W - 4)
            gt[:, c:c + 2] = r.rand() * 50 + 1
        gt[r.rand(H, W) < 0.1] = 0
        b = {"left": r.randn(B, H, W, 3).astype(np.float32),
             "right": r.randn(B, H, W, 3).astype(np.float32),
             "gt": np.repeat(gt[None], B, 0).astype(np.float32)}
        for side in ("left_masks", "right_masks"):
            b[side] = [(r.rand(B, H // s, W // s) < 0.3).astype(np.float32)
                       for s in (9, 3, 1)]
        out.append(b)
    return out


def torch_batch(b):
    t = torch.from_numpy
    return {"left": t(b["left"]).permute(0, 3, 1, 2).contiguous(),
            "right": t(b["right"]).permute(0, 3, 1, 2).contiguous(),
            "gt": t(b["gt"]),
            "left_masks": [t(m) for m in b["left_masks"]],
            "right_masks": [t(m) for m in b["right_masks"]]}


def write_checkpoint(path, sidecar=True, **model):
    """A fresh model's params.npz (+ config.json): the weights both
    packages read."""
    cfg = Config()
    cfg.model = ModelConfig(**{**MODEL, **model})
    torch.manual_seed(0)
    m = DecNet(cfg.model)
    save_params(str(path), m, cfg)
    if not sidecar:
        os.remove(os.path.join(path, "config.json"))
    return str(path)


def run_jax(monkeypatch, ckpt, flags, batches):
    """scripts/report_eval.py's JSON for `flags` on `batches`."""
    def stream(seed, **kw):
        assert kw["batch"] == B and (kw["h"], kw["w"]) == (H, W)
        yield from batches

    def init(cfg, resume):
        model = get_model(cfg.model.arch, cfg.model)
        with np.load(os.path.join(resume, "params.npz")) as z:
            v = nest_variables(dict(z))
        state = types.SimpleNamespace(step=0, params=v["params"],
                                      batch_stats=v["batch_stats"])
        return model, state, None
    monkeypatch.setattr(jsynth, "device_batch_stream", stream)
    monkeypatch.setattr(jcommon, "init_model_and_state", init)
    out = os.path.join(os.path.dirname(ckpt), "jax.json")
    monkeypatch.setattr(sys, "argv", [SCRIPT, "--ckpt", ckpt, "--h", str(H),
                                      "--w", str(W), "--max_disp",
                                      str(MAX_DISP), "--batch", str(B),
                                      "--batches", str(BATCHES), "--json",
                                      out] + flags)
    runpy.run_path(SCRIPT, run_name="__main__")
    with open(out) as f:
        return json.load(f)


def run_port(monkeypatch, ckpt, flags, batches):
    def stream(seed, **kw):
        yield from (torch_batch(b) for b in batches)
    monkeypatch.setattr(report_eval, "device_batch_stream", stream)
    a = report_eval.parse_args(["--ckpt", ckpt, "--h", str(H), "--w",
                                str(W), "--max_disp", str(MAX_DISP),
                                "--batch", str(B), "--batches",
                                str(BATCHES), "--device", "cpu"] + flags)
    return report_eval.report(
        a.ckpt, h=a.h, w=a.w, max_disp=a.max_disp, batch=a.batch,
        batches=a.batches, device=a.device, s2d=a.s2d,
        use_detail=a.use_detail, thold=a.thold, thold_mode=a.thold_mode,
        detail_density=a.detail_density, ld_thresh=a.ld_thresh)


CASES = {
    "batch_masks": (dict(), True, []),
    "thold_over_sidecar_empty": (dict(use_detail=True, thold=0.5), True, []),
    # without a sidecar both build the default model (base_channels 8)
    "no_sidecar_s2d_quantile": (dict(s2d_fine=True, base_channels=8,
                                     use_detail=True), False,
                                ["--s2d", "--use_detail", "--thold_mode",
                                 "quantile", "--detail_density", "0.3"]),
}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    batches = make_batches()
    out = {}
    try:
        for name, (model, sidecar, flags) in CASES.items():
            d = tmp_path_factory.mktemp(name)
            ckpt = write_checkpoint(d / "ckpt", sidecar, **model)
            out[name] = (run_jax(mp, ckpt, flags, batches),
                         run_port(mp, ckpt, flags, batches))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_key_of_the_script_within_tolerance(reports, case):
    jax_rep, port = reports[case]
    assert set(jax_rep) <= set(port), sorted(set(jax_rep) - set(port))
    for k, want in jax_rep.items():
        got = port[k]
        if want is None:
            assert got is None, k
        elif isinstance(want, (int, float)) and not isinstance(want, bool):
            assert got is not None and abs(got - want) <= TOL, (k, got, want)
        else:
            assert got == want, (k, got, want)


def test_breakdowns_present_and_sound(reports):
    jax_rep, port = reports["batch_masks"]
    for k in ("mask_sparse_cand", "cand_avail", "mask_oracle",
              "soft_mask_where_sparse_wins", "ld_mask_sparse", "ld_final"):
        assert port[f"{k}_epe"] is not None, k
    assert 0.2 < port["mask_density"] < 0.4
    assert port["mask_oracle_epe"] <= min(port["mask_dense_epe"],
                                          port["mask_sparse_epe"]) + 1e-9
    for k in ("cand_avail_exact", "cand_avail", "sparse_win_frac",
              "ld_frac", "ld_mask_frac_of_ld"):
        assert 0 <= port[f"{k}_epe"] <= 1, k


def test_thold_overrides_the_sidecar_and_an_empty_set_is_null(reports):
    jax_rep, port = reports["thold_over_sidecar_empty"]
    assert jax_rep["thold"] == port["thold"] == 0.9
    assert port["mask_density"] == 0
    for k in ("mask_dense", "mask_sparse_cand", "cand_avail_exact",
              "mask_oracle", "soft_mask_where_dense_wins", "ld_mask_fusion",
              "ld_cand_sparse"):
        assert jax_rep[f"{k}_epe"] is None and port[f"{k}_epe"] is None, k
    assert "cand_avail_epe" not in jax_rep and "cand_avail_epe" not in port


def test_flags_without_a_sidecar(reports):
    jax_rep, port = reports["no_sidecar_s2d_quantile"]
    for k, v in (("s2d", True), ("use_detail", True),
                 ("thold_mode", "quantile"), ("detail_density_target", 0.3)):
        assert jax_rep[k] == v and port[k] == v, k
    assert 0.2 < port["mask_density"] < 0.4
