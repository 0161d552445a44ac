"""The port's train step against decnet_tpu's for the paths the committed
s2d checkpoints were trained with, in f32 on the CPU, one step each from
the same freshly initialised weights (carried by the weight bridge) and
the same batch:

  * ckpt_detail_r5's recipe: the s2d full-resolution stage, the matching
    windowed around the detached dense prediction (match_window 12, so
    windows 2 / 4 / 12), learned detail heads binarised at the pooled
    quantile (density 0.25), the learned temperature and cand_fallback;
    the multi-stage loss with sparse_term_scale 20 plus alpha 0.3 times
    the detail mask loss against the batch's masks;
  * multi_stage_regression_upmaskloss with binary_thold (the pure mask
    loss of binarised maps, so every gradient is zero) on the faithful
    form with fixed-threshold detail heads (DetailHead rather than
    DetailHeadS2D) and the window.  Its focal terms are the one
    exception to the tolerances below: XLA's compiled step folds the
    constants of log(1 - p + 1e-5) into log(1.00001f - p), which at a
    binarised p = 1 reads log(1.00136e-5) = -11.511568 where the formula
    (and JAX run op by op, and the port) reads -11.512925, 1.18e-4
    relative.  So the jitted step's mask{i}/focal are held to 2e-4, and
    the port's to JAX's op-by-op `detail_mask_loss` of JAX's own forward
    at 1e-5.

As in tests/test_torch_s2d_model.py, the untrained detail heads' last conv
is scaled by 0.05, so that their maps have their target density; as in
tests/test_torch_train_step.py, every Refinement's last conv by 0.01, so
that the warped disparities stay inside the port warp's clip range.
Each step compiles once, in its own fixture.

Then, without a step compile: the windowed sparse-matching backward (the
plain version and the model's autograd Function) against JAX's
`_spamat_bwd_xla` and the windowed matching's VJP at the training path's
windows 2 / 4 / 12 (tests/test_torch_backward.py's tolerance, 1e-5 of the
largest gradient), and that freeze_bn reaches the s2d and detail heads.

Tolerances are tests/test_torch_train_step.py's: loss and every log term
1e-5 relative, grad_norm 2e-3, the flattened gradient 1e-3 of its norm and
every tensor 5e-2 of its own (1e-6 of the whole for a gradient that is
zero up to rounding); the BN running statistics after the step (which the
heads' batch-statistic batch norm moves) 1e-3.  The masks the heads make
must be equal in both packages: a mask pixel that flipped would move the
sparse terms by far more than the tolerances."""
import copy

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import Config as JaxConfig
from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.models import get_model
from decnet_tpu.ops import matching as jmatching
from decnet_tpu.train.state import create_train_state as jax_state
from decnet_tpu.train import loss as jloss
from decnet_tpu.train.step import make_train_step
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.ops import matching as tmatching
from decnet_tpu_torch.ops.kernels import spamat as tspamat
from decnet_tpu_torch.train import step as tstep
from decnet_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from tests.test_torch_backward import (assert_grads_close, forward_residuals,
                                       make_inputs, nchw, to_nhwc)
from tests.test_torch_s2d_model import BASE, CASES
from tests.test_torch_train_step import (LOSS_RTOL, STATS_RTOL, TRAIN,
                                         assert_first_step_matches,
                                         assert_warp_inputs_in_range,
                                         make_batch, torch_batch)

# the jitted step's binarised focal terms (see the module docstring)
FOLDED_LOG_RTOL = 2e-4
RECIPES = {
    "detail_r5": (CASES["s2d_window_quantile_detail"],
                  dict(sparse_term_scale=20.0, sparse_cand_mask=True,
                       alpha=0.3)),
    "upmaskloss": (CASES["window_fixed_detail"],
                   dict(loss_type="multi_stage_regression_upmaskloss",
                        binary_thold=0.5)),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(recipe):
    model_kw, loss_kw = RECIPES[recipe]
    kw = dict(BASE, **model_kw)
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**kw, dtype="float32", matching_impl="xla")
    for k, v in TRAIN.items():
        setattr(jcfg.train, k, v)
    for k, v in loss_kw.items():
        setattr(jcfg.loss, k, v)
    tcfg = Config().apply_overrides(
        [f"train.{k}={v}" for k, v in TRAIN.items()]
        + [f"loss.{k}={v}" for k, v in loss_kw.items()])
    tcfg.model = ModelConfig(**kw, dtype="float32")
    return jcfg, tcfg


def init_variables(jcfg, batch):
    model = get_model("decnet", jcfg.model)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), batch["left"],
                            batch["right"], batch["left_masks"],
                            batch["right_masks"])
    v = {c: jax.tree_util.tree_map(np.array, t) for c, t in v.items()}
    for name, tree in v["params"].items():
        if name.startswith("detail_"):
            tree["head1"]["Conv_0"]["kernel"] *= np.float32(0.05)
        if name.startswith("refine_"):
            for leaf in tree["c6"]["Conv_0"].values():
                leaf *= np.float32(0.01)
    return model, v


def one_step(recipe):
    """Both packages' first step of `recipe` on one batch."""
    jcfg, tcfg = configs(recipe)
    b = make_batch(1)
    model, variables = init_variables(jcfg, b)
    jst = jax_state(model, variables, jcfg.train)
    jst, jlogs = make_train_step(model, jcfg, donate=False)(jst, b)
    tst = tstep.create_train_state(DecNet(tcfg.model), tcfg)
    load_flax_variables(tst.model, variables)
    tb = torch_batch(b)
    assert_warp_inputs_in_range(copy.deepcopy(tst.model), tb,
                                tcfg.model.max_disp)
    with torch.no_grad():
        jout = model.apply(variables, b["left"], b["right"], train=True,
                           mutable=["batch_stats"])[0]
        tout = copy.deepcopy(tst.model).train()(tb["left"], tb["right"])
    tlogs = tstep.train_step(tst, tb, tcfg)
    return {"jst": jst, "jlogs": {k: float(v) for k, v in jlogs.items()},
            "tlogs": {k: float(v) for k, v in tlogs.items()},
            "tgrads": {k: p.grad.clone()
                       for k, p in tst.model.named_parameters()},
            "tstate": tst, "jout": jout, "tout": tout}


@pytest.fixture(scope="module")
def detail_r5():
    return one_step("detail_r5")


@pytest.fixture(scope="module")
def upmaskloss():
    return one_step("upmaskloss")


def assert_masks_equal(run):
    for key in ("masks_used", "cand"):
        for i, (g, w) in enumerate(zip(run["tout"][key], run["jout"][key])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{key}[{i}]")
    for m in run["tout"]["masks_used"]:
        assert 0.05 < float(m.mean()) < 0.95


def assert_batch_stats_match(run):
    jst = run["jst"]
    want = state_dict_from_flax({"params": jst.params,
                                 "batch_stats": jst.batch_stats})
    got = run["tstate"].model.state_dict()
    detail_stats = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                       rtol=STATS_RTOL, atol=STATS_RTOL,
                                       err_msg=k)
            detail_stats += k.startswith("detail_")
    assert detail_stats > 0


def test_detail_r5_step_matches_jax(detail_r5):
    r = detail_r5
    assert_masks_equal(r)
    assert {f"mask{i}/{t}" for i in range(3) for t in ("focal", "l1")} \
        <= set(r["tlogs"])
    assert_first_step_matches(r["jst"], r["jlogs"], r["tlogs"], r["tgrads"])
    # the detail heads learn from the mask term
    for k, g in r["tgrads"].items():
        if k.startswith("detail_") and k.endswith("conv.weight"):
            assert float(g.abs().max()) > 0, k


def test_detail_r5_batch_stats_match_jax(detail_r5):
    assert_batch_stats_match(detail_r5)


def test_detail_r5_total_adds_alpha_times_mask_loss(detail_r5):
    """total = the disparity terms + 0.3 (focal + 3 L1) summed over the
    fine stages (weights 1): the alpha term is in the port's total."""
    logs = detail_r5["tlogs"]
    mask = sum(logs[f"mask{i}/focal"] + 3 * logs[f"mask{i}/l1"]
               for i in range(3))
    no_alpha = logs["total"] - 0.3 * mask
    disparity = logs["stage0/pred"] + sum(
        0.5 * logs[f"stage{s}/pred"] + 0.1 * logs[f"stage{s}/dense"]
        + 20 * 0.2 / (10 + 3.75 * s) * logs[f"stage{s}/sparse"]
        + 0.2 * logs[f"stage{s}/fusion"] for s in (1, 2, 3))
    np.testing.assert_allclose(no_alpha, disparity, rtol=1e-5)


def test_upmaskloss_step_matches_jax(upmaskloss):
    r = upmaskloss
    assert_masks_equal(r)
    assert set(r["tlogs"]) == {"total", "grad_norm"} | {
        f"mask{i}/{t}" for i in range(3) for t in ("focal", "l1")}
    focal = [f"mask{i}/focal" for i in range(3)]
    assert_first_step_matches(r["jst"], r["jlogs"], r["tlogs"], r["tgrads"],
                              log_rtol=dict.fromkeys(focal + ["total"],
                                                     FOLDED_LOG_RTOL))
    jcfg = configs("upmaskloss")[0]
    b = make_batch(1)
    total, logs = jloss.detail_mask_loss(
        r["jout"], b["left_masks"], b["right_masks"], jcfg.loss.weights,
        binary_thold=jcfg.loss.binary_thold)
    for k, v in logs.items():
        np.testing.assert_allclose(r["tlogs"][k], float(v), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(r["tlogs"]["total"], float(total),
                               rtol=LOSS_RTOL)
    # binarised maps carry no gradient: the step's gradients are all zero
    assert r["tlogs"]["grad_norm"] == 0.0
    assert r["tlogs"]["total"] > 0


def test_upmaskloss_batch_stats_match_jax(upmaskloss):
    assert_batch_stats_match(upmaskloss)


# -- the windowed sparse-matching backward ------------------------------------

# (C, max_disp, window, W) of the three fine stages of a 54x81 crop at
# max_disp 54 with match_window 12 (windows max(2, round(12 / 9)),
# round(12 / 3), 12), on rows of width W
WINDOWED = [(16, 6, 2, 30), (12, 18, 4, 60), (4, 54, 12, 120)]


def smooth_center(rng, B, H, W, D):
    """A smooth disparity field in [0, D): a 2x4 grid of uniform values
    interpolated bilinearly, as a dense prediction gives the centres."""
    grid = rng.rand(B, 2, 4) * D
    ys, xs = np.linspace(0, 1, H), np.linspace(0, 3, W)
    x0 = np.minimum(xs.astype(int), 2)
    fx = xs - x0
    rows = grid[:, :, x0] * (1 - fx) + grid[:, :, x0 + 1] * fx   # (B,2,W)
    return (rows[:, :1] * (1 - ys[:, None]) + rows[:, 1:] * ys[:, None]
            ).astype(np.float32)


@pytest.mark.parametrize("C,D,window,W", WINDOWED)
def test_windowed_backward_matches_xla(C, D, window, W):
    """The plain windowed backward against `_spamat_bwd_xla` with center
    and window set, and the model's autograd Function (forward and
    backward) against jax.vjp of the windowed matching, at the training
    path's three windows."""
    B, H = 2, 3
    ref, tar, rm, tm, _, g = make_inputs(11, B, H, W, C, D, no_cand_row=True)
    center = smooth_center(np.random.RandomState(12), B, H, W, D)
    out, ss, mc = forward_residuals(ref, tar, rm, tm, D, center, window)
    xla_ref, xla_tar = jmatching._spamat_bwd_xla(
        ref, tar, rm, tm, out, ss, mc, g, D, center=center, window=window)
    t = lambda x: torch.from_numpy(np.array(x))
    got_ref, got_tar = tspamat.spamat_backward_plain(
        nchw(ref), nchw(tar), t(rm), t(tm), t(out), t(ss), t(mc), t(g), D,
        center=t(center), window=window)
    for got, want, name in ((got_ref, xla_ref, "grad_ref"),
                            (got_tar, xla_tar, "grad_tar")):
        assert torch.isfinite(got).all() and np.abs(np.asarray(want)).max() > 0
        assert_grads_close(to_nhwc(got), want, name)

    (w_out, _), vjp = jax.vjp(
        lambda r, q: jmatching.sparse_matching_with_var_windowed(
            r, q, rm, tm, center, D, window, "xla"),
        jax.numpy.asarray(ref), jax.numpy.asarray(tar))
    w_gref, w_gtar = vjp((g, np.zeros_like(g)))
    r, q = nchw(ref).requires_grad_(), nchw(tar).requires_grad_()
    o, _ = tmatching.sparse_matching_with_var(r, q, t(rm), t(tm), D,
                                              center=t(center), window=window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(w_out),
                               rtol=1e-5, atol=1e-5)
    (o * t(g)).sum().backward()
    assert_grads_close(to_nhwc(r.grad), w_gref, "Function grad_ref")
    assert_grads_close(to_nhwc(q.grad), w_gtar, "Function grad_tar")


# -- freeze_bn reaches the s2d and detail heads --------------------------------

def test_freeze_bn_switches_the_s2d_and_detail_heads():
    """A freeze-BN step keeps every running statistic, the s2d heads' and
    the detail heads' too; a batch-statistic step moves each module's."""
    _, tcfg = configs("detail_r5")
    tb = torch_batch(make_batch(2))
    moved = {}
    for freeze in (True, False):
        st = tstep.create_train_state(DecNet(tcfg.model), tcfg)
        before = {k: v.clone() for k, v in st.model.state_dict().items()
                  if k.endswith("running_mean")}
        tstep.train_step(st, tb, tcfg, freeze_bn=freeze)
        after = st.model.state_dict()
        moved[freeze] = {k.split(".")[0] for k, v in before.items()
                         if not torch.equal(after[k], v)}
    assert moved[True] == set()
    assert {"detail_0", "detail_2", "soft_att_2", "refine_2",
            "feature_extractor", "dyn_up_2"} <= moved[False]
