"""The port's weight repacking (decnet_tpu_torch/models/repack.py) against
decnet_tpu/models/repack.py and against the port's own faithful model, on
the CPU in f32, at tests/test_repack.py's shapes (54x54, base 4,
max_disp 54).

- Each pack function equals JAX's bit for bit on the same numpy input.
- `repack_faithful_to_s2d(stages=1, 2)` on a randomised faithful tree
  (tests/test_repack.py's way: every parameter N(0, 0.2^2), every BN
  statistic |N(0, 1)| + 0.5) equals JAX's array for array, bit for bit.
- The port's s2d model on the repacked weights equals the port's faithful
  model within 2e-4 (tests/test_repack.py's tolerance: the packed convs
  sum in another order), for use_detail x stages, and so does the
  stage-2 upgrade of an s2d_stages 1 tree (`s2d_exec`).
- `repack_linear`: the gather map reproduces the numpy repack exactly, and
  the faithful parameters' gradients taken through the port's packed graph
  equal JAX's through its packed graph
  (tests/test_repack.py::test_repack_linear_matches_and_differentiates's
  setup) within 1e-5 abs + 1e-3 rel."""
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.config import ModelConfig as JaxConfig
from decnet_tpu.models import get_model
from decnet_tpu.models import repack as jrepack
from decnet_tpu_torch.config import ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.models import repack as trepack
from decnet_tpu_torch.weights import (flatten_variables,
                                      flax_arrays_from_state,
                                      load_flax_variables, nest_variables,
                                      variables_from_model)
from tests.test_torch_layers import nchw

CFG = dict(max_disp=54, base_channels=4, num_stage=4, down_scale=3,
           cost_func="cor", thold=0.5, dtype="float32")
B, H, W = 2, 54, 54


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomised(cfg: ModelConfig, seed: int = 7):
    """A fresh port model's variables tree with every parameter drawn
    N(0, 0.2^2) and every BN statistic |N(0, 1)| + 0.5, as
    tests/test_repack.py randomises JAX's."""
    torch.manual_seed(0)
    tree = variables_from_model(DecNet(cfg))
    prng = np.random.RandomState(seed)

    def draw(t, stats):
        return {k: draw(v, stats) if isinstance(v, dict) else (
            (np.abs(prng.randn(*v.shape)) + 0.5) if stats
            else prng.randn(*v.shape) * 0.2).astype(np.float32)
            for k, v in t.items()}
    return {"params": draw(tree["params"], False),
            "batch_stats": draw(tree["batch_stats"], True)}


def inputs():
    rng = np.random.RandomState(0)
    left = rng.rand(B, H, W, 3).astype(np.float32)
    right = rng.rand(B, H, W, 3).astype(np.float32)
    masks = [(rng.rand(B, H // s, W // s) < 0.5).astype(np.float32)
             for s in (9, 3, 1)]
    rmasks = [(rng.rand(B, H // s, W // s) < 0.5).astype(np.float32)
              for s in (9, 3, 1)]
    return (nchw(left), nchw(right), [torch.from_numpy(m) for m in masks],
            [torch.from_numpy(m) for m in rmasks])


def forward(cfg, variables):
    model = DecNet(cfg)
    load_flax_variables(model, variables)
    with torch.no_grad():
        return model.eval()(*inputs())


@pytest.mark.parametrize("dilation", [1, 2, 3, 4, 6, 9])
def test_pack_conv3x3_equals_jax(dilation):
    rng = np.random.RandomState(dilation)
    K = rng.randn(3, 3, 4, 5).astype(np.float32)
    perm = rng.permutation(36)
    for in_perm in (None, perm):
        np.testing.assert_array_equal(
            trepack.pack_conv3x3(K, 3, dilation, in_perm),
            jrepack.pack_conv3x3(K, 3, dilation, in_perm))
    assert trepack.packed_geometry(dilation, 3) == \
        jrepack.packed_geometry(dilation, 3)


def test_pack_functions_equal_jax():
    rng = np.random.RandomState(1)
    K = rng.randn(3, 3, 4, 5).astype(np.float32)
    K1 = rng.randn(1, 1, 4, 5).astype(np.float32)
    v = rng.randn(5).astype(np.float32)
    for name, args in (("pack_conv3x3_stride", (K, 3)),
                       ("pack_conv1x1", (K1, 3)),
                       ("deconv_to_1x1", (K, 3)), ("tile_vec", (v, 3)),
                       ("concat_blocks_perm", ([4, 1, 1, 1, 1], 3)),
                       ("unfold_to_s2d_perm", (4, 3, 1))):
        got = getattr(trepack, name)(*args)
        want = getattr(jrepack, name)(*args)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("use_detail,stages", [(False, 1), (True, 1),
                                               (False, 2), (True, 2)])
def test_repack_equals_jax_array_for_array(use_detail, stages):
    cfg = ModelConfig(**CFG, use_detail=use_detail)
    vf = randomised(cfg)
    got = flatten_variables(trepack.repack_faithful_to_s2d(vf, cfg, stages))
    want = flatten_variables(jrepack.repack_faithful_to_s2d(
        vf, JaxConfig(**CFG, use_detail=use_detail), stages))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    # the repacked tree fills a fresh s2d model exactly (strict both ways)
    s2d = DecNet(ModelConfig(**CFG, use_detail=use_detail, s2d_fine=True,
                             s2d_stages=stages))
    assert load_flax_variables(s2d, nest_variables(
        {"/".join(f"['{p}']" for p in k): v for k, v in got.items()})) \
        == len(got)


@pytest.mark.parametrize("use_detail,stages", [(False, 1), (True, 1),
                                               (False, 2), (True, 2)])
def test_repacked_s2d_forward_equals_faithful(use_detail, stages):
    cfg_f = ModelConfig(**CFG, use_detail=use_detail)
    cfg_s = ModelConfig(**CFG, use_detail=use_detail, s2d_fine=True,
                        s2d_stages=stages)
    vf = randomised(cfg_f)
    of = forward(cfg_f, vf)
    os_ = forward(cfg_s, trepack.repack_faithful_to_s2d(vf, cfg_f, stages))
    for key in ("preds", "dense", "sparse", "fusion", "soft_mask"):
        for i, (a, b) in enumerate(zip(of[key], os_[key])):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{key}[{i}]")


def test_s2d_exec_stage2_upgrade_equals_stage1():
    """An s2d_stages 1 tree upgrades to the stage-2-packed graph with the
    same outputs (`s2d_exec(stages=2)`); `s2d_exec_model` does the same
    on a loaded model."""
    cfg1 = ModelConfig(**dict(CFG, use_detail=False), s2d_fine=True,
                       s2d_stages=1)
    v1 = randomised(cfg1, seed=9)
    o1 = forward(cfg1, v1)
    m2, v2 = trepack.s2d_exec(v1, cfg1, stages=2)
    assert m2.cfg.s2d_stages == 2
    o2 = forward(m2.cfg, v2)
    m1 = DecNet(cfg1)
    load_flax_variables(m1, v1)
    with torch.no_grad():
        o3 = trepack.s2d_exec_model(m1.eval(), stages=2)(*inputs())
    for a, b, c in zip(o1["preds"], o2["preds"], o3["preds"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert torch.equal(b, c)


def test_trained_checkpoint_repacked_equals_faithful():
    """ckpt_faithful's trained weights (refinement and attention residuals
    larger than a fresh init's) repacked to s2d_stages 1 and 2 serve the
    faithful model's outputs in f32 (`s2d_exec_model`), at bench.py's CPU
    shape and inputs: 2e-4 at every stage."""
    from decnet_tpu_torch.cli import bench
    from decnet_tpu_torch.weights import load_checkpoint
    model = load_checkpoint(os.path.join(ROOT, "runs", "ckpt_faithful"),
                            device="cpu", dtype="float32")
    inputs = bench.make_inputs(bench.CPU["H"], bench.CPU["W"], 1,
                               "cpu")[:4]
    with torch.inference_mode():
        want = model(*inputs)["preds"]
        for stages in (1, 2):
            twin = trepack.s2d_exec_model(model, stages=stages)
            assert twin.cfg.s2d_fine and twin.cfg.s2d_stages == stages
            for i, (a, b) in enumerate(zip(want, twin(*inputs)["preds"])):
                np.testing.assert_allclose(
                    b.numpy(), a.numpy(), rtol=2e-4, atol=2e-4,
                    err_msg=f"stages {stages}, preds[{i}]")


# -------------------------------------------------- repack_linear vs JAX

LIN = dict(max_disp=27, base_channels=4, num_stage=4, down_scale=3,
           use_detail=False, dtype="float32")
LIN_SHAPE = (1, 54, 81)


def lin_inputs():
    """tests/test_repack.py::test_repack_linear_matches_and_differentiates's
    draws (its rng fixture is RandomState(0))."""
    rng = np.random.RandomState(0)
    Bl, Hl, Wl = LIN_SHAPE
    left = rng.rand(Bl, Hl, Wl, 3).astype(np.float32)
    right = rng.rand(Bl, Hl, Wl, 3).astype(np.float32)
    masks = [(rng.rand(Bl, Hl // s, Wl // s) < 0.4).astype(np.float32)
             for s in (9, 3, 1)]
    gt = (rng.rand(Bl, Hl, Wl) * 20).astype(np.float32)
    return left, right, masks, gt


def loss_of(preds, gt, xp):
    total = 0.0
    for p in preds:
        s = gt.shape[1] // p.shape[1]
        total = total + xp.abs(p - gt[:, ::s, ::s] / s).mean()
    return total


@functools.lru_cache(maxsize=None)
def lin_jax():
    """The faithful variables (the port's fresh init carried over) and
    JAX's loss and parameter gradients through its packed graph."""
    cfg = ModelConfig(**LIN)
    torch.manual_seed(0)
    variables = variables_from_model(DecNet(cfg))
    left, right, masks, gt = lin_inputs()
    jcfg = JaxConfig(**LIN, matching_impl="xla")
    model_s, apply_fn = jrepack.repack_linear(variables, jcfg, stages=2)

    def loss_packed(params):
        vs = apply_fn({"params": params,
                       "batch_stats": variables["batch_stats"]})
        out = model_s.apply(vs, left, right, masks, masks, train=False)
        return loss_of(out["preds"], jnp.asarray(gt), jnp)
    loss, grads = jax.jit(jax.value_and_grad(loss_packed))(
        variables["params"])
    return variables, float(loss), flatten_variables(
        {"params": jax.tree_util.tree_map(np.asarray, grads)})


def test_repack_linear_gather_is_exact():
    variables, _, _ = lin_jax()
    cfg = ModelConfig(**LIN)
    model = DecNet(cfg)
    load_flax_variables(model, variables)
    twin, apply_fn = trepack.repack_linear(model, stages=2)
    assert twin.cfg.s2d_fine and twin.cfg.s2d_stages == 2
    got = {k: v.detach().numpy() for k, v in apply_fn(model).items()}
    want = flatten_variables(trepack.repack_faithful_to_s2d(
        variables, cfg, stages=2))
    back = flatten_variables(nest_variables(flax_arrays_from_state(twin,
                                                                   got)))
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_repack_linear_gradients_equal_jax():
    variables, jloss, jgrads = lin_jax()
    model = DecNet(ModelConfig(**LIN))
    load_flax_variables(model, variables)
    model.eval()
    twin, apply_fn = trepack.repack_linear(model, stages=2)
    left, right, masks, gt = lin_inputs()
    ms = [torch.from_numpy(m) for m in masks]
    out = torch.func.functional_call(twin, apply_fn(model),
                                     (nchw(left), nchw(right), ms, ms))
    loss = loss_of(out["preds"], torch.from_numpy(gt), torch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()],
                                allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    got = flatten_variables(nest_variables(flax_arrays_from_state(model, {
        n: (torch.zeros_like(p) if g is None else g).numpy()
        for (n, p), g in zip(model.named_parameters(), grads)})))
    assert len(names) == len(jgrads) and sorted(got) == sorted(jgrads)
    moved = 0
    for k, want in jgrads.items():
        np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=1e-5,
                                   err_msg=str(k))
        moved += bool(np.abs(want).max() > 0)
    assert moved > len(jgrads) // 2


# -------------------------------------------------- packed_exec training


def test_packed_exec_step_equals_the_faithful_frozen_step(tmp_path):
    """train.packed_exec: the train CLI's frozen-BN step runs the packed
    twin on the faithful parameters (as decnet_tpu/cli/train.py:89-105
    wires it); its loss and gradients equal the faithful frozen-BN step's
    on the same batch within 1e-5 abs + 1e-3 rel, and the update lands on
    the faithful parameters.  Without a frozen phase, or on an s2d model,
    it is refused, as JAX asserts."""
    from decnet_tpu_torch.cli import train as tcli
    from decnet_tpu_torch.train.step import loss_and_grads
    base = ["--dataset", "synthetic", "--device", "cpu", "--ckpt_dir",
            str(tmp_path), "--steps", "2", "--set", "model.max_disp=27",
            "--set", "model.base_channels=4", "--set",
            "model.dtype=float32", "--set", "train.batch_size=1", "--set",
            "train.crop_h=54", "--set", "train.crop_w=81", "--set",
            "train.lr_schedule=constant"]
    run = tcli.prepare(base + ["--set", "train.packed_exec=1", "--set",
                               "train.freeze_bn=1"])
    twin, _ = run.packed
    assert run.freeze_bn() and twin.cfg.s2d_fine and twin.cfg.s2d_stages == 2
    batch = next(run.stream)
    model = run.state.model
    logs_f, grads_f = loss_and_grads(model, batch, run.cfg, True)
    grads_f = [g.clone() for g in grads_f]
    logs_p, grads_p = loss_and_grads(model, batch, run.cfg, True,
                                     run.packed)
    np.testing.assert_allclose(float(logs_p["total"]),
                               float(logs_f["total"]), rtol=1e-5)
    for (name, _), a, b in zip(model.named_parameters(), grads_f, grads_p):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    before = [p.detach().clone() for p in model.parameters()]
    run.step(batch)
    assert run.state.step == 1
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    with pytest.raises(ValueError, match="freeze_bn phase"):
        tcli.prepare(base + ["--set", "train.packed_exec=1"])
    with pytest.raises(ValueError, match="faithful form"):
        tcli.prepare(base + ["--set", "train.packed_exec=1", "--set",
                             "train.freeze_bn=1", "--set",
                             "model.s2d_fine=1"])
