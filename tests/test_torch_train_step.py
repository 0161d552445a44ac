"""The port's train step against decnet_tpu's, in f32 on the CPU, on the
faithful small configuration of tests/test_torch_model.py (bf16 replaced by
f32, the learned temperature, cand_fallback, the multi-stage loss with
sparse_cand_mask and sparse_term_scale 20, Adam with warmup-cosine), from
the same freshly initialised weights (carried by the weight bridge) and the
same batch.  The JAX train step is compiled once for the module.

JAX runs its XLA matching and its unclipped XLA warp off the TPU; the port
runs the plain versions of its kernels, whose warp clips disparities to
[-16, max_disp]; the two agree while the disparities warped stay in that
range, which the test asserts.  To keep them there from a fresh
initialisation, the last conv of every Refinement head starts at 1/100 of
its initial weights (residuals of a fraction of a pixel instead of tens of
pixels); both packages get those weights.

Tolerances, f32:
  * loss and every logged term: 1e-5 relative (sums of a few thousand
    smooth-L1 terms after ~100 convolutions summed in other orders);
  * gradients: the flattened gradient within 1e-3 of JAX's relative to its
    norm (the backward runs ~200 convolutions whose sums XLA and PyTorch
    order differently; measured 2e-5..1.5e-4), and every tensor within 5e-2
    of its own norm (measured median 2e-5).  A tensor can lose more than
    the whole: a pre-activation that lies within the ~1e-5 forward
    difference of zero takes a ReLU's other branch in one package only
    (measured: one dyn_up_1.w1 pre-activation of 8748 at 7.6e-6 moves that
    tensor by 0.9%).  5e-2 still catches a wrong term, which moves a
    tensor by O(1).  A tensor whose gradient is zero up to rounding (the
    last cost-regulariser BN bias shifts every cost alike, which the
    soft-argmin ignores) is held to 1e-6 of the whole norm instead;
  * grad_norm: 2e-3 relative.  JAX logs it from jnp.vdot, an XLA dot at
    default precision, which on this CPU is not f32-exact: measured 1.1e-3
    below the f64 norm of the same gradients, which the port's matches to
    1e-6;
  * after three steps (rate 0, then the peak rate, then cosine decay):
    the parameters' total update (after - before, flattened) within 2e-2
    of JAX's relative to its norm (measured 3.6e-3), and every value
    within 5e-3 (Adam's steps at these rates move each value by ~1e-3).
    Adam divides each gradient by its own root mean square, so where two
    steps' gradients nearly cancel, or a gradient is zero up to rounding,
    a value moves by up to a whole step on rounding noise (measured: 625
    of 3.7e6 values off by more than 1e-4, none by more than 3e-3).
    BN running statistics (O(0.1..1)) within 1e-3: they average
    activations of those weights (measured 1.2e-4); the batch norm's own
    convention is held exactly in tests/test_torch_train.py.
The gradients JAX used are read back from Adam's first moment after the
first step, whose rate is 0: mu = (1 - b1) * clipped gradient."""
import copy

import numpy as np
import jax
import pytest
import torch

from decnet_tpu.config import Config as JaxConfig
from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.models import get_model
from decnet_tpu.train.state import create_train_state as jax_state
from decnet_tpu.train.step import make_train_step
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train import step as tstep
from decnet_tpu_torch.weights import load_flax_variables, state_dict_from_flax
from tests.test_torch_layers import nchw
from tests.test_torch_model import FAITHFUL_SMALL, NEG_MARGIN

B, H, W = 2, 54, 81
LOSS_RTOL = 1e-5
GRAD_TOL, TENSOR_TOL, ZERO_TOL = 1e-3, 5e-2, 1e-6
NORM_RTOL = 2e-3
UPDATE_TOL, PARAM_MAX = 2e-2, 5e-3
STATS_RTOL = 1e-3
TRAIN = dict(lr=1e-3, lr_schedule="cosine", warmup_steps=500,
             total_steps=10, batch_size=B)
LOSS = dict(sparse_term_scale=20.0, sparse_cand_mask=True)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def configs(**train):
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**FAITHFUL_SMALL, dtype="float32",
                                matching_impl="xla")
    for k, v in {**TRAIN, **train}.items():
        setattr(jcfg.train, k, v)
    for k, v in LOSS.items():
        setattr(jcfg.loss, k, v)
    tcfg = Config().apply_overrides(
        [f"train.{k}={v}" for k, v in {**TRAIN, **train}.items()]
        + [f"loss.{k}={v}" for k, v in LOSS.items()])
    tcfg.model = ModelConfig(**FAITHFUL_SMALL, dtype="float32")
    return jcfg, tcfg


def make_batch(seed):
    rng = np.random.RandomState(seed)
    b = {"left": rng.randn(B, H, W, 3).astype(np.float32),
         "right": rng.randn(B, H, W, 3).astype(np.float32),
         "gt": (rng.rand(B, H, W) * 60 - 3).astype(np.float32)}
    for side in ("left_masks", "right_masks"):
        b[side] = [(rng.rand(B, H // s, W // s) < 0.3).astype(np.float32)
                   for s in (9, 3, 1)]
    return b


def torch_batch(b):
    return {"left": nchw(b["left"]), "right": nchw(b["right"]),
            "gt": torch.from_numpy(b["gt"]),
            "left_masks": [torch.from_numpy(m) for m in b["left_masks"]],
            "right_masks": [torch.from_numpy(m) for m in b["right_masks"]]}


def init_variables(jcfg, batch):
    model = get_model("decnet", jcfg.model)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), batch["left"], batch["right"],
        batch["left_masks"], batch["right_masks"])
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = dict(variables["params"])
    for name in [k for k in params if k.startswith("refine_")]:
        head = dict(params[name])
        head["c6"] = {"Conv_0": {k: v * np.float32(0.01) for k, v in
                                 head["c6"]["Conv_0"].items()}}
        params[name] = head
    return model, {**variables, "params": params}


def port_state(tcfg, variables):
    state = tstep.create_train_state(DecNet(tcfg.model), tcfg)
    load_flax_variables(state.model, variables)
    return state


def assert_warp_inputs_in_range(model, batch, max_disp):
    """The disparities each Refinement warps (the fusions) stay inside the
    port warp's clip range, where it equals JAX's unclipped warp."""
    with torch.no_grad():
        out = model.train()(batch["left"], batch["right"],
                            batch["left_masks"], batch["right_masks"])
    for i, fused in enumerate(out["fusion"]):
        d = max_disp // 3 ** (2 - i)
        assert fused.min() >= -NEG_MARGIN and fused.max() <= d, i


@pytest.fixture(scope="module")
def runs():
    """Three steps of both packages on three batches, JAX compiled once."""
    jcfg, tcfg = configs()
    batches = [make_batch(s) for s in (1, 2, 3)]
    model, variables = init_variables(jcfg, batches[0])
    # JAX's initialisation, compiled once: the tests that read the
    # initial parameters take them from here
    init = jax.tree_util.tree_map(np.copy, variables)
    jstep = make_train_step(model, jcfg, donate=False)
    jst = jax_state(model, variables, jcfg.train)
    tst = port_state(tcfg, variables)
    out = {"jax": [], "port": [], "tcfg": tcfg, "init": init}
    for b in batches:
        jst, jlogs = jstep(jst, b)
        out["jax"].append((jst, {k: float(v) for k, v in jlogs.items()}))
        tb = torch_batch(b)
        assert_warp_inputs_in_range(copy.deepcopy(tst.model), tb,
                                    tcfg.model.max_disp)
        tlogs = tstep.train_step(tst, tb, tcfg)
        grads = {k: p.grad.clone() for k, p in
                 tst.model.named_parameters()}
        out["port"].append(({k: float(v) for k, v in tlogs.items()}, grads,
                            copy.deepcopy(tst.model.state_dict())))
    out["port_state"] = tst
    out["batches"] = batches
    return out


def test_first_step_loss_logs_and_gradients(runs):
    (jst, jlogs), (tlogs, tgrads, _) = runs["jax"][0], runs["port"][0]
    assert_first_step_matches(jst, jlogs, tlogs, tgrads)


def assert_first_step_matches(jst, jlogs, tlogs, tgrads, log_rtol=None):
    """The logs of a first step (rate 0) and the port's gradients against
    JAX's, read back from Adam's first moment, at the tolerances of the
    module docstring (`log_rtol` names a log's own, where a caller
    documents one)."""
    assert set(tlogs) == set(jlogs)
    for k, v in jlogs.items():
        rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        rtol = (log_rtol or {}).get(k, rtol)
        np.testing.assert_allclose(tlogs[k], v, rtol=rtol, err_msg=k)
    # mu after the first step is (1 - b1) * the clipped gradient
    mu = jst.opt_state[1][0].mu
    want = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / np.float32(0.1), mu)})
    assert set(want) == set(tgrads)
    norm = lambda x: float(np.linalg.norm(np.asarray(x, np.float64)))
    total = np.sqrt(sum(norm(w) ** 2 for w in want.values()))
    diff = np.sqrt(sum(norm(tgrads[k] - w) ** 2 for k, w in want.items()))
    assert diff <= GRAD_TOL * total, (diff, total)
    for k, w in want.items():
        err, scale = norm(tgrads[k] - w), norm(w)
        if scale > ZERO_TOL * total:
            assert err <= TENSOR_TOL * scale, (k, err, scale)
        else:
            assert err <= ZERO_TOL * total, (k, err, total)
    # the port's grad_norm is the norm of the gradients it clipped
    raw = tlogs["grad_norm"]
    clipped = np.sqrt(sum(norm(g) ** 2 for g in tgrads.values()))
    np.testing.assert_allclose(clipped, 10.0 if raw >= 10.0 else raw,
                               rtol=1e-5)


def test_three_steps_parameters_and_batch_stats(runs):
    jst = runs["jax"][-1][0]
    want = state_dict_from_flax({"params": jst.params,
                                 "batch_stats": jst.batch_stats})
    got = runs["port_state"].model.state_dict()
    start = state_dict_from_flax(runs["init"])
    assert runs["port_state"].step == 3
    err2 = upd2 = 0.0
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        assert not np.array_equal(g, start[k].numpy()), f"{k} did not move"
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=STATS_RTOL,
                                       atol=STATS_RTOL, err_msg=k)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_MAX, err_msg=k)
        s0 = start[k].numpy().astype(np.float64)
        err2 += float(np.sum((g - s0 - (w - s0)) ** 2))
        upd2 += float(np.sum((w - s0) ** 2))
    assert np.sqrt(err2) <= UPDATE_TOL * np.sqrt(upd2), (err2, upd2)
    # grad_norm is the norm of the unclipped gradients, as in JAX
    for (_, jl), (tl, _, _) in zip(runs["jax"], runs["port"]):
        np.testing.assert_allclose(tl["grad_norm"], jl["grad_norm"],
                                   rtol=NORM_RTOL)


def test_first_step_has_rate_zero(runs):
    """The cosine schedule's first update has rate 0: after step 1 the
    JAX parameters are the initial ones, and the port's too."""
    jst = runs["jax"][0][0]
    init = runs["init"]
    for a, b in zip(jax.tree_util.tree_leaves(jst.params),
                    jax.tree_util.tree_leaves(init["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    after_one = runs["port"][0][2]
    for k, v in state_dict_from_flax({"params": init["params"]}).items():
        assert torch.equal(after_one[k], v), k
