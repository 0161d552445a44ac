"""The port's freeze-BN train step and eval step against decnet_tpu's, in
f32 on the CPU, on the faithful small configuration and weights of
tests/test_torch_train_step.py with non-trivial batch-norm statistics
(which both steps normalise with), one batch.

Tolerances, f32: loss terms 1e-5 relative; the running statistics
bit-identical before and after the freeze step (both packages); the
parameters' update of that step (a constant rate, so Adam's first update
is +-rate per value) within 2e-2 of JAX's relative to its norm, each value
within 5e-3 (a value whose gradient is zero up to rounding takes the sign
of the noise: see tests/test_torch_train_step.py); eval EPE 1e-5
relative and the final disparity 1e-3 px (the tolerance of
tests/test_torch_model.py); D1 within one pixel of the count, 100/n %
(a pixel whose error sits at the 3 px threshold may fall either side)."""
import numpy as np
import pytest

from decnet_tpu.train.state import create_train_state as jax_state
from decnet_tpu.train.step import make_eval_step, make_train_step
from decnet_tpu_torch.train import step as tstep
from decnet_tpu_torch.weights import state_dict_from_flax
from tests.test_torch_layers import randomized
from tests.test_torch_train_step import (configs, init_variables, make_batch,
                                         port_state, torch_batch)

LOSS_RTOL = 1e-5
UPDATE_TOL, PARAM_MAX = 2e-2, 5e-3


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs(lr_schedule="constant")
    batch = make_batch(7)
    model, variables = init_variables(jcfg, batch)
    variables = randomized(variables, 3)
    return jcfg, tcfg, batch, model, variables


def test_freeze_bn_step_matches_jax(setup):
    jcfg, tcfg, batch, model, variables = setup
    jstep = make_train_step(model, jcfg, donate=False, freeze_bn=True)
    jst, jlogs = jstep(jax_state(model, variables, jcfg.train), batch)
    tst = port_state(tcfg, variables)
    tlogs = tstep.train_step(tst, torch_batch(batch), tcfg, freeze_bn=True)
    for k, v in jlogs.items():
        if k != "grad_norm":
            np.testing.assert_allclose(float(tlogs[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    start = state_dict_from_flax(variables)
    want = state_dict_from_flax({"params": jst.params,
                                 "batch_stats": jst.batch_stats})
    got = tst.model.state_dict()
    err2 = upd2 = 0.0
    for k, s0 in start.items():
        g, w, s0 = got[k].numpy(), want[k].numpy(), s0.numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(w, s0, err_msg=k)   # JAX
            np.testing.assert_array_equal(g, s0, err_msg=k)   # the port
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_MAX, err_msg=k)
        err2 += float(np.sum((g.astype(np.float64) - w) ** 2))
        upd2 += float(np.sum((w.astype(np.float64) - s0) ** 2))
    assert upd2 > 0
    assert np.sqrt(err2) <= UPDATE_TOL * np.sqrt(upd2), (err2, upd2)


def test_eval_step_matches_jax(setup):
    jcfg, tcfg, batch, model, variables = setup
    jst = jax_state(model, variables, jcfg.train)
    want = make_eval_step(model, jcfg)(jst, batch)
    tst = port_state(tcfg, variables)
    got = tstep.eval_step(tst.model, torch_batch(batch), tcfg)
    pred = got["pred"].numpy()
    assert pred.min() >= -16 and pred.max() <= tcfg.model.max_disp
    np.testing.assert_allclose(pred, np.asarray(want["pred"]), rtol=0,
                               atol=1e-3)
    n_valid = int(((batch["gt"] > 0) & (batch["gt"] < 54)).sum())
    for k in ("epe", "epe_up0"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for k in ("d1", "d1_up0"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=100.0 / n_valid + 1e-4, err_msg=k)
