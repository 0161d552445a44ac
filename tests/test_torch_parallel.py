"""Data-parallel training across processes (decnet_tpu_torch/parallel/)
against one process on the whole batch, and against JAX's step on a
2-device `data` mesh, on the CPU in f32.  Every multi-process case runs
two gloo processes (`parallel/dryrun.py::spawn`: the spawn start method, a
free local port, a deadline; one CPU thread each, and two in this process
while the module runs: the cases are collective-bound, and more threads
only contend with the other test workers).

  * batch norm in train mode, 2-D and 3-D units, on two halves of a batch
    against one process on all of it: output, mean, variance and running
    statistics 1e-6; dx, dscale and dbias (the ranks' shares summed) 1e-5;
  * every loss with ground truth whose valid share differs between the
    halves (0.3 and 0.8): the ranks' shares sum to the whole batch's loss
    (1e-6 relative), a mask empty on one rank or on both included; epe and
    d1 are the whole batch's on every rank;
  * the dry run (`dryrun_multichip`, __graft_entry__.py's config at its
    shapes): the 2-process step against the 1-process replay, loss 2e-5
    and grad norm 2e-4 relative, parameters, BN statistics and the clipped
    gradient 1e-5 (a tensor that is zero up to rounding within 1e-7); and
    the same 2-process step from the same weights (the port's
    initialisation, carried to JAX) against JAX's step on a 2-device
    `data` mesh (the conftest's virtual CPU devices): loss 2e-5, the
    parameters and BN statistics after it 1e-5, the clipped gradient
    (Adam's first moment / 0.1) 1e-3 of its norm as
    tests/test_torch_train_step.py holds it, and grad norm 2e-3: JAX logs
    it from an XLA dot that is not f32-exact on this CPU (see that file;
    6.7e-4 here).  One JAX compile;
  * the dry run on 4 processes, JAX's mesh for 4 devices (data 1 x tile
    2 x disp 2): against the replay with JAX's dry-run tolerances (loss
    2e-5, grad norm 2e-4) and every leaf's gradient norm within [0.9,
    1.1]; against JAX's step with the data mesh's tolerances (the JAX
    step is the one fixture both share); each rank's collectives by kind;
  * the train CLI under --multihost 1 in two processes: its losses are the
    one-process run's (the dry run's tolerances), the two shards of each global batch are disjoint
    and together the one-process batch, only rank 0 logs and writes, and
    data.on_device is refused with JAX's message; its RSS guard
    checkpoints and exits 75;
  * make_mesh's shapes, rank positions and refusals, as
    tests/test_parallel.py's."""
import json
import os

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from decnet_tpu.config import Config as JaxConfig
from decnet_tpu.config import MeshConfig as JaxMeshConfig
from decnet_tpu.config import ModelConfig as JaxModelConfig
from decnet_tpu.models import get_model
from decnet_tpu.parallel import mesh as jmesh
from decnet_tpu.train.state import create_train_state as jax_state
from decnet_tpu.train.step import make_train_step
from decnet_tpu_torch.cli import train as train_cli
from decnet_tpu_torch.config import MeshConfig
from decnet_tpu_torch.data.loader import DataLoader
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.parallel import dryrun, mesh
from decnet_tpu_torch.weights import state_dict_from_flax, variables_from_model
from tests import torch_parallel_workers as workers

THREADS = 1
BN_RTOL, BN_GRAD_RTOL, LOSS_RTOL = 1e-6, 1e-5, 1e-6
STEP_RTOL, STATE_FLOOR = 1e-5, 1e-7
JAX_GRAD_TOL, JAX_NORM_RTOL = 1e-3, 2e-3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def units():
    return (workers.unit_results(),
            dryrun.spawn(2, workers.units_worker, threads=THREADS))


def close(got, want, rtol, what, floor=0.0):
    """Within rtol of the largest value; an array that is zero up to
    rounding (a batch mean of ~1e-11) within `floor`."""
    np.testing.assert_allclose(
        got, want, rtol=rtol, err_msg=what,
        atol=max(rtol * float(np.abs(want).max()), floor))


@pytest.mark.parametrize("kind", sorted(workers.BN_SHAPES))
def test_global_batch_norm_equals_one_process(units, kind):
    one, ranks = units[0]["bn"][kind], [r["bn"][kind] for r in units[1]]
    close(np.concatenate([r["y"] for r in ranks]), one["y"], BN_RTOL, "y")
    for k in ("mean", "var", "running_mean", "running_var"):
        for r in ranks:
            close(r[k], one[k], BN_RTOL, k)
    close(np.concatenate([r["dx"] for r in ranks]), one["dx"], BN_GRAD_RTOL,
          "dx")
    for k in ("dscale", "dbias"):
        close(sum(r[k] for r in ranks), one[k], BN_GRAD_RTOL, k)


@pytest.mark.parametrize("name", ["masked_mean", "masked_mean_rank0_empty",
                                  "masked_mean_empty", "focal", "mask_l1",
                                  "uploss", "upsample", "chamfer",
                                  "lr_consistency"])
def test_losses_shares_sum_to_the_global_loss(units, name):
    one, ranks = units[0]["loss"], [r["loss"] for r in units[1]]
    total = sum(r[name] for r in ranks)
    np.testing.assert_allclose(total, one[name], rtol=LOSS_RTOL)
    if name == "masked_mean_empty":
        assert one[name] == 0 and all(r[name] == 0 for r in ranks)
    else:
        # a mean of the ranks' own means would differ
        assert one[name] != 0


def test_metrics_are_global_on_every_rank(units):
    one, ranks = units[0]["loss"], [r["loss"] for r in units[1]]
    for k in ("epe", "d1"):
        for r in ranks:
            np.testing.assert_allclose(r[k], one[k], rtol=LOSS_RTOL)


@pytest.fixture(scope="module")
def dry():
    # a data mesh: the tile and disp axes are tests/test_torch_mesh.py's
    return dryrun.dryrun_multichip(2, "cpu", threads=THREADS,
                                   mesh_cfg=MeshConfig(data=2))


def test_dryrun_two_processes_equal_the_replay(dry, capsys):
    r0, one = dry["ranks"][0], dry["replay"]
    np.testing.assert_allclose(r0["loss"], one["loss"],
                               rtol=dryrun.LOSS_RTOL)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"],
                               rtol=dryrun.GRAD_NORM_RTOL)
    norm = np.linalg.norm(one["grads"].astype(np.float64))
    assert np.linalg.norm(r0["grads"] - one["grads"]) <= STEP_RTOL * norm
    for k, v in one["state"].items():
        close(r0["state"][k], v, STEP_RTOL, k, STATE_FLOOR)
    assert all(r["rank_max_abs_diff"] == 0 for r in dry["ranks"])
    assert dry["ranks"][1]["loss"] == r0["loss"]


def jax_dryrun_config():
    jcfg = JaxConfig()
    jcfg.model = JaxModelConfig(**dryrun.DRYRUN_MODEL, matching_impl="xla")
    jcfg.train.batch_size = dryrun.B
    return jcfg


def jax_batch():
    """The dry run's batch as JAX takes it (NHWC)."""
    b = dryrun.build_batch()
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    return {"left": nhwc(b["left"]), "right": nhwc(b["right"]),
            "gt": b["gt"].numpy(),
            "left_masks": [m.numpy() for m in b["left_masks"]],
            "right_masks": [m.numpy() for m in b["right_masks"]]}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's step of the dry run (the port's initialisation carried to
    JAX; no JAX init to compile) on a 2-device `data` mesh: its logs, its
    state after the step and the clipped gradient (Adam's first moment /
    0.1), flat in the port's parameter order.  One JAX compile, shared by
    the data mesh's and the tile x disp mesh's comparisons."""
    jcfg, b = jax_dryrun_config(), jax_batch()
    model = get_model("decnet", jcfg.model)
    cfg = dryrun.dryrun_config()
    tmodel = DecNet(cfg.model)
    tmodel.load_state_dict(dryrun.fresh_state(cfg))
    variables = variables_from_model(tmodel)
    mesh2 = jmesh.make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    st = jax.device_put(jax_state(model, variables, jcfg.train),
                        NamedSharding(mesh2, P()))
    jb = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, jmesh.batch_sharding(mesh2, np.ndim(x))),
        b)
    with mesh2:
        st, logs = make_train_step(model, jcfg, donate=False)(st, jb)
    logs = {k: float(v) for k, v in logs.items()}
    want = state_dict_from_flax({"params": st.params,
                                 "batch_stats": st.batch_stats})
    mu = state_dict_from_flax({"params": jax.tree_util.tree_map(
        lambda m: np.asarray(m) / np.float32(0.1), st.opt_state[1][0].mu)})
    names = [k for k, _ in tmodel.named_parameters()]
    jgrad = np.concatenate([mu[k].numpy().ravel() for k in names])
    return logs, {k: w.numpy() for k, w in want.items()}, jgrad


def equal_jax(r0, jax_step):
    logs, want, jgrad = jax_step
    np.testing.assert_allclose(r0["loss"], logs["total"],
                               rtol=dryrun.LOSS_RTOL)
    np.testing.assert_allclose(r0["grad_norm"], logs["grad_norm"],
                               rtol=JAX_NORM_RTOL)
    for k, w in want.items():
        close(r0["state"][k], w, STEP_RTOL, k, STATE_FLOOR)
    assert np.linalg.norm(r0["grads"] - jgrad) <= \
        JAX_GRAD_TOL * np.linalg.norm(jgrad)


def test_two_processes_equal_jax_on_a_data_mesh(dry, jax_step):
    equal_jax(dry["ranks"][0], jax_step)


@pytest.fixture(scope="module")
def dry4():
    """The dry run on 4 processes: JAX's mesh for 4 devices, data 1 x
    tile 2 x disp 2 (dryrun_multichip checks it against the replay, loss
    2e-5, grad norm 2e-4, every leaf's norm within [0.9, 1.1])."""
    return dryrun.dryrun_multichip(4, "cpu", threads=THREADS)


def test_tile_disp_step_equals_the_replay(dry4):
    """Loss 2e-5 and grad norm 2e-4 relative as JAX's dry run holds them;
    every leaf's gradient norm within [0.9, 1.1] of the replay's (a sum
    over an idle axis gives 2); every rank logs the same loss and holds
    rank 0's state bit for bit; the mesh is JAX's."""
    r0, one = dry4["ranks"][0], dry4["replay"]
    assert [r["position"] for r in dry4["ranks"]] == [
        (0, t, s) for t in range(2) for s in range(2)]
    np.testing.assert_allclose(r0["loss"], one["loss"],
                               rtol=dryrun.LOSS_RTOL)
    np.testing.assert_allclose(r0["grad_norm"], one["grad_norm"],
                               rtol=dryrun.GRAD_NORM_RTOL)
    assert not dryrun.leaf_outliers(r0["leaf_norms"], one["leaf_norms"])
    assert all(r["rank_max_abs_diff"] == 0 for r in dry4["ranks"])
    assert all(r["loss"] == r0["loss"] for r in dry4["ranks"])


def test_tile_disp_step_equals_jax(dry4, jax_step):
    """The 4-process step against JAX's on the same batch and weights
    (JAX's own tests hold its sharded step to its unsharded one): loss
    2e-5, and the grad norm, the gradient and the state after the step
    as on the data mesh."""
    equal_jax(dry4["ranks"][0], jax_step)


def test_tile_disp_step_collectives_by_kind(dry4):
    """Each rank's first step: all-gathers only of conv2's rows (one a
    view) and of the quantile masks' detail maps (two a fine stage);
    halos for the convolutions; all-reduces for the statistics, the
    soft-argmin, the losses and the gradients."""
    for r in dry4["ranks"]:
        c = r["collectives_first"]
        assert c["all_gather"][0] == 2 + 2 * 3, c
        assert c["halo"][0] > 0 and c["all_reduce"][0] > 0, c
        assert set(c) == {"all_gather", "halo", "all_reduce"}, c


# -- the train CLI across processes ------------------------------------------

CLI = ["--config", "runs/ckpt_faithful/config.json", "--dataset",
       "synthetic", "--steps", "2", "--device", "cpu", "--dataset_length",
       "8", "--set", "model.max_disp=27", "--set", "model.base_channels=4",
       "--set", "model.dtype=float32", "--set", "train.batch_size=2",
       "--set", "train.crop_h=54", "--set", "train.crop_w=54",
       "--set", "train.log_every=1", "--set", "data.on_device=false",
       "--set", "data.num_workers=1"]


def log_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def test_train_cli_multihost_two_processes(tmp_path, capsys):
    one = str(tmp_path / "one")
    train_cli.main(CLI + ["--ckpt_dir", one])
    want = log_lines(capsys.readouterr().out)
    # the W=1 loader's first epoch, as the CLI draws it
    cfg = train_cli.build_config(train_cli.parse_args(CLI))
    whole = DataLoader(list(range(8)), batch_size=2, shuffle=True,
                       seed=cfg.train.seed, drop_last=True)._epoch()

    two = str(tmp_path / "two")
    ranks = dryrun.spawn(
        2, workers.cli_worker,
        (CLI + ["--ckpt_dir", two, "--multihost", "1"],
         CLI + ["--ckpt_dir", str(tmp_path / "refused"), "--multihost", "1",
                "--set", "data.on_device=true"], dryrun.free_port()),
        threads=THREADS)
    got = log_lines(ranks[0]["log"])
    assert [l["step"] for l in got] == [1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "stage3/fusion"):
            np.testing.assert_allclose(g[k], w[k], rtol=dryrun.LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=dryrun.GRAD_NORM_RTOL)
    assert ranks[1]["log"] == ""
    assert ranks[0]["saves"] == [2] and ranks[1]["saves"] == []
    assert sorted(os.listdir(two)) == ["2", "config.json", "params.npz"]
    # each global batch is the W=1 batch, split into disjoint shards
    for i, batch in enumerate(whole):
        a, b = ranks[0]["epoch"][i], ranks[1]["epoch"][i]
        assert not set(a) & set(b)
        assert sorted(a + b) == sorted(int(x) for x in batch)
    for r in ranks:
        assert r["refused"] == "on_device data stream is single-process"
    assert not os.path.exists(tmp_path / "refused")


def test_train_cli_on_a_tile_disp_mesh(tmp_path, capsys):
    """`--set mesh.tile=2 --set mesh.disp=2` on four processes, the
    on-device stream (each rank its rows of the global draw), S = 2 at
    stage 0: each step's loss, fusion term and grad norm are the
    one-process run's (the dry run's tolerances); rank 0 alone logs and
    saves."""
    argv = [a for a in CLI]
    argv[argv.index("model.max_disp=27")] = "model.max_disp=54"
    argv[argv.index("data.on_device=false")] = "data.on_device=true"
    train_cli.main(argv + ["--ckpt_dir", str(tmp_path / "one")])
    want = log_lines(capsys.readouterr().out)
    four = str(tmp_path / "four")
    ranks = dryrun.spawn(
        4, workers.cli_mesh_worker,
        (argv + ["--ckpt_dir", four, "--multihost", "1", "--set",
                 "mesh.tile=2", "--set", "mesh.disp=2"],), threads=THREADS)
    got = log_lines(ranks[0]["log"])
    assert [l["step"] for l in got] == [1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "stage3/fusion"):
            np.testing.assert_allclose(g[k], w[k], rtol=dryrun.LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=dryrun.GRAD_NORM_RTOL)
    assert all(r["log"] == "" for r in ranks[1:])
    assert ranks[0]["saves"] == [2] and all(r["saves"] == []
                                            for r in ranks[1:])
    assert "mesh {'data': 1, 'tile': 2, 'disp': 2}" in ranks[0]["log"]


def test_train_cli_rss_guard_checkpoints_and_exits_75(tmp_path):
    out = str(tmp_path / "rss")
    with pytest.raises(SystemExit) as e:
        train_cli.main(CLI + ["--ckpt_dir", out, "--set",
                              "train.max_rss_gb=0.001"])
    assert e.value.code == train_cli.RSS_EXIT_CODE
    assert sorted(os.listdir(out)) == ["1", "config.json", "params.npz"]
    assert train_cli.rss_gb() > 0.001


def test_make_mesh_shapes():
    assert mesh.make_mesh(MeshConfig(data=-1), world=2).shape == \
        {"data": 2, "tile": 1, "disp": 1}
    assert mesh.make_mesh(MeshConfig(data=8), world=8).shape == \
        {"data": 8, "tile": 1, "disp": 1}
    assert mesh.make_mesh().data == 1
    with pytest.raises(ValueError, match="mesh 3x1x1 != 2 processes"):
        mesh.make_mesh(MeshConfig(data=3), world=2)
    # the tile and disp axes: JAX's layout, rank r at data r // (tile
    # disp), tile (r // disp) % tile, disp r % disp
    for axis in ("tile", "disp"):
        m = mesh.make_mesh(MeshConfig(**{axis: 2}), world=4)
        assert m.shape == {"data": 2, "tile": 1, "disp": 1, axis: 2}
    m = mesh.make_mesh(MeshConfig(tile=2, disp=2), world=8)
    assert m.shape == {"data": 2, "tile": 2, "disp": 2}
    assert [m.position(r) for r in range(8)] == [
        (d, t, s) for d in range(2) for t in range(2) for s in range(2)]
    assert m.members(("tile",), 5) == [5, 7]
    assert m.members(("data", "disp"), 5) == [0, 1, 4, 5]
    with pytest.raises(ValueError, match="mesh 1x2x2 != 2 processes"):
        mesh.make_mesh(MeshConfig(data=1, tile=2, disp=2), world=2)
    assert mesh.shard(8, world=2, index=1) == ((1, 2), 4)
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        mesh.shard(8, world=3)
