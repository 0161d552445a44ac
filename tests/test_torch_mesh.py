"""The mesh's tile and disp axes (decnet_tpu_torch/parallel/mesh.py) on
the CPU, in f32: gloo processes (`parallel/dryrun.py::spawn`, a deadline,
one CPU thread each), one spawn of 2 (tile 2) and one of 4 (tile 2 x
disp 2) for all the module cases, each held to the same computation
unsplit in this process:

  * the halo convolutions (2D stride 1, stride 3, dilated and transposed
    over tile; 3D over disp, and over disp and tile): forward 1e-6, dx and
    the kernel gradient after the rule's reduction 1e-5;
  * JAX's idle-axis repro (tests/test_parallel.py::
    test_conv_kernel_grad_idle_mesh_axis) on tile 2 x disp 2: the kernel
    gradient reduced by the rule equals the unsplit one (2e-5), and a sum
    over the whole world comes back 2x;
  * `_BatchStats` under each placement, normalising its part: mean,
    variance and output 1e-6, dx 1e-5; GroupNorm's per-image statistics
    over rows: output 1e-6, gradients 1e-5;
  * the split soft-argmin: prediction and gradient 1e-6 against the
    unsplit one, and 1e-5 against JAX's `disparity_regression`;
  * the quantile masks over tile: bit-equal;
  * `warp_plain` and the reference warp on row shards with an offset:
    exactly the unsplit rows; the differentiable warp on 2 ranks 1e-6;
  * `interpolate` on rows: 1e-6, gradients 1e-5;
  * the dry run's model split over tile 2 (eval mode): the unsplit
    forward's rows and JAX's forward on the same weights, within JAX's own
    2e-4 (tests/test_parallel.py:73); its collectives by kind; and an H
    that does not divide by tile x 27 refused with a ValueError.

The 4-process train step against the replay and against JAX is
tests/test_torch_parallel.py's (it shares that file's JAX step); the
8-process dry run is chip_smoke.py's (8 processes of this model would
outgrow the tier-1 time and memory here)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.models import get_model
from decnet_tpu.ops.regression import disparity_regression as jax_regression
from decnet_tpu_torch.ops.kernels.warp import warp_plain
from decnet_tpu_torch.ops.warp import warp_by_disparity
from decnet_tpu_torch.parallel import dryrun, mesh
from decnet_tpu_torch.weights import variables_from_model
from tests import torch_parallel_workers as workers

FWD_TOL, GRAD_TOL, IDLE_TOL, JAX_TOL, JAX_FWD_TOL = 1e-6, 1e-5, 2e-5, 1e-5, 2e-4
THREADS = 1


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
def tile2():
    return dryrun.spawn(2, workers.mesh_module_worker, (2, 1),
                        threads=THREADS)


@pytest.fixture(scope="module")
def tile2_disp2():
    return dryrun.spawn(4, workers.mesh_module_worker, (2, 2),
                        threads=THREADS)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def assemble(ranks, key, split, field, disp_dim=2):
    """The global tensor from the ranks' parts (`workers.part`): rows of
    the tile ranks concatenated along dim -2, S slices along disp_dim;
    replicas taken from the first rank that holds each part."""
    parts = {}
    for r in ranks:
        _, t, s = r["position"]
        key_ = (t if "tile" in split else 0, s if "disp" in split else 0)
        parts.setdefault(key_, r[key][field])
    tiles = sorted({k[0] for k in parts})
    disps = sorted({k[1] for k in parts})
    rows = []
    for t in tiles:
        x = [parts[(t, s)] for s in disps]
        rows.append(np.concatenate(x, disp_dim) if len(x) > 1 else x[0])
    return np.concatenate(rows, -2) if len(rows) > 1 else rows[0]


@pytest.mark.parametrize("name", sorted(workers.CONV_CASES))
def test_halo_convolution_equals_unsplit(tile2, tile2_disp2, name):
    split = workers.CONV_CASES[name][3]
    ranks = tile2 if "disp" not in split else tile2_disp2
    one = workers.conv_case(name)
    close(assemble(ranks, f"conv/{name}", split, "y"), one["y"], FWD_TOL,
          "y")
    close(assemble(ranks, f"conv/{name}", split, "dx"), one["dx"], GRAD_TOL,
          "dx")
    for r in ranks:
        close(r[f"conv/{name}"]["dw"], one["dw"], GRAD_TOL, "dw")


def test_group_norm_over_rows_equals_unsplit(tile2):
    one = workers.group_norm_case()
    for k in ("y", "dx"):
        close(assemble(tile2, "group_norm", ("tile",), k), one[k],
              FWD_TOL if k == "y" else GRAD_TOL, k)
    for r in tile2:
        close(r["group_norm"]["dgamma"], one["dgamma"], GRAD_TOL, "dgamma")


def test_idle_axis_kernel_gradient(tile2_disp2):
    one = workers.idle_axis_case()
    for r in tile2_disp2:
        close(r["idle"]["dw"], one["dw"], IDLE_TOL, "dw")
        # the sum over every process counts each tile shard twice, once
        # per disp rank: the bug of decnet_tpu/ops/spmd_conv.py
        ratio = (np.linalg.norm(r["idle"]["dw_world_sum"])
                 / np.linalg.norm(one["dw"]))
        assert abs(ratio - 2.0) < 1e-4, ratio
    close(assemble(tile2_disp2, "idle", ("tile",), "dx"), one["dx"],
          IDLE_TOL, "dx")


@pytest.mark.parametrize("name", sorted(workers.BN_PLACEMENTS))
def test_batch_stats_over_each_group(tile2_disp2, name):
    split = workers.BN_PLACEMENTS[name]
    one = workers.bn_case(name)
    for r in tile2_disp2:
        for k in ("mean", "var"):
            close(r[f"bn/{name}"][k], one[k], FWD_TOL, k)
    close(assemble(tile2_disp2, f"bn/{name}", split, "y"), one["y"],
          FWD_TOL, "y")
    close(assemble(tile2_disp2, f"bn/{name}", split, "dx"), one["dx"],
          GRAD_TOL, "dx")


def test_split_soft_argmin_equals_unsplit_and_jax(tile2_disp2):
    one = workers.regression_case()
    for r in tile2_disp2:
        close(r["regression"]["pred"], one["pred"], FWD_TOL, "pred")
    close(assemble(tile2_disp2, "regression", ("disp",), "dcost", 1),
          one["dcost"], FWD_TOL, "dcost")
    cost, g = workers.regression_inputs()
    samples = jnp.broadcast_to(jnp.arange(4.0)[None, :, None, None],
                               cost.shape)
    want, vjp = jax.vjp(lambda c: jax_regression(c, samples),
                        jnp.asarray(cost))
    close(tile2_disp2[0]["regression"]["pred"], np.asarray(want), JAX_TOL,
          "pred vs JAX")
    close(assemble(tile2_disp2, "regression", ("disp",), "dcost", 1),
          np.asarray(vjp(jnp.asarray(g))[0]), JAX_TOL, "dcost vs JAX")


def test_quantile_threshold_over_tile_is_bit_equal(tile2_disp2):
    one = workers.quantile_case()
    for k in ("left", "right", "single"):
        got = assemble(tile2_disp2, "quantile", ("tile",), k)
        assert np.array_equal(got, one[k]), k
        assert 0 < got.mean() < 1, k


def shard_with_halo(x, t, n, halo=1):
    """Rows of tile shard t of n of x (B,C,H,W) with `halo` rows each
    side, zeros beyond the image."""
    H = x.shape[2]
    h = H // n
    pad = torch.nn.functional.pad(x, (0, 0, halo, halo))
    return pad[:, :, t * h:(t + 1) * h + 2 * halo].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_on_rows_equals_unsplit_rows(dtype):
    r = np.random.RandomState(3)
    B, C, H, W, D = 2, 3, 12, 16, 6
    feat = torch.from_numpy(r.randn(B, C, H, W).astype(np.float32)).to(dtype)
    disp = torch.from_numpy((r.rand(B, H, W) * 8 - 1).astype(np.float32))
    whole = warp_plain(feat, disp, D)
    ref = warp_by_disparity(feat.float(), disp)
    for n in (2, 3):
        h = H // n
        for t in range(n):
            rows = (H, t * h, 1)
            part = shard_with_halo(feat, t, n)
            d = disp[:, t * h:(t + 1) * h].contiguous()
            got = warp_plain(part, d, D, rows)
            assert torch.equal(got, whole[:, :, t * h:(t + 1) * h]), (n, t)
            got = warp_by_disparity(part.float(), d, rows)
            assert torch.equal(got, ref[:, :, t * h:(t + 1) * h]), (n, t)


def test_differentiable_warp_on_rows(tile2):
    one = workers.warp_case()
    for k in ("y", "dfeat", "ddisp"):
        close(assemble(tile2, "warp", ("tile",), k), one[k], FWD_TOL, k)


@pytest.mark.parametrize("name", sorted(workers.RESIZE_CASES))
def test_interpolate_on_rows(tile2, name):
    one = workers.resize_case(name)
    close(assemble(tile2, f"resize/{name}", ("tile",), "y"), one["y"],
          FWD_TOL, "y")
    close(assemble(tile2, f"resize/{name}", ("tile",), "dx"), one["dx"],
          GRAD_TOL, "dx")


def test_forward_split_over_tile_equals_unsplit_and_jax(tile2):
    one = workers.forward_case()
    cfg = dryrun.dryrun_config()
    from decnet_tpu_torch.models.decnet import DecNet
    from tests.test_torch_parallel import jax_dryrun_config
    model = DecNet(cfg.model)
    model.load_state_dict(dryrun.fresh_state(cfg))
    b = dryrun.rows(dryrun.build_batch(), 0, dryrun.B // workers.FORWARD_B,
                    "cpu")
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    jax_out = jax.jit(get_model("decnet", jax_dryrun_config().model).apply)(
        variables_from_model(model), nhwc(b["left"]), nhwc(b["right"]),
        [m.numpy() for m in b["left_masks"]],
        [m.numpy() for m in b["right_masks"]])
    for k in ("preds", "fusion", "dense"):
        for i, want in enumerate(one[k]):
            got = np.concatenate([r["forward"][k][i] for r in tile2], -2)
            close(got, want, JAX_FWD_TOL, f"{k}[{i}] vs unsplit")
            close(got, np.asarray(jax_out[k][i]), JAX_FWD_TOL,
                  f"{k}[{i}] vs JAX")
    for i, want in enumerate(one["masks_used"]):
        got = np.concatenate([r["forward"]["masks_used"][i] for r in tile2],
                             -2)
        assert np.array_equal(got, want), i


def test_forward_collectives_by_kind(tile2):
    """A forward gathers only conv2's rows (one all-gather a view) and the
    learned masks' detail maps (two a fine stage): no fine level."""
    for r in tile2:
        c = r["forward_collectives"]
        assert c["all_gather"][0] == 2 + 2 * 3, c
        assert c["halo"][0] > 0, c


def test_indivisible_shards_are_refused(tile2):
    for r in tile2:
        assert "H=28 is not divisible by tile 2 x 27" in r["forward"][
            "refused"]
        assert "ROADMAP.md section 3" in r["forward"]["refused"]
    m = mesh.Mesh(1, 2, 2)
    mesh.check_divisible(54, 27, 2, m)
    with pytest.raises(ValueError, match="H=81 is not divisible"):
        mesh.check_divisible(81, 27, 2, m)
    with pytest.raises(ValueError, match="S=3 is not divisible by disp 2"):
        mesh.check_divisible(54, 27, 3, m)
