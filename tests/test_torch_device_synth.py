"""The port's on-device synthetic stream (`decnet_tpu_torch/data/
device_synth.py`) against decnet_tpu's, on the CPU.

torch.Generator cannot give jax.random's bits, so the JAX package's draws
are made here from its key, exactly as its make_device_batch splits it, and
handed to the port's deterministic `scene_from_draws`; the batch must then
be JAX's.  Then the geometry properties the JAX stream is held to
(tests/test_train_and_data.py) are checked on the port's own stream.

Tolerances: the z-buffer is exact; textures and images 1e-4 (f32 sums of
values up to 255 in another order); the disparity 1e-5.  The right view
samples the texture at x + d_r, with d_r from four fixed-point steps
d_r <- d(x + d_r) that multiply a difference in d by the disparity step at
a depth edge (up to ~50 px per px): the 2e-6 px by which the two smooth
backgrounds differ (interpolation sums in another order) move a few right
samples by ~1e-3 px.  So 99.9% of right-view values within 1e-4, all
within 1e-2 (measured: 4 of 8748 pixels off, by at most 4e-3).  Masks may
differ only where the normalised residual lies within 1e-4 of the
threshold (measured: none)."""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from decnet_tpu.data import device_synth as jsynth
from decnet_tpu_torch.data import device_synth as tsynth
from decnet_tpu_torch.ops.detail import detail_residuals

B, H, W, D = 2, 54, 81, 27


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def jax_draws(key, b, h, w, max_disp, grids=3):
    """make_device_batch's uniform draws from `key`, in the port's layout;
    the first `grids` texture grids of the three."""
    k_tex, k_bg, k_box, k_bar = jax.random.split(key, 4)
    bg = jax.random.uniform(k_bg, (b, 5, 5, 1), jnp.float32)
    rects = []
    for k0 in (k_box, k_bar, jax.random.fold_in(k_bar, 1)):
        k = k0
        for _ in range(3):
            k, k1 = jax.random.split(k)
            rects.append(torch.from_numpy(np.array(
                jax.random.uniform(k1, (6, b), jnp.float32))))
    tex, k = [], k_tex
    for gw in tsynth.texture_widths(w, max_disp)[:grids]:
        k, k1 = jax.random.split(k)
        tex.append(nchw(jax.random.uniform(k1, (b, min(gw, 2 * h), gw, 3),
                                           jnp.float32)))
    return {"bg": nchw(bg), "rects": rects, "tex": tex}


def test_right_view_disparity_matches_jax():
    rng = np.random.RandomState(0)
    disp = (rng.rand(B, H, W) * 10 + 5).astype(np.float32)
    disp[:, 10:30, 40:44] = 25.0                     # a thin near bar
    xs = np.broadcast_to(np.arange(W, dtype=np.float32), disp.shape)
    want = jsynth._right_view_disparity(jnp.asarray(disp), jnp.asarray(xs), W)
    got = tsynth.right_view_disparity(torch.from_numpy(disp),
                                      torch.from_numpy(xs.copy()), W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_texture_matches_jax():
    draws = jax_draws(jax.random.PRNGKey(5), B, H, W, D)
    wd = W + D
    jtex = jsynth._TexFn(jax.random.PRNGKey(5), B, H, W, wd=wd)
    jtex.grids = [jsynth.interpolate(jnp.asarray(g.numpy().transpose(
        0, 2, 3, 1)), H, g.shape[-1], "bilinear") for g in draws["tex"]]
    x = np.random.RandomState(1).rand(B, H, W).astype(np.float32) * wd * 1.1
    want = jtex(jnp.asarray(x))
    got = tsynth.TexFn(draws["tex"], H, wd)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0, atol=1e-4)


def test_batch_from_jax_draws_matches_jax():
    key = jax.random.PRNGKey(3)
    want = jsynth.make_device_batch(key, batch=B, h=H, w=W, max_disp=D,
                                    dtype=jnp.float32)
    got = tsynth.scene_from_draws(jax_draws(key, B, H, W, D), h=H, w=W,
                                  max_disp=D)
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(want["gt"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["left"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want["left"]), rtol=0, atol=1e-4)
    err = np.abs(got["right"].numpy().transpose(0, 2, 3, 1)
                 - np.asarray(want["right"]))
    assert (err > 1e-4).mean() <= 1e-3 and err.max() <= 1e-2, err.max()
    for side, img in (("left_masks", got["left"]),
                      ("right_masks", got["right"])):
        # the residuals of the port's image decide which flips may happen
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        res = detail_residuals(img * std + mean, 3, 3)[::-1]
        for g, w, r in zip(got[side], want[side], res):
            flips = g.numpy() != np.asarray(w)
            assert (np.abs(r.numpy()[flips] - 0.3) <= 1e-4).all(), side


def test_stream_shapes_and_geometry():
    """Shapes match the train-batch contract, masks sit on the stage grids,
    and left(x) photometrically matches right(x - gt(x)), much better than
    at a wrong disparity."""
    gen = torch.Generator().manual_seed(3)
    b = tsynth.make_device_batch(gen, batch=2, h=54, w=81, max_disp=27,
                                 device="cpu")
    assert b["left"].shape == (2, 3, 54, 81) == b["right"].shape
    assert b["gt"].shape == (2, 54, 81)
    assert [tuple(m.shape[1:]) for m in b["left_masks"]] == \
        [(6, 9), (18, 27), (54, 81)]
    gt = b["gt"].numpy()
    assert 0 < gt.min() and gt.max() <= 27.0
    l = b["left"].numpy().transpose(0, 2, 3, 1)
    r = b["right"].numpy().transpose(0, 2, 3, 1)

    def warp_err(shift):
        src = np.arange(81)[None, None, :] - gt - shift
        x0 = np.clip(np.floor(src).astype(int), 0, 79)
        fx = (src - x0)[..., None]
        warped = (np.take_along_axis(r, x0[..., None], axis=2) * (1 - fx)
                  + np.take_along_axis(r, (x0 + 1)[..., None], axis=2) * fx)
        return np.abs(warped - l).mean(axis=-1)

    src = np.arange(81)[None, None, :] - gt
    valid = (src > 0) & (src < 80)
    good = np.percentile(warp_err(0.0)[valid], 50)
    assert good < 0.4 * l.std()
    assert np.percentile(warp_err(4.0)[valid], 50) > 2.0 * good

    gen.manual_seed(3)
    b2 = tsynth.make_device_batch(gen, batch=2, h=54, w=81, max_disp=27,
                                  device="cpu")
    np.testing.assert_array_equal(b2["gt"].numpy(), gt)
    gen.manual_seed(4)
    b3 = tsynth.make_device_batch(gen, batch=2, h=54, w=81, max_disp=27,
                                  device="cpu")
    assert np.abs(b3["gt"].numpy() - gt).max() > 1.0


def test_stream_masks_are_symmetric_and_matchable():
    """Left and right detail masks are comparably dense, and the true
    match of a left detail pixel is itself a right detail pixel (within
    +-1 px) most of the time: the sparse branch has candidates."""
    gen = torch.Generator().manual_seed(11)
    b = tsynth.make_device_batch(gen, batch=2, h=162, w=243, max_disp=108,
                                 device="cpu")
    gt = b["gt"].numpy()
    for lm_t, rm_t in zip(b["left_masks"], b["right_masks"]):
        lmd, rmd = float(lm_t.mean()), float(rm_t.mean())
        assert rmd > 0.4 * lmd and lmd > 0.05, (lmd, rmd)
    lm = b["left_masks"][-1].numpy() > 0
    rm = b["right_masks"][-1].numpy() > 0
    xs = np.arange(lm.shape[2])[None, None, :]
    src = np.clip(np.round(xs - gt).astype(int), 0, lm.shape[2] - 1)
    hit = np.zeros_like(lm)
    for d in (-1, 0, 1):
        hit |= np.take_along_axis(rm, np.clip(src + d, 0, lm.shape[2] - 1),
                                  axis=2)
    valid = np.broadcast_to((xs - gt) >= 0, lm.shape)
    assert hit[lm & valid].mean() > 0.5


def test_stream_repeats_and_val_split():
    kw = dict(batch=1, h=27, w=27, max_disp=9, device="cpu")
    s0 = tsynth.device_batch_stream(7, **kw)
    batches = [next(s0) for _ in range(3)]
    again = tsynth.device_batch_stream(7, **kw)
    for b in batches:
        np.testing.assert_array_equal(next(again)["gt"].numpy(),
                                      b["gt"].numpy())
    assert np.abs(batches[1]["gt"].numpy()
                  - batches[0]["gt"].numpy()).max() > 1.0
    sv = tsynth.device_batch_stream(7, val=True, **kw)
    assert np.abs(next(sv)["gt"].numpy()
                  - batches[0]["gt"].numpy()).max() > 1.0
    assert batches[0]["left"].dtype == torch.float32
    bf = next(tsynth.device_batch_stream(7, dtype=torch.bfloat16, **kw))
    assert bf["left"].dtype == torch.bfloat16 and bf["gt"].dtype == \
        torch.float32
