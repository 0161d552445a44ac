"""The legacy and stressor variants of the port's on-device stream against
decnet_tpu's, made from JAX's draws on the CPU (the pattern of
tests/test_torch_device_synth.py, whose tolerances and their reasons hold
here: gt 1e-5, left view 1e-4, right view 99.9% within 1e-4 and all within
1e-2 (its four fixed-point steps carry the backgrounds' 2e-6 px
difference across depth edges), masks flipping only on the threshold).
The stressor's sinusoids add sin of arguments up to ~60 rad in f32, whose
results may differ by an ulp between the two packages."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from decnet_tpu.data import device_synth as jsynth
from decnet_tpu_torch.data import device_synth as tsynth
from decnet_tpu_torch.ops.detail import detail_residuals
from tests.test_torch_device_synth import B, D, H, W, jax_draws, nchw


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads while the module runs: the suite runs six
    workers at once, and more threads per worker only contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_stressor_draws(key, b, h, w, max_disp):
    """_stressor_scene's uniform draws from make_device_batch's `key`, in
    the port's layout."""
    k_tex, k_bg, _, k_bar = jax.random.split(key, 4)
    bg = jax.random.uniform(k_bg, (b, 5, 5, 1), jnp.float32)
    rects = []
    for k0, n in ((k_bar, 6), (jax.random.fold_in(k_bar, 1), 2)):
        k = k0
        for _ in range(n):
            k, k1 = jax.random.split(k)
            rects.append(torch.from_numpy(np.array(
                jax.random.uniform(k1, (6, b), jnp.float32))))
    tex, k = [], k_tex
    for gw in tsynth.texture_widths(w, max_disp):
        k, k1 = jax.random.split(k)
        tex.append(nchw(jax.random.uniform(k1, (b, min(gw, 2 * h), gw, 3),
                                           jnp.float32)))
    phases = np.array(jax.random.uniform(jax.random.fold_in(k_tex, 7),
                                         (2, b, 1, 1, 3), jnp.float32))
    return {"bg": nchw(bg), "rects": rects, "tex": tex,
            "phases": torch.from_numpy(np.ascontiguousarray(
                phases.transpose(0, 1, 4, 2, 3)))}


@pytest.mark.parametrize("variant", ["legacy", "stressor"])
def test_variant_from_jax_draws_matches_jax(variant):
    key = jax.random.PRNGKey(3)
    want = jsynth.make_device_batch(key, batch=B, h=H, w=W, max_disp=D,
                                    dtype=jnp.float32, variant=variant)
    if variant == "legacy":
        got = tsynth.scene_from_draws(jax_draws(key, B, H, W, D), h=H, w=W,
                                      max_disp=D, legacy=True)
    else:
        got = tsynth.stressor_from_draws(jax_stressor_draws(key, B, H, W, D),
                                         h=H, w=W, max_disp=D)
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(want["gt"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["left"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(want["left"]), rtol=0, atol=1e-4)
    err = np.abs(got["right"].numpy().transpose(0, 2, 3, 1)
                 - np.asarray(want["right"]))
    assert (err > 1e-4).mean() <= 1e-3 and err.max() <= 1e-2, err.max()
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    for side, img in (("left_masks", got["left"]),
                      ("right_masks", got["right"])):
        res = detail_residuals(img * std + mean, 3, 3)[::-1]
        for g, w, r in zip(got[side], want[side], res):
            flips = g.numpy() != np.asarray(w)
            assert (np.abs(r.numpy()[flips] - 0.3) <= 1e-4).all(), side


def test_variants_differ_where_they_should():
    """From one set of draws: legacy's right view misses the thin bars that
    the default's z-buffer draws; the stressor's bars stand 0.55-0.9
    max_disp over a 0.08-0.22 max_disp background."""
    gen = torch.Generator().manual_seed(5)
    draws = tsynth.draw_default(gen, batch=2, h=H, w=W, max_disp=D,
                                device="cpu")
    default = tsynth.scene_from_draws(draws, h=H, w=W, max_disp=D)
    legacy = tsynth.scene_from_draws(draws, h=H, w=W, max_disp=D,
                                     legacy=True)
    assert torch.equal(default["gt"], legacy["gt"])
    assert torch.equal(default["left"], legacy["left"])
    assert not torch.equal(default["right"], legacy["right"])
    gen.manual_seed(5)
    s = tsynth.make_device_batch(gen, batch=2, h=H, w=W, max_disp=D,
                                 device="cpu", variant="stressor")
    gt = s["gt"]
    assert float(gt.min()) >= 0.08 * D - 1e-4
    assert float(gt.max()) <= 0.9 * D + 1e-4
    assert float((gt > 0.5 * D).float().mean()) > 0.005     # bars present
    with pytest.raises(ValueError):
        tsynth.make_device_batch(gen, batch=1, h=H, w=W, max_disp=D,
                                 device="cpu", variant="nosuch")


def test_stream_takes_variant():
    kw = dict(batch=1, h=27, w=54, max_disp=27, device="cpu")
    for v in tsynth.VARIANTS:
        a = next(tsynth.device_batch_stream(7, variant=v, **kw))
        b = next(tsynth.device_batch_stream(7, variant=v, **kw))
        assert torch.equal(a["left"], b["left"]), v
    d = next(tsynth.device_batch_stream(7, **kw))
    s = next(tsynth.device_batch_stream(7, variant="stressor", **kw))
    assert not torch.equal(d["gt"], s["gt"])


def jax_val_draws(seed, batches, b, h, w, max_disp):
    """The draws of batches 0..batches-1 of JAX's val stream
    (`device_batch_stream(seed, val=True)`, scripts/report_eval.py's
    batches) but the per-pixel noise grid, as `saved_draw_stream` reads
    them."""
    root = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    rows = [jax_draws(jax.random.fold_in(root, step), b, h, w, max_disp,
                      grids=2) for step in range(batches)]
    return {"bg": np.stack([r["bg"].numpy() for r in rows]),
            "rects": np.stack([np.stack([x.numpy() for x in r["rects"]])
                               for r in rows]),
            "tex0": np.stack([r["tex"][0].numpy() for r in rows]),
            "tex1": np.stack([r["tex"][1].numpy() for r in rows]),
            "shape": np.array([b, h, w, max_disp])}


def test_saved_draws_give_the_jax_report_scenes(tmp_path):
    """The dump of JAX's val stream through `saved_draw_stream` gives JAX's
    scenes (gt 1e-5, as above), and `report_eval --draws` evaluates them."""
    from decnet_tpu_torch.cli import report_eval
    b, h, w, max_disp, seed = 1, 54, 81, 54, 37
    path = str(tmp_path / "draws.npz")
    np.savez(path, **jax_val_draws(seed, 2, b, h, w, max_disp))
    kw = dict(batch=b, h=h, w=w, max_disp=max_disp, variant="legacy")
    want = jsynth.device_batch_stream(seed, val=True, **kw)
    got = list(tsynth.saved_draw_stream(path, seed=seed, device="cpu", **kw))
    assert len(got) == 2
    for g in got:
        np.testing.assert_allclose(g["gt"].numpy(),
                                   np.asarray(next(want)["gt"]),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        next(tsynth.saved_draw_stream(path, seed=seed, device="cpu",
                                      **dict(kw, w=108)))
    ckpt = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runs", "ckpt_faithful")
    rep = report_eval.report(ckpt, batches=2, seed=seed,
                             device="cpu", draws=path, **kw)
    assert rep["batches"] == 2 and rep["draws"] == path
    assert len(rep["final_epe_per_batch"]) == 2
    with pytest.raises(ValueError):
        report_eval.report(ckpt, batches=3, seed=seed, device="cpu",
                           draws=path, **kw)
    assert np.isfinite(rep["stage3_epe"]) and np.isfinite(rep["final_epe_se"])


if __name__ == "__main__":
    import argparse
    jax.config.update("jax_platforms", "cpu")
    p = argparse.ArgumentParser(
        description="Write the scenes of JAX's val stream (the batches of "
        "scripts/report_eval.py) for `decnet_tpu_torch.cli.report_eval "
        "--draws`.")
    p.add_argument("--dump", required=True, help="the npz to write")
    p.add_argument("--h", type=int, default=540)
    p.add_argument("--w", type=int, default=972)
    p.add_argument("--max_disp", type=int, default=216)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--batches", type=int, default=24)
    p.add_argument("--seed", type=int, default=37)
    a = p.parse_args()
    np.savez(a.dump, **jax_val_draws(a.seed, a.batches, a.batch, a.h, a.w,
                                     a.max_disp))
