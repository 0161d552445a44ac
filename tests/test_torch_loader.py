"""The port's loader (decnet_tpu_torch/data/loader.py) against
decnet_tpu/data/loader.py: the same batches in the same order for every
shuffle / shard / drop_last setting, a worker's exception raised in the
consumer, and the device hand-off in the layout the port's steps take."""
import itertools

import numpy as np
import pytest
import torch

from decnet_tpu.data.loader import DataLoader as JaxLoader
from decnet_tpu_torch.config import Config, ModelConfig
from decnet_tpu_torch.data import get_dataset
from decnet_tpu_torch.data.loader import (DataLoader, collate,
                                          device_batches, to_device)
from decnet_tpu_torch.models import DecNet
from decnet_tpu_torch.train.step import eval_step
from tests.test_torch_datasets import write_packs


class Indexed:
    """Samples that name their index, in the datasets' layout."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"sample {i} is broken")
        return {"left": np.full((2, 3, 3), i, np.float32),
                "left_masks": [np.full((1, 1), i, np.float32)] * 2,
                "name": str(i), "n_disp": 192 + i}


def flat(batches):
    return [(b["name"], b["n_disp"], b["left"].tolist(),
             [m.tolist() for m in b["left_masks"]]) for b in batches]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shard", [None, (0, 3), (2, 3)])
def test_batches_equal_jax(shuffle, drop_last, shard):
    ds = Indexed(11)
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=3, seed=7,
              drop_last=drop_last, prefetch=1, shard=shard)
    ours, jax = DataLoader(ds, **kw), JaxLoader(ds, **kw)
    assert len(ours) == len(jax)
    for epoch in range(2):    # the shuffle's generator goes on per epoch
        got, want = flat(ours), flat(jax)
        assert got == want and len(got) == len(ours), epoch


def test_worker_error_reaches_consumer():
    loader = DataLoader(Indexed(9, fail_at=5), batch_size=2, num_workers=3,
                        prefetch=1)
    with pytest.raises(KeyError, match="sample 5 is broken"):
        for _ in loader:
            pass


def test_to_device_gives_the_steps_layout(tmp_path):
    """A dataset's collated batch, handed to the device, is what the
    model and eval_step take: NCHW f32 views, (B,H,W) gt, mask lists."""
    write_packs(str(tmp_path), "test", n=2, masks=False)
    ds = get_dataset("sceneflow", str(tmp_path), split="test",
                     is_training=False)
    batch = collate([ds[0], ds[1]])
    b = to_device(batch, "cpu")
    assert b["left"].shape == (2, 3, 81, 108) and b["left"].dtype == \
        torch.float32
    assert torch.equal(b["right"], torch.from_numpy(
        batch["right"]).permute(0, 3, 1, 2))
    assert b["gt"].shape == (2, 81, 108)
    assert [tuple(m.shape) for m in b["left_masks"]] == [
        (2, 9, 12), (2, 27, 36), (2, 81, 108)]
    assert b["name"] == ["0000", "0001"] and b["ori_h"] == [63, 63]
    cfg = Config()
    cfg.model = ModelConfig(max_disp=54, base_channels=4, dtype="float32")
    m = eval_step(DecNet(cfg.model), b, cfg)
    assert m["pred"].shape == (2, 81, 108) and torch.isfinite(m["epe"])


@pytest.mark.parametrize("shuffle", [False, True])
def test_repeat_equals_successive_epochs_of_jax(shuffle):
    """`repeat` runs one pool of workers over epoch after epoch: its
    batches are those of successive epochs of JAX's loader."""
    ds = Indexed(7)
    kw = dict(batch_size=3, shuffle=shuffle, num_workers=3, seed=4,
              drop_last=True, prefetch=1)
    jax = JaxLoader(ds, **kw)
    want = flat([b for _ in range(4) for b in jax])
    got = flat(itertools.islice(DataLoader(ds, **kw).repeat(), len(want)))
    assert got == want and len(want) == 8
    with pytest.raises(ValueError, match="no batch"):
        DataLoader(Indexed(2), batch_size=3, drop_last=True).repeat()


def test_device_batches_ahead_of_the_consumer(tmp_path):
    """`device_batches` gives `to_device` of each batch, in order, and
    raises the loader's error in the consumer."""
    write_packs(str(tmp_path), "test", n=3, masks=False)
    ds = get_dataset("sceneflow", str(tmp_path), split="test",
                     is_training=False)
    loader = DataLoader(ds, batch_size=1, num_workers=2)
    for got, want in zip(device_batches(iter(loader), "cpu"),
                         [to_device(b, "cpu") for b in loader]):
        assert got["name"] == want["name"]
        for k in ("left", "right", "gt"):
            assert torch.equal(got[k], want[k]), k
        for a, b in zip(got["left_masks"], want["left_masks"]):
            assert torch.equal(a, b)
    failing = DataLoader(Indexed(9, fail_at=5), batch_size=2, num_workers=2)
    stream = device_batches((b | {"gt": b["left"][..., 0],
                                  "right": b["left"],
                                  "right_masks": b["left_masks"]}
                             for b in failing.repeat()), "cpu")
    with pytest.raises(KeyError, match="sample 5 is broken"):
        for _ in stream:
            pass
