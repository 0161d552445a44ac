"""Threaded prefetching batch loader — the port of
decnet_tpu/data/loader.py, and the hand-off of its batches to the device.

Worker threads run the numpy decode + augment + mask pipeline (the native
mask library and zlib release the GIL) and a bounded queue keeps batches
ready ahead of the card.  The order of batches, the seeded shuffle,
`shard` and `drop_last` are the JAX loader's; a worker's exception is
raised in the consumer.  Beyond the JAX loader: `repeat` runs epoch after
epoch through one pool of workers, and `device_batches` pins each batch
in a thread ahead of the step that copies it to the card."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

# what `to_device` leaves on the host: per-sample names and sizes
HOST_KEYS = ("name", "ori_h", "ori_w", "n_disp")


def collate(samples: List[Dict]) -> Dict:
    """Stack a list of sample dicts into batched numpy arrays."""
    out: Dict = {}
    first = samples[0]
    for k, v in first.items():
        if isinstance(v, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        elif isinstance(v, list):
            out[k] = [np.stack([s[k][i] for s in samples])
                      for i in range(len(v))]
        else:
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 4, shard: Optional[tuple] = None):
        """`shard=(index, count)`: this loader yields only every count-th
        sample after the seeded global shuffle (the same in every
        process), so processes feed disjoint subsets; `batch_size` is then
        the per-process batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard = shard

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.shard is not None:
            idx, count = self.shard
            order = order[idx::count]
        return order

    def __len__(self):
        n = len(self.dataset)
        if self.shard is not None:
            idx, count = self.shard
            n = (n - idx + count - 1) // count
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _epoch(self) -> List[np.ndarray]:
        """One epoch's batches of indices (drawing the shuffle)."""
        order = self._order()
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self._epoch()
        yield from self._run(iter(batches), len(batches))

    def repeat(self) -> Iterator[Dict]:
        """The batches of epoch after epoch, as successive `iter` calls
        give them, through one pool of workers: the next epoch's samples
        are prepared while this one's last batches are consumed, where
        `iter` starts each epoch with an empty queue."""
        if len(self) == 0:
            raise ValueError(f"{len(self.dataset)} samples make no batch of "
                             f"{self.batch_size}")

        def epochs():
            while True:
                yield from self._epoch()
        return self._run(epochs(), None)

    def _run(self, batches: Iterator[np.ndarray],
             total: Optional[int]) -> Iterator[Dict]:
        """Collated batches of `batches` (index arrays; `total` of them, or
        endless with None), in order, the samples read by the workers
        (started at the first batch asked for)."""
        sample_q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch * self.batch_size)
        stop = threading.Event()
        lock = threading.Lock()
        expect: Dict[int, int] = {}

        def task_stream():
            for bi, batch in enumerate(batches):
                expect[bi] = len(batch)
                for pos, idx in enumerate(batch):
                    yield bi, pos, int(idx)
        tasks = task_stream()

        def put(item):
            """Queue `item`; give up when the consumer has stopped."""
            while not stop.is_set():
                try:
                    sample_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                with lock:
                    task = next(tasks, None)
                if task is None:
                    return
                bi, pos, idx = task
                try:
                    put((bi, pos, self.dataset[idx]))
                except Exception as e:  # the consumer raises it
                    put((bi, pos, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Dict[int, Dict]] = {}
            next_bi = 0
            while total is None or next_bi < total:
                bi, pos, item = sample_q.get()
                if isinstance(item, Exception):
                    raise item
                pending.setdefault(bi, {})[pos] = item
                while next_bi in pending and \
                        len(pending[next_bi]) == expect[next_bi]:
                    ordered = [pending[next_bi][p]
                               for p in range(expect[next_bi])]
                    pending.pop(next_bi)
                    yield collate(ordered)
                    next_bi += 1
        finally:
            stop.set()
            for t in threads:
                t.join()


def pinned(batch: Dict, device) -> Dict:
    """The host half of `to_device`: the arrays as f32 CPU tensors, in
    pinned memory when `device` is a card."""
    cuda = torch.device(device).type == "cuda"

    def host(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return t.pin_memory() if cuda else t

    out = {k: batch[k] for k in HOST_KEYS if k in batch}
    for k in ("left", "right", "gt"):
        out[k] = host(batch[k])
    for k in ("left_masks", "right_masks"):
        out[k] = [host(m) for m in batch[k]]
    return out


def _moved(batch: Dict, device) -> Dict:
    """The device half of `to_device`: copies enqueued without blocking
    the host, the views laid out NCHW on the device."""
    dev = torch.device(device)
    move = lambda t: t.to(dev, non_blocking=True)
    out = dict(batch)
    for k in ("left", "right"):
        out[k] = move(batch[k]).permute(0, 3, 1, 2).contiguous()
    out["gt"] = move(batch["gt"])
    for k in ("left_masks", "right_masks"):
        out[k] = [move(m) for m in batch[k]]
    return out


def to_device(batch: Dict, device) -> Dict:
    """A collated batch as the port's model, `train_step` and `eval_step`
    take it: left/right (B,3,H,W) f32, gt (B,H,W) f32, left_masks /
    right_masks lists of (B,h,w) f32 tensors, all on `device`; the
    per-sample names and sizes (`HOST_KEYS`) stay host lists.  To a card
    each array is copied from pinned memory without blocking the host, and
    the views are laid out NCHW there."""
    return _moved(pinned(batch, device), device)


_END = object()


def device_batches(batches: Iterator[Dict], device,
                   depth: int = 2) -> Iterator[Dict]:
    """`to_device` of each batch of `batches` (collated numpy batches),
    with the host half (drawing the batch, its pinned copy) done ahead by
    a thread, up to `depth` batches, so that the consumer only enqueues
    the copies to the device.  The thread's exception is raised in the
    consumer; stopping closes `batches` in the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def run():
        try:
            for b in batches:
                put(pinned(b, device))
                if stop.is_set():
                    return
            put(_END)
        except Exception as e:          # the consumer raises it
            put(e)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield _moved(item, device)
    finally:
        stop.set()
        thread.join()
