"""Host batching (as ``pavenet_tpu/datasets/loader.py``): GT padded to a
static number of slots, batches grouped by padded image shape (bucket),
and a prefetch thread that overlaps the host pipeline with the card.

The JAX package's pipeline and its resample of a dropped sample draw from
the global Python and numpy streams; here they draw from the loader's
generators (``rng``, ``utils/seed.py::Generators``), which only the thread
that builds the batches touches, in the same order. The shuffle takes
``np.random.RandomState(seed + epoch)``, as there, and ``num_shards`` /
``shard_index`` split that permutation over the ranks of a data-parallel
run as the JAX loader splits it over processes.
"""
from __future__ import annotations

import itertools
import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np

from ..utils.seed import Generators, set_random_seed


def pad_gt(sample: dict, max_gt: int, num_keypoints: int) -> dict:
    """Pad per-sample GT arrays to ``max_gt`` slots with a validity mask
    ``gt_valid``; ``_row_valid`` marks a real (not repeat-padded) row."""
    out = dict(sample)
    kpts = sample.get("gt_keypoints",
                      np.zeros((0, num_keypoints, 3), np.float32))
    G = min(len(kpts), max_gt)
    pk = np.zeros((max_gt, num_keypoints, 3), np.float32)
    pa = np.zeros((max_gt,), np.float32)
    pv = np.zeros((max_gt,), bool)
    if G:
        pk[:G] = kpts[:G]
        pa[:G] = sample["gt_areas"][:G]
        pv[:G] = True
    out["gt_keypoints"] = pk
    out["gt_areas"] = np.maximum(pa, 1e-6)
    out["gt_valid"] = pv
    out["_row_valid"] = np.ones((), bool)
    if "gt_bboxes" in sample:
        pb = np.zeros((max_gt, 4), np.float32)
        if G:
            pb[:G] = sample["gt_bboxes"][:G]
        out["gt_bboxes"] = pb
    out.pop("gt_labels", None)
    return out


class ClipLoader:
    """Iterates a dataset into model-ready numpy batches.

    Samples are grouped by padded image shape so that a batch has one
    shape; with ``drop_last`` a bucket's incomplete tail is dropped,
    otherwise repeat-padded with rows marked ``_row_valid`` False. Each
    ``iter`` is one epoch. ``prefetch`` > 0 builds batches on a background
    thread, at most ``prefetch`` ahead. With ``num_shards`` > 1 the loader
    holds shard ``shard_index`` of every epoch's permutation, and with
    ``drop_last`` yields exactly ``len(self)`` batches (``_index_stream``).
    """

    def __init__(self, dataset, batch_size: int = 1, max_gt: int = 30,
                 num_keypoints: int = 15, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2, rng: Optional[Generators] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.num_keypoints = num_keypoints
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.rng = rng if rng is not None else set_random_seed(seed)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        """The epoch's indices of this shard: the same ``seed + epoch``
        permutation on every shard, then every ``num_shards``-th entry."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def _index_stream(self):
        """The shard's indices once; a shard of a sharded loader with
        ``drop_last`` wraps around them as long as its batches need. Its
        buckets may leave it short of ``len(self)`` full batches (the rows
        of a shard can fall into different buckets), and every rank must
        take the same number of steps, or one would wait in a collective
        for the others: the repeats fill those batches, as the reference's
        ``DistributedGroupSampler`` pads its groups."""
        idx = self._indices()
        if self.num_shards == 1 or not self.drop_last or not len(idx):
            return iter(idx)
        return itertools.cycle(idx)

    def _sample(self, i):
        s = self.dataset.prepare(i, self.rng)
        while s is None:   # the pipeline dropped it: draw another
            s = self.dataset.prepare(
                self.rng.np.randint(len(self.dataset)), self.rng)
        return pad_gt(s, self.max_gt, self.num_keypoints)

    def _batches(self) -> Iterator[dict]:
        by_bucket = {}
        # a sharded loader yields exactly len(self) batches an epoch
        limit = len(self) if self.num_shards > 1 and self.drop_last else None
        if limit == 0:
            return
        n_out = 0
        for i in self._index_stream():
            s = self._sample(i)
            key = s["img"].shape
            by_bucket.setdefault(key, []).append(s)
            if len(by_bucket[key]) == self.batch_size:
                yield self._collate(by_bucket.pop(key))
                n_out += 1
                if n_out == limit:
                    return
        if not self.drop_last:
            for group in by_bucket.values():
                while len(group) < self.batch_size:
                    pad = dict(group[-1])
                    pad["_row_valid"] = np.zeros((), bool)
                    group.append(pad)
                yield self._collate(group)

    @staticmethod
    def _collate(samples) -> dict:
        return {k: np.stack([s[k] for s in samples], 0)
                for k in samples[0]}

    def __iter__(self):
        self.epoch += 1
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def producer():
            try:
                for b in self._batches():
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue_mod.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as e:   # raised again in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            # an epoch left early (--max-steps) stops the producer, so that
            # it draws nothing more from the generators
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue_mod.Empty:
                    pass
            t.join()
