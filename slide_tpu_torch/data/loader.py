"""Batch loader: dataset -> shuffled, collated numpy batches with background
thread prefetch (counterpart: `slide_tpu/data/loader.py`, a copy; the same
seed gives the same batches).

Batches are dicts of stacked numpy arrays (string fields become lists); the
training driver moves them to the card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def collate(items: list) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = False, seed: Optional[int] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        for i in range(nb):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def offer(item) -> bool:
            # bounded put that gives up once the consumer abandons iteration,
            # so a mid-epoch `break` doesn't leave the producer thread (and
            # its prefetched batches) pinned forever
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for batch_idx in self._index_batches():
                    if not offer(collate([self.dataset[int(i)] for i in batch_idx])):
                        return
                offer(stop)
            except BaseException as exc:  # propagate to the consumer
                offer(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            abandoned.set()


def get_dataloader(args: dict, phase: str = "train", rank: int = 0,
                   world_size: int = 1, append_samples_to_last_rank: bool = True,
                   shuffle_before_rank_split: bool = True,
                   random_subsample: bool = False, num_samples: int = 1000,
                   seed: Optional[int] = None) -> BatchLoader:
    """Dataset factory (`dataset.py:10-42`): per-rank batch size =
    batch_size / world_size; train phase shuffles."""
    from slide_tpu_torch.data.shapenet_psr import ShapesPSRDataset

    if args["dataset"] != "shapenet_psr_dataset":
        raise ValueError(f"{args['dataset']} dataset is not supported")
    if phase not in ("train", "test", "val"):
        raise ValueError(phase)
    if phase == "train":
        batch_size = int(args["batch_size"] / world_size)
        shuffle = True
    else:
        batch_size = int(args["eval_batch_size"] / world_size)
        shuffle = False
    dataset = ShapesPSRDataset(
        args["data_dir"], split=phase, categories=args["categories"],
        scale=args["scale"], num_gt_points=args["npoints"], rank=rank,
        world_size=world_size,
        append_samples_to_last_rank=append_samples_to_last_rank,
        shuffle_before_rank_split=shuffle_before_rank_split,
        load_psr=args.get("load_psr", False),
        augmentation=args.get("augmentation", False),
        random_subsample=random_subsample, num_samples=num_samples,
        repeat_dataset=args.get("repeat_dataset", 1),
        centered_to_centroid=args.get("centered_to_centroid", False),
        seed=seed)
    return BatchLoader(dataset, batch_size, shuffle=shuffle, seed=seed)
