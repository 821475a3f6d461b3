"""Datasets of labels only (counterpart: `slide_tpu/data/dummy.py`, a copy):
unconditional generation runs with no point data on disk.  Same seeds,
same labels and the same split over ranks as the JAX package."""

from __future__ import annotations

import random
from typing import Optional, Sequence

import numpy as np

from slide_tpu_torch.data.shapenet_psr import load_metadata


class DummyShapesDataset:
    """Yields only {label, category, category_name} drawn from metadata.yaml."""

    def __init__(self, dataset_folder: str, num_samples: int,
                 categories: Optional[Sequence[str]] = None, rank: int = 0,
                 world_size: int = 1, seed: Optional[int] = None):
        self.metadata = load_metadata(dataset_folder)
        self.categories = list(categories) if categories is not None \
            else sorted(self.metadata.keys())
        self._rng = random.Random(seed)
        self.num_samples_per_rank = num_samples
        if world_size > 1:
            self.num_samples_per_rank = int(np.ceil(num_samples / world_size))
            if rank == world_size - 1:
                # the last rank takes the remainder, clamped at 0
                self.num_samples = max(
                    0, num_samples - self.num_samples_per_rank * (world_size - 1))
            else:
                self.num_samples = self.num_samples_per_rank
        else:
            self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        c = self._rng.choice(self.categories)
        meta = self.metadata[c]
        return {"label": meta["idx"], "category": c,
                "category_name": meta["name"].split(",")[0]}


class DummyLabelDataset:
    """Random integer labels only."""

    def __init__(self, length: int, num_labels: int = 13, rank: int = 0,
                 world_size: int = 1, seed: Optional[int] = None):
        if world_size == 1:
            self.length = length
        else:
            per = int(np.ceil(length / world_size))
            self.length = max(0, length - (world_size - 1) * per) \
                if rank == world_size - 1 else per
        self.num_labels = num_labels
        self._rng = random.Random(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        return {"label": self._rng.randrange(self.num_labels)}
