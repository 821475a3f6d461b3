"""The training corpus on the device (counterpart:
`slide_tpu/data/device_corpus.py`): a split's raw clouds (and PSR grids)
held on the card, each step's batch assembled there from a (B,) index
array: the row gather, the subsample of `npoints` of P points, the
augmentations and the scaling, vectorised over the batch.  The only
per-step transfer from the host is the index array.

    corpus = DeviceCorpus.from_dataset(loader.dataset).to("cuda")
    assemble = make_assemble_fn(trainset_config)
    batch = assemble(corpus, idx, generator)      # idx (B,) on the card

The semantics are `ShapesPSRDataset.__getitem__`'s: a subsample without
replacement, optional centring on the centroid, the mirror of z about the
centroid with `mirror_prob` (normals too), gaussian noise on points and
normals, one translation per model, a uniform scale in [1/s, s], then the
final 2 * scale.  The draws come from a `torch.Generator` on the corpus's
device, or are handed in (`draws`): a test replays the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


class DeviceCorpus:
    """A split's raw clouds (before subsample, augmentation and scaling),
    each unique (category, model) once: points and normals (M, P, 3), labels
    (M,), PSR grids (M, R, R, R) where the dataset loads them; `rows` (N,)
    maps each of the dataset's N entries (`repeat_dataset` repeats them)
    onto its row.  Indices given to `assemble` are the dataset's."""

    def __init__(self, points, normals, labels, rows, psr=None):
        points, normals = torch.as_tensor(points), torch.as_tensor(normals)
        if points.ndim != 3 or points.shape != normals.shape:
            raise ValueError(f"points {tuple(points.shape)} / normals "
                             f"{tuple(normals.shape)} must both be (M, P, 3)")
        self.points = points
        self.normals = normals
        self.labels = torch.as_tensor(labels)
        self.rows = torch.as_tensor(rows)
        self.psr = None if psr is None else torch.as_tensor(psr)

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def tensors(self) -> dict:
        out = {"points": self.points, "normals": self.normals, "labels": self.labels,
               "rows": self.rows}
        if self.psr is not None:
            out["psr"] = self.psr
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors().values())

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "DeviceCorpus":
        """The corpus on `device` (copied once)."""
        return DeviceCorpus(**{k: v.to(device) for k, v in self.tensors().items()})

    @classmethod
    def from_dataset(cls, dataset) -> "DeviceCorpus":
        """Read every unique model of a `ShapesPSRDataset` once, raw, in
        host memory.  Raises unless every model has the same point count."""
        key_row: dict = {}
        entries, rows = [], []
        for m in dataset.models:
            key = (m["category"], m["model"])
            if key not in key_row:
                key_row[key] = len(entries)
                path = os.path.join(dataset.dataset_folder, *key)
                with np.load(os.path.join(path, "pointcloud.npz")) as d:
                    entry = {"points": d["points"].astype(np.float32),
                             "normals": d["normals"].astype(np.float32),
                             "label": dataset.metadata[m["category"]]["idx"]}
                if dataset.load_psr:
                    with np.load(os.path.join(path, "psr.npz")) as d:
                        entry["psr"] = d["psr"].astype(np.float32)
                entries.append(entry)
            rows.append(key_row[key])
        p = entries[0]["points"].shape[0]
        if any(e["points"].shape[0] != p for e in entries):
            raise ValueError("the device corpus requires a uniform point count per model")
        return cls(np.stack([e["points"] for e in entries]),
                   np.stack([e["normals"] for e in entries]),
                   np.asarray([e["label"] for e in entries], np.int64),
                   np.asarray(rows, np.int64),
                   np.stack([e["psr"] for e in entries]) if dataset.load_psr else None)


def draw_assembly(trainset_config: dict, b: int, n_points: int,
                  generator: torch.Generator) -> dict:
    """One batch's draws from `generator`, on its device: "sel" (B,
    npoints) the subsample (the first npoints of a random permutation),
    and where the config's augmentation asks for them "flip" (B,) bool,
    "noise_points" / "noise_normals" (B, npoints, 3) and "translation" (B, 1,
    3) standard normal, "scale" (B,) uniform in [1/s, s]."""
    npoints = trainset_config["npoints"]
    aug = trainset_config.get("augmentation", False)
    aug = aug if isinstance(aug, dict) else {}
    dev = generator.device
    draws = {"sel": torch.rand((b, n_points), generator=generator, device=dev)
             .argsort(dim=1)[:, :npoints]}
    if aug.get("mirror_prob", 0) > 0:
        draws["flip"] = torch.rand((b,), generator=generator, device=dev) < aug["mirror_prob"]
    if aug.get("noise_magnitude", 0) > 0:
        for key in ("noise_points", "noise_normals"):
            draws[key] = torch.randn((b, npoints, 3), generator=generator, device=dev)
    if aug.get("translation_magnitude", 0) > 0:
        draws["translation"] = torch.randn((b, 1, 3), generator=generator, device=dev)
    sc = aug.get("augm_scale", 0)
    if sc > 1:
        u = torch.rand((b,), generator=generator, device=dev)
        draws["scale"] = 1.0 / sc + u * (sc - 1.0 / sc)
    return draws


def make_assemble_fn(trainset_config: dict):
    """`assemble(corpus, idx, generator, draws=None) -> batch`: the batch
    of the dataset's entries `idx` (B,), on the corpus's device, as the
    loader would give it (points, normals, label [, psr]).  `draws` (the
    keys of `draw_assembly`) replaces the generator's."""
    scale = trainset_config["scale"]
    centered = trainset_config.get("centered_to_centroid", False)
    aug = trainset_config.get("augmentation", False)
    aug = aug if isinstance(aug, dict) else {}

    def assemble(corpus: DeviceCorpus, idx: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None) -> dict:
        dev = corpus.device
        row = corpus.rows[idx.to(dev).long()]
        if draws is None:
            draws = draw_assembly(trainset_config, row.shape[0], corpus.points.shape[1],
                                  generator)
        sel = draws["sel"].to(dev).long()
        points = corpus.points[row[:, None], sel]
        normals = corpus.normals[row[:, None], sel]
        if centered:
            points = points - points.mean(dim=1, keepdim=True)
        if aug.get("mirror_prob", 0) > 0:
            center = points.mean(dim=1, keepdim=True)
            sign = 1.0 - 2.0 * draws["flip"].to(dev).to(points.dtype)
            zsign = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign],
                                dim=-1)[:, None, :]
            # the same rounding as the JAX package's: every axis goes
            # through (p - c) * s + c, the unflipped ones too
            points = (points - center) * zsign + center
            normals = normals * zsign
        nm = aug.get("noise_magnitude", 0)
        if nm > 0:
            points = points + nm * draws["noise_points"].to(dev)
            normals = normals + nm * draws["noise_normals"].to(dev)
        tm = aug.get("translation_magnitude", 0)
        if tm > 0:
            points = points + tm * draws["translation"].to(dev)
        if aug.get("augm_scale", 0) > 1:
            points = points * draws["scale"].to(dev)[:, None, None]
        batch = {"points": points * (scale * 2), "normals": normals,
                 "label": corpus.labels[row]}
        if corpus.psr is not None:
            batch["psr"] = corpus.psr[row]
        return batch

    return assemble
