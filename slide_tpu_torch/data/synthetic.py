"""Synthetic ShapeNet-PSR fixture (counterpart: `slide_tpu/data/synthetic.py`):
writes a small dataset tree in the real on-disk layout, so training runs
without the real data.  No PyYAML: `metadata.yaml` is written by hand in the
form PyYAML's `safe_dump` gives (the same bytes), and the same seed gives
the same clouds as the JAX package's writer (the `psr_from_points` grids
agree to DPSR's rounding: `torch.fft` against XLA's FFT)."""

from __future__ import annotations

import os
import re

import numpy as np
import torch

# the 13 ShapeNet-PSR synsets (metadata.yaml), so label indices match
ALL_SYNSETS = {
    "02691156": "airplane,aeroplane,plane",
    "02828884": "bench",
    "02933112": "cabinet",
    "02958343": "car,auto,automobile,machine,motorcar",
    "03001627": "chair",
    "03211117": "display,video display",
    "03636649": "lamp",
    "03691459": "loudspeaker,speaker,speaker unit,loudspeaker system,speaker system",
    "04090263": "rifle",
    "04256520": "sofa,couch,lounge",
    "04379243": "table",
    "04401088": "telephone,phone,telephone set",
    "04530566": "vessel,watercraft",
}

# per-category ellipsoid semi-axis ranges ((lo, hi) per axis) for the five
# reference-trained categories; others use the generic range
CATEGORY_AXIS_RANGES = {
    "02691156": ((0.40, 0.48), (0.28, 0.38), (0.08, 0.14)),   # airplane
    "02933112": ((0.32, 0.42), (0.32, 0.42), (0.36, 0.46)),   # cabinet
    "02958343": ((0.40, 0.48), (0.18, 0.26), (0.10, 0.16)),   # car
    "03001627": ((0.20, 0.28), (0.20, 0.28), (0.40, 0.48)),   # chair
    "03636649": ((0.07, 0.13), (0.07, 0.13), (0.42, 0.50)),   # lamp
}
_GENERIC_AXIS_RANGE = ((0.25, 0.45),) * 3

# strings YAML 1.1 would read as something else (integers, octal, floats,
# booleans, null) are quoted, as PyYAML's emitter quotes them
_NEEDS_QUOTES = re.compile(
    r"^(?:[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+|"
    r"[-+]?(?:[0-9][0-9_]*)?\.[0-9_]*(?:[eE][-+][0-9]+)?|"
    r"y|Y|yes|Yes|YES|n|N|no|No|NO|true|True|TRUE|false|False|FALSE|"
    r"on|On|ON|off|Off|OFF|~|null|Null|NULL|)$")


def _scalar(s: str) -> str:
    return f"'{s}'" if _NEEDS_QUOTES.match(s) else s


def dump_metadata(metadata: dict) -> str:
    """A two-level mapping {synset: {id, name}} as `yaml.safe_dump` writes it
    (keys sorted, block style)."""
    lines = []
    for key in sorted(metadata):
        lines.append(f"{_scalar(key)}:")
        for field in sorted(metadata[key]):
            lines.append(f"  {field}: {_scalar(str(metadata[key][field]))}")
    return "\n".join(lines) + "\n"


def parse_metadata(text: str) -> dict:
    """Read the two-level mapping `dump_metadata` (or PyYAML) writes."""
    def unquote(s):
        s = s.strip()
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            return s[1:-1]
        return s

    out: dict = {}
    current = None
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, _, value = line.strip().partition(":")
        if not line.startswith(" "):
            current = out.setdefault(unquote(key), {})
        elif current is None:
            raise ValueError(f"metadata: field outside a category: {line!r}")
        else:
            current[unquote(key)] = unquote(value)
    return out


def write_synthetic_shapenet_psr(root: str, categories=("02691156",),
                                 models_per_split: int = 4,
                                 num_points: int = 3000, psr_res: int = 16,
                                 seed: int = 0, with_psr: bool = True,
                                 shape_variety: bool = False,
                                 psr_from_points: bool = False, device=None) -> str:
    """Write metadata.yaml, the .lst splits and random pointcloud.npz /
    psr.npz files; returns `root`.  shape_variety: a random ellipsoid per
    model (per-category axis ranges) in place of the radius-0.4 sphere.
    psr_from_points: each psr.npz is DPSR (`psr_res`^3, sigma 2) of the
    model's own points and normals, mapped into DPSR's cube as the SAP
    training path maps them (raw / 1.2 + 0.5), the indicator grid the SAP
    upsampler trains against, in place of uniform noise; it draws nothing
    from the seed's generator.  The grids are solved on `device` (the card
    unless the caller asks for the CPU)."""
    dpsr = None
    if with_psr and psr_from_points:
        from slide_tpu_torch.pipeline import resolve_device
        from slide_tpu_torch.sap import DPSR
        dev = resolve_device(device)
        dpsr = DPSR((psr_res,) * 3, sig=2).to(dev)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    metadata = {c: {"id": c, "name": ALL_SYNSETS.get(c, c)} for c in ALL_SYNSETS}
    with open(os.path.join(root, "metadata.yaml"), "w") as f:
        f.write(dump_metadata(metadata))
    for c in categories:
        cdir = os.path.join(root, c)
        os.makedirs(cdir, exist_ok=True)
        for split in ("train", "val", "test"):
            names = [f"{split}_model_{i}" for i in range(models_per_split)]
            with open(os.path.join(cdir, split + ".lst"), "w") as f:
                f.write("\n".join(names) + "\n")
            for name in names:
                mdir = os.path.join(cdir, name)
                os.makedirs(mdir, exist_ok=True)
                d = rng.standard_normal((num_points, 3)).astype(np.float32)
                n = d / np.linalg.norm(d, axis=1, keepdims=True)
                if shape_variety:
                    lohi = CATEGORY_AXIS_RANGES.get(c, _GENERIC_AXIS_RANGE)
                    axes = np.array([rng.uniform(lo, hi) for lo, hi in lohi], np.float32)
                else:
                    axes = np.full(3, 0.4, np.float32)
                pts = axes * n + 0.02 * rng.standard_normal((num_points, 3)).astype(np.float32)
                nrm = n / axes if shape_variety else n
                nrm = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                np.savez(os.path.join(mdir, "pointcloud.npz"),
                         points=pts.astype(np.float32), normals=nrm.astype(np.float32))
                if dpsr is not None:
                    g = np.clip(pts / 1.2 + 0.5, 0.0, 0.99)
                    with torch.no_grad():
                        psr = dpsr(torch.as_tensor(g[None], device=dev),
                                   torch.as_tensor(nrm[None], device=dev))[0].cpu().numpy()
                    np.savez(os.path.join(mdir, "psr.npz"), psr=psr)
                elif with_psr:
                    psr = rng.uniform(-1, 1, (psr_res,) * 3)
                    np.savez(os.path.join(mdir, "psr.npz"), psr=psr.astype(np.float32))
    return root
