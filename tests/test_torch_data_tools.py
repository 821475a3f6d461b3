"""The port's dataset tools (`slide_tpu_torch/data/tools.py`) and
object-store IO (`data/object_io.py`) against the JAX package's on the same
tree, files and fake client (no network): the exported reference npz,
the per-split counts, the bounding box, the label remap, the loader's
throughput probe; npz, text, JSON-form YAML and pickle through a local path
and through a registered `s3://` client, each read back by the other
package."""

import os

import numpy as np
import pytest

from slide_tpu.data import object_io as j_io
from slide_tpu.data import tools as j_tools
from slide_tpu_torch import data as tdata
from slide_tpu_torch.data import object_io as t_io
from slide_tpu_torch.data import tools as t_tools


def test_tools_match_jax(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"),
                                              categories=("02691156", "03001627"),
                                              models_per_split=3, num_points=300)
    cats = ["02691156", "03001627"]
    for split, samples in (("val", None), ("train", 4)):
        kw = dict(split=split, categories=cats, npoints=64, scale=0.5, num_samples=samples)
        t_out = t_tools.save_reference_data(root, str(tmp_path / f"t_{split}.npz"), **kw)
        j_out = j_tools.save_reference_data(root, str(tmp_path / f"j_{split}.npz"), **kw)
        with np.load(t_out) as t, np.load(j_out) as j:
            assert sorted(t.files) == sorted(j.files)
            for name in j.files:
                np.testing.assert_array_equal(t[name], j[name])
    assert t_tools.count_samples(root, cats) == j_tools.count_samples(root, cats)
    assert t_tools.count_samples(root, cats)["03001627"] == {"train": 3, "val": 3, "test": 3,
                                                             "total": 9}
    pts = np.random.default_rng(0).standard_normal((3, 50, 3)).astype(np.float32)
    for arr in (pts, pts[0]):
        t_box, j_box = t_tools.get_bounding_box(arr), j_tools.get_bounding_box(arr)
        assert sorted(t_box) == sorted(j_box)
        for k in j_box:
            np.testing.assert_array_equal(t_box[k], j_box[k])
    with pytest.raises(ValueError):
        t_tools.get_bounding_box(pts[0, 0])
    # the label remap: os.listdir order -> sorted order, next to the input
    listed = [c for c in os.listdir(root) if os.path.isdir(os.path.join(root, c))]
    gen = str(tmp_path / "gen.npz")
    np.savez(gen, points=pts, label=np.array([0, 1, 1]))
    out = t_tools.remap_labels_to_sorted(gen, root)
    assert out == str(tmp_path / "gen_corrected.npz")
    with np.load(out) as d:
        np.testing.assert_array_equal(d["label"], [sorted(listed).index(listed[i])
                                                   for i in (0, 1, 1)])
    ds = tdata.ShapesPSRDataset(root, split="train", categories=cats, num_gt_points=64,
                                centered_to_centroid=False, seed=0)
    stats = t_tools.dataset_throughput(ds, batch_size=2, n_batches=2)
    assert stats["samples"] == 4 and stats["samples_per_sec"] > 0


class _FakeClient:
    """An object store in a dict."""

    def __init__(self):
        self.store = {}

    def get(self, path):
        return self.store[path]

    def put(self, path, data):
        self.store[path] = data


def test_object_io_local_and_s3_match_jax(tmp_path):
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.array([1, 2])}
    obj = {"iter": 3, "w": np.ones(4)}
    cfg = {"model": {"t_dim": 64, "layers": [1, 2]}, "lr": 0.0002, "name": "kp"}
    client = _FakeClient()
    t_io.register_s3_client(client)
    j_io.register_s3_client(client)
    try:
        for base in (str(tmp_path / "local"), "s3://bucket/run"):
            t_io.NpzIO().write(f"{base}/x.npz", **arrays)
            for reader in (t_io.NpzIO(), j_io.NpzIO()):
                got = reader.read(f"{base}/x.npz")
                assert sorted(got) == ["a", "b"]
                for k in arrays:
                    np.testing.assert_array_equal(got[k], arrays[k])
            t_io.PickleIO().write(f"{base}/o.pkl", obj)
            got = j_io.PickleIO().read(f"{base}/o.pkl")
            assert got["iter"] == 3 and np.array_equal(got["w"], obj["w"])
            t_io.TextIO().write(f"{base}/note.txt", "hello\n")
            assert j_io.TextIO().read(f"{base}/note.txt") == "hello\n"
            # YAML in its JSON form: PyYAML (the JAX package) reads it
            t_io.TextIO().write(f"{base}/cfg.yaml", cfg)
            assert j_io.TextIO().read(f"{base}/cfg.yaml") == cfg
            assert t_io.TextIO().read(f"{base}/cfg.yaml") == cfg
        assert sorted(client.store) == ["s3://bucket/run/cfg.yaml", "s3://bucket/run/note.txt",
                                        "s3://bucket/run/o.pkl", "s3://bucket/run/x.npz"]
        # block-style YAML needs PyYAML, which the port does not use
        j_io.TextIO().write("s3://bucket/run/block.yaml", cfg)
        with pytest.raises(ValueError, match="JSON form"):
            t_io.TextIO().read("s3://bucket/run/block.yaml")
    finally:
        t_io.register_s3_client(None)
        j_io.register_s3_client(None)
    with pytest.raises(RuntimeError, match="register_s3_client"):
        t_io.NpzIO().read("s3://bucket/run/x.npz")
