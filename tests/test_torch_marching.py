"""The port's mesh extraction and sampling (`slide_tpu_torch/sap/marching_gpu.py`
on CPU tensors, and the numpy modules `marching.py`, `mesh_sampling.py`)
against the JAX package's: the oracle `slide_tpu/sap/marching.py::
marching_tetrahedra_numpy`, `count_cells_and_faces` and the device sampler of
`slide_tpu/sap/marching_tpu.py`.

Tolerances (`mesh_compare.assert_same_mesh`): the same faces with the same
winding (corner positions rounded to 1e-4 grid units), vertices within 1e-4 grid
units (measured: equal) and normals within 1e-5 (measured 1.2e-7: the
norm's sum runs in another order); counts and the numpy copies exactly.  The sampler's uniforms cannot be injected, so its
statistics are compared, as `tests/test_marching_tpu.py` compares the JAX
device sampler with the host one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.sap import marching as j_marching
from slide_tpu.sap import mesh_sampling as j_mesh_sampling
from slide_tpu.sap.marching_tpu import count_cells_and_faces as j_count_cells_and_faces
from slide_tpu.sap.marching_tpu import marching_tetrahedra_device as j_marching_device
from slide_tpu.sap.marching_tpu import sample_points_from_mesh_device as j_sample_device
from slide_tpu_torch.sap import marching, marching_gpu, mesh_sampling
from mesh_compare import assert_same_mesh, mesh_difference


def _noisy_sphere(r=20, noise=0.04, seed=0):
    rng = np.random.default_rng(seed)
    x, y, z = np.mgrid[:r, :r, :r] / (r - 1.0) - 0.5
    return (0.35 - np.sqrt(x * x + y * y + z * z)
            + noise * rng.standard_normal((r, r, r))).astype(np.float32)


@pytest.mark.parametrize("level", [0.0, 0.05])
def test_device_extraction_matches_the_numpy_oracle(level):
    vols = np.stack([_noisy_sphere(seed=1), _noisy_sphere(seed=2),
                     _noisy_sphere(noise=0.0)])
    mesh = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vols), level)
    for i in range(3):
        want = j_marching.marching_tetrahedra_numpy(vols[i], level)
        assert int(mesh["n_faces"][i]) == len(want[1])
        assert_same_mesh(marching_gpu.mesh_to_host(mesh, i), want)
    # one grid alone is a batch of one
    single = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vols[1]), level)
    assert_same_mesh(marching_gpu.mesh_to_host(single, 0),
                     j_marching.marching_tetrahedra_numpy(vols[1], level))


def test_uneven_grid_matches_the_oracle():
    vol = _noisy_sphere(r=24, seed=4)[:20, :24, :17]
    mesh = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vol), 0.02)
    assert_same_mesh(marching_gpu.mesh_to_host(mesh, 0),
                     j_marching.marching_tetrahedra_numpy(vol, 0.02))


@pytest.mark.parametrize("change, same", [
    ("vertices renumbered", True), ("faces rotated", True), ("one face reversed", False),
    ("one corner moved to another vertex", False)])
def test_the_mesh_gate_sees_winding(change, same):
    # the gate compares faces with their winding, whatever the vertex order
    verts, faces, normals = j_marching.marching_tetrahedra_numpy(_noisy_sphere(seed=5))
    v, f, n = verts.copy(), faces.copy(), normals.copy()
    if change == "vertices renumbered":
        perm = np.random.default_rng(0).permutation(len(v))
        v, n, f = v[perm], n[perm], np.argsort(perm)[f]
    elif change == "faces rotated":
        f = np.roll(f, 1, axis=1)
    elif change == "one face reversed":
        f[7] = f[7, ::-1]
    else:
        f[7, 0] = next(i for i in range(len(v)) if i not in f[7])
    diff = mesh_difference((v, f, n), (verts, faces, normals))
    assert diff["same_sizes"] and diff["same_faces"] == same, diff
    if same:
        assert_same_mesh((v, f, n), (verts, faces, normals))


def test_empty_grid_raises_and_samples_nan():
    vols = torch.as_tensor(np.stack([np.full((8, 8, 8), 2.0, np.float32),
                                     _noisy_sphere(r=8, noise=0.0, seed=0)]))
    mesh = marching_gpu.marching_tetrahedra_device(vols, 0.0)
    assert int(mesh["n_faces"][0]) == 0 and int(mesh["n_cells"][0]) == 0
    assert int(mesh["n_faces"][1]) > 0
    with pytest.raises(ValueError, match="empty"):
        marching_gpu.mesh_to_host(mesh, 0)
    with pytest.raises(ValueError, match="empty"):
        marching.marching_tetrahedra_numpy(vols[0].numpy())
    with pytest.raises(ValueError, match="empty"):
        j_marching.marching_tetrahedra_numpy(vols[0].numpy())
    pts, nrm = marching_gpu.sample_points_from_mesh_device(
        mesh, torch.Generator().manual_seed(0), 16)
    assert torch.isnan(pts[0]).all() and torch.isnan(nrm[0]).all()
    assert torch.isfinite(pts[1]).all() and torch.isfinite(nrm[1]).all()


def test_count_cells_and_faces_matches_jax():
    vols = np.stack([_noisy_sphere(seed=6), _noisy_sphere(seed=7, noise=0.0),
                     np.full((20, 20, 20), -1.0, np.float32)])
    for level in (0.0, 0.05):
        got = marching_gpu.count_cells_and_faces(torch.as_tensor(vols), level)
        want = j_count_cells_and_faces(jnp.asarray(vols), level)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        mesh = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vols), level)
        assert torch.equal(mesh["n_cells"], got[0]) and torch.equal(mesh["n_faces"], got[1])


def test_host_marching_is_the_jax_one():
    vols = np.stack([_noisy_sphere(seed=8), _noisy_sphere(seed=9)])
    for a, b in zip(marching.marching_tetrahedra_numpy(vols[0], 0.03),
                    j_marching.marching_tetrahedra_numpy(vols[0], 0.03)):
        np.testing.assert_array_equal(a, b)
    # mc_from_psr: the numpy route, vertices scaled by 1/s or 1/(s - 1)
    # (the JAX package's runs its native route, whose vertex order differs)
    for real_scale, div in ((False, 20.0), (True, 19.0)):
        verts, faces, normals = marching.mc_from_psr(vols, real_scale=real_scale)
        for i in range(2):
            v, f, n = j_marching.marching_tetrahedra_numpy(vols[i])
            np.testing.assert_array_equal(verts[i], (v / div).astype(np.float32))
            np.testing.assert_array_equal(faces[i], f)
            np.testing.assert_array_equal(normals[i], n)


def test_host_mesh_sampling_is_the_jax_one():
    v, f, _ = marching.marching_tetrahedra_numpy(_noisy_sphere(seed=10))
    for fn in ("sample_points_from_mesh", "uniform_sample_points_from_mesh"):
        got = getattr(mesh_sampling, fn)(v, f, 256, rng=np.random.default_rng(3))
        want = getattr(j_mesh_sampling, fn)(v, f, 256, rng=np.random.default_rng(3))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mesh_sampling.fps_numpy(v, 64, start=5),
                                  j_mesh_sampling.fps_numpy(v, 64, start=5))


def test_sampler_statistics_match_the_jax_device_sampler():
    vol = _noisy_sphere(noise=0.0)
    mesh = marching_gpu.marching_tetrahedra_device(torch.as_tensor(vol), 0.0)
    pts, nrm = marching_gpu.sample_points_from_mesh_device(
        mesh, torch.Generator().manual_seed(0), 4096)
    assert pts.shape == (1, 4096, 3) and nrm.shape == (1, 4096, 3)
    pts, nrm = pts[0].numpy(), nrm[0].numpy()
    j_mesh = j_marching_device(jnp.asarray(vol), 0.0, f_max=32768, c_max=16384)
    j_pts, j_nrm = (np.asarray(a) for a in j_sample_device(j_mesh, jax.random.key(0), 4096))
    c = (vol.shape[0] - 1) / 2.0
    rad, j_rad = np.linalg.norm(pts - c, axis=1), np.linalg.norm(j_pts - c, axis=1)
    np.testing.assert_allclose(rad.mean(), j_rad.mean(), rtol=0.01)
    np.testing.assert_allclose(rad.std(), j_rad.std(), rtol=0.2, atol=0.01)
    np.testing.assert_allclose(pts.mean(0), j_pts.mean(0), atol=0.15)
    np.testing.assert_allclose(np.abs(nrm).mean(0), np.abs(j_nrm).mean(0), atol=0.03)
    assert np.all(np.abs(np.linalg.norm(nrm, axis=1) - 1) < 1e-4)
    # the normals point outward, as -grad(vol) does
    assert ((nrm * (pts - c)).sum(1) > 0).mean() > 0.95


def test_extract_and_sample_scales_counts_and_keeps_the_mesh():
    vols = np.stack([_noisy_sphere(r=16, seed=11), _noisy_sphere(r=16, seed=12)])
    gen = torch.Generator().manual_seed(1)
    pts, nrm, n_faces, n_cells, mesh = marching_gpu.extract_and_sample_device(
        torch.as_tensor(vols), gen, 512)
    assert pts.shape == (2, 512, 3) and nrm.shape == (2, 512, 3)
    cells, faces = j_count_cells_and_faces(jnp.asarray(vols))
    np.testing.assert_array_equal(n_faces.numpy(), np.asarray(faces))
    np.testing.assert_array_equal(n_cells.numpy(), np.asarray(cells))
    assert float(pts.min()) >= 0.0 and float(pts.max()) < 1.0
    for i in range(2):
        assert_same_mesh(marching_gpu.mesh_to_host(mesh, i),
                         j_marching.marching_tetrahedra_numpy(vols[i]), scale=16.0)
    # the same generator state gives the same samples
    again = marching_gpu.extract_and_sample_device(torch.as_tensor(vols),
                                                   torch.Generator().manual_seed(1), 512)
    assert torch.equal(again[0], pts)
