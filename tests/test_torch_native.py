"""The host's native marching tetrahedra in the port
(`slide_tpu_torch/native/marching.cpp`, built with g++ at first use by
`_build.load_host_library`; `sap/marching.py`) against the numpy oracle
`marching_tetrahedra_numpy` and the JAX package's native route, as
`tests/test_native_marching.py` holds the JAX package's: the same content
(vertices, normals and faces as coordinate sets) bit for bit, in another
order (JAX's native route on fields with no vertex at a .5 coordinate: it
rounds a normal's voxel half away from zero, ROADMAP Queue C); the empty
surface; `mc_from_psr` threaded against serial; the size rule that sends a
grid to numpy; a first build that many threads ask for at once; a failed
build that raises."""

import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mesh_compare import same_content
from slide_tpu.sap import marching as j_marching
from slide_tpu_torch import _build
from slide_tpu_torch.sap import marching


def _blob(r=32):
    x = np.linspace(-1, 1, r)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    return (0.5 - np.sqrt(X**2 + Y**2 + Z**2)
            + 0.2 * np.sin(4 * X) * np.cos(3 * Y)).astype(np.float32)


def test_native_matches_numpy_and_the_jax_native_route():
    vol = _blob(32)
    native = marching.marching_tetrahedra(vol)
    assert marching.native_library() is _build.load_host_library("marching")
    assert _build.host_library_path("marching").exists()
    assert same_content(native, marching.marching_tetrahedra_numpy(vol))
    assert same_content(native, j_marching.marching_tetrahedra(vol))
    # the winding follows the field's gradient
    v, f, n = native
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.sum(fn * n[f].sum(axis=1), axis=1) >= 0).all()


def test_native_matches_numpy_on_noise_and_at_half_voxels():
    vol = np.random.RandomState(3).randn(12, 14, 10).astype(np.float32)
    native = marching.marching_tetrahedra(vol, level=0.1)
    assert not (native[0] % 1 == 0.5).any()
    assert same_content(native, marching.marching_tetrahedra_numpy(vol, level=0.1))
    assert same_content(native, j_marching.marching_tetrahedra(vol, level=0.1))
    # a field of +-1: every vertex sits half way along its edge, at a .5
    # coordinate, and its normal's voxel is the rounded vertex: half to
    # even, as numpy rounds
    signs = np.where(np.random.RandomState(4).rand(10, 10, 10) < 0.5, -1.0, 1.0)
    signs = signs.astype(np.float32)
    oracle = marching.marching_tetrahedra_numpy(signs)
    assert (oracle[0] % 1 == 0.5).any(axis=1).all()
    assert same_content(marching.marching_tetrahedra(signs), oracle)


def test_empty_surface_raises():
    for fill in (-1.0, 1.0):                   # all outside, all inside
        with pytest.raises(ValueError, match="empty"):
            marching.marching_tetrahedra(np.full((8, 8, 8), fill, np.float32))
    with pytest.raises(ValueError, match="empty"):
        marching.mc_from_psr(np.full((1, 8, 8, 8), -1.0, np.float32))


def test_mc_from_psr_threaded_equals_serial_and_the_size_rule(monkeypatch):
    grid = np.stack([_blob(20), np.full((20, 20, 20), -1.0, np.float32), _blob(20)[::-1]])
    serial = marching.mc_from_psr(grid)
    threaded = marching.mc_from_psr(grid, num_threads=3)
    for a, b in zip(serial, threaded):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert len(serial[0][1]) == 0 and len(serial[0][0]) > 0   # empty -> empty arrays
    assert (serial[0][0] >= 0).all() and (serial[0][0] < 1).all()
    # numpy by the caller's choice, or above the dedup table's limit: the
    # oracle's own order
    want = marching.marching_tetrahedra_numpy(grid[0])
    monkeypatch.setattr(marching, "NATIVE_TABLE_LIMIT", 28 * 20 ** 3 - 1)
    for got in (marching.marching_tetrahedra(grid[0]),
                marching.marching_tetrahedra(grid[0], native=False)):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def cold_build(monkeypatch, tmp_path):
    """No host library built or loaded yet: an empty build directory and
    both caches cleared (and cleared again after the test)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_host_library.cache_clear()
    marching.native_library.cache_clear()
    yield tmp_path / "build"
    monkeypatch.undo()
    _build.load_host_library.cache_clear()
    marching.native_library.cache_clear()


def test_cold_build_under_threads(cold_build):
    grid = np.stack([_blob(16), _blob(16)[::-1], _blob(16)[:, ::-1], _blob(16).T])
    serial = [marching.marching_tetrahedra_numpy(g) for g in grid]
    # threads that all ask for the library at once wait for one build
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(marching.marching_tetrahedra, grid))
    assert all(same_content(a, b) for a, b in zip(got, serial))
    assert [p.name for p in cold_build.iterdir()] == [_build.host_library_path("marching").name]
    # mc_from_psr on a pool, cold: equal to the serial run
    _build.load_host_library.cache_clear()
    marching.native_library.cache_clear()
    for p in cold_build.iterdir():
        p.unlink()
    threaded = marching.mc_from_psr(grid, num_threads=4)
    for a, b in zip(threaded, marching.mc_from_psr(grid)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path, cold_build):
    src = tmp_path / "native"
    src.mkdir()
    shutil.copy(_build.NATIVE / "marching.cpp", src / "marching.cpp")
    with open(src / "marching.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(_build, "NATIVE", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\\n)*error"):
        marching.marching_tetrahedra(_blob(8))
    assert not list(cold_build.glob("*"))
