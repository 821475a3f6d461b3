"""The port's point-cloud ops against the JAX package's on the CPU: neighbour
search, grouping and pooling (fp32, atol 1e-5 where values are compared:
both sides run the same fp32 formulas, with sums taken in another order),
and FPS, whose indices must equal `_fps_scan`'s and the interpreted Pallas
kernel's exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.ops import grouping as jgroup
from slide_tpu.ops import neighbors as jnbr
from slide_tpu.ops.fps import _fps_scan
from slide_tpu.ops.pallas.fps import fps_pallas
from slide_tpu_torch import ops
from slide_tpu_torch.ops import fps as tfps

ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cloud(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grid_cloud(seed, b, n):
    # integer coordinates: inner products are exact, so equal distances are
    # exactly equal on both sides and the tie rule decides the order
    rng = np.random.default_rng(seed)
    return rng.integers(-2, 3, (b, n, 3)).astype(np.float32)


# ---------------------------------------------------------------- neighbours

def test_pairwise_sqdist_matches_and_is_clamped():
    x, y = _cloud(0, 2, 33, 3), _cloud(1, 2, 47, 3)
    np.testing.assert_allclose(_np(ops.pairwise_sqdist(_t(x), _t(y))),
                               _np(jnbr.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y))),
                               atol=ATOL)
    self_d = _np(ops.pairwise_sqdist(_t(x), _t(x)))
    assert (self_d >= 0).all()


@pytest.mark.parametrize("k", [1, 4, 16])
def test_knn_points_random(k):
    q, p = _cloud(2, 3, 20, 3), _cloud(3, 3, 64, 3)
    td, ti = ops.knn_points(_t(q), _t(p), k)
    jd, ji = jnbr.knn_points(jnp.asarray(q), jnp.asarray(p), k)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL)


@pytest.mark.parametrize("k", [3, 8, 27])
def test_knn_points_ties_go_to_lowest_index(k):
    pts = _grid_cloud(4, 2, 40)
    td, ti = ops.knn_points(_t(pts), _t(pts), k)
    jd, ji = jnbr.knn_points(jnp.asarray(pts), jnp.asarray(pts), k)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(td), _np(jd))


def test_knn_points_rejects_k_above_n():
    with pytest.raises(ValueError):
        ops.knn_points(_t(_cloud(0, 1, 4, 3)), _t(_cloud(1, 1, 4, 3)), 5)


@pytest.mark.parametrize("radius,k", [(0.5, 8), (1.0, 16), (0.05, 4)])
def test_ball_query(radius, k):
    q, p = _cloud(5, 2, 30, 3), _cloud(6, 2, 80, 3)
    ti, tc = ops.ball_query(_t(q), _t(p), radius, k)
    ji, jc = jnbr.ball_query(jnp.asarray(q), jnp.asarray(p), radius, k)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tc), _np(jc))


def test_three_nn():
    u, kn = _cloud(7, 2, 50, 3), _cloud(8, 2, 12, 3)
    td, ti = ops.three_nn(_t(u), _t(kn))
    jd, ji = jnbr.three_nn(jnp.asarray(u), jnp.asarray(kn))
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_allclose(_np(td), _np(jd), atol=ATOL)


# ---------------------------------------------------------------- grouping

def test_gather_and_group_points():
    pts = _cloud(9, 2, 30, 5)
    idx = np.random.default_rng(9).integers(0, 30, (2, 7, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(ops.gather_points(_t(pts), _t(idx[:, :, 0]))),
        _np(jgroup.gather_points(jnp.asarray(pts), jnp.asarray(idx[:, :, 0]))))
    np.testing.assert_array_equal(
        _np(ops.group_points(_t(pts), _t(idx))),
        _np(jgroup.group_points(jnp.asarray(pts), jnp.asarray(idx))))


def test_count_to_mask():
    count = np.array([[0, 3, 5], [1, 2, 4]], np.int32)
    np.testing.assert_array_equal(_np(ops.count_to_mask(_t(count), 5)),
                                  _np(jgroup.count_to_mask(jnp.asarray(count), 5)))


@pytest.mark.parametrize("pooling", ["max", "avg", "avg_max"])
@pytest.mark.parametrize("counted", [True, False])
def test_pool_features(pooling, counted):
    feat = _cloud(10, 2, 6, 5, 8)
    count = np.random.default_rng(10).integers(0, 6, (2, 6)).astype(np.int32)
    tc = _t(count) if counted else "all"
    jc = jnp.asarray(count) if counted else "all"
    np.testing.assert_allclose(_np(ops.pool_features(_t(feat), tc, pooling)),
                               _np(jgroup.pool_features(jnp.asarray(feat), jc, pooling)),
                               atol=ATOL)


def test_three_interpolate_with_weights():
    feats = _cloud(11, 2, 12, 6)
    dist = np.abs(_cloud(12, 2, 20, 3))
    idx = np.random.default_rng(11).integers(0, 12, (2, 20, 3)).astype(np.int32)
    tw = ops.interp_weights_from_dists(_t(dist))
    jw = jgroup.interp_weights_from_dists(jnp.asarray(dist))
    np.testing.assert_allclose(_np(tw), _np(jw), atol=ATOL)
    np.testing.assert_allclose(
        _np(ops.three_interpolate(_t(feats), _t(idx), tw)),
        _np(jgroup.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), jw)),
        atol=ATOL)


# ---------------------------------------------------------------- FPS

def _fps_all(pts, k, starts=0, num_forced=0, pallas=True):
    got = _np(ops.furthest_point_sample(_t(pts), k, start_idx=_t(starts)
                                        if isinstance(starts, np.ndarray) else starts,
                                        num_forced=num_forced))
    js = jnp.asarray(starts)
    np.testing.assert_array_equal(got, _np(_fps_scan(jnp.asarray(pts), k, js, num_forced)))
    if pallas:
        np.testing.assert_array_equal(
            got, _np(fps_pallas(jnp.asarray(pts), k, start_idx=js,
                                num_forced=num_forced, interpret=True)))
    return got


@pytest.mark.parametrize("b,n,k", [(3, 100, 16), (8, 256, 64), (16, 128, 128)])
def test_fps_matches_scan_and_pallas(b, n, k):
    _fps_all(_cloud(0, b, n, 3), k)


def test_fps_per_row_start_and_forced():
    pts = _cloud(1, 4, 80, 3)
    _fps_all(pts, 12, starts=np.array([5, 0, 7, 79], np.int32))
    got = _fps_all(pts, 12, num_forced=4)
    np.testing.assert_array_equal(got[:, :4], np.tile(np.arange(4), (4, 1)))


@pytest.mark.parametrize("b,n,k", [(3, 2049, 16), (2, 129, 64), (5, 200, 33),
                                   (1, 127, 13), (6, 333, 1)])
def test_fps_odd_shapes_with_random_starts(b, n, k):
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    _fps_all(pts, k, starts=rng.integers(0, n, b).astype(np.int32))


@pytest.mark.parametrize("b", [25, 9, 1])
def test_fps_batches_off_the_tpu_tile(b):
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((b, 96, 3)).astype(np.float32)
    _fps_all(pts, 24, starts=rng.integers(0, 96, b).astype(np.int32))


def test_fps_ties_on_a_grid():
    # repeated points: every round has ties, which go to the lowest index
    _fps_all(_grid_cloud(3, 4, 60), 20, starts=np.array([0, 5, 59, 17], np.int32))


def test_fps_distance_uses_all_channels():
    # the scan's definition; the Pallas kernel reads only xyz, so it is left out
    pts = _cloud(2, 2, 64, 6)
    _fps_all(pts, 8, pallas=False)


def test_fps_decode_shape_with_forced_points():
    rng = np.random.default_rng(6)
    pts = rng.standard_normal((2, 512, 3)).astype(np.float32)
    _fps_all(pts, 256, num_forced=3, pallas=False)


def test_fps_validates_inputs():
    pts = _t(_cloud(0, 2, 10, 3))
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts, 11)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts[0], 4)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts, 4, start_idx=10)
    with pytest.raises(ValueError):
        ops.furthest_point_sample(pts, 4, start_idx=torch.tensor([0, -1]))


def test_fps_cuda_wrapper_refuses_cpu_tensors():
    # a CPU tensor reaches the kernel wrapper only by mistake: it raises
    pts = _t(_cloud(0, 2, 10, 3))
    with pytest.raises(ValueError):
        tfps.fps_cuda(pts, 4, torch.zeros(2, dtype=torch.int32))


def test_fps_cpu_path_counts_no_kernel_launch():
    from slide_tpu_torch import _build
    before = _build.launch_counts["fps"]
    ops.furthest_point_sample(_t(_cloud(0, 2, 32, 3)), 8)
    assert _build.launch_counts["fps"] == before
