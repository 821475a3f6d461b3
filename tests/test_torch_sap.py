"""The port's Shape-As-Points modules (`slide_tpu_torch/sap/`: DPSR, mirror,
refine, and the SAP net built from `upsampler_config`) against the JAX
package's (`slide_tpu/sap/`, the flax `ConditionalPointNet2`) on the CPU,
same numpy inputs and weights.

Tolerances, each from the largest difference measured here (fp32 on both
sides, sums in other orders):
  - `fftfreqs`, `spec_gaussian_filter`: exact (both numpy);
  - `point_rasterize`: 1e-6 (measured 0: the CPU scatter adds in order);
  - `grid_interp`: 1e-6 on values up to ~3 (measured 3.6e-7);
  - `DPSR` at res 32 and 64: 2e-6 on fields up to ~0.8 (measured 5.4e-7;
    `torch.fft` and XLA's FFT round differently);
  - mirror, normalize, the grid of `network_output_to_dpsr_grid`: 1e-6;
  - the SAP net, held to JAX and, on the same FPS picks, to its own forward
    run in float64, which shows how far fp32 itself carries (`pytest -rP`
    prints the three distances): narrow (perturbed weights drawn by the
    port's init), 1e-3 of JAX on outputs up to ~3.2 and 5e-4 of float64
    (measured 4.5e-4 and 1.5e-4; JAX's own fp32 forward lies 4.6e-4 from the
    float64 one); at full width with the committed checkpoint, 0.2 of JAX on
    displacements up to ~313 and 2e-3 of float64 (measured: JAX's fp32
    forward 0.0954 from the float64 one, the port's 5.0e-4, so what
    separates the two is JAX's fp32 rounding, through the KnnFP weights'
    self-distances: see the last test; 0.2 is twice it).
The FPS picks of the SAP net's SA levels are JAX's, replayed; the port's
own picks on the same clouds must equal them or part from them at a tie
(`torch_port_helpers.fps_ties`): the mirrored cloud holds pairs of points at
equal distances."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import upsampler_config as j_upsampler_config
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.ops import furthest_point_sample as j_furthest_point_sample
from slide_tpu.sap import dpsr as j_dpsr
from slide_tpu.sap import refine as j_refine
from slide_tpu.sap.mirror import mirror as j_mirror
from slide_tpu.sap.mirror import mirror_and_concat as j_mirror_and_concat
from slide_tpu_torch.configs import upsampler_config
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.ops import furthest_point_sample
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.sap import dpsr, refine
from slide_tpu_torch.sap.mirror import mirror, mirror_and_concat
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.weights import load_flax_params, load_inference_params, module_to_flax
from torch_port_helpers import (fps_ties, narrow_sap_config, perturb, record_jax_fps,
                                replay_fps_in_port, to_np)

RASTER_ATOL = 1e-6
INTERP_ATOL = 1e-6
DPSR_ATOL = 2e-6
GLUE_ATOL = 1e-6
NARROW_NET_ATOL, NARROW_NET_F64_ATOL = 1e-3, 5e-4
FULL_NET_ATOL, FULL_NET_F64_ATOL = 0.2, 2e-3


def _sphere_cloud(b, n, seed):
    """Points near a sphere in [0, 0.99] and their unit normals."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3))
    nrm = d / np.linalg.norm(d, axis=-1, keepdims=True)
    v = np.clip(0.5 + 0.3 * nrm * rng.uniform(0.8, 1.0, (b, n, 1)), 0.0, 0.99)
    return v.astype(np.float32), nrm.astype(np.float32)


def _oriented_cloud(b, n, seed):
    """An ellipsoid's surface with its normals, the decode's (B, N, 6)."""
    rng = np.random.default_rng(seed)
    axes = np.array([0.45, 0.15, 0.3])
    p = rng.standard_normal((b, n, 3))
    p = p / np.linalg.norm(p, axis=-1, keepdims=True) * axes
    nrm = p / axes ** 2
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([p, nrm], axis=-1).astype(np.float32)


@pytest.mark.parametrize("res", [(32, 32, 32), (64, 64, 64), (8, 12, 10)])
def test_fftfreqs_and_filter_are_the_jax_ones(res):
    np.testing.assert_array_equal(dpsr.fftfreqs(res), j_dpsr.fftfreqs(res))
    np.testing.assert_array_equal(dpsr.spec_gaussian_filter(res, 2),
                                  j_dpsr.spec_gaussian_filter(res, 2))


@pytest.mark.parametrize("r", [32, 64])
def test_point_rasterize_and_grid_interp_match_jax(r):
    res = (r,) * 3
    v, n = _sphere_cloud(2, 2000, r)
    got = dpsr.point_rasterize(torch.as_tensor(v), torch.as_tensor(n), res)
    want = j_dpsr.point_rasterize(jnp.asarray(v), jnp.asarray(n), res)
    assert got.shape == (2, 3, *res)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=RASTER_ATOL, rtol=0)
    grid = np.random.default_rng(r).standard_normal((2, *res, 2)).astype(np.float32)
    got = dpsr.grid_interp(torch.as_tensor(grid), torch.as_tensor(v))
    want = j_dpsr.grid_interp(jnp.asarray(grid), jnp.asarray(v))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=INTERP_ATOL, rtol=0)


@pytest.mark.parametrize("r", [32, 64])
def test_dpsr_matches_jax(r):
    v, n = _sphere_cloud(2, 2000, 10 + r)
    solver = dpsr.DPSR((r,) * 3, sig=2)
    assert {name for name, _ in solver.named_buffers()} == {"G", "omega"}
    got = solver(torch.as_tensor(v), torch.as_tensor(n))
    want = j_dpsr.DPSR((r,) * 3, sig=2)(jnp.asarray(v), jnp.asarray(n))
    assert got.shape == (2, r, r, r) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=DPSR_ATOL, rtol=0)
    # the scale maps the origin's value to +-0.5
    np.testing.assert_allclose(to_np(got[:, 0, 0, 0].abs()), 0.5, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_mirror_matches_jax(axis):
    x = _oriented_cloud(2, 100, axis)
    np.testing.assert_allclose(to_np(mirror(torch.as_tensor(x), axis)),
                               np.asarray(j_mirror(jnp.asarray(x), axis)),
                               atol=GLUE_ATOL, rtol=0)


def test_mirror_and_concat_replays_the_jax_permutation():
    x = _oriented_cloud(2, 128, 3)
    key = jax.random.key(7)
    want = j_mirror_and_concat(jnp.asarray(x), axis=2, num_points=(64,),
                                      attach_label=True, permute=True, key=key)
    perm = torch.as_tensor(np.array(jax.random.permutation(key, 256)))
    got = mirror_and_concat(torch.as_tensor(x), axis=2, num_points=(64,),
                                   attach_label=True, perm=perm)
    assert got[0].shape == (2, 256, 7) and got[1].shape == (2, 64, 7)
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), atol=GLUE_ATOL, rtol=0)
    # the downsampled variant: FPS from index 0 on xyz, JAX's picks or a tie
    xyz = np.array(want[0][..., :3])
    j_idx = np.asarray(j_furthest_point_sample(jnp.asarray(xyz), 64))
    fps_ties(xyz, 64, np.zeros(2, np.int32), j_idx)
    t_idx = furthest_point_sample(got[0][..., :3], 64).long()
    assert torch.equal(got[1], torch.gather(got[0], 1, t_idx[..., None].expand(-1, -1, 7)))
    # drawn from a generator: one permutation for the whole batch
    gen = torch.Generator().manual_seed(0)
    drawn = mirror_and_concat(torch.as_tensor(x), attach_label=True,
                                     generator=gen)[0]
    unshuffled = mirror_and_concat(torch.as_tensor(x), attach_label=True,
                                          permute=False)[0]
    order = torch.randperm(256, generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, unshuffled[:, order])
    with pytest.raises(ValueError, match="generator"):
        mirror_and_concat(torch.as_tensor(x))


def test_normalize_and_bounding_box_match_jax():
    x = 3.0 * _oriented_cloud(2, 200, 4)[..., :3]
    np.testing.assert_allclose(to_np(refine.shapenet_psr_normalize(torch.as_tensor(x))),
                               np.asarray(j_refine.shapenet_psr_normalize(jnp.asarray(x))),
                               atol=GLUE_ATOL, rtol=0)
    for g, w in zip(refine.compute_center_and_max_length(torch.as_tensor(x)),
                    j_refine.compute_center_and_max_length(jnp.asarray(x))):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=GLUE_ATOL, rtol=0)


@pytest.mark.parametrize("explicit_normalize,only_original", [(True, False), (False, True)])
def test_network_output_to_dpsr_grid_matches_jax(explicit_normalize, only_original):
    rng = np.random.default_rng(5)
    cfg = upsampler_config()["pointnet_config"]
    x = _oriented_cloud(2, 300, 5)
    tag = np.where(rng.uniform(size=(2, 300, 1)) < 0.5, 1.0, -1.0).astype(np.float32)
    x = np.concatenate([x, tag], axis=-1)
    disp = (100.0 * rng.standard_normal((2, 300, 30))).astype(np.float32)
    kw = dict(last_dim_as_indicator=True, only_original_points_split=only_original,
              explicit_normalize=explicit_normalize)
    got = refine.network_output_to_dpsr_grid(torch.as_tensor(x), torch.as_tensor(disp),
                                             dpsr.DPSR((32,) * 3, sig=2), 1, cfg, **kw)
    want = j_refine.network_output_to_dpsr_grid(jnp.asarray(x), jnp.asarray(disp),
                                                j_dpsr.DPSR((32,) * 3, sig=2), 1, cfg, **kw)
    assert got[1].shape == ((2, 750, 3) if only_original else (2, 1500, 3))
    np.testing.assert_allclose(to_np(got[1]), np.asarray(want[1]), atol=GLUE_ATOL, rtol=0)
    np.testing.assert_allclose(to_np(got[2]), np.asarray(want[2]), atol=GLUE_ATOL, rtol=0)
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]), atol=DPSR_ATOL, rtol=0)


def test_upsampler_config_is_the_jax_preset():
    assert upsampler_config() == j_upsampler_config()
    assert upsampler_config(batch_size=8) == j_upsampler_config(batch_size=8)


def _sap_pair(monkeypatch, cfg, params, x, key):
    """The flax SAP net and the port's on the same mirrored cloud, the JAX
    FPS picks replayed in the port (ties allowed, `fps_ties`)."""
    pc = cfg["pointnet_config"]
    xm = j_mirror_and_concat(jnp.asarray(x), axis=2, attach_label=True,
                                    permute=True, key=key)[0]
    label = jnp.zeros((x.shape[0],), jnp.int32)
    calls = record_jax_fps(monkeypatch)
    j_net = JNet(pc)
    want = jax.jit(lambda p, xm: j_net.apply({"params": p}, xm, ts=None, label=label))(
        params, xm)
    jax.effects_barrier()
    assert len(calls) == 4
    net = load_flax_params(ConditionalPointNet2(pc), params).eval()
    perm = torch.as_tensor(np.array(jax.random.permutation(key, xm.shape[1])))
    txm = mirror_and_concat(torch.as_tensor(x), axis=2, attach_label=True,
                                   perm=perm)[0]
    np.testing.assert_allclose(to_np(txm), np.asarray(xm), atol=GLUE_ATOL, rtol=0)
    replay = replay_fps_in_port(monkeypatch, calls, GLUE_ATOL, tie_calls=range(4))
    with torch.no_grad():
        got = net(txm, ts=None, label=torch.zeros(x.shape[0], dtype=torch.int64))
    assert next(replay, None) is None
    return net, txm, np.asarray(want), got, calls


def _float64_forward(monkeypatch, net, txm, calls):
    """The port's net run in float64 on the same input and FPS picks."""
    replay = replay_fps_in_port(monkeypatch, calls, GLUE_ATOL, tie_calls=range(4))
    with torch.no_grad():
        out = copy.deepcopy(net).double()(txm.double(), ts=None,
                                          label=torch.zeros(txm.shape[0], dtype=torch.int64))
    assert next(replay, None) is None
    return out


def _report(got, want, got64, atol, f64_atol):
    """The port against JAX within `atol`, against its float64 forward
    within `f64_atol`; prints the three distances (`pytest -rP` shows them)."""
    got, got64 = to_np(got), to_np(got64)
    print(f"port vs jax {np.abs(got - want).max()}, port vs float64 "
          f"{np.abs(got - got64).max()}, jax vs float64 {np.abs(want - got64).max()}, "
          f"max |out| {np.abs(want).max()}")
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, got64, atol=f64_atol, rtol=0)


def test_narrow_sap_net_matches_flax(monkeypatch):
    cfg = narrow_sap_config()
    x = _oriented_cloud(2, 100, 6)
    key = jax.random.key(1)
    # the weights drawn by the port's init_params (the JAX package's
    # initialisers) and perturbed: the flax tree both packages load
    net = init_params(ConditionalPointNet2(cfg["pointnet_config"]),
                      torch.Generator().manual_seed(0))
    params = perturb(module_to_flax(net), 0, scale=0.05)
    net, txm, want, got, calls = _sap_pair(monkeypatch, cfg, params, x, key)
    assert got.shape == (2, 200, 30)
    _report(got, want, _float64_forward(monkeypatch, net, txm, calls),
            NARROW_NET_ATOL, NARROW_NET_F64_ATOL)


def test_full_width_sap_net_with_the_committed_checkpoint(monkeypatch):
    # batch 1, 2 x 1024 points: SA level 0 runs FPS (2048 -> 1024)
    cfg = upsampler_config()
    params = load_inference_params(str(DEFAULT_CKPTS["sap"]), -1)
    x = _oriented_cloud(1, 1024, 7)
    net, txm, want, got, calls = _sap_pair(monkeypatch, cfg, params, x, jax.random.key(5))
    assert [c[2].shape[1] for c in calls] == [1024, 256, 64, 16]
    assert got.shape == (1, 2048, 30)
    _report(got, want, _float64_forward(monkeypatch, net, txm, calls),
            FULL_NET_ATOL, FULL_NET_F64_ATOL)


def test_sap_net_follows_the_rounding_of_its_self_distances(monkeypatch):
    # Every KnnFP query coincides with one of its neighbours, whose squared
    # distance ||x||^2 - 2<x, y> + ||y||^2 is fp32 rounding noise (~1e-8),
    # and the neighbour weights are 1 / (d + 1e-8): a change of those
    # distances by less than 1e-8 moves the full-width net's outputs (up to
    # ~330) by more than five times FULL_NET_F64_ATOL (measured 0.0276), which
    # is why two fp32 runs (JAX and the port, the card and the CPU) part
    # there unless the distances are replayed
    import slide_tpu_torch.ops.neighbors as neighbors
    net = load_flax_params(ConditionalPointNet2(upsampler_config()["pointnet_config"]),
                           load_inference_params(str(DEFAULT_CKPTS["sap"]), -1)).eval()
    x = torch.as_tensor(_oriented_cloud(1, 2048, 8))
    xm = mirror_and_concat(x, axis=2, attach_label=True,
                           generator=torch.Generator().manual_seed(0))[0]
    label = torch.zeros(1, dtype=torch.int64)
    with torch.no_grad():
        before = net(xm, ts=None, label=label)
    real = neighbors.pairwise_sqdist
    noise = torch.Generator().manual_seed(1)

    def nudged(a, b):
        d = real(a, b)
        near = d < 1e-6
        return torch.where(near, d + 1e-8 * torch.rand(d.shape, generator=noise), d)

    monkeypatch.setattr(neighbors, "pairwise_sqdist", nudged)
    with torch.no_grad():
        after = net(xm, ts=None, label=label)
    moved = float((after - before).abs().max())
    print(f"self-distances nudged below 1e-8 move the outputs by {moved} "
          f"of max {float(before.abs().max())}")
    assert moved > 5 * FULL_NET_F64_ATOL
