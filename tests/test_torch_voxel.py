"""The voxel ops of the PVCNN backbone (`slide_tpu_torch/ops/voxel.py`) and
PVConv's parts (`models/pvcnn.py`) against the JAX package's on the CPU:
values and gradients, a coordinate at .5 (both round half to even), and a
3x3x3 kernel whose 27 taps all differ, carried through `weights.py` both
ways, so that a mirrored kernel would show.

Tolerances: the voxel ops are gathers, scatter sums and a few products:
1e-6 absolute (sums of a handful of fp32 terms in another order); the
PVConv parts 2e-5 absolute / 1e-5 relative (two convolutions of 27 x C
terms and GroupNorms, whose sums XLA takes in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slide_tpu.models import pvcnn as jp
from slide_tpu.ops import voxel as jv
from slide_tpu_torch.models import pvcnn as tp
from slide_tpu_torch.ops import voxel as tv
from slide_tpu_torch.weights import kernel_to_torch, load_flax_params, module_to_flax
from torch_port_helpers import assert_close, run_pair, to_np

OPS_ATOL = 1e-6
PV_ATOL = 2e-5


def _coords(rng, b, n, r):
    c = rng.uniform(-0.4, r - 0.6, (b, n, 3)).astype(np.float32)
    c[0, 0] = [1.5, 2.5, 0.5]          # halves: round to even, as jnp.round
    c[0, 1] = [r - 1, 0.0, r - 1.5]    # on the borders
    return c


def test_avg_voxelize_value_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    r = 4
    feats = rng.standard_normal((2, 40, 5)).astype(np.float32)
    coords = _coords(rng, 2, 40, r)
    cot = rng.standard_normal((2, r, r, r, 5)).astype(np.float32)

    def j_loss(f):
        return jnp.sum(jv.avg_voxelize(f, coords, r) * cot)

    j_grid = jv.avg_voxelize(feats, coords, r)
    j_grad = jax.grad(j_loss)(feats)
    f = torch.as_tensor(feats).requires_grad_(True)
    t_grid = tv.avg_voxelize(f, torch.as_tensor(coords), r)
    (t_grid * torch.as_tensor(cot)).sum().backward()
    assert_close(j_grid, t_grid, OPS_ATOL)
    assert_close(j_grad, f.grad, OPS_ATOL)
    # the point at (1.5, 2.5, 0.5) lands in voxel (2, 2, 0), as jnp.round puts it
    lone = tv.avg_voxelize(torch.ones(1, 1, 1), torch.tensor([[[1.5, 2.5, 0.5]]]), r)
    assert float(lone[0, 2, 2, 0, 0]) == 1.0 and float(lone.sum()) == 1.0


def test_trilinear_devoxelize_value_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    r = 5
    grid = rng.standard_normal((2, r, r, r, 3)).astype(np.float32)
    coords = _coords(rng, 2, 30, r)
    coords[1, 2] = [-0.3, r + 0.2, 2.0]  # outside: clipped (half the gradient at a bound)
    cot = rng.standard_normal((2, 30, 3)).astype(np.float32)

    def j_loss(g, c):
        return jnp.sum(jv.trilinear_devoxelize(g, c) * cot)

    j_out = jv.trilinear_devoxelize(grid, coords)
    j_dg, j_dc = jax.grad(j_loss, argnums=(0, 1))(grid, coords)
    g = torch.as_tensor(grid).requires_grad_(True)
    c = torch.as_tensor(coords).requires_grad_(True)
    t_out = tv.trilinear_devoxelize(g, c)
    (t_out * torch.as_tensor(cot)).sum().backward()
    assert_close(j_out, t_out, OPS_ATOL)
    assert_close(j_dg, g.grad, OPS_ATOL)
    assert_close(j_dc, c.grad, OPS_ATOL)


def test_normalize_coords_matches_jax():
    rng = np.random.default_rng(2)
    xyz = rng.standard_normal((3, 50, 3)).astype(np.float32)
    for r, eps in ((8, 0.0), (32, 1e-4)):
        assert_close(jv.normalize_coords_for_voxelization(xyz, r, eps),
                     tv.normalize_coords_for_voxelization(torch.as_tensor(xyz), r, eps),
                     OPS_ATOL)


def test_pvconv_parts_and_conv_layout_match_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 64, 5)).astype(np.float32)
    coords = rng.standard_normal((2, 64, 3)).astype(np.float32)
    # the squeeze-excitation (flax's Dense_0 / Dense_1) and the voxel
    # attention, each alone
    grid = rng.standard_normal((2, 4, 4, 4, 16)).astype(np.float32)
    jout, tout, _ = run_pair(jp.SE3d(16), tp.SE3d(16), (grid,))
    assert_close(jout, tout, PV_ATOL)
    flat = rng.standard_normal((2, 27, 16)).astype(np.float32)
    jout, tout, _ = run_pair(jp.VoxelAttention(16), tp.VoxelAttention(16), (flat,))
    assert_close(jout, tout, PV_ATOL)
    # PVConv with the squeeze-excitation and with the attention
    for att in (False, True):
        jmod = jp.PVConv(out_channels=8, resolution=4, attention=att, with_se=not att,
                         dropout=None)
        tmod = tp.PVConv(5, 8, 4, attention=att, with_se=not att)
        jout, tout, params = run_pair(jmod, tmod, (feats, coords), seed=4 + att)
        assert_close(jout, tout, PV_ATOL)
    # the kernel's 27 taps all differ; the bridge carries them both ways
    kernel = np.asarray(params["vconv_1"]["kernel"])
    assert kernel.shape == (3, 3, 3, 5, 8)
    assert len(np.unique(kernel[:, :, :, 0, 0])) == 27
    assert tmod.vconv_1.weight.shape == (8, 5, 3, 3, 3)
    np.testing.assert_array_equal(to_np(tmod.vconv_1.weight)[:, :, 0, 1, 2],
                                  kernel[0, 1, 2].T)
    back = module_to_flax(tmod)
    np.testing.assert_array_equal(back["vconv_1"]["kernel"], kernel)
    # what `.T` would seat, (out, in, kw, kh, kd): the same shape, the taps
    # mirrored, and another result
    mirrored = jax.tree_util.tree_map(np.asarray, params)
    for conv in ("vconv_1", "vconv_2"):
        k = mirrored[conv]["kernel"]
        mirrored[conv]["kernel"] = np.ascontiguousarray(k.transpose(2, 1, 0, 3, 4))
        np.testing.assert_array_equal(kernel_to_torch(mirrored[conv]["kernel"]), k.T)
    load_flax_params(tmod, mirrored)
    with torch.no_grad():
        wrong = tmod(torch.as_tensor(feats), torch.as_tensor(coords))
    assert float(np.abs(to_np(wrong) - np.asarray(jout)).max()) > 1e-2
