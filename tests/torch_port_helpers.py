"""Shared helpers of the tests that hold `slide_tpu_torch` against the JAX
package: run a flax module and its port on the same numpy inputs with the
same (perturbed) weights, copied by `weights.load_flax_params`."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slide_tpu_torch.weights import flax_leaves, load_flax_params, module_to_flax
# the dual-tower net's layout, shared with the card tests and chip_smoke.py
from conditional_layout import conditional_config  # noqa: F401


def perturb(params, seed: int, scale: float = 0.1):
    """Move every weight off its init value (zero biases, unit GroupNorm
    scales), so the comparison sees every leaf land in the right place."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.standard_normal(a.shape)).astype(np.float32),
        params)


def to_jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def to_torch(x):
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# XLA's CPU backend at LLVM -O0 without its expensive passes: a reference
# compile takes about half the time; the operations and their rounding are
# the same up to fused multiply-adds
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, *args):
    """`jax.jit(fn)(*args)`, compiled with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def run_pair(flax_mod, torch_mod, args, kwargs=None, *, seed=0):
    """Init the flax module on `args`, perturb its params, copy them into the
    torch module, run both.  Returns (jax outputs, torch outputs, params)."""
    kwargs = kwargs or {}
    jargs = [to_jax(a) for a in args]
    jkw = {k: to_jax(v) for k, v in kwargs.items()}
    # jitted: one compile of the whole module costs less than op-by-op
    # dispatch of a cold process
    variables = fast_jit(lambda key: flax_mod.init(key, *jargs, **jkw), jax.random.key(seed))
    params = perturb(variables["params"], seed)
    jout = fast_jit(lambda p: flax_mod.apply({"params": p}, *jargs, **jkw), params)
    load_flax_params(torch_mod, params)
    with torch.no_grad():
        tout = torch_mod(*[to_torch(a) for a in args],
                         **{k: to_torch(v) for k, v in kwargs.items()})
    return jout, tout, params


def assert_close(jout, tout, atol, rtol=1e-5):
    """|torch - jax| <= atol + rtol * |jax|, elementwise.  rtol 1e-5 is some
    80 fp32 ulps: outputs of magnitude ~1-3 come out of several layers of
    sums taken in another order than XLA's."""
    if isinstance(jout, (tuple, list)):
        assert len(jout) == len(tout)
        for j, t in zip(jout, tout):
            assert_close(j, t, atol, rtol)
        return
    j, t = to_np(jout), to_np(tout)
    assert j.shape == t.shape, (j.shape, t.shape)
    np.testing.assert_allclose(t, j, atol=atol, rtol=rtol)


# decode stacks two PointNet++ networks (some 40 fp32 layers) and feeds their
# features, scaled by 0.5 (small_ae_config), into the next level's points
DECODE_ATOL = 5e-4
# positions of the trims among a decode's nine FPS calls
TRIM_CALLS = (0, 4, 8)


def small_ae_config():
    """The airplane autoencoder at narrow widths (latent width 16) and few
    points: an encoder of four SA levels to 64, 32, 16, 8 centers, then
    16 keypoints -> 64 -> 128 -> 200.  The displacement scales grow
    to 0.5: at the shipped 0.03 / 0.003 / 0.001 the split points sit so close
    that their squared distances (||x||^2 - 2<x, y> + ||y||^2 in fp32, in
    either framework) are rounding noise, and neighbour order within a
    cluster is decided by the order of the sums."""
    from slide_tpu_torch.configs import autoencoder_config
    cfg = copy.deepcopy(autoencoder_config()["pointnet_config"])
    cfg["encoder_config"]["architecture"].update(npoint=[64, 32, 16, 8], nsample=[8, 8, 8, 4],
                                                 feature_dim=[8, 16, 16, 32, 32])
    l1, l2, l3 = cfg["decoder_config_list"]
    l1["architecture"]["feature_dim"] = [8, 8, 8]
    l1["feature_mapper_setting"]["out_dim"] = 8
    l1["upsampling_setting"].update(point_upsample_factor=8, num_output_points=64,
                                    output_scale_factor=0.5)
    for lvl, npoint, ups, n_out in [(l2, [32, 16, 8], 4, 128), (l3, [64, 16, 8], 2, 200)]:
        lvl["architecture"].update(npoint=npoint, nsample=[8, 8, 4], K=4,
                                   feature_dim=[16, 16, 32, 32],
                                   decoder_feature_dim=[32, 32, 32, 32])
        lvl["feature_mapper_setting"].update(out_dim=16, nsample=4)
        lvl["upsampling_setting"].update(point_upsample_factor=ups,
                                         num_output_points=n_out, output_scale_factor=0.5)
    return cfg


def train_ae_config():
    """A small autoencoder for the round trip and its gradient: an encoder
    of two SA levels (to 32 and 8 centers), `small_ae_config`'s keypoint
    level, then ONE decoder level (64 -> 200 points), all GroupNorm'd layers
    past the first at 128-256 channels.

    Every GroupNorm has min(32, C) groups, so layers of 64-128 channels
    normalise groups of two to four, whose statistics cancel in fp32 where a
    channel's mean dwarfs its spread: at `small_ae_config`'s widths fp32
    rounding moves the last level's points ~3e-3 from the float64 forward,
    which flips chamfer picks and most of the gradient, and at 128 channels
    JAX's gradient still has 5836 of 2.6M elements beyond rtol 5e-3, atol
    1e-4 of the port's float64 one.  Here both fp32 forwards lie ~6e-7 from
    float64 and no gradient element is beyond the gate.  One decoder level
    (its code is the cascade's) and two SA levels keep JAX's compile of the
    train step near 30 s."""
    cfg = small_ae_config()
    level1, level2, _ = cfg["decoder_config_list"]
    cfg["decoder_config_list"] = [level1, level2]
    cfg["feature_weight"] = [0, 0.1]
    cfg["encoder_config"]["architecture"].update(
        npoint=[32, 8], nsample=[8, 4], radius=[0, 0], feature_dim=[16, 128, 256], mlp_depth=2)
    level2["architecture"].update(npoint=[16, 8], nsample=[8, 4], radius=[0, 0],
                                  feature_dim=[128, 128, 256],
                                  decoder_feature_dim=[256] * 3, mlp_depth=2)
    level2["feature_mapper_setting"].update(out_dim=128)
    level2["upsampling_setting"].update(num_output_points=200)
    return cfg


def narrow_sap_config():
    """The SAP refine+upsample preset at narrow widths, every SA level below
    its input's size from 200 points on (so all four run FPS), kNN
    neighbourhoods of 8 and KnnFP K=4; DPSR at 32^3."""
    from slide_tpu_torch.configs import upsampler_config
    cfg = copy.deepcopy(upsampler_config())
    pc = cfg["pointnet_config"]
    pc.update(class_condition_dim=16)
    pc["architecture"].update(npoint=[96, 48, 24, 12], nsample=[8, 8, 8, 8],
                              feature_dim=[8, 8, 16, 16, 32],
                              decoder_feature_dim=[16, 16, 16, 16, 32], K=4)
    cfg["dpsr_config"]["grid_res"] = 32
    return cfg


def train_sap_config():
    """`narrow_sap_config` cut to two SA levels (96 and 24 centers), each SA
    and FP level 128 channels wide: the upsampler step's tests run it.  At
    the narrow widths the GroupNorms of the first levels normalise single
    channels, whose fp32 statistics cancel: the narrow net's gradient lay
    2.9e-2 (port) and 1.3e-2 (JAX) of its largest element from the port's
    float64 run, and still 4.7e-3 and 5.4e-3 at 64 channels; at 128 (groups
    of four) 5.4e-4 and 2.2e-3.  The four-level net is held to JAX in
    tests/torch_sap_cases.py; two levels halve JAX's compile of the step."""
    cfg = narrow_sap_config()
    cfg["pointnet_config"]["architecture"].update(
        npoint=[96, 24], nsample=[8, 8], radius=[0.1, 0.2], feature_dim=[128] * 3,
        decoder_feature_dim=[128] * 3)
    return cfg


def record_jax_fps(monkeypatch):
    """Record every FPS call of the JAX autoencoder (its trims, SA levels
    and training targets), in order, as [cloud, start (B,), indices]; works
    under jit."""
    import slide_tpu.models.autoencoder as j_ae
    import slide_tpu.models.upsample_decoder as j_updec
    import slide_tpu.nn.modules as j_modules
    calls = []
    real = j_updec.furthest_point_sample

    def recording(xyz, k, start_idx=0, num_forced=0):
        idx = real(xyz, k, start_idx=start_idx, num_forced=num_forced)
        start = jnp.broadcast_to(jnp.asarray(start_idx, jnp.int32), (xyz.shape[0],))
        jax.debug.callback(lambda *a: calls.append([np.array(x) for x in a]),
                           xyz, start, idx, ordered=True)
        return idx

    for mod in (j_updec, j_modules, j_ae):
        monkeypatch.setattr(mod, "furthest_point_sample", recording)
    return calls


# FPS picks of two fp32 implementations may part where two candidates' running
# minimum distances are equal to rounding (mirrored clouds meet this): a gap
# below 1e-6 of the farthest distance, some 8 fp32 ulps, is such a tie
FPS_TIE_RTOL = 1e-6


def fps_ties(xyz, k, start, j_idx, tie_rtol=FPS_TIE_RTOL) -> int:
    """The port's FPS on the numpy cloud `xyz` against the JAX picks `j_idx`:
    each row must give the same indices or first part from JAX's at a tie,
    where the two candidates' running minimum distances (float64, over the
    picks both made before) are the farthest to within `tie_rtol`.  Returns
    the number of rows that part at a tie."""
    from slide_tpu_torch.ops import furthest_point_sample
    t_idx = to_np(furthest_point_sample(torch.as_tensor(xyz), k, torch.as_tensor(start)))
    ties = 0
    for b in np.nonzero((t_idx != j_idx).any(axis=1))[0]:
        r = int(np.nonzero(t_idx[b] != j_idx[b])[0][0])
        pts = xyz[b].astype(np.float64)
        picked = pts[j_idx[b, :r]]
        dist = ((pts[:, None, :] - picked[None]) ** 2).sum(-1).min(axis=1)
        far = dist.max()
        assert abs(dist[t_idx[b, r]] - dist[j_idx[b, r]]) <= tie_rtol * far, \
            (b, r, dist[t_idx[b, r]], dist[j_idx[b, r]], far)
        assert min(dist[t_idx[b, r]], dist[j_idx[b, r]]) >= far * (1 - tie_rtol)
        ties += 1
    return ties


def replay_fps_in_port(monkeypatch, calls, atol, tie_calls=()):
    """Make the port's autoencoder replay the recorded JAX FPS calls: the cloud
    it hands FPS must match the JAX one within atol, its start must be the
    JAX start, the port's own FPS on the JAX cloud must give the JAX indices
    exactly (or, at the call positions in `tie_calls`, part from them only
    at a tie, `fps_ties`), and the JAX indices are what it gets back, so a
    near-tie between points 1e-6 apart cannot fork the two runs.  Returns
    the iterator, to check that every call was replayed."""
    import slide_tpu_torch.models.autoencoder as t_ae
    import slide_tpu_torch.models.upsample_decoder as t_updec
    import slide_tpu_torch.nn.modules as t_modules
    from slide_tpu_torch.ops import furthest_point_sample
    replay = iter(enumerate(calls))

    def replaying(xyz, k, start_idx=0, num_forced=0):
        i, (j_xyz, j_start, j_idx) = next(replay)
        np.testing.assert_allclose(to_np(xyz), j_xyz, atol=atol, rtol=1e-5)
        start = torch.broadcast_to(torch.as_tensor(start_idx), (xyz.shape[0],))
        np.testing.assert_array_equal(to_np(start), j_start)
        if i in tie_calls:
            fps_ties(j_xyz, k, j_start, j_idx)
        else:
            np.testing.assert_array_equal(
                to_np(furthest_point_sample(torch.as_tensor(j_xyz), k,
                                            torch.as_tensor(j_start))), j_idx)
        return torch.as_tensor(j_idx)

    for mod in (t_updec, t_modules, t_ae):
        monkeypatch.setattr(mod, "furthest_point_sample", replaying)
    return replay


def trim_starts(calls):
    """A decode `start_fn` that hands out the JAX run's trim starts."""
    starts = iter([calls[i][1] for i in TRIM_CALLS])
    return lambda b, n: torch.as_tensor(next(starts))


def flax_params_of(module: torch.nn.Module):
    """A port module's parameters as the flax tree `weights.load_flax_params`
    reads (`weights.module_to_flax`)."""
    return module_to_flax(module)


def record_jax_posterior_noise(monkeypatch):
    """Record the standard-normal noise of every posterior the JAX package
    samples (`DiagonalGaussian.sample`), in order; works under jit."""
    from slide_tpu.nn.distributions import DiagonalGaussian
    noises = []

    def sample(self, key):
        noise = jax.random.normal(key, self.mean.shape, self.mean.dtype)
        jax.debug.callback(lambda n: noises.append(np.array(n)), noise, ordered=True)
        return self.mean + self.std * noise

    monkeypatch.setattr(DiagonalGaussian, "sample", sample)
    return noises


def assert_trees_close(got, want, rtol, atol):
    """A port tree (`module_to_flax` layout) against a JAX tree, leaf by leaf
    in `jax.tree.leaves` order."""
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], flax_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def assert_one_adam_step(state, new_params, opt_state, rtol=5e-3, atol=1e-4, sure=1e-3):
    """The port's `TrainState` after one Adam step against optax's: the
    count; |g| read back from each moment (mu = 0.1 g, nu = 1e-3 g^2) at the
    gradient tolerance; the parameters 1e-6 where |g| > `sure` (the step's
    sign is beyond doubt there), else within the 2 lr a sign decided
    otherwise could move them."""
    from slide_tpu_torch.train.driver import adam_state_tree
    count, mu, nu = adam_state_tree(state)[0]
    jstate = opt_state[0]
    assert int(count) == int(jstate.count) == state.step == 1
    assert_trees_close(mu, jstate.mu, rtol=rtol, atol=0.1 * atol)
    g_abs = jax.tree_util.tree_map(lambda v: np.sqrt(np.asarray(v) / 1e-3), jstate.nu)
    assert_trees_close(jax.tree_util.tree_map(lambda v: np.sqrt(v / 1e-3), nu), g_abs,
                       rtol=rtol, atol=atol)
    lr = state.optimizer.param_groups[0]["lr"]
    for g, w, a in zip(flax_leaves(module_to_flax(state.net)), jax.tree.leaves(new_params),
                       jax.tree.leaves(g_abs)):
        err = np.abs(g - np.asarray(w))
        assert float(err[a > sure].max(initial=0)) <= 1e-6
        assert float(err.max()) <= 2 * lr + 1e-6

