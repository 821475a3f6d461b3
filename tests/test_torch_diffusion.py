"""The port's DDPM samplers against the JAX ones on the CPU.  The JAX chains
draw their noise from `jax.random` keys; the test rebuilds those draws from
the same key-split order and hands them to the port through `noise_fn`.
Schedules are computed in float64 on both sides and must be equal; chains
are fp32 and agree to atol 1e-5 with a closed-form network, 1e-4 with a
PointNet denoiser (ten steps of it, sums taken in another order)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config, latent_ddpm_config
from slide_tpu.diffusion import eps as jeps
from slide_tpu.diffusion import latent as jlat
from slide_tpu.diffusion import x0 as jx0
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu_torch import diffusion as td
from slide_tpu_torch.models import ConditionalPointNet2 as TNet
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.weights import load_flax_params, module_to_flax
from torch_port_helpers import perturb, to_np


def _chain_noise(key, shape, steps):
    """The draws of a JAX chain: one from the first split for x_T, then one
    per step, each from a fresh split of the carried key."""
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.asarray(d)) for d in draws]


def _replay(draws):
    it = iter(draws)
    return lambda shape: next(it)


def _lat_sdc(t):
    return dict(latent_ddpm_config()["standard_diffusion_config"],
                num_diffusion_timesteps=t)


def test_eps_schedule_equals_jax():
    j = jeps.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    t = td.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    for name in ("beta", "alpha", "alpha_bar", "sigma"):
        np.testing.assert_array_equal(to_np(getattr(t, name)), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("schedule", ["linear", "quad", "warmup10", "warmup50",
                                      "const", "jsd"])
def test_beta_schedules_equal_jax(schedule):
    kw = dict(beta_start=1e-4, beta_end=0.02, num_diffusion_timesteps=100)
    np.testing.assert_array_equal(td.get_beta_schedule(schedule, **kw),
                                  jx0.get_beta_schedule(schedule, **kw))


@pytest.mark.parametrize("var_type", ["fixedsmall", "fixedlarge"])
def test_x0_schedule_equals_jax(var_type):
    cfg = dict(_lat_sdc(1000), model_var_type=var_type)
    j, t = jx0.X0Schedule.from_config(cfg), td.X0Schedule.from_config(cfg)
    for name in ("alphas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1",
                 "posterior_mean_coef2", "logvar"):
        np.testing.assert_array_equal(to_np(getattr(t, name)), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("clamp", [-1, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_denoising_step(clamp, masked):
    cfg = dict(_lat_sdc(50), data_clamp_range=clamp)
    js, ts_ = jx0.X0Schedule.from_config(cfg), td.X0Schedule.from_config(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32) * 2
    out = rng.standard_normal((3, 7, 5)).astype(np.float32)
    steps = np.array([0, 17, 49], np.int32)
    kw_j, kw_t = {}, {}
    if masked:
        mask = (rng.random((3, 7)) > 0.5).astype(np.float32)
        comp = rng.standard_normal((3, 7, 5)).astype(np.float32)
        kw_j = dict(complete_x0=jnp.asarray(comp), keypoint_mask=jnp.asarray(mask))
        kw_t = dict(complete_x0=torch.as_tensor(comp), keypoint_mask=torch.as_tensor(mask))
    key = jax.random.key(3)
    want, want_x0 = jx0.denoising_step(js, key, jnp.asarray(x), jnp.asarray(steps),
                                       jnp.asarray(out), **kw_j)
    noise = torch.as_tensor(np.asarray(jax.random.normal(key, x.shape)))
    got, got_x0 = td.denoising_step(ts_, torch.as_tensor(x), torch.as_tensor(steps),
                                    torch.as_tensor(out), noise, **kw_t)
    np.testing.assert_allclose(to_np(got_x0), np.asarray(want_x0), atol=1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def _closed_form_nets():
    # a network stand-in with the samplers' signature: depends on x and t
    def jnet(x, ts):
        return 0.3 * jnp.tanh(x) + 1e-3 * ts[:, None, None].astype(jnp.float32)

    def tnet(x, ts):
        return 0.3 * torch.tanh(x) + 1e-3 * ts[:, None, None].float()

    return jnet, tnet


@pytest.mark.parametrize("t_steps", [1, 10])
def test_eps_chain_closed_form(t_steps):
    jnet, tnet = _closed_form_nets()
    shape = (3, 16, 3)
    key = jax.random.key(11)
    want = jeps.diffusion_sampling(jnet, key, shape,
                                   jeps.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02))
    got = td.diffusion_sampling(tnet, shape,
                                td.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02),
                                _replay(_chain_noise(key, shape, t_steps)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("pinned", [False, True])
def test_x0_chain_closed_form(pinned):
    jnet, tnet = _closed_form_nets()
    shape = (2, 16, 9)
    t_steps = 10
    key = jax.random.key(12)
    kp = np.random.default_rng(1).standard_normal((2, 16, 3)).astype(np.float32)
    j_kw = dict(keypoint=jnp.asarray(kp), keypoint_dim=3) if pinned else {}
    t_kw = dict(keypoint=torch.as_tensor(kp), keypoint_dim=3) if pinned else {}
    want = jx0.x0_denoise(jnet, key, shape, jx0.X0Schedule.from_config(_lat_sdc(t_steps)),
                          **j_kw)
    got = td.x0_denoise(tnet, shape, td.X0Schedule.from_config(_lat_sdc(t_steps)),
                        _replay(_chain_noise(key, shape, t_steps)), **t_kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
    if pinned:
        np.testing.assert_array_equal(to_np(got)[..., :3], kp)


def test_x0_chain_warm_start_partial():
    jnet, tnet = _closed_form_nets()
    shape = (2, 16, 6)
    key = jax.random.key(13)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jx0.x0_denoise(jnet, key, shape, jx0.X0Schedule.from_config(_lat_sdc(20)),
                          x=jnp.asarray(x), curr_step=12, n_steps=5)
    # with x given the JAX chain makes no x_T draw: the first split feeds step 1
    steps = []
    for _ in range(5):
        key, k = jax.random.split(key)
        steps.append(torch.as_tensor(np.asarray(jax.random.normal(k, shape))))
    got = td.x0_denoise(tnet, shape, td.X0Schedule.from_config(_lat_sdc(20)),
                        _replay(steps), x=torch.as_tensor(x), curr_step=12, n_steps=5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_latent_denoise_and_reconstruct_closed_form():
    jnet, tnet = _closed_form_nets()
    t_steps = 6
    kp = np.random.default_rng(3).standard_normal((2, 16, 3)).astype(np.float32)
    label = np.array([0, 2], np.int32)
    key = jax.random.key(14)

    def jdecode(k, f, lbl, kk):
        return jnp.concatenate([k, jnp.tanh(f)], axis=-1)

    def tdecode(k, f, lbl):
        return torch.cat([k, torch.tanh(f)], dim=-1)

    want = jlat.latent_denoise_and_reconstruct(
        jnet, jdecode, key, 2, 3, (16, 9), jx0.X0Schedule.from_config(_lat_sdc(t_steps)),
        label=jnp.asarray(label), keypoint=jnp.asarray(kp))
    _, k_chain, _ = jax.random.split(key, 3)
    got = td.latent_denoise_and_reconstruct(
        tnet, tdecode, 2, 3, (16, 9), td.X0Schedule.from_config(_lat_sdc(t_steps)),
        _replay(_chain_noise(k_chain, (2, 16, 9), t_steps)),
        label=torch.as_tensor(label), keypoint=torch.as_tensor(kp))
    for w, g in zip(want, got):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5)


def _narrow_net(cfg_fn, in_fea_dim, out_dim, seed):
    pc = copy.deepcopy(cfg_fn()["pointnet_config"])
    pc.update(in_fea_dim=in_fea_dim, out_dim=out_dim, t_dim=32, class_condition_dim=16)
    pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                              mlp_depth=2, decoder_mlp_depth=2)
    # the weights drawn by the port's init_params (the JAX package's
    # initialisers) and perturbed: the flax tree both packages load
    tnet = init_params(TNet(pc), torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(tnet), seed)
    load_flax_params(tnet, params)
    return JNet(pc), params, tnet


def test_eps_chain_with_the_kp_network():
    jnet, params, tnet = _narrow_net(keypoint_ddpm_config, 0, 3, 0)
    label = np.array([0, 5], np.int32)
    shape, t_steps, key = (2, 16, 3), 8, jax.random.key(21)
    want = jax.jit(lambda k: jeps.diffusion_sampling(
        lambda x, ts: jnet.apply({"params": params}, x, ts=ts, label=jnp.asarray(label)),
        k, shape, jeps.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02)))(key)
    got = td.diffusion_sampling(
        lambda x, ts: tnet(x, ts=ts, label=torch.as_tensor(label)), shape,
        td.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02),
        _replay(_chain_noise(key, shape, t_steps)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_x0_chain_with_the_latent_network():
    jnet, params, tnet = _narrow_net(latent_ddpm_config, 6, 9, 1)
    label = np.array([1, 3], np.int32)
    kp = np.random.default_rng(4).standard_normal((2, 16, 3)).astype(np.float32)
    shape, t_steps, key = (2, 16, 9), 8, jax.random.key(22)
    want = jax.jit(lambda k: jx0.x0_denoise(
        lambda x, ts: jnet.apply({"params": params}, x, ts=ts, label=jnp.asarray(label)),
        k, shape, jx0.X0Schedule.from_config(_lat_sdc(t_steps)),
        keypoint=jnp.asarray(kp), keypoint_dim=3))(key)
    got = td.x0_denoise(
        lambda x, ts: tnet(x, ts=ts, label=torch.as_tensor(label)), shape,
        td.X0Schedule.from_config(_lat_sdc(t_steps)),
        _replay(_chain_noise(key, shape, t_steps)),
        keypoint=torch.as_tensor(kp), keypoint_dim=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_unported_sampler_raises():
    # FastDPM is ported (tests/test_torch_eval.py); an unknown sampler, and
    # FastDPM with a warm start, raise as in the JAX package
    sched = td.X0Schedule.from_config(_lat_sdc(5))
    with pytest.raises(ValueError, match="unknown sampler"):
        td.latent_denoise_and_reconstruct(None, None, 1, 3, (16, 9), sched, None,
                                          sampler="ddim")
    with pytest.raises(ValueError, match="full-chain"):
        td.latent_denoise_and_reconstruct(None, None, 1, 3, (16, 9), sched, None,
                                          sampler="fastdpm", n_steps=3)
