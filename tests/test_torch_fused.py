"""The port's fused denoiser (`slide_tpu_torch/models/fused_denoiser.py`) and
FastDPM samplers (`slide_tpu_torch/diffusion/fastdpm.py`) against the JAX
package on the CPU.  Inputs, weights and noise are made with numpy from a
seed (JAX chains' noise is rebuilt from their key splits and replayed through
`noise_fn`).  The JAX fused forward runs its own CPU path
(`fused_forward(..., use_pallas=False)`, plain jnp, jitted).

Tolerances: 2e-5 abs + 1e-5 rel between the port's plain fused forward and
JAX's (the same fp32 arithmetic, sums in another order); 1e-4 abs + 1e-4 rel
against the port's module (as the JAX package holds its fused path to its
flax module); 1e-4 on five-step chains; schedules equal; 1e-5 on FastDPM
chains with a closed-form network."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.configs import latent_ddpm_config as j_lat_config
from slide_tpu.diffusion import eps as jeps
from slide_tpu.diffusion import fastdpm as jfast
from slide_tpu.diffusion import x0 as jx0
from slide_tpu.models import fused_denoiser as jf
from slide_tpu_torch import diffusion as td
from slide_tpu_torch.diffusion import fastdpm as tfast
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models import fused_denoiser as tf
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.weights import load_flax_params, load_inference_params
from torch_port_helpers import assert_close, flax_params_of, to_np

N = 16


def _narrow(cfg_fn, nsample=None):
    cfg = copy.deepcopy(cfg_fn()["pointnet_config"])
    cfg.update(t_dim=16, class_condition_dim=16)
    cfg["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                               mlp_depth=2, decoder_mlp_depth=2)
    if nsample is not None:
        cfg["architecture"]["nsample"] = nsample
    return cfg


def _perturbed_net(cfg, seed):
    """A port module with every weight moved off its init value."""
    net = ConditionalPointNet2(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.as_tensor(0.1 * rng.standard_normal(tuple(p.shape)),
                                   dtype=torch.float32))
    return net.eval()


_CASES = {}


def _case(name):
    """(config, port module, flax params, din) of one test network, built once:
    `kp` the narrow kp net (both SA levels group all 16 points), `lat_topk`
    the narrow latent net with SA nsample 6 < N on the first level (the kNN
    gather path), `kp_ckpt` the shipped kp preset with the committed
    checkpoint."""
    if name not in _CASES:
        if name == "kp_ckpt":
            cfg = copy.deepcopy(j_kp_config()["pointnet_config"])
            params = load_inference_params(str(DEFAULT_CKPTS["kp"]))
            net = load_flax_params(ConditionalPointNet2(cfg), params).eval()
        else:
            cfg = (_narrow(j_kp_config) if name == "kp"
                   else _narrow(j_lat_config, nsample=[6, 16]))
            net = _perturbed_net(cfg, seed=len(name))
            params = flax_params_of(net)
        _CASES[name] = (cfg, net, params, 3 + cfg["in_fea_dim"])
    return _CASES[name]


def _inputs(b, din, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, N, din)).astype(np.float32)
    ts = rng.integers(0, 1000, b).astype(np.int32)
    label = rng.integers(0, 13, b).astype(np.int32)
    return x, ts, label


def _jax_fused(cfg, params):
    spec = jf.build_spec(cfg, N)
    weights = jf.extract_weights(params)
    return jax.jit(lambda x, ts, lbl: jf.fused_forward(spec, weights, x, ts, lbl,
                                                        use_pallas=False))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("cfg_fn", [j_kp_config, j_lat_config])
def test_spec_equals_jax(cfg_fn):
    cfg = cfg_fn("airplane")["pointnet_config"]
    assert tf.supports_config(cfg) and jf.supports_config(cfg)
    assert tf.build_spec(cfg, N) == jf.build_spec(cfg, N)


@pytest.mark.parametrize("change", ["bn_first", "include_local_feature", "npoint", "K"])
def test_unsupported_configs_are_rejected(change):
    cfg = copy.deepcopy(j_kp_config("airplane")["pointnet_config"])
    if change in ("bn_first", "include_local_feature"):
        cfg[change] = True
        assert not tf.supports_config(cfg) and not jf.supports_config(cfg)
    else:
        cfg["architecture"].update(npoint=[8, 16]) if change == "npoint" else \
            cfg["architecture"].update(K=17)
        assert tf.supports_config(cfg)
        with pytest.raises(ValueError):
            jf.build_spec(cfg, N)
    with pytest.raises(ValueError):
        tf.build_spec(cfg, N)
    assert tf.make_fused_net_fn(cfg, ConditionalPointNet2(j_kp_config()["pointnet_config"]),
                                N) is None


def test_packed_table_reads_back():
    cfg, net, _, _ = _case("kp")
    fn = tf.make_fused_net_fn(cfg, net, N)
    ints = fn.packed.table.tolist()
    assert len(ints) == tf.table_ints()
    assert tf.encode_table(tf.TABLE, fn.packed.layout) == ints
    flat, lay = fn.packed.flat, fn.packed.layout
    w = lay["sa"][1]["att"]["w_conv_2"]
    want = net.sa_modules_1.attention.w_conv_2
    got = flat[w["w"]:w["w"] + w["cin"] * w["cout"]].view(w["cin"], w["cout"])
    assert torch.equal(got, want.weight.t())
    assert torch.equal(flat[w["b"]:w["b"] + w["cout"]], want.bias)
    assert lay["sa"][0]["mlp"]["n_layers"] == 2 and lay["fp"][0]["mlp1"]["res"] == 2
    assert lay["n_sa"] == 2 and lay["sa"][2]["k"] == 0   # unused slots are zeros


@pytest.mark.parametrize("name", ["kp", "lat_topk", "kp_ckpt"])
def test_plain_matches_jax_fused(name):
    cfg, net, params, din = _case(name)
    x, ts, label = _inputs(3, din, seed=1)
    want = _jax_fused(cfg, params)(x, ts, label)
    got = tf.make_fused_net_fn(cfg, net, N)(*_t(x, ts, label))
    assert_close(want, got, atol=2e-5)


@pytest.mark.parametrize("name", ["kp", "lat_topk", "kp_ckpt"])
def test_plain_matches_the_module(name):
    cfg, net, _, din = _case(name)
    x, ts, label = _t(*_inputs(4, din, seed=2))
    with torch.no_grad():
        want = net(x, ts=ts, label=label)
    got = tf.make_fused_net_fn(cfg, net, N)(x, ts, label)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["lat_topk", "kp_ckpt"])
def test_duplicate_points_stay_finite(name):
    # equal points have distance 0 and a kNN weight 1 / 1e-8: huge, but finite
    cfg, net, _, din = _case(name)
    x, ts, label = _inputs(2, din, seed=3)
    x[:, 1] = x[:, 0]
    x[:, 2] = x[:, 0]
    x[:, 7:] = x[:, 6:7]
    got = tf.make_fused_net_fn(cfg, net, N)(*_t(x, ts, label))
    assert got.shape == (2, N, din) and torch.isfinite(got).all()


def _chain_noise(key, shape, steps):
    """A JAX chain's draws: the first split for x_T, then one per step."""
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.array(d)) for d in draws]


def _replay(draws):
    it = iter(draws)
    return lambda shape: next(it)


@pytest.mark.parametrize("sampler", ["ddpm", "fastdpm"])
def test_fused_kp_chain_matches_jax(sampler):
    cfg, net, params, _ = _case("kp")
    b, steps = 2, 5
    label = np.array([0, 4], np.int32)
    jfn = jf.make_fused_net_fn(cfg, params, N, use_pallas=False)
    tfn = tf.make_fused_net_fn(cfg, net, N)
    key = jax.random.key(7)
    shape = (b, N, 3)
    jsched = jeps.calc_diffusion_hyperparams(100 if sampler == "fastdpm" else steps,
                                             1e-4, 0.02)
    tsched = td.calc_diffusion_hyperparams(jsched.T, 1e-4, 0.02)

    def jnet(x, ts):
        return jfn(x, ts, jnp.asarray(label))

    def tnet(x, ts):
        return tfn(x, ts, torch.as_tensor(label))

    if sampler == "ddpm":
        want = jax.jit(lambda k: jeps.diffusion_sampling(jnet, k, shape, jsched))(key)
        got = td.diffusion_sampling(tnet, shape, tsched, _replay(_chain_noise(key, shape,
                                                                            steps)))
    else:
        dc = {"T": 100, "beta_0": 1e-4, "beta_T": 0.02}
        want = jax.jit(lambda k: jfast.fast_sampling(
            jnet, k, shape, jsched, dc, length=steps, sampling_method="step",
            schedule="quadratic", kappa=0.5))(key)
        got = tfast.fast_sampling(tnet, shape, tsched, dc,
                                  _replay(_chain_noise(key, shape, steps)), length=steps,
                                  sampling_method="step", schedule="quadratic", kappa=0.5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


def test_fused_lat_chain_matches_jax():
    cfg, net, params, din = _case("lat_topk")
    b, steps = 2, 5
    label = np.array([1, 2], np.int32)
    jfn = jf.make_fused_net_fn(cfg, params, N, use_pallas=False)
    tfn = tf.make_fused_net_fn(cfg, net, N)
    kp = np.random.default_rng(4).standard_normal((b, N, 3)).astype(np.float32)
    sdc = dict(j_lat_config()["standard_diffusion_config"], num_diffusion_timesteps=steps)
    key = jax.random.key(8)
    shape = (b, N, din)
    want = jax.jit(lambda k: jx0.x0_denoise(
        lambda x, ts: jfn(x, ts, jnp.asarray(label)), k, shape,
        jx0.X0Schedule.from_config(sdc), keypoint=jnp.asarray(kp), keypoint_dim=3))(key)
    got = td.x0_denoise(lambda x, ts: tfn(x, ts, torch.as_tensor(label)), shape,
                        td.X0Schedule.from_config(sdc),
                        _replay(_chain_noise(key, shape, steps)),
                        keypoint=torch.as_tensor(kp), keypoint_dim=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# FastDPM

_DC = {"T": 1000, "beta_0": 1e-4, "beta_T": 0.02}


@pytest.mark.parametrize("schedule", ["linear", "quadratic"])
@pytest.mark.parametrize("s", [5, 50])
def test_fastdpm_schedules_equal_jax(schedule, s):
    np.testing.assert_array_equal(tfast.get_var_noise(s, _DC, schedule),
                                  jfast.get_var_noise(s, _DC, schedule))
    assert tfast.get_step_steps(s, _DC, schedule) == jfast.get_step_steps(s, _DC, schedule)
    eta = jfast.get_var_noise(s, _DC, schedule)
    jsched = jeps.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    tsched = td.calc_diffusion_hyperparams(1000, 1e-4, 0.02)
    np.testing.assert_allclose(tfast.precompute_var_steps(tsched, eta, 1e-4, 0.02),
                               jfast.precompute_var_steps(jsched, eta, 1e-4, 0.02),
                               rtol=0, atol=1e-6)
    assert tfast.diffusion_config_of(tsched) == jfast.diffusion_config_of(jsched)


def _closed_form_nets():
    # a network stand-in with the samplers' signature: depends on x and t
    def jnet(x, ts):
        return 0.3 * jnp.tanh(x) + 1e-3 * ts[:, None, None].astype(jnp.float32)

    def tnet(x, ts):
        return 0.3 * torch.tanh(x) + 1e-3 * ts[:, None, None].float()

    return jnet, tnet


@pytest.mark.parametrize("method", ["var", "step"])
def test_fast_sampling_closed_form(method):
    jnet, tnet = _closed_form_nets()
    shape, s = (3, N, 3), 5
    key = jax.random.key(21)
    dc = {"T": 200, "beta_0": 1e-4, "beta_T": 0.02}
    want = jfast.fast_sampling(jnet, key, shape, jeps.calc_diffusion_hyperparams(200, 1e-4,
                                                                                 0.02),
                               dc, length=s, sampling_method=method, kappa=0.5)
    got = tfast.fast_sampling(tnet, shape, td.calc_diffusion_hyperparams(200, 1e-4, 0.02),
                              dc, _replay(_chain_noise(key, shape, s)), length=s,
                              sampling_method=method, kappa=0.5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kappa", [0.0, 0.5])
def test_fast_x0_denoise_closed_form(kappa):
    jnet, tnet = _closed_form_nets()
    shape, s = (2, N, 9), 5
    key = jax.random.key(22)
    kp = np.random.default_rng(5).standard_normal((2, N, 3)).astype(np.float32)
    sdc = dict(j_lat_config()["standard_diffusion_config"], num_diffusion_timesteps=100)
    want = jfast.fast_x0_denoise(jnet, key, shape, jx0.X0Schedule.from_config(sdc),
                                 length=s, kappa=kappa, keypoint=jnp.asarray(kp),
                                 keypoint_dim=3)
    got = tfast.fast_x0_denoise(tnet, shape, td.X0Schedule.from_config(sdc),
                                _replay(_chain_noise(key, shape, s)), length=s,
                                kappa=kappa, keypoint=torch.as_tensor(kp), keypoint_dim=3)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(to_np(got)[..., :3], kp)
