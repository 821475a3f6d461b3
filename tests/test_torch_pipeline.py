"""The whole slice, position DDPM -> feature DDPM -> AE decode, built by the
port's `build_stages` (fused denoisers by default) and run against the JAX
composition of the same three stages (`benchmarks/e2e_pipeline.py::
device_chain`, flax modules) at narrow widths and T=4, on the CPU.  The JAX noise is replayed through `noise_fn` and the decode's
FPS calls through the record / replay of `torch_port_helpers`.  Tolerances:
1e-4 on the two chains (fp32 PointNet steps, sums in another order), then
`DECODE_ATOL` on the decoded cloud."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.diffusion import calc_diffusion_hyperparams as j_eps_sched
from slide_tpu.diffusion import diffusion_sampling as j_diffusion_sampling
from slide_tpu.diffusion.x0 import X0Schedule as JX0Schedule
from slide_tpu.diffusion.x0 import x0_denoise as j_x0_denoise
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu_torch import _build
from slide_tpu_torch.configs import (autoencoder_config, keypoint_ddpm_config,
                                     latent_ddpm_config)
from slide_tpu_torch.pipeline import build_stages, generate, resolve_device, with_fastdpm
from torch_port_helpers import (DECODE_ATOL, assert_close, perturb, record_jax_fps,
                                replay_fps_in_port, small_ae_config, to_np,
                                trim_starts)

B, K, T = 2, 16, 4


def _narrow_configs():
    kp = keypoint_ddpm_config()
    lat = latent_ddpm_config(latent_dim=16)
    for cfg in (kp, lat):
        pc = cfg["pointnet_config"]
        pc.update(t_dim=32, class_condition_dim=16)
        pc["architecture"].update(feature_dim=[16, 32, 32],
                                  decoder_feature_dim=[16, 32, 32],
                                  mlp_depth=2, decoder_mlp_depth=2)
    ae = autoencoder_config()
    ae["pointnet_config"] = small_ae_config()
    return {"kp": kp, "lat": lat, "ae": ae}


def _flax_params(module, key, *args, **kwargs):
    v = jax.jit(lambda k: module.init(k, *args, **kwargs))(key)
    return perturb(v["params"], int(jax.random.randint(key, (), 0, 1000)), scale=0.05)


def _chain_draws(key, shape, steps):
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.asarray(d)) for d in draws]


@pytest.fixture(scope="module")
def narrow():
    """Narrow configs, their flax modules and perturbed flax parameters."""
    cfgs = _narrow_configs()
    label = jnp.zeros((B,), jnp.int32)
    nets = {"kp": JNet(cfgs["kp"]["pointnet_config"]),
            "lat": JNet(cfgs["lat"]["pointnet_config"]),
            "ae": j_build_ae(cfgs["ae"]["pointnet_config"])}
    zeros_t = jnp.zeros((B,), jnp.int32)
    params = {
        "kp": _flax_params(nets["kp"], jax.random.key(1), jnp.zeros((B, K, 3)),
                           ts=zeros_t, label=label),
        "lat": _flax_params(nets["lat"], jax.random.key(2), jnp.zeros((B, K, 19)),
                            ts=zeros_t, label=label),
        "ae": _flax_params(nets["ae"], jax.random.key(3), jnp.zeros((B, K, 3)),
                           jnp.zeros((B, K, 16)), label=label, method=nets["ae"].decode)}
    return cfgs, nets, params


def test_slice_matches_the_jax_composition(monkeypatch, narrow):
    cfgs, nets, params = narrow
    kp_net, lat_net, jae = nets["kp"], nets["lat"], nets["ae"]
    kp_params, lat_params, ae_params = params["kp"], params["lat"], params["ae"]
    label = jnp.zeros((B,), jnp.int32)

    # the JAX composition, keys split as device_chain splits them
    ks = jax.random.split(jax.random.key(100), 4)
    calls = record_jax_fps(monkeypatch)

    def chain(ks):
        kp = j_diffusion_sampling(
            lambda x, ts: kp_net.apply({"params": kp_params}, x, ts=ts, label=label),
            ks[0], (B, K, 3), j_eps_sched(T, 1e-4, 0.02))
        sdc = dict(cfgs["lat"]["standard_diffusion_config"], num_diffusion_timesteps=T)
        latent = j_x0_denoise(
            lambda x, ts: lat_net.apply({"params": lat_params}, x, ts=ts, label=label),
            ks[1], (B, K, 19), JX0Schedule.from_config(sdc), keypoint=kp, keypoint_dim=3)
        cloud = jae.apply({"params": ae_params}, latent[..., :3], latent[..., 3:],
                          label=label, method=jae.decode, rngs={"fps": ks[2]})
        return kp, latent, cloud

    j_kp, j_latent, j_cloud = jax.jit(chain)(ks)
    jax.effects_barrier()

    stages = build_stages(B, T, ckpts=params, device="cpu", configs=cfgs)
    kp_noise = iter(_chain_draws(ks[0], (B, K, 3), T))
    kp = stages.sample_kp(lambda shape: next(kp_noise))
    np.testing.assert_allclose(to_np(kp), np.asarray(j_kp), atol=1e-4)
    lat_noise = iter(_chain_draws(ks[1], (B, K, 19), T))
    latent = stages.sample_lat(lambda shape: next(lat_noise), kp)
    np.testing.assert_allclose(to_np(latent), np.asarray(j_latent), atol=1e-4)

    replay = replay_fps_in_port(monkeypatch, calls, DECODE_ATOL)
    cloud = stages.decode(latent[..., :3], latent[..., 3:], trim_starts(calls))
    assert next(replay, None) is None
    assert cloud.shape == (B, 200, 6)
    assert_close(j_cloud, cloud, DECODE_ATOL)


def test_generate_full_width_on_the_cpu():
    # the shipped airplane presets and the committed checkpoints, T cut to 2
    stages = build_stages(1, t_steps=2, device="cpu")
    before = _build.launch_counts["fps"]
    out = generate(stages, seed=3)
    assert out["cloud"].shape == (1, 2048, 6)
    assert out["keypoints"].shape == (1, 16, 3) and out["features"].shape == (1, 16, 48)
    assert torch.isfinite(out["cloud"]).all()
    assert set(out["seconds"]) == {"position_ddpm", "feature_ddpm", "ae_decode"}
    assert _build.launch_counts["fps"] == before   # the CPU runs the plain FPS


def test_generate_is_reproducible_from_its_seed(narrow):
    cfgs, _, params = narrow
    stages = build_stages(B, 3, ckpts=params, device="cpu", configs=cfgs)
    a, b, c = generate(stages, 5), generate(stages, 5), generate(stages, 6)
    assert torch.equal(a["cloud"], b["cloud"])
    assert not torch.equal(a["cloud"], c["cloud"])


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        build_stages(1, 2)


def test_configs_stay_the_jax_presets():
    assert keypoint_ddpm_config() == j_kp_config()
    from slide_tpu.configs import autoencoder_config as j_ae, latent_ddpm_config as j_lat
    assert latent_ddpm_config() == j_lat() and autoencoder_config() == j_ae()
    assert autoencoder_config("chair") == j_ae("chair")


def test_unfused_chains_match_the_fused_ones(narrow):
    # fused=False runs the modules; the same noise gives the same chains
    cfgs, _, params = narrow
    fused = build_stages(B, 3, ckpts=params, device="cpu", configs=cfgs)
    unfused = build_stages(B, 3, ckpts=params, device="cpu", configs=cfgs, fused=False)
    assert fused.kp_fused is not None and fused.lat_fused is not None
    assert unfused.kp_fused is None and unfused.lat_fused is None
    draws = [torch.randn((B, K, 19), generator=torch.Generator().manual_seed(i))
             for i in range(8)]
    outs = []
    for stages in (fused, unfused):
        kp_noise, lat_noise = iter(d[..., :3] for d in draws), iter(draws)
        kp = stages.sample_kp(lambda shape: next(kp_noise))
        outs.append((kp, stages.sample_lat(lambda shape: next(lat_noise), kp)))
    for a, b in zip(*outs):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=1e-4)


def test_fused_raises_outside_its_scope():
    # npoint < N needs FPS inside the forward: the fused kernel does not take it
    cfgs = {"kp": keypoint_ddpm_config(), "lat": latent_ddpm_config(),
            "ae": autoencoder_config()}
    cfgs["kp"]["pointnet_config"]["architecture"]["npoint"] = [8, 16]
    with pytest.raises(ValueError, match="fused=False"):
        build_stages(1, 2, device="cpu", configs=cfgs)
    assert build_stages(1, 2, device="cpu", configs=cfgs, fused=False).kp_fused is None


def test_fastdpm_generate_full_width_on_the_cpu():
    # the shipped presets and the committed checkpoints, FastDPM with S=3
    stages = with_fastdpm(build_stages(1, device="cpu"), 3)
    calls = {"kp": 0, "lat": 0}

    def counting(name, fn):
        def wrapped(x, ts, label):
            calls[name] += 1
            return fn(x, ts, label)
        return wrapped

    stages.kp_fused = counting("kp", stages.kp_fused)
    stages.lat_fused = counting("lat", stages.lat_fused)
    out = generate(stages, seed=4)
    assert calls == {"kp": 3, "lat": 3}
    assert out["cloud"].shape == (1, 2048, 6) and torch.isfinite(out["cloud"]).all()
