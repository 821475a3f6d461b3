"""The whole slice, position DDPM -> feature DDPM -> AE decode -> SAP
refine+upsample -> DPSR -> marching tetrahedra and surface sampling, built
by the port's `build_stages` (fused denoisers by default) and run through
`generate(device="cpu")` against the JAX composition of the same stages
(`benchmarks/e2e_pipeline.py::device_chain` and its `sap_fn`, flax modules,
built here) at narrow widths, T=4 and DPSR at 32^3, on the CPU.  The JAX
noise, the decode's FPS starts and the mirror's permutation are replayed
through `generate`'s `noise_fn`, `start_fn` and `perm`, and every FPS call
(the decode's and the SAP net's SA levels') through the record / replay of
`torch_port_helpers`.  Tolerances: 1e-4 on the two chains (fp32 PointNet
steps, sums in another order), then `DECODE_ATOL` on the decoded cloud and
`GRID_ATOL` on the DPSR grid; the port's mesh equals the numpy oracle's on
the port's own grid (`mesh_compare.assert_same_mesh`)."""

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
from slide_tpu.sap import DPSR as JDPSR
from slide_tpu.sap import network_output_to_dpsr_grid as j_network_output_to_dpsr_grid
from slide_tpu.sap.marching import marching_tetrahedra_numpy
from slide_tpu.sap.mirror import mirror_and_concat as j_mirror_and_concat
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu_torch import _build
from slide_tpu_torch.configs import (autoencoder_config, keypoint_ddpm_config,
                                     latent_ddpm_config)
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.pipeline import build_stages, generate, resolve_device, with_fastdpm
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.weights import module_to_flax
from slide_tpu_torch.sap import mesh_to_host
from mesh_compare import assert_same_mesh
from torch_port_helpers import (DECODE_ATOL, TRIM_CALLS, assert_close, narrow_sap_config,
                                perturb, record_jax_fps, replay_fps_in_port,
                                small_ae_config, to_np, trim_starts)

B, K, T = 2, 16, 4
# the grid at 32^3 (values up to ~1), behind the decoded cloud's differences:
# measured 4.6e-5
GRID_ATOL = 2e-4


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
    return {"kp": kp, "lat": lat, "ae": ae, "sap": narrow_sap_config()}


def _flax_params(module, key, *args, **kwargs):
    v = jax.jit(lambda k: module.init(k, *args, **kwargs))(key)
    return perturb(v["params"], int(jax.random.randint(key, (), 0, 1000)), scale=0.05)


def _port_params(pointnet_config, seed):
    """A `ConditionalPointNet2`'s weights drawn by the port's `init_params`
    (the JAX package's initialisers), perturbed, as the flax tree both
    packages load: no JAX init to compile."""
    net = init_params(ConditionalPointNet2(pointnet_config), torch.Generator().manual_seed(seed))
    return perturb(module_to_flax(net), seed, scale=0.05)


def _chain_draws(key, shape, steps):
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.asarray(d)) for d in draws]


@pytest.fixture(scope="module")
def narrow():
    """Narrow configs, their flax modules and perturbed flax parameters (the
    two denoisers' and the SAP net's drawn by the port, the decode's by its
    flax init)."""
    cfgs = _narrow_configs()
    label = jnp.zeros((B,), jnp.int32)
    nets = {"kp": JNet(cfgs["kp"]["pointnet_config"]),
            "lat": JNet(cfgs["lat"]["pointnet_config"]),
            "ae": j_build_ae(cfgs["ae"]["pointnet_config"]),
            "sap": JNet(cfgs["sap"]["pointnet_config"])}
    params = {
        "kp": _port_params(cfgs["kp"]["pointnet_config"], 1),
        "lat": _port_params(cfgs["lat"]["pointnet_config"], 2),
        "ae": _flax_params(nets["ae"], jax.random.key(3), jnp.zeros((B, K, 3)),
                           jnp.zeros((B, K, 16)), label=label, method=nets["ae"].decode),
        "sap": _port_params(cfgs["sap"]["pointnet_config"], 4)}
    return cfgs, nets, params


def test_slice_matches_the_jax_composition(monkeypatch, narrow):
    cfgs, nets, params = narrow
    kp_net, lat_net, jae, jsap = nets["kp"], nets["lat"], nets["ae"], nets["sap"]
    label = jnp.zeros((B,), jnp.int32)
    sap_pc = cfgs["sap"]["pointnet_config"]
    res = (cfgs["sap"]["dpsr_config"]["grid_res"],) * 3

    # the JAX composition, keys split as device_chain splits them
    ks = jax.random.split(jax.random.key(100), 4)
    calls = record_jax_fps(monkeypatch)

    def chain(ks):
        kp = j_diffusion_sampling(
            lambda x, ts: kp_net.apply({"params": params["kp"]}, x, ts=ts, label=label),
            ks[0], (B, K, 3), j_eps_sched(T, 1e-4, 0.02))
        sdc = dict(cfgs["lat"]["standard_diffusion_config"], num_diffusion_timesteps=T)
        latent = j_x0_denoise(
            lambda x, ts: lat_net.apply({"params": params["lat"]}, x, ts=ts, label=label),
            ks[1], (B, K, 19), JX0Schedule.from_config(sdc), keypoint=kp, keypoint_dim=3)
        cloud = jae.apply({"params": params["ae"]}, latent[..., :3], latent[..., 3:],
                          label=label, method=jae.decode, rngs={"fps": ks[2]})
        # e2e_pipeline.py's sap_fn
        xm = j_mirror_and_concat(cloud, axis=2, num_points=(), attach_label=True,
                                 permute=True, key=ks[3])[0]
        disp = jsap.apply({"params": params["sap"]}, xm, ts=None, label=label)
        grid, _, _ = j_network_output_to_dpsr_grid(
            xm, disp, JDPSR(res, sig=2), 1, sap_pc, last_dim_as_indicator=True,
            explicit_normalize=True)
        return kp, latent, cloud, grid

    j_kp, j_latent, j_cloud, j_grid = jax.jit(chain)(ks)
    jax.effects_barrier()
    assert len(calls) == len(TRIM_CALLS) + 6 + 4      # decode's 9, then the SAP net's 4

    stages = build_stages(B, T, ckpts=params, device="cpu", configs=cfgs)
    draws = iter(_chain_draws(ks[0], (B, K, 3), T) + _chain_draws(ks[1], (B, K, 19), T))

    def noise_fn(shape):
        d = next(draws)
        assert tuple(d.shape) == tuple(shape)
        return d

    perm = torch.as_tensor(np.array(jax.random.permutation(ks[3], j_cloud.shape[1] * 2)))
    replay = replay_fps_in_port(monkeypatch, calls, DECODE_ATOL,
                                tie_calls=range(len(calls) - 4, len(calls)))
    out = generate(stages, seed=0, noise_fn=noise_fn, start_fn=trim_starts(calls), perm=perm)
    assert next(replay, None) is None and next(draws, None) is None
    np.testing.assert_allclose(to_np(out["keypoints"]), np.asarray(j_kp), atol=1e-4)
    np.testing.assert_allclose(to_np(out["features"]), np.asarray(j_latent[..., 3:]),
                               atol=1e-4)
    assert out["cloud"].shape == (B, 200, 6)
    assert_close(j_cloud, out["cloud"], DECODE_ATOL)
    assert out["grid"].shape == (B, *res)
    np.testing.assert_allclose(to_np(out["grid"]), np.asarray(j_grid), atol=GRID_ATOL, rtol=0)

    # the mesh of each sample is the numpy oracle's on the port's grid
    assert out["points"].shape == (B, 2048, 3) and torch.isfinite(out["points"]).all()
    for i in range(B):
        want = marching_tetrahedra_numpy(to_np(out["grid"][i]))
        assert int(out["n_faces"][i]) == len(want[1])
        assert_same_mesh(mesh_to_host(out["mesh"], i), want, scale=float(res[0]))


def test_generate_full_width_on_the_cpu():
    # the shipped presets and the committed checkpoints, T cut to 2
    stages = build_stages(1, t_steps=2, device="cpu")
    before = _build.launch_counts["fps"]
    out = generate(stages, seed=3)
    assert out["cloud"].shape == (1, 2048, 6)
    assert out["keypoints"].shape == (1, 16, 3) and out["features"].shape == (1, 16, 48)
    assert torch.isfinite(out["cloud"]).all()
    assert out["grid"].shape == (1, 128, 128, 128) and torch.isfinite(out["grid"]).all()
    assert out["points"].shape == (1, 2048, 3) and torch.isfinite(out["points"]).all()
    norms = torch.linalg.vector_norm(out["normals"], dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    assert int(out["n_faces"][0]) > 0 and int(out["n_cells"][0]) > 0
    assert set(out["seconds"]) == {"position_ddpm", "feature_ddpm", "ae_decode",
                                   "sap_dpsr", "marching"}
    assert _build.launch_counts["fps"] == before   # the CPU runs the plain FPS


def test_generate_is_reproducible_from_its_seed(narrow):
    cfgs, _, params = narrow
    stages = build_stages(B, 3, ckpts=params, device="cpu", configs=cfgs)
    a, b, c = generate(stages, 5), generate(stages, 5), generate(stages, 6)
    for key in ("cloud", "grid", "points", "normals"):
        assert torch.equal(a[key], b[key])
        assert not torch.equal(a[key], c[key])


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
    assert out["points"].shape == (1, 2048, 3) and torch.isfinite(out["points"]).all()
