"""Feature (latent) DDPM training in the port (`diffusion/latent.py`,
`train/driver.py::train_latent_ddpm`) against the JAX package on the CPU: a
narrow latent denoiser over `train_ae_config`'s frozen autoencoder, except the
checkpoint tests, which use the shipped presets.

One jitted step of the JAX package's `make_latent_train_step` (the
denoiser as the flax module) gives the reference; its posterior noises are
recorded and its timesteps and noise drawn again from its keys.  The port
runs the same step through the fused net's plain version (the CPU side of
K1 + K2) and through the module.  Tolerances: the loss 1e-5 relative; Adam's
moments at the JAX package's fused-vs-flax gradient tolerance (rtol 5e-3,
atol 1e-4; the first moment is 0.1 g, so its atol is scaled by 0.1); the
parameters 1e-6 where |g| > 1e-3, else within 2 lr."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.diffusion import X0Schedule as JX0Schedule
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu.train import checkpoint as jckpt
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import latent_ddpm_config
from slide_tpu_torch.diffusion import X0Schedule, latent_config_weights, latent_train_loss
from slide_tpu_torch.models import fused_denoiser as tf
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train.checkpoint import find_max_iter
from slide_tpu_torch.weights import (flax_leaves, load_flax_params, module_to_flax,
                                     read_checkpoint)
from torch_port_helpers import (assert_one_adam_step, perturb, record_jax_posterior_noise,
                                train_ae_config)

B, N, K = 2, 200, 16
LR = 2e-4
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow_latent_config():
    """The latent preset over `train_ae_config` (latent width 16), its
    denoiser narrow, at 16 keypoints."""
    cfg = latent_ddpm_config("airplane", batch_size=B)
    cfg["autoencoder_config"]["pointnet_config"] = train_ae_config()
    pc = cfg["pointnet_config"]
    pc.update(in_fea_dim=16, out_dim=19, t_dim=16, class_condition_dim=16)
    pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                              mlp_depth=2, decoder_mlp_depth=2, nsample=[6, 16])
    cfg["shapenet_psr_dataset_config"].update(npoints=N)
    return cfg


def _cloud(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.2, 0.5, (b, 1, 3))
    return (d * axes).astype(np.float32), (d / axes * 1.7).astype(np.float32)


def _perturbed(module, seed, scale=0.1):
    tdriver.init_params(module, torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(module), seed, scale=scale)
    load_flax_params(module, params)
    return params


@pytest.fixture(scope="module")
def latent_step():
    """One jitted step of the JAX package's latent train step on a batch,
    with the draws it made: the posterior noises (recorded), the timesteps
    and the noise (drawn again from its keys)."""
    cfg = _narrow_latent_config()
    sdc = cfg["standard_diffusion_config"]
    trainset = cfg["shapenet_psr_dataset_config"]
    net = tm.ConditionalPointNet2(cfg["pointnet_config"])
    params = _perturbed(net, 0)
    ae = tm.build_autoencoder(cfg["autoencoder_config"]["pointnet_config"])
    ae_params = _perturbed(ae, 1, scale=0.05)
    points, normals = _cloud(3)
    label = np.array([0, 4], np.int32)
    batch = {"points": jnp.asarray(points), "normals": jnp.asarray(normals),
             "label": jnp.asarray(label)}
    opt = optax.adam(LR)
    rates = (0.999,)
    jstep = jdriver.make_latent_train_step(
        JNet(cfg["pointnet_config"]), j_build_ae(cfg["autoencoder_config"]["pointnet_config"]),
        ae_params, JX0Schedule.from_config(sdc), sdc, opt, rates, trainset)
    key = jax.random.key(7)
    mp = pytest.MonkeyPatch()
    try:
        noises = record_jax_posterior_noise(mp)
        jnew, jloss = jax.jit(jstep)(jdriver._init_state(params, opt, rates), batch, key)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert len(noises) == 2
    _, k_loss = jax.random.split(key)
    _, k_t, k_z = jax.random.split(k_loss, 3)
    ts = np.asarray(jax.random.randint(k_t, (B,), 0, sdc["num_diffusion_timesteps"]))
    z = np.asarray(jax.random.normal(k_z, (B, K, 19)))
    return dict(cfg=cfg, params=params, ae=ae.eval().requires_grad_(False), points=points,
                normals=normals, label=label, noises=noises, ts=ts, z=z, jnew=jnew,
                jloss=jloss, rates=rates)


def _draws(case):
    return {"posterior": [torch.tensor(n) for n in case["noises"]],
            "ts": torch.tensor(case["ts"]), "z": torch.tensor(case["z"])}


def _batch(case):
    return {"points": torch.tensor(case["points"]), "normals": torch.tensor(case["normals"]),
            "label": torch.tensor(case["label"], dtype=torch.int64)}


@pytest.mark.parametrize("path", ["module", "fused_plain"])
def test_latent_train_loss_matches_jax(latent_step, path):
    # the same latent, timesteps and noise through the denoiser module and
    # through the fused net's plain version (K1 and K2's CPU side)
    case = latent_step
    cfg = case["cfg"]
    sdc = cfg["standard_diffusion_config"]
    net = load_flax_params(tm.ConditionalPointNet2(cfg["pointnet_config"]), case["params"])
    batch, draws = _batch(case), _draws(case)
    kp = tdriver.sample_train_keypoints(batch["points"], cfg["shapenet_psr_dataset_config"])
    x = torch.cat([batch["points"], batch["normals"]], dim=-1)
    noises = iter(draws["posterior"])
    fused = tf.make_fused_train_fn(cfg["pointnet_config"], net, K)

    def net_fn(xt, ts):
        if path == "module":
            return net(xt, ts=ts, label=batch["label"])
        return fused(xt, ts, batch["label"])

    kp_w, feat_w = latent_config_weights(sdc)
    assert (kp_w, feat_w) == (0.0, 1.0)
    per_cloud = latent_train_loss(
        net_fn, lambda xx, k, lbl: case["ae"].encode(xx, k, label=lbl,
                                                    noise_fn=lambda s: next(noises)),
        x, kp, batch["label"], X0Schedule.from_config(sdc), keypoint_conditional=True,
        keypoint_position_loss_weight=kp_w, feature_loss_weight=feat_w,
        ts=draws["ts"], z=draws["z"])
    assert per_cloud.shape == (B,)
    np.testing.assert_allclose(float(per_cloud.mean().detach()), float(case["jloss"]), rtol=1e-5)


def test_latent_train_step_matches_optax(latent_step):
    case = latent_step
    cfg = case["cfg"]
    net = load_flax_params(tm.ConditionalPointNet2(cfg["pointnet_config"]), case["params"])
    state = tdriver._new_state(net, {"learning_rate": LR, "ema_rate": case["rates"]})
    step = tdriver.make_latent_train_step(
        net, case["ae"], X0Schedule.from_config(cfg["standard_diffusion_config"]),
        cfg["standard_diffusion_config"], cfg["shapenet_psr_dataset_config"],
        fused_apply=tf.make_fused_train_fn(cfg["pointnet_config"], net, K))
    loss = step(state, _batch(case), torch.Generator(), draws=_draws(case))
    np.testing.assert_allclose(float(loss), float(case["jloss"]), rtol=1e-5)
    jnew = case["jnew"]
    assert_one_adam_step(state, jnew.params, jnew.opt_state, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the EMA shadow: one update from the starting parameters
    want_ema = jax.tree.leaves(jnew.ema[0])
    for g, w in zip(flax_leaves(tdriver._ema_trees(state)[0]), want_ema):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=0)


def test_latent_checkpoints_both_ways(tmp_path):
    from slide_tpu.cli.main import load_inference_params as j_load_inference
    cfg = latent_ddpm_config()["pointnet_config"]
    rates = (0.999, 0.9999)
    # the JAX package's: the committed latent checkpoint, parameters, Adam
    # state and EMA shadows
    ckpt = read_checkpoint(str(DEFAULT_CKPTS["lat"]))
    net = tm.ConditionalPointNet2(cfg)
    state = tdriver._new_state(net, {"learning_rate": LR, "ema_rate": rates})
    tdriver.load_adam_state(state, ckpt["optimizer_state_dict"])
    load_flax_params(net, ckpt["model_state_dict"])
    tdriver._load_ema(state, ckpt["ema_state_list"])
    for a, b in zip(flax_leaves(tdriver.adam_state_tree(state)),
                    flax_leaves(ckpt["optimizer_state_dict"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(flax_leaves(tdriver._ema_trees(state)), flax_leaves(ckpt["ema_state_list"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's, read by the JAX package
    tdriver._save(state, str(tmp_path), 9, 1, None)
    jc = jckpt.load_checkpoint(str(tmp_path))
    assert jc["iter"] == 9 and len(jc["ema_state_list"]) == 2
    fresh = jax.eval_shape(optax.adam(LR).init, jc["model_state_dict"])
    saved = jax.tree.leaves(jc["optimizer_state_dict"])
    assert [np.shape(s) for s in saved] == [np.shape(f) for f in jax.tree.leaves(fresh)]
    for a, b in zip(jax.tree.leaves(j_load_inference(str(tmp_path / "pointnet_ckpt_9.pkl"), 1)),
                    flax_leaves(ckpt["ema_state_list"][1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_latent_ddpm_checkpoints_and_resumes(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=4,
                                              num_points=600, with_psr=False)
    cfg = _narrow_latent_config()
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    ae = tm.build_autoencoder(cfg["autoencoder_config"]["pointnet_config"])
    ae_params = _perturbed(ae, 1, scale=0.05)
    state, losses = tdriver.train_latent_ddpm(cfg, ae_params, data_dir=root, max_iters=3,
                                              device="cpu", verbose=False)
    assert [i for i, _ in losses] == [0, 1, 2] and np.isfinite([l for _, l in losses]).all()
    assert state.step == 3 and state.ema_rates == (0.999, 0.9999)
    ckpt_dir = str(tmp_path / "exp" / "T1000_betaT0.02_latent_ddpm_airplane" / "checkpoint")
    assert sorted(os.listdir(ckpt_dir)) == ["pointnet_ckpt_1.pkl", "pointnet_ckpt_2.pkl"]
    state2, losses2 = tdriver.train_latent_ddpm(cfg, ae_params, data_dir=root, max_iters=4,
                                                device="cpu", verbose=False)
    assert losses2[0][0] == 3 and state2.step == 4 and find_max_iter(ckpt_dir) == 3
    # the JAX package would resume from it, EMA shadows included
    ckpt = jckpt.load_checkpoint(ckpt_dir)
    assert ckpt["iter"] == 3 and len(ckpt["ema_state_list"]) == 2
    # activation_dtype (tests/test_torch_conditional.py) and the corpus on
    # the device are ported: the loader run's checkpoint resumes under
    # device_data (tests/test_torch_device_corpus.py)
    dev_cfg = copy.deepcopy(cfg)
    dev_cfg["train_config"]["device_data"] = True
    state3, losses3 = tdriver.train_latent_ddpm(dev_cfg, ae_params, data_dir=root, max_iters=6,
                                                device="cpu", verbose=False)
    assert [i for i, _ in losses3] == [4, 5] and np.isfinite([l for _, l in losses3]).all()
    assert state3.step == 6 and find_max_iter(ckpt_dir) == 5
