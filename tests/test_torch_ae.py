"""The point autoencoder in the port (`nn/pnet.py`, `models/encoder.py`,
`models/upsample_decoder.py`, `models/autoencoder.py`, `ops/chamfer.py`,
`train/driver.py::train_autoencoder`) against the JAX package on the CPU:
the blocks at `small_ae_config`'s narrow widths, the round trip, its
gradient and a train step at `train_ae_config` (where fp32 itself agrees
with float64, see there), the encode at full width with the committed
checkpoint.  JAX's FPS picks and starts and its posterior noises are
replayed into the port (`replay_fps_in_port`, `record_jax_posterior_noise`).

Tolerances: blocks atol 5e-5 (+ rtol 1e-5), the gap of a few fp32 layers
whose sums run in another order; the narrow encoder 3e-4 (ENC_ATOL, from
its measured gap); chamfer values 1e-6 and gradients 1e-5 (a handful of
fp32 operations); the round trip's clouds and features 5e-5 and its losses
1e-5 relative; the loss gradient rtol 5e-3, atol 1e-4 (the JAX package's
own fused-vs-flax gradient tolerance); the step's Adam moments at that
gradient tolerance (the first moment is 0.1 g: its atol scaled by 0.1) and
its parameters 1e-6 where the gradient's sign is beyond doubt (|g| > 1e-3),
else within the 2 lr that a sign decided otherwise could move them; the
full-width encode against its float64 run and JAX within bounds set from
their measured gaps (FULL_ENCODE_F64_ATOL, FULL_ENCODE_ATOL)."""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.configs import autoencoder_config as j_ae_config
from slide_tpu.models.encoder import PointNetEncoder as JEncoder
from slide_tpu.models.upsample_decoder import PointUpsampleDecoder as JLevel
from slide_tpu.nn.pnet import PNet2Stage as JPNet
from slide_tpu.ops import chamfer as jchamfer
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu.train import checkpoint as jckpt
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import autoencoder_config
from slide_tpu_torch.nn.pnet import PNet2Stage
from slide_tpu_torch.ops import chamfer as tchamfer
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train.checkpoint import find_max_iter
from slide_tpu_torch.weights import (flax_leaves, load_flax_params, module_to_flax,
                                     read_checkpoint)
from torch_port_helpers import (DECODE_ATOL, assert_close, assert_one_adam_step,
                                assert_trees_close, perturb, record_jax_fps,
                                record_jax_posterior_noise, replay_fps_in_port,
                                small_ae_config, to_np, train_ae_config)

ATOL = 5e-5
# the narrow encoder's four SA levels end in GroupNorms over 8 centers x 4
# neighbours: JAX lies 1.6e-4 from the port's float64 forward there, the port
# 6.7e-5 (features up to ~3); the two fp32 runs 1.2e-4 apart
ENC_ATOL = 3e-4
# the shipped encoder at 2048 points, features up to ~3.5 (batch 2): the port
# lies 8.0e-6 from its float64 run (1.8e-3 while GroupNorm summed its
# statistics in fp32), JAX 4.3e-3; port and JAX 4.3e-3 apart
FULL_ENCODE_ATOL, FULL_ENCODE_F64_ATOL = 1e-2, 5e-5
GRAD_RTOL, GRAD_ATOL = 5e-3, 1e-4
LR = 1e-3
B, N, K = 2, 200, 16
# the positions of the trims and of the targets among the FPS calls of
# `train_ae_config`'s forward: the encoder's two SA levels, the keypoint
# level's trim, the decoder level's two SA levels and trim, the targets
START_CALLS = (2, 5, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # narrow nets: one thread runs them as fast and leaves the cores to the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _cloud(seed, b=B, n=N):
    """Points on ellipsoids with their unit normals: (b, n, 6)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    axes = rng.uniform(0.2, 0.5, (b, 1, 3))
    nrm = d / axes
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return np.concatenate([d * axes, nrm], axis=-1).astype(np.float32)


def _grads_tree(module):
    return module_to_flax(module, {n: p.grad for n, p in module.named_parameters()})


# ---------------------------------------------------------------------------
# The blocks


def _pair(jmod, tmod, args, kwargs=None, *, seed=0, method=None):
    """Draw the port module's weights, move them off their init values, run
    the flax module on the same weights (one compile) and the port: (JAX
    outputs, port outputs, params)."""
    kwargs = kwargs or {}
    tdriver.init_params(tmod, torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(tmod), seed)
    load_flax_params(tmod, params)
    jargs = [jnp.asarray(a) for a in args]
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    jout = jax.jit(lambda p: jmod.apply({"params": p}, *jargs, method=method, **jkw))(params)
    with torch.no_grad():
        tout = tmod(*[torch.as_tensor(a) for a in args],
                    **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    return jout, tout, params


@pytest.mark.parametrize("remove_last_activation", [True, False])
def test_pnet2stage_matches_jax(remove_last_activation):
    x = _x(0, 2, 24, 6)
    jout, tout, _ = _pair(JPNet((6, 16, 32), (40, 24),
                                remove_last_activation=remove_last_activation),
                          PNet2Stage((6, 16, 32), (40, 24),
                                     remove_last_activation=remove_last_activation), [x])
    assert tout.shape == (2, 24)
    assert_close(jout, tout, ATOL)


@pytest.mark.parametrize("level", ["encoder", "keypoint_level"])
def test_point_net_encoder_matches_jax(level):
    # the AE's encoder (class condition, normals as features) and the
    # keypoint level's backbone (the global PNet feature as the condition,
    # the class as the second condition, no input features)
    cfg = small_ae_config()
    cfg = cfg["encoder_config"] if level == "encoder" else cfg["decoder_config_list"][0]
    assert cfg.get("include_global_feature", False) == (level == "keypoint_level")
    x = _cloud(1) if level == "encoder" else _x(1, B, K, 3, scale=0.4)
    label = np.array([0, 5], np.int32)
    jout, tout, _ = _pair(JEncoder(cfg), tm.PointNetEncoder(cfg), [x], {"label": label})
    assert len(tout[1]) == len(cfg["architecture"]["npoint"]) + 1
    assert_close(jout[0], tout[0], ENC_ATOL)
    assert_close(list(jout[1]), list(tout[1]), 0.0, rtol=0.0)     # FPS picks: equal
    assert_close(list(jout[2][1:]), list(tout[2][1:]), ENC_ATOL)


def test_encoder_rejects_unported_options():
    cfg = copy.deepcopy(autoencoder_config()["pointnet_config"]["encoder_config"])
    cfg["use_position_encoding"] = True
    with pytest.raises(NotImplementedError, match="use_position_encoding"):
        tm.PointNetEncoder(cfg)


def _chamfer_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 30, 6)).astype(np.float32)
    y = rng.standard_normal((2, 25, 6)).astype(np.float32)
    y[:, 3] = x[:, 7]                 # exactly coincident points (distance 0)
    x[0, 2, :3] = 0.0                 # x[0, 2]'s two nearest tie exactly
    y[0, 4, :3] = [0.01, 0.02, 0.03]
    y[0, 5, :3] = [-0.01, -0.02, -0.03]
    y[1, 9:11] = y[1, 8]              # three copies: a tie for whoever is nearest
    return x, y


@pytest.mark.parametrize("normal_loss_type", ["cos", "mse"])
def test_chamfer_values_and_gradients_match_jax(normal_loss_type):
    x, y = _chamfer_inputs()
    keys = ("cd_p", "cd_t", "cd_feature_p", "cd_feature_t", "f1")
    w = dict(zip(keys, _x(3, len(keys)).tolist()))

    def j_obj(a, b):
        r = jchamfer.calc_cd(a, b, calc_f1=True, f1_threshold=0.3,
                             normal_loss_type=normal_loss_type)
        return sum(jnp.sum(v * w[k]) for k, v in r.items()), r

    (jval, jres), jgrad = jax.jit(jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True))(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.as_tensor(x).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    tres = tchamfer.calc_cd(xt, yt, calc_f1=True, f1_threshold=0.3,
                            normal_loss_type=normal_loss_type)
    assert sorted(tres) == sorted(jres) == sorted(keys)
    sum(torch.sum(v * w[k]) for k, v in tres.items()).backward()
    for key in jres:
        np.testing.assert_allclose(to_np(tres[key]), np.asarray(jres[key]), atol=1e-6,
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad[0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(jgrad[1]), atol=1e-5, rtol=1e-5)
    # the parts: the same picks (ties to the lowest index), exact distances
    jp = jchamfer.chamfer_parts(jnp.asarray(x[..., :3]), jnp.asarray(y[..., :3]))
    tp = tchamfer.chamfer_parts(torch.as_tensor(x[..., :3]), torch.as_tensor(y[..., :3]))
    for key in ("idx_x", "idx_y"):
        np.testing.assert_array_equal(to_np(tp[key]), np.asarray(jp[key]))
    assert int(tp["idx_x"][0, 2]) == 4 and float(tp["dist_y"][0, 3]) == 0.0
    f, p1, p2 = tchamfer.fscore(torch.zeros(2, 4) + 1.0, torch.zeros(2, 5) + 1.0)
    assert f.tolist() == [0.0, 0.0] and p1.tolist() == p2.tolist() == [0.0, 0.0]


@pytest.fixture(scope="module")
def kl_level():
    """The keypoint level with KL and perturbed weights, its inputs, and the
    JAX level's features and KL with the posterior's mode and sampled (its
    two noises recorded)."""
    cfg = small_ae_config()
    level = cfg["decoder_config_list"][0]
    in_dim = cfg["encoder_config"]["architecture"]["feature_dim"][-1]
    xyz, feat = _x(4, B, 8, 3, scale=0.4), _x(5, B, 8, in_dim)
    kp, label = _x(6, B, K, 3, scale=0.4), np.array([1, 2], np.int32)
    tlevel = tm.PointUpsampleDecoder(level, in_dim, apply_kl_regularization=True)
    tdriver.init_params(tlevel, torch.Generator().manual_seed(4))
    params = perturb(module_to_flax(tlevel), 4, scale=0.05)
    load_flax_params(tlevel, params)
    jlevel = JLevel(level, in_dim, apply_kl_regularization=True)
    args = [jnp.asarray(a) for a in (xyz, feat, kp)]

    def both(p):
        return [jlevel.apply({"params": p}, *args, label=jnp.asarray(label),
                             sample_posterior=sample, rngs={"gaussian": jax.random.key(2)},
                             method=jlevel.propagate_feature) for sample in (False, True)]

    mp = pytest.MonkeyPatch()
    try:
        noises = record_jax_posterior_noise(mp)
        want = jax.jit(both)(params)
        jax.effects_barrier()
    finally:
        mp.undo()
    assert len(noises) == 2
    return dict(tlevel=tlevel, args=[torch.as_tensor(a) for a in (xyz, feat, kp)],
                label=torch.as_tensor(label), want=want, noises=noises)


@pytest.mark.parametrize("sample_posterior", [False, True])
def test_propagate_feature_with_kl_matches_jax(kl_level, sample_posterior):
    # the keypoint level with KL: the port on JAX's posterior noise gives
    # JAX's sampled features and KL; zero noise gives the posterior's mode
    case = kl_level
    tlevel, targs, tlabel = case["tlevel"], case["args"], case["label"]
    jfeat, jkl = case["want"][int(sample_posterior)]
    with torch.no_grad():
        if sample_posterior:
            it = iter(case["noises"])
            tfeat, tkl = tlevel.propagate_feature(*targs, label=tlabel,
                                                  noise_fn=lambda s: torch.as_tensor(next(it)))
        else:
            tfeat, tkl = tlevel.propagate_feature(*targs, label=tlabel,
                                                  noise_fn=lambda s: torch.zeros(s))
            mode, mode_kl = tlevel.propagate_feature(*targs, label=tlabel,
                                                     sample_posterior=False)
            assert torch.equal(mode, tfeat) and torch.equal(mode_kl, tkl)
    assert tfeat.shape == (B, K, 16) and tkl.shape == (B,)
    assert_close(jfeat, tfeat, ATOL)
    assert_close(jkl, tkl, ATOL)


# ---------------------------------------------------------------------------
# The autoencoder: encode, the round trip's losses and their gradient, a step


def _perturbed_ae_params(cfg, seed):
    ae = tdriver.init_params(tm.build_autoencoder(cfg), torch.Generator().manual_seed(seed))
    return perturb(module_to_flax(ae), seed, scale=0.05)


@pytest.fixture(scope="module")
def round_trip():
    """`train_ae_config` with perturbed weights, a batch, and the JAX
    package's AE train step (`train/driver.py::make_ae_train_step`: unit
    normals, noisy keypoints, the round trip with the posterior sampled and
    random FPS starts, the loss's gradient, optax's Adam) in one jitted
    function that also returns the round trip's clouds, losses and keypoint
    features; its FPS calls, posterior noises and keypoint noise recorded."""
    cfg = train_ae_config()
    jae = j_build_ae(cfg)
    cloud = _cloud(7)
    trainset = autoencoder_config()["shapenet_psr_dataset_config"]
    label = np.array([0, 3], np.int32)
    params = _perturbed_ae_params(cfg, 0)
    normals = cloud[..., 3:] * np.float32(1.7)        # the step normalises them
    key = jax.random.key(5)
    k_kp, k_g, k_f = jax.random.split(key, 3)

    def step_body(p):
        # make_ae_train_step's body, with the round trip's outputs kept
        points, nrm = jnp.asarray(cloud[..., :3]), jnp.asarray(normals)
        nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)
        keypoints = jdriver.sample_train_keypoints(points, trainset, k_kp)
        x = jnp.concatenate([points, nrm], axis=-1)

        def loss_fn(q):
            l_xyz, loss_list, feat = jae.apply(
                {"params": q}, x, keypoints, label=jnp.asarray(label), loss_type="cd_p",
                rngs={"gaussian": k_g, "fps": k_f}, return_keypoint_feature=True)
            return sum(jnp.mean(ld["training_loss"]) for ld in loss_list), \
                (l_xyz, loss_list, feat)

        return jax.value_and_grad(loss_fn, has_aux=True)(p), keypoints

    mp = pytest.MonkeyPatch()
    try:
        calls = record_jax_fps(mp)
        noises = record_jax_posterior_noise(mp)
        ((loss, (l_xyz, loss_list, feat)), grads), kp = jax.jit(step_body)(params)
        jax.effects_barrier()
    finally:
        mp.undo()
    opt = optax.adam(LR)

    @jax.jit
    def adam_step(g, p):
        updates, opt_state = opt.update(g, opt.init(p), p)
        return optax.apply_updates(p, updates), opt_state

    new_params, opt_state = adam_step(grads, params)
    kp_noise = np.asarray(jax.random.normal(jax.random.split(k_kp)[1], (B, K, 3)))
    return dict(cfg=cfg, cloud=cloud, normals=normals, kp=np.asarray(kp), label=label,
                params=params, trainset=trainset, calls=calls, noises=noises,
                kp_noise=kp_noise, loss=loss, l_xyz=l_xyz, loss_list=loss_list, feat=feat,
                grads=grads, new_params=new_params, opt_state=opt_state)


def _port_ae(case):
    ae = tm.build_autoencoder(case["cfg"])
    load_flax_params(ae, case["params"])
    return ae


def _step_draws(case):
    calls = case["calls"]
    return {"keypoint_noise": torch.tensor(case["kp_noise"]),
            "posterior": [torch.tensor(n) for n in case["noises"]],
            "fps_starts": [calls[i][1] for i in START_CALLS]}


def _batch(case):
    return {"points": torch.tensor(case["cloud"][..., :3]),
            "normals": torch.tensor(case["normals"]),
            "label": torch.tensor(case["label"], dtype=torch.int64)}


def test_ae_encode_and_losses_match_jax(monkeypatch, round_trip):
    # on the JAX step's input and draws: its two posterior noises, its FPS
    # starts (the trims' and the targets') and picks
    case = round_trip
    calls = case["calls"]
    assert len(calls) == 7 and len(case["noises"]) == 2
    assert all(calls[i][1].any() for i in START_CALLS)
    ae = _port_ae(case)
    x = torch.tensor(np.concatenate([case["cloud"][..., :3], case["cloud"][..., 3:]], -1))
    kp, label = torch.tensor(case["kp"]), torch.tensor(case["label"])
    noises = [torch.as_tensor(n) for n in case["noises"]]
    n_enc = len(case["cfg"]["encoder_config"]["architecture"]["npoint"])
    replay = replay_fps_in_port(monkeypatch, calls[:n_enc] * 2, DECODE_ATOL)
    with torch.no_grad():
        it = iter(noises)
        feat = ae.encode(x, kp, label=label, noise_fn=lambda s: next(it))
        mode = ae.encode(x, kp, label=label, sample_posterior=False)
    assert next(replay, None) is None
    assert feat.shape == (B, K, 16) and not torch.equal(feat, mode)
    assert_close(case["feat"], feat, ATOL)

    replay = replay_fps_in_port(monkeypatch, calls, DECODE_ATOL)
    starts = iter(_step_draws(case)["fps_starts"])
    with torch.no_grad():
        it = iter(noises)
        l_xyz, loss_list = ae(x, kp, label=label, noise_fn=lambda s: next(it),
                              start_fn=lambda b, n: torch.as_tensor(next(starts)))
    assert next(replay, None) is None
    assert [tuple(c.shape) for c in l_xyz[1:]] == [(B, 64, 6), (B, 200, 6)]
    assert_close(list(case["l_xyz"]), l_xyz, ATOL)
    assert len(loss_list) == len(case["loss_list"]) == 2
    for i, (want, got) in enumerate(zip(case["loss_list"], loss_list)):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"level {i + 1} {key}")
    assert float(loss_list[-1]["kl_loss"].abs().min()) > 0 and \
        float(loss_list[0]["kl_loss"].abs().max()) == 0.0


def test_ae_loss_gradient_matches_jax(monkeypatch, round_trip):
    case = round_trip
    ae = _port_ae(case)
    replay = replay_fps_in_port(monkeypatch, case["calls"], DECODE_ATOL)
    batch, draws = _batch(case), _step_draws(case)
    normals = batch["normals"] / torch.linalg.vector_norm(batch["normals"], dim=-1,
                                                          keepdim=True)
    kp = tdriver.sample_train_keypoints(batch["points"], case["trainset"],
                                        noise=draws["keypoint_noise"])
    np.testing.assert_allclose(kp.numpy(), case["kp"], atol=1e-6)
    noises, starts = iter(draws["posterior"]), iter(draws["fps_starts"])
    _, loss_list = ae(torch.cat([batch["points"], normals], dim=-1), kp, label=batch["label"],
                      noise_fn=lambda s: next(noises),
                      start_fn=lambda b, n: torch.as_tensor(next(starts)))
    loss = sum(ld["training_loss"].mean() for ld in loss_list)
    loss.backward()
    assert next(replay, None) is None
    np.testing.assert_allclose(float(loss.detach()), float(case["loss"]), rtol=1e-5)
    assert_trees_close(_grads_tree(ae), case["grads"], rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_ae_train_step_matches_optax(monkeypatch, round_trip):
    # one step of the port on the JAX step's batch, weights and draws
    case = round_trip
    ae = _port_ae(case)
    state = tdriver._new_state(ae, {"learning_rate": LR})
    replay = replay_fps_in_port(monkeypatch, case["calls"], DECODE_ATOL)
    step = tdriver.make_ae_train_step(ae, case["trainset"])
    loss = step(state, _batch(case), torch.Generator(), draws=_step_draws(case))
    assert next(replay, None) is None
    np.testing.assert_allclose(float(loss), float(case["loss"]), rtol=1e-5)
    assert_one_adam_step(state, case["new_params"], case["opt_state"])


# ---------------------------------------------------------------------------
# Full width, checkpoints, the driver


def test_full_width_encode_with_the_committed_checkpoint():
    # the shipped AE's encoder and keypoint level at 2048 points: its first
    # layers normalise groups of one channel, so fp32 itself carries the
    # features ~1e-3 from float64; the port is held to its own float64 run
    # and to JAX, each within a bound set from their measured gaps
    cfg = autoencoder_config()["pointnet_config"]
    params = read_checkpoint(str(DEFAULT_CKPTS["ae"]))["model_state_dict"]
    cloud = _cloud(9, b=2, n=2048)
    kp = np.asarray(jdriver.sample_train_keypoints(
        jnp.asarray(cloud[..., :3]), autoencoder_config()["shapenet_psr_dataset_config"],
        jax.random.key(0)))
    label = np.zeros(2, np.int32)
    jae = j_build_ae(j_ae_config()["pointnet_config"])
    want = jax.jit(lambda p: jae.apply({"params": p}, jnp.asarray(cloud), jnp.asarray(kp),
                                       label=jnp.asarray(label), sample_posterior=False,
                                       method=jae.encode))(
        jax.tree_util.tree_map(jnp.asarray, params))
    ae = tm.build_autoencoder(cfg)
    load_flax_params(ae, params)       # strict: every leaf, encoder included
    args = (torch.tensor(cloud), torch.tensor(kp))
    with torch.no_grad():
        got = ae.encode(*args, label=torch.as_tensor(label), sample_posterior=False)
        got64 = ae.double().encode(*(a.double() for a in args), label=torch.as_tensor(label),
                                   sample_posterior=False)
    assert got.shape == (2, K, 48)
    want, got, got64 = np.asarray(want), to_np(got), to_np(got64)
    print(f"full-width encode (features to {np.abs(got64).max()}): port vs jax "
          f"{np.abs(got - want).max()}, port vs float64 {np.abs(got - got64).max()}, "
          f"jax vs float64 {np.abs(want - got64).max()}")
    np.testing.assert_allclose(got, got64, atol=FULL_ENCODE_F64_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=FULL_ENCODE_ATOL, rtol=0)


def _ae_state(cfg, seed):
    ae = tm.build_autoencoder(cfg)
    tdriver.init_params(ae, torch.Generator().manual_seed(seed))
    return tdriver._new_state(ae, {"learning_rate": LR})


def test_ae_checkpoints_both_ways(tmp_path):
    from slide_tpu.cli.main import load_inference_params as j_load_inference
    cfg = autoencoder_config()["pointnet_config"]
    # the JAX package's: the committed checkpoint, parameters and Adam state
    ckpt = read_checkpoint(str(DEFAULT_CKPTS["ae"]))
    state = _ae_state(cfg, 0)
    tdriver.load_adam_state(state, ckpt["optimizer_state_dict"])
    load_flax_params(state.net, ckpt["model_state_dict"])
    for a, b in zip(flax_leaves(tdriver.adam_state_tree(state)),
                    flax_leaves(ckpt["optimizer_state_dict"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's, read by the JAX package (no EMA: the AE preset has none)
    gen = torch.Generator().manual_seed(1)
    for p in state.net.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    tdriver._save(state, str(tmp_path), 4, 2, None)
    jc = jckpt.load_checkpoint(str(tmp_path))
    assert jc["iter"] == 4 and "ema_state_list" not in jc
    fresh = jax.eval_shape(optax.adam(LR).init, jc["model_state_dict"])
    saved = jax.tree.leaves(jc["optimizer_state_dict"])
    assert [np.shape(s) for s in saved] == [np.shape(f) for f in jax.tree.leaves(fresh)]
    jax.tree.unflatten(jax.tree.structure(fresh), saved)
    assert_trees_close(module_to_flax(state.net),
                        j_load_inference(str(tmp_path / "pointnet_ckpt_4.pkl")), 0, 0)


def _tiny_ae_config(tmp_path):
    cfg = autoencoder_config("airplane", batch_size=2)
    cfg["pointnet_config"] = small_ae_config()
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, npoints=N)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    return cfg


def test_train_autoencoder_checkpoints_and_resumes(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=4,
                                              num_points=600, with_psr=False)
    cfg = _tiny_ae_config(tmp_path)
    state, losses = tdriver.train_autoencoder(cfg, data_dir=root, max_iters=3,
                                              device="cpu", verbose=False)
    assert [i for i, _ in losses] == [0, 1, 2] and np.isfinite([l for _, l in losses]).all()
    assert state.step == 3 and state.ema_rates == ()
    ckpt_dir = str(tmp_path / "exp" / "ae_airplane_kl_1e-5_latent_16_32" / "checkpoint")
    assert sorted(os.listdir(ckpt_dir)) == ["pointnet_ckpt_1.pkl", "pointnet_ckpt_2.pkl"]
    # resumed, with the checkpoint-time evaluation: the step to 4 ends an
    # epoch, a checkpoint of the cadence, and the hook writes the JAX
    # package's files
    state2, losses2 = tdriver.train_autoencoder(cfg, data_dir=root, max_iters=4,
                                                device="cpu", eval_hook="auto", verbose=False)
    assert losses2[0][0] == 3 and state2.step == 4 and find_max_iter(ckpt_dir) == 3
    out = str(tmp_path / "exp" / "ae_airplane_kl_1e-5_latent_16_32" / "eval_result")
    quantitative = "shapenet_psr_autoencoder_quantitative_eval_result.pkl"
    assert sorted(os.listdir(out)) == [
        "shapenet_psr_autoencoder_visualization_result_iteration_00000003_epoch_0000.pkl",
        "trainset_eval", "valset_eval", "valset_eval_keypoint_noise_0"]
    for sub in ("trainset_eval", "valset_eval", "valset_eval_keypoint_noise_0"):
        assert os.listdir(os.path.join(out, sub)) == [quantitative]
        with open(os.path.join(out, sub, quantitative), "rb") as f:
            history = pickle.load(f)
        assert history["iter"] == [3] and np.isfinite(history["cd_p"]).all()
