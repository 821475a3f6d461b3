"""The port's networks against the flax ones on the CPU, fp32: the
conditional PointNet++ denoiser at the kp and latent specs (narrow widths),
the autoencoder's decode with a small config and the JAX run's own FPS
starts, and one forward of the real kp and latent nets loaded from the
committed checkpoints, which holds the weight bridge at full width."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.cli.main import load_inference_params as j_load
from slide_tpu.configs import (autoencoder_config, keypoint_ddpm_config,
                               latent_ddpm_config)
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.models.upsample_decoder import point_upsample as j_point_upsample
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu_torch import models as tm
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.weights import (flax_to_torch_state, load_flax_params,
                                     load_inference_params, module_to_flax)
from torch_port_helpers import (DECODE_ATOL, TRIM_CALLS, assert_close, perturb,
                                record_jax_fps, replay_fps_in_port,
                                small_ae_config, to_np, trim_starts)

CKPTS = Path(__file__).resolve().parent.parent / "benchmarks" / "results" / "ckpts"
KP_CKPT = CKPTS / "kp" / "pointnet_ckpt_19999.pkl"
LAT_CKPT = CKPTS / "lat" / "pointnet_ckpt_24999.pkl"
AE_CKPT = CKPTS / "ae" / "pointnet_ckpt_29999.pkl"
# fp32 through the whole network (some 20 layers, GroupNorms over 16 points):
# sums taken in another order than XLA's grow to a few 1e-5
ATOL = 5e-5


def _narrow(pc, in_fea_dim, out_dim):
    pc = copy.deepcopy(pc)
    pc.update(in_fea_dim=in_fea_dim, out_dim=out_dim, t_dim=32, class_condition_dim=24)
    pc["architecture"].update(feature_dim=[16, 32, 48], decoder_feature_dim=[16, 32, 48],
                              mlp_depth=2, decoder_mlp_depth=2)
    return pc


def _net_inputs(seed, b, n, width, t_max):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, width)).astype(np.float32)
    ts = rng.integers(0, t_max, b).astype(np.int32)
    label = rng.integers(0, 13, b).astype(np.int32)
    return x, ts, label


_NARROW = {}


def _narrow_pair(spec):
    """The narrow denoiser of `spec` and its flax init and apply, jitted once
    for the module (the inputs are arguments, so both seeds share them)."""
    if spec not in _NARROW:
        if spec == "kp":
            pc = _narrow(keypoint_ddpm_config()["pointnet_config"], 0, 3)
        else:
            pc = _narrow(latent_ddpm_config()["pointnet_config"], 8, 11)
        jnet = JNet(pc)
        _NARROW[spec] = (pc, jax.jit(lambda k, x, ts, lbl: jnet.init(k, x, ts=ts, label=lbl)),
                         jax.jit(lambda p, x, ts, lbl: jnet.apply({"params": p}, x, ts=ts,
                                                                  label=lbl)))
    return _NARROW[spec]


@pytest.mark.parametrize("spec", ["kp", "latent"])
@pytest.mark.parametrize("seed", [0, 1])
def test_denoiser_narrow(spec, seed):
    # run_pair's steps: init the flax net, perturb, copy into the port, run both
    pc, j_init, j_apply = _narrow_pair(spec)
    x, ts, label = _net_inputs(seed, 2, 16, 3 + pc["in_fea_dim"], 50)
    args = [jnp.asarray(a) for a in (x, ts, label)]
    params = perturb(j_init(jax.random.key(seed), *args)["params"], seed)
    jout = j_apply(params, *args)
    net = load_flax_params(tm.ConditionalPointNet2(pc), params)
    with torch.no_grad():
        tout = net(torch.as_tensor(x), ts=torch.as_tensor(ts), label=torch.as_tensor(label))
    assert_close(jout, tout, ATOL)


def test_class_embeddings_are_drawn_at_the_jax_scale():
    # flax's nn.Embed with normal(1.0) in the JAX package's nets; the port's
    # init_params draws the same N(0, 1) (312 entries: the sample deviation
    # lies within 20% of 1, where N(0, 1/features) would give 0.2)
    pc, j_init, _ = _narrow_pair("latent")
    x, ts, label = _net_inputs(0, 2, 16, 3 + pc["in_fea_dim"], 50)
    jemb = np.asarray(j_init(jax.random.key(3), *[jnp.asarray(a) for a in (x, ts, label)])
                      ["params"]["class_emb"]["embedding"])
    temb = init_params(tm.ConditionalPointNet2(pc), torch.Generator().manual_seed(3)) \
        .class_emb.weight.detach().numpy()
    assert jemb.shape == temb.shape == (13, pc["class_condition_dim"])
    print(f"class embeddings' deviation: jax {jemb.std()}, port {temb.std()}")
    assert abs(jemb.std() - 1.0) < 0.2 and abs(temb.std() - 1.0) < 0.2


def test_denoiser_without_head_as_decoder_backbone():
    pc = copy.deepcopy(autoencoder_config()["pointnet_config"]["decoder_config_list"][1])
    pc["architecture"].update(npoint=[24, 12, 8], nsample=[8, 8, 4], K=4,
                              feature_dim=[16, 16, 32, 32],
                              decoder_feature_dim=[32, 32, 32, 32])
    x, _, label = _net_inputs(3, 2, 48, 6, 1)
    # the weights drawn by the port's init_params (the JAX package's
    # initialisers), perturbed, then run by both packages
    net = init_params(tm.ConditionalPointNet2(pc), torch.Generator().manual_seed(3))
    params = perturb(module_to_flax(net), 3)
    load_flax_params(net, params)
    jnet = JNet(pc)
    jout = jax.jit(lambda p: jnet.apply({"params": p}, jnp.asarray(x),
                                        label=jnp.asarray(label)))(params)
    with torch.no_grad():
        tout = net(torch.as_tensor(x), label=torch.as_tensor(label))
    assert tout.shape == (2, 48, 32)
    assert_close(jout, tout, ATOL)


def test_denoiser_rejects_unported_options():
    # the condition towers, the global feature, positional encoding and the
    # concatenated partial are ported (tests/test_torch_conditional.py);
    # neighbour statistics and global attention raise, naming their item
    for key, value in (("record_neighbor_stats", True),
                       ("global_attention_setting", {"use_global_attention_module": True})):
        pc = copy.deepcopy(keypoint_ddpm_config()["pointnet_config"])
        pc[key] = value
        with pytest.raises(NotImplementedError, match=f"item 18.*{key}"):
            tm.ConditionalPointNet2(pc)


@pytest.mark.parametrize("first_refine,center", [(False, False), (True, False),
                                                 (True, True)])
def test_point_upsample(first_refine, center):
    rng = np.random.default_rng(4)
    coarse = rng.standard_normal((2, 5, 6)).astype(np.float32)
    groups = 4 + int(first_refine)
    disp = rng.standard_normal((2, 5, 6 * groups)).astype(np.float32)
    kw = dict(include_displacement_center_to_final_output=center,
              output_scale_factor_value=0.03, first_refine_coarse_points=first_refine)
    got = tm.point_upsample(torch.as_tensor(coarse), torch.as_tensor(disp), 4, **kw)
    want = j_point_upsample(jnp.asarray(coarse), jnp.asarray(disp), 4, **kw)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-6)


@pytest.fixture(scope="module")
def small_decode():
    """`small_ae_config`'s flax autoencoder, a decode input and the decode's
    perturbed parameters: drawn by the port's `init_params` (the JAX
    package's initialisers) and read by both, which spares compiling a flax
    init.  The decode's gap at DECODE_ATOL (5e-4) measured 1.2e-4 / 1.1e-4
    (random / zero starts) on these weights, 1.3e-4 / 1.5e-4 on a perturbed
    flax init."""
    cfg = small_ae_config()
    jae = j_build_ae(cfg)
    rng = np.random.default_rng(5)
    kp = rng.standard_normal((2, 16, 3)).astype(np.float32) * 0.5
    feat = rng.standard_normal((2, 16, 16)).astype(np.float32)
    label = np.array([0, 4], np.int32)
    tae = init_params(tm.build_autoencoder(cfg, decode_only=True),
                      torch.Generator().manual_seed(0))
    return cfg, jae, kp, feat, label, perturb(module_to_flax(tae), 0, scale=0.05)


@pytest.mark.parametrize("random_starts", [True, False])
def test_autoencoder_decode_small(monkeypatch, small_decode, random_starts):
    """Decode against the JAX decode, with the FPS record / replay of
    `torch_port_helpers` (every FPS call held to exact equality on the JAX
    cloud, and the JAX indices taken, so near-ties cannot fork the runs)."""
    cfg, jae, kp, feat, label, params = small_decode
    args = (jnp.asarray(kp), jnp.asarray(feat))
    calls = record_jax_fps(monkeypatch)
    rngs = {"fps": jax.random.key(7)} if random_starts else {}
    want = jax.jit(lambda p: jae.apply({"params": p}, *args, label=jnp.asarray(label),
                                       method=jae.decode, rngs=rngs))(params)
    jax.effects_barrier()
    assert len(calls) == 9
    assert any(calls[i][1].any() for i in TRIM_CALLS) == random_starts

    replay = replay_fps_in_port(monkeypatch, calls, DECODE_ATOL)
    tae = tm.build_autoencoder(cfg, decode_only=True)
    load_flax_params(tae, params)   # decode's params are exactly the port's
    with torch.no_grad():
        got = tae.decode(torch.as_tensor(kp), torch.as_tensor(feat),
                         label=torch.as_tensor(label), start_fn=trim_starts(calls))
    assert next(replay, None) is None
    assert got.shape == (2, 200, 6)
    assert_close(want, got, DECODE_ATOL)


def test_decode_params_picks_the_decode_subtree():
    tree = {"encoder": {"w": {"kernel": np.zeros((2, 2))}},
            "keypoint_encoder": {"fc_layer": {"kernel": np.zeros((2, 3)),
                                              "bias": np.zeros(3)},
                                 "feature_mapper": {"x": {"bias": np.zeros(1)}}},
            "decoder": {"decoders_0": {"fc_layer": {"bias": np.zeros(4)}}}}
    sub = tm.decode_params(tree)
    assert set(sub) == {"keypoint_encoder", "decoder"}
    assert set(sub["keypoint_encoder"]) == {"fc_layer"}


def test_weight_bridge_is_strict():
    net = torch.nn.Sequential()
    net.add_module("fc", torch.nn.Linear(3, 2))
    good = {"fc": {"kernel": np.ones((3, 2), np.float32), "bias": np.ones(2, np.float32)}}
    load_flax_params(net, good)
    np.testing.assert_array_equal(net.fc.weight.detach().numpy(), np.ones((2, 3)))
    assert set(flax_to_torch_state(good)) == {"fc.weight", "fc.bias"}
    with pytest.raises(ValueError, match="fc.bias"):
        load_flax_params(net, {"fc": {"kernel": np.ones((3, 2), np.float32)}})
    with pytest.raises(ValueError, match="extra"):
        load_flax_params(net, {**good, "extra": {"bias": np.ones(1, np.float32)}})
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(net, {"fc": {"kernel": np.ones((2, 2), np.float32),
                                      "bias": np.ones(2, np.float32)}})


@pytest.mark.parametrize("ema_idx", [-1, 1])
def test_load_inference_params_matches_the_cli(ema_idx):
    got = flax_to_torch_state(load_inference_params(str(KP_CKPT), ema_idx))
    want = flax_to_torch_state(j_load(str(KP_CKPT), ema_idx))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name,ckpt,width", [("kp", KP_CKPT, 3), ("lat", LAT_CKPT, 51)])
def test_real_nets_from_committed_checkpoints(name, ckpt, width):
    pc = (keypoint_ddpm_config() if name == "kp" else latent_ddpm_config())["pointnet_config"]
    params = load_inference_params(str(ckpt))
    net = tm.ConditionalPointNet2(pc)
    load_flax_params(net, params)
    x, ts, label = _net_inputs(6, 2, 16, width, 1000)
    want = jax.jit(lambda p: JNet(pc).apply({"params": p}, jnp.asarray(x),
                                            ts=jnp.asarray(ts), label=jnp.asarray(label)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    with torch.no_grad():
        got = net(torch.as_tensor(x), ts=torch.as_tensor(ts), label=torch.as_tensor(label))
    # late steps: the f32 timestep embedding differs by up to 2e-4
    # (test_torch_nn.py::test_calc_t_emb_late_steps) before the network
    assert_close(want, got, 2e-4, rtol=1e-4)


def test_real_autoencoder_decode_loads_strictly():
    ae = tm.build_autoencoder(autoencoder_config()["pointnet_config"], decode_only=True)
    load_flax_params(ae, tm.decode_params(load_inference_params(str(AE_CKPT))))
    assert ae.decoder.decoders_0.fc_layer.weight.shape == (48, 390)
