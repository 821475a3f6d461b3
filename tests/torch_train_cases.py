"""Position-DDPM training in the port (`slide_tpu_torch/train/`, `data/`,
`ops/fps.py::sample_keypoints`, `diffusion/eps.py::diffusion_training_loss`,
`models/fused_denoiser.py::make_fused_train_fn`, `weights.py`) against the
JAX package on the CPU, at narrow widths except the checkpoint tests.

Tolerances: indices, files and batches equal; the training loss 1e-6 with
replayed draws; fused-train gradients at JAX's own fused-vs-flax tolerance
(rtol 5e-3, atol 1e-4, `tests/test_fused_train.py`); one train step's loss
1e-5 relative and its gradients (read as Adam's first moment, 0.1 g) at the
same tolerance scaled by 0.1; Adam against optax 1e-6 over five steps; EMA
1e-7 (the same two products and one sum)."""

import copy
import filecmp
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.configs import latent_ddpm_config as j_lat_config
from slide_tpu.data import get_dataloader as j_get_dataloader
from slide_tpu.data import write_synthetic_shapenet_psr as j_write_synthetic
from slide_tpu.diffusion import calc_diffusion_hyperparams as j_sched
from slide_tpu.diffusion import diffusion_training_loss as j_training_loss
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.models import fused_denoiser as jf
from slide_tpu.ops import fps as jfps
from slide_tpu.train import checkpoint as jckpt
from slide_tpu.train import driver as jdriver
from slide_tpu.train import ema as jema
from slide_tpu_torch import data as tdata
from slide_tpu_torch.configs import autoencoder_config, keypoint_ddpm_config
from slide_tpu_torch.configs import latent_ddpm_config
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams, diffusion_training_loss
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models import fused_denoiser as tf
from slide_tpu_torch.ops import fps as tfps
from slide_tpu_torch.ops import neighbors as tneighbors
from slide_tpu_torch.pipeline import DEFAULT_CKPTS, build_stages, generate
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train import ema as tema
from slide_tpu_torch.train.checkpoint import find_max_iter
from slide_tpu_torch.weights import (flax_leaves, load_flax_params, module_to_flax,
                                     read_checkpoint)
from torch_port_helpers import fast_jit, flax_params_of

N = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the nets here are narrow: one thread runs them as fast, and keeps this
    # file from competing for the cores with the other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(cfg_fn, nsample=None):
    cfg = copy.deepcopy(cfg_fn()["pointnet_config"])
    cfg.update(t_dim=16, class_condition_dim=16)
    cfg["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                               mlp_depth=2, decoder_mlp_depth=2)
    if nsample is not None:
        cfg["architecture"]["nsample"] = nsample
    return cfg


def _perturbed_net(cfg, seed):
    # drawn from a seeded generator (the module's own init takes torch's
    # global one), then moved off the init values
    net = tdriver.init_params(ConditionalPointNet2(cfg), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(torch.as_tensor(0.1 * rng.standard_normal(tuple(p.shape)),
                                   dtype=torch.float32))
    return net


def _grads_tree(net):
    return module_to_flax(net, {n: p.grad for n, p in net.named_parameters()})


def _assert_trees_close(got, want, rtol, atol):
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], flax_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The layer table, the scope, the clamps


def test_cuda_spec_struct_matches_the_table():
    # the kernels' `Spec` (csrc/fused_spec.cuh) and TABLE, K2's `Spec2` and
    # TABLE2, must list the same int fields in the same order: count them,
    # record by record
    import re
    src = open(os.path.join(REPO, "slide_tpu_torch", "csrc", "fused_spec.cuh")).read()
    consts = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    structs = {}
    for name, body in re.findall(r"struct (\w+) \{(.*?)\};", src, re.S):
        if name == "Dense" or name == "Norm":
            structs[name] = [f.strip() for f in body.split(";")[0].replace("int", "").split(",")]
            continue
        fields = []
        for decl in body.split(";"):
            decl = re.sub(r"//.*", "", decl).strip()
            if not decl:
                continue
            typ, rest = decl.split(None, 1)
            for item in rest.split(","):
                m = re.match(r"\s*(\w+)(?:\[(\w+)(?: \+ 1)?\])?", item)
                count = 1
                if m[2]:
                    count = consts.get(m[2], 0) + (1 if "+ 1" in item else 0) \
                        if not m[2].isdigit() else int(m[2])
                fields.append((m[1], typ, count))
        structs[name] = fields

    def names(schema, prefix=""):
        out = []
        for field in schema:
            sub = field[1] if len(field) > 1 else None
            count = field[2] if len(field) > 2 else 1
            out.append((field[0], count, names(sub) if sub is not None else None))
        return out

    def c_names(struct):
        if struct in ("Dense", "Norm"):
            return [(f, 1, None) for f in structs[struct]]
        return [(f, count, c_names(typ) if typ != "int" else None)
                for f, typ, count in structs[struct]]

    assert c_names("Spec") == names(tf.TABLE)
    assert c_names("Spec2") == names(tf.TABLE2)


def test_64_keypoints_are_outside_the_fused_scope():
    # the kernels hold up to 128 points: 129 keypoints are past them
    cfg = keypoint_ddpm_config("airplane", num_keypoints=129)["pointnet_config"]
    # the JAX package takes it (its Pallas kernel has no such limit)
    assert jf.supports_config(cfg) and jf.build_spec(cfg, 129)["n"] == 129
    reason = tf.scope_error(cfg, 129)
    assert reason is not None and "at most 128 points" in reason
    net = ConditionalPointNet2(cfg)
    # past a limit nothing falls back to the module, on any device: the
    # constructors raise naming the limit and fused=False
    with pytest.raises(ValueError, match="at most 128 points.*fused=False"):
        tf.make_fused_net_fn(cfg, net, 129)
    with pytest.raises(ValueError, match="at most 128 points.*fused=False"):
        tf.make_fused_train_fn(cfg, net, 129)
    with pytest.raises(ValueError, match="at most 128 points"):
        tf.pack_weights(net, tf.build_spec(cfg, 129))
    cfgs = {"kp": keypoint_ddpm_config(num_keypoints=129),
            "lat": latent_ddpm_config(num_keypoints=129), "ae": autoencoder_config()}
    with pytest.raises(ValueError, match="at most 128 points.*fused=False"):
        build_stages(1, 2, device="cpu", configs=cfgs)


@pytest.mark.parametrize("n", [128, 129])
def test_train_route_at_the_point_limit(n):
    # the train step's fused route: taken at 128 points; at 129 fused=True
    # raises naming fused=False (no silent module route), fused=False runs
    # the module
    cfg = keypoint_ddpm_config("airplane", num_keypoints=n)["pointnet_config"]
    net = ConditionalPointNet2(cfg)
    assert tdriver.maybe_fused_train_apply(cfg, n, net, fused=False) is None
    if n <= tf.MAX_POINTS:
        assert tdriver.maybe_fused_train_apply(cfg, n, net).packed.layout["n"] == n
    else:
        with pytest.raises(ValueError, match=f"at most {tf.MAX_POINTS} points.*fused=False"):
            tdriver.maybe_fused_train_apply(cfg, n, net)


def test_build_stages_fuses_64_keypoints():
    # the shipped presets at 64 keypoints with the committed checkpoints (a
    # ConditionalPointNet2's weights do not depend on N): both chains fused,
    # one pass down to the meshes, each chain's result the module's
    cfgs = {"kp": keypoint_ddpm_config(num_keypoints=64),
            "lat": latent_ddpm_config(num_keypoints=64)}
    stages = build_stages(1, 2, device="cpu", configs=cfgs)
    assert stages.kp_fused.packed.layout["n"] == stages.lat_fused.packed.layout["n"] == 64
    out = generate(stages, seed=0)
    assert out["keypoints"].shape == (1, 64, 3) and out["features"].shape == (1, 64, 48)
    assert out["points"].shape == (1, 2048, 3) and int(out["n_faces"][0]) > 0
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 64, 51)),
                        dtype=torch.float32)
    ts, label = torch.tensor([5, 900]), torch.tensor([0, 0])
    with torch.no_grad():
        for net, fn, width in ((stages.kp_net, stages.kp_fused, 3),
                               (stages.lat_net, stages.lat_fused, 51)):
            want = net(x[..., :width], ts=ts, label=label)
            np.testing.assert_allclose(fn(x[..., :width], ts, label).numpy(), want.numpy(),
                                       atol=1e-4, rtol=1e-4)


def test_scratch_past_the_card_raises_naming_its_size(monkeypatch):
    # a kernel's per-cloud scratch that the card cannot hold: an out-of-memory
    # error that names the floats a cloud and the batch (no module fallback)
    cfg = keypoint_ddpm_config("airplane", num_keypoints=64)["pointnet_config"]
    packed = tf.pack_weights(ConditionalPointNet2(cfg), tf.build_spec(cfg, 64))

    def refuse(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "empty", refuse)
    floats = packed.layout2["bwd_floats"]
    with pytest.raises(torch.cuda.OutOfMemoryError,
                       match=f"K2 needs {floats} floats .* at 64 points.*batch of 300"):
        packed.bwd_scratch_for(300)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="K1 needs .*batch of 16"):
        packed.scratch_for(16)
    assert packed.scratch is None and packed.bwd_scratch is None


def test_build_stages_ema_idx_loads_the_raw_autoencoder():
    stages = build_stages(1, 2, device="cpu", ema_idx=0)
    for net, key in ((stages.kp_net, "kp"), (stages.lat_net, "lat")):
        want = read_checkpoint(str(DEFAULT_CKPTS[key]))["ema_state_list"][0]
        _assert_trees_close(module_to_flax(net), want, rtol=0, atol=0)
    ae_ckpt = read_checkpoint(str(DEFAULT_CKPTS["ae"]))
    assert "ema_state_list" not in ae_ckpt
    got = module_to_flax(stages.ae)
    want = ae_ckpt["model_state_dict"]
    for part in ("keypoint_encoder", "decoder"):
        sub = want[part] if part == "decoder" else {"fc_layer": want[part]["fc_layer"]}
        _assert_trees_close(got[part], sub, rtol=0, atol=0)


def test_distance_gradient_at_the_tie_matches_jax():
    # duplicate points: every self-distance and the duplicates' distances are
    # exactly 0, where max(., 0) has the gradient 0.5 in JAX
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    x[:, 1] = x[:, 0]
    w = rng.standard_normal((2, 6, 6)).astype(np.float32)
    want = jax.grad(lambda p: jnp.sum(jf._pairwise_sqdist(p) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (tf.pairwise_sqdist(xt) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    from slide_tpu.ops import neighbors as jneighbors
    want = jax.grad(lambda p: jnp.sum(jneighbors.pairwise_sqdist(p, p) * w))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    (tneighbors.pairwise_sqdist(xt, xt) * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the tie itself: gradient 0.5 of the clamp, as jnp.maximum
    z = torch.zeros((), requires_grad=True)
    torch.maximum(z, torch.zeros(())).backward()
    assert float(z.grad) == float(jax.grad(lambda v: jnp.maximum(v, 0.0))(0.0)) == 0.5


# ---------------------------------------------------------------------------
# Keypoints and the loss


def _clouds(b=3, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((b, n, 3)).astype(np.float32)
    axes = rng.uniform(0.1, 0.5, (b, 1, 3)).astype(np.float32)
    return (axes * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_sample_keypoints_match_jax():
    pts = _clouds()
    kp_j, idx_j = jfps.sample_keypoints(jnp.asarray(pts), N, add_centroid=True)
    kp_t, idx_t = tfps.sample_keypoints(torch.as_tensor(pts), N, add_centroid=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(kp_t.numpy(), np.asarray(kp_j), atol=1e-6)
    cfg = keypoint_ddpm_config()["shapenet_psr_dataset_config"]
    got = tdriver.sample_train_keypoints(torch.as_tensor(pts), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jdriver.sample_train_keypoints(jnp.asarray(pts), cfg)), atol=1e-6)
    # append and subsample: forced picks, then FPS
    init = pts[:, :3]
    a_j, ai_j = jfps.append_points_to_keypoints(jnp.asarray(pts), jnp.asarray(init), 12)
    a_t, ai_t = tfps.append_points_to_keypoints(torch.as_tensor(pts), torch.as_tensor(init), 12)
    np.testing.assert_array_equal(ai_t.numpy(), np.asarray(ai_j))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(tfps.fps_subsample(torch.as_tensor(pts), 20).numpy(),
                                  np.asarray(jfps.fps_subsample(jnp.asarray(pts), 20)))


def test_sample_keypoints_random_modes():
    pts = torch.as_tensor(_clouds(b=4, n=300))
    gen = torch.Generator().manual_seed(0)
    kp, idx = tfps.sample_keypoints(pts, 8, add_centroid=False, random_subsample=True,
                                    generator=gen)
    assert (idx == idx[:1]).all() and len(set(idx[0].tolist())) == 8   # one permutation
    np.testing.assert_array_equal(kp.numpy(), pts.numpy()[:, idx[0].long().numpy()])
    kp, idx = tfps.sample_keypoints(pts, 8, add_centroid=False, generator=gen)
    for row in range(4):                    # random start, then FPS from it
        want = tfps.furthest_point_sample(pts[row:row + 1], 8, start_idx=int(idx[row, 0]))
        np.testing.assert_array_equal(idx[row:row + 1].numpy(), want.numpy())
    with pytest.raises(ValueError):
        tfps.sample_keypoints(pts, 8, add_centroid=False)


def test_training_loss_matches_jax_with_replayed_draws():
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((4, N, 3)).astype(np.float32)
    key = jax.random.key(3)
    k_t, k_z = jax.random.split(key)
    ts = np.asarray(jax.random.randint(k_t, (4,), 0, 1000))
    z = np.asarray(jax.random.normal(k_z, x0.shape))

    def jnet(x, t):
        return jnp.tanh(x) * (1.0 + t[:, None, None] / 1000.0)

    def tnet(x, t):
        return torch.tanh(x) * (1.0 + t[:, None, None].float() / 1000.0)

    want = j_training_loss(jnet, key, jnp.asarray(x0), j_sched(1000, 1e-4, 0.02))
    got = diffusion_training_loss(tnet, torch.as_tensor(x0),
                                  calc_diffusion_hyperparams(1000, 1e-4, 0.02),
                                  ts=torch.as_tensor(ts), z=torch.as_tensor(z))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The differentiable fused denoiser


@pytest.mark.parametrize("name", ["kp", "lat_topk"])
def test_fused_train_grads_match_jax_and_the_module(name):
    cfg = _narrow(j_kp_config) if name == "kp" else _narrow(j_lat_config, nsample=[6, 16])
    net = _perturbed_net(cfg, seed=len(name))
    din = 3 + cfg["in_fea_dim"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, N, din)).astype(np.float32)
    x[:, 1] = x[:, 0]                      # a duplicate point: the clamp's tie
    ts = np.array([3, 500, 999], np.int32)
    label = np.array([0, 4, 7], np.int32)
    tgt = 0.3

    params = flax_params_of(net)
    jfn = jf.make_fused_train_fn(cfg, N, use_pallas=False)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jnp.mean((jfn(p, x, ts, label) - tgt) ** 2)))(params)

    apply = tf.make_fused_train_fn(cfg, net, N)
    xt = torch.as_tensor(x).requires_grad_(True)
    loss = torch.mean((apply(xt, torch.as_tensor(ts), torch.as_tensor(label)) - tgt) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(_grads_tree(net), jgrads, rtol=5e-3, atol=1e-4)
    fused_grads, fused_dx = _grads_tree(net), xt.grad.clone()

    net.zero_grad()
    xm = torch.as_tensor(x).requires_grad_(True)
    torch.mean((net(xm, ts=torch.as_tensor(ts), label=torch.as_tensor(label)) - tgt) ** 2
               ).backward()
    _assert_trees_close(fused_grads, _grads_tree(net), rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(fused_dx.numpy(), xm.grad.numpy(), rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["kp", "lat"])
def test_fused_train_grads_at_64_points_match_jax(name):
    # K2's plain version (autograd through the plain forward, recomputed in
    # `backward`) against jax.vjp of JAX's `_forward_tile` (its fused train
    # fn off Pallas) at the kernels' limit: the first SA level groups all 64
    # points, the second and the KnnFP levels pick by kNN.  No duplicate
    # point: with x[:, 50] = x[:, 40] two relu inputs of the kp net lie within
    # 3e-6 of 0 in float64, and the two packages' fp32 backwards pass them
    # apart (either is right; the port's is within 1e-6 of float64 once they
    # are resolved as `fused_backward_reference` resolves them, the K2 gate)
    n = 64
    cfg = _narrow(j_kp_config if name == "kp" else j_lat_config, nsample=[n, 16])
    cfg["architecture"]["npoint"] = [n, n]
    net = _perturbed_net(cfg, seed=n + len(name))
    din = 3 + cfg["in_fea_dim"]
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, n, din)).astype(np.float32)
    ts = np.array([7, 640], np.int32)
    label = np.array([2, 11], np.int32)
    tgt = 0.3

    params = flax_params_of(net)
    jfn = jf.make_fused_train_fn(cfg, n, use_pallas=False)
    jloss, (jgrads, jdx) = jax.jit(jax.value_and_grad(
        lambda p, xx: jnp.mean((jfn(p, xx, ts, label) - tgt) ** 2), argnums=(0, 1)))(
            params, x)

    apply = tf.make_fused_train_fn(cfg, net, n)
    assert apply.packed.layout["n"] == n
    xt = torch.as_tensor(x).requires_grad_(True)
    loss = torch.mean((apply(xt, torch.as_tensor(ts), torch.as_tensor(label)) - tgt) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_trees_close(_grads_tree(net), jgrads, rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=5e-3, atol=1e-4)



K2_TOL = 1e-4       # chip_smoke.py's: each gradient within K2_TOL x max(1, max |reference|)


def _within_k2_tol(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, bound = float(np.abs(got - want).max()), K2_TOL * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: {err} > {bound}"


def test_fused_train_grads_at_128_points_match_jax():
    # K2's plain version against jax.vjp of JAX's `_forward_tile` (its fused
    # train fn off Pallas) at the kernels' limit, the cotangent g applied:
    # the first SA level groups all 128 points, the second and the KnnFP
    # levels pick by kNN (picks past index 63).  A relu whose input lies
    # within fp32 rounding of 0 passes its gradient in one fp32 backward and
    # not in another (here one unit, its float64 input 1.7e-8, which JAX
    # decides as float64 does): the port's decisions that float64 makes
    # otherwise are taken off its gradients (`fused_backward_reference`, the
    # K2 gate's search).  Then every parameter's gradient and d x within
    # K2_TOL x max(1, max |JAX's|)
    n = 128
    cfg = _narrow(j_kp_config, nsample=[n, 16])
    cfg["architecture"]["npoint"] = [n, n]
    net = _perturbed_net(cfg, seed=n)
    din = 3 + cfg["in_fea_dim"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, n, din)).astype(np.float32)
    g = rng.standard_normal((2, n, din)).astype(np.float32)
    ts = np.array([11, 730], np.int32)
    label = np.array([5, 1], np.int32)

    params = flax_params_of(net)
    jfn = jf.make_fused_train_fn(cfg, n, use_pallas=False)
    jgrads, jdx = fast_jit(jax.grad(lambda p, xx: jnp.sum(jfn(p, xx, ts, label) * g),
                                    argnums=(0, 1)), params, x)

    apply = tf.make_fused_train_fn(cfg, net, n)
    packed = apply.packed
    assert packed.layout["n"] == n
    xt, gt = torch.as_tensor(x).requires_grad_(True), torch.as_tensor(g)
    tt, lt = torch.as_tensor(ts), torch.as_tensor(label)
    (apply(xt, tt, lt) * gt).sum().backward()

    # the port's ties: the float64 reference with its decisions, less the
    # float64 reference, carried back to the parameters by autograd
    t4, cls, flat = net.t_embedder(tt), net.class_emb(lt.long()), packed.live_flat()
    core = [xt.detach(), t4.detach(), cls.detach(), flat.detach()]
    got = tf.fused_backward_plain(packed, core[0], core[1], core[2], gt, core[3])
    mine, ties = tf.fused_backward_reference(packed, *core[:3], gt, got, core[3], tol=K2_TOL)
    plain64, _ = tf.fused_backward_reference(packed, *core[:3], gt, got, core[3], max_tries=0)
    assert len(ties) <= 4, ties
    delta = [(a - b).float() for a, b in zip(mine, plain64)]
    names = [name for name, _ in net.named_parameters()]
    taken = dict(zip(names, torch.autograd.grad([t4, cls, flat], list(net.parameters()),
                                                delta[1:], allow_unused=True)))
    for name, p in net.named_parameters():
        if taken[name] is not None:
            p.grad -= taken[name]
    jl, tl = jax.tree_util.tree_flatten_with_path(jgrads)[0], flax_leaves(_grads_tree(net))
    assert len(jl) == len(tl)
    for (path, w), mine_p in zip(jl, tl):
        _within_k2_tol(mine_p, w, jax.tree_util.keystr(path))
    _within_k2_tol(xt.grad.numpy() - delta[0].numpy(), jdx, "d x")


def test_k2_tiles_plain_route_equals_the_whole_batch(monkeypatch):
    # K2 runs a batch in the tiles of `PackedNet.k2_tiles`, one launch a
    # tile, and the card's K2 gate holds a batch chunk by chunk against
    # float64: both rest on a cloud's gradients not depending on the other
    # clouds, and on d flat adding up over any split of the batch.  Here,
    # under a tape budget of two clouds, K2's plain version one pass a tile
    # against one pass over the whole batch: each cloud's rows of d pc, d t4
    # and d cls, and d flat summed over the tiles in order, within 1e-5 x
    # max(1, max |whole|) (the same fp32 terms, the weight sums split in
    # another order); and its float64 run (`fused_backward_reference`, no
    # tie search) in the same tiles, d flat summed, against the whole
    # batch's within 1e-12 x max(1, max |whole|)
    cfg = _narrow(j_lat_config, nsample=[6, 16])
    net = _perturbed_net(cfg, seed=9)
    packed = tf.pack_weights(net, tf.build_spec(cfg, N))
    b, din = 5, 3 + cfg["in_fea_dim"]
    gen = torch.Generator().manual_seed(10)
    pc, g = torch.randn((b, N, din), generator=gen), torch.randn((b, N, din), generator=gen)
    ts, label = torch.tensor([3, 500, 999, 42, 7]), torch.tensor([0, 4, 7, 1, 12])
    with torch.no_grad():
        t4, cls = net.t_embedder(ts), net.class_emb(label)
    assert packed.k2_tiles(b) == [(0, b)]
    monkeypatch.setattr(tf, "K2_TAPE_FLOATS", 2 * packed.layout2["bwd_floats"])
    tiles = packed.k2_tiles(b)
    assert tiles == [(0, 1), (1, 3), (3, 5)]

    def in_tiles(fn):
        parts = [fn(pc[s:e], t4[s:e], cls[s:e], g[s:e]) for s, e in tiles]
        dflat = parts[0][3]
        for part in parts[1:]:
            dflat = dflat + part[3]
        return [torch.cat([part[i] for part in parts]) for i in range(3)] + [dflat]

    def close(got, want, what, rtol):
        assert got.shape == want.shape, what
        err = float((got - want).abs().max())
        assert err <= rtol * max(1.0, float(want.abs().max())), (what, err)

    whole = tf.fused_backward_plain(packed, pc, t4, cls, g)
    tiled = in_tiles(lambda *x: tf.fused_backward_plain(packed, *x))
    whole64, _ = tf.fused_backward_reference(packed, pc, t4, cls, g, whole, max_tries=0)
    tiled64 = in_tiles(lambda *x: tf.fused_backward_reference(
        packed, *x, tf.fused_backward_plain(packed, *x), max_tries=0)[0])
    for what, a, w, a64, w64 in zip(("d pc", "d t4", "d cls", "d flat"), tiled, whole,
                                    tiled64, whole64):
        close(a, w, what, 1e-5)
        close(a64, w64, what, 1e-12)


def test_k2_tile_plan(monkeypatch):
    # K2's tiles at the presets' training batch of 32: one launch for every
    # shipped net up to 64 points, several at 128, each tile's tape within
    # K2_TAPE_FLOATS, the tiles as even as can be.  The plans do not read the
    # weights' values: their copies are left out
    monkeypatch.setattr(tf, "pack_flat", lambda sources: torch.zeros(0))
    monkeypatch.setattr(tf, "_transpose_gather", lambda rec, size: torch.zeros(0))
    batch = 32
    for cfg_fn in (keypoint_ddpm_config, latent_ddpm_config):
        net = ConditionalPointNet2(cfg_fn("airplane")["pointnet_config"])
        for n, tiles in ((16, 1), (64, 1), (128, 2 if cfg_fn is keypoint_ddpm_config else 3)):
            cfg = cfg_fn("airplane", num_keypoints=n)["pointnet_config"]
            packed = tf.pack_weights(net, tf.build_spec(cfg, n))
            got = packed.k2_tiles(batch)
            assert len(got) == tiles, (cfg_fn.__name__, n, got)
            assert got[0][0] == 0 and got[-1][1] == batch
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
            per = packed.layout2["bwd_floats"]
            assert all((e - s) * per <= tf.K2_TAPE_FLOATS for s, e in got)
            assert max(e - s for s, e in got) - min(e - s for s, e in got) <= 1

@pytest.mark.parametrize("name", ["kp", "lat_topk"])
def test_weight_gradient_jobs_equal_autograd(name, monkeypatch):
    # K2's weight-gradient launch, in its plain version (`weight_grads_plain`):
    # every d W the batch's sum of X_b^T dY_b (and d b of dY_b), each read from
    # a tape laid out as the chain lays it out.  The tape is written here from
    # the plain forward and autograd: each product's input and output
    # gradient where its job reads them, each GroupNorm's d scale / d bias and
    # each injection's d vector in the blocks' first row of sums.  Equals
    # autograd's d flat within the K2 gate (1e-4 x max(1, max |d flat|)).
    cfg = _narrow(j_kp_config) if name == "kp" else _narrow(j_lat_config, nsample=[6, 16])
    net = _perturbed_net(cfg, seed=5)
    packed = tf.pack_weights(net, tf.build_spec(cfg, N))
    b, din = 3, 3 + cfg["in_fea_dim"]
    gen = torch.Generator().manual_seed(6)
    pc, g = torch.randn((b, N, din), generator=gen), torch.randn((b, N, din), generator=gen)
    with torch.no_grad():
        t4 = net.t_embedder(torch.tensor([3, 500, 999]))
        cls = net.class_emb(torch.tensor([0, 4, 7]))
    dense_calls, norm_calls = [], []
    plain_dense, plain_norm = tf._dense, tf._group_norm

    def record(calls, fn):
        def wrapped(x, flat, d):
            y = fn(x, flat, d)
            rec = {"d": d, "x": x.detach()}
            calls.append(rec)
            y.register_hook(lambda gy: rec.update(dy=gy.detach()))
            return y
        return wrapped

    monkeypatch.setattr(tf, "_dense", record(dense_calls, plain_dense))
    monkeypatch.setattr(tf, "_group_norm", record(norm_calls, plain_norm))
    flat = packed.flat.clone().requires_grad_(True)
    tf.fused_forward_plain(None, packed, pc, t4, cls, flat).backward(g)
    monkeypatch.undo()

    floats, cl = packed.layout2["bwd_floats"], packed.layout2["cluster"]
    tape = torch.zeros(b * floats)

    def rows(off, ld, r, width):
        return tape.as_strided((b, r, width), (floats, ld, 1), off)

    jobs = {job[0]: job for job in packed.jobs.tolist() if job[0] >= 0}
    assert len(jobs) == len(dense_calls)
    for rec in dense_calls:
        _, _, cin, cout, r, xk, xoff, xld, yk, yoff, yld, _ = jobs[rec["d"]["w"]]
        if xk == tf.TAPE:
            rows(xoff, xld, r, cin).copy_(rec["x"].reshape(b, r, cin))
        if yk == tf.TAPE:
            dy = rec["dy"].reshape(b, -1, cout)
            rows(yoff, yld, r, cout)[:, :dy.shape[1]].copy_(dy)   # an injection: row 0
    for rec in norm_calls:
        nd, x, dy = rec["d"], rec["x"], rec["dy"]
        c, grp = x.shape[-1], nd["g"]
        cn = c - c % grp
        xn = x[..., :cn].reshape(b, x.shape[1], grp, -1)
        mean = xn.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((xn * xn).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0)
        xhat = ((xn - mean) * torch.rsqrt(var + 1e-5)).reshape(b, -1, cn)
        sums = rows(nd["p"], 2 * c, cl, 2 * c)
        sums[:, 0, :cn] = (dy[..., :cn] * xhat).sum(dim=1)
        sums[:, 0, c:c + cn] = dy[..., :cn].sum(dim=1)
    got = tf.weight_grads_plain(packed, tape, t4, cls, g)
    want = flat.grad
    err = float((got - want).abs().max())
    assert err <= 1e-4 * max(1.0, float(want.abs().max())), err
    assert float(got.abs().max()) > 0


def _relu_inputs(packed, *inputs):
    seen = []

    def relu(x):
        seen.append(x.detach().reshape(-1))
        return torch.relu(x)

    tf.fused_forward_plain(None, packed, *inputs, relu=relu)
    return seen


@pytest.mark.parametrize("name", ["kp", "lat_topk"])
def test_backward_reference_resolves_only_relu_ties(name):
    # K2's reference: the plain backward in float64, with a relu tie (input
    # within rounding of 0) decided as the backward under test decided it,
    # and nothing else explained away.  Bound 1e-4 x max(1, max |reference|).
    cfg = _narrow(j_kp_config) if name == "kp" else _narrow(j_lat_config, nsample=[6, 16])
    net = _perturbed_net(cfg, seed=3)
    packed = tf.pack_weights(net, tf.build_spec(cfg, N))
    gen = torch.Generator().manual_seed(4)
    din = 3 + cfg["in_fea_dim"]
    pc, g = torch.randn((2, N, din), generator=gen), torch.randn((2, N, din), generator=gen)
    with torch.no_grad():
        t4 = net.t_embedder(torch.tensor([7, 600]))
        cls = net.class_emb(torch.tensor([1, 9]))

    def worst(got, want):
        return max(float((a.double() - w).abs().max()) / (1e-4 * max(1.0, float(w.abs().max())))
                   for a, w in zip(got, want))

    got = tf.fused_backward_plain(packed, pc, t4, cls, g)
    plain64, kept = tf.fused_backward_reference(packed, pc, t4, cls, g, got)
    assert kept == [] and worst(got, plain64) <= 1.0

    # the unit nearest 0 decided the other way: found, and only it
    seen = _relu_inputs(packed, *(t.double() for t in (pc, t4, cls, packed.flat)))
    call = min(range(len(seen)), key=lambda i: float(seen[i].abs().min()))
    unit = int(seen[call].abs().argmin())

    def flipped(x, calls=[0]):
        mask = x > 0
        if calls[0] == call:
            mask = mask.clone().view(-1)
            mask[unit] = ~mask[unit]
            mask = mask.view(x.shape)
        calls[0] += 1
        return x * mask

    leaves = [t.double().requires_grad_(True) for t in (pc, t4, cls, packed.flat)]
    out = tf.fused_forward_plain(None, packed, *leaves, relu=flipped)
    other = torch.autograd.grad(out, leaves, g.double())
    tied = tuple((a.double() + o - p).float() for a, o, p in zip(got, other, plain64))
    want, kept = tf.fused_backward_reference(packed, pc, t4, cls, g, tied, tie=1.0)
    assert [(i, j) for i, j, _ in kept] == [(call, unit)]
    assert worst(tied, want) <= 1.0

    # an error that no tie explains stays an error
    wrong = [t.clone() for t in got]
    wrong[3][int(wrong[3].abs().argmax())] *= 1.01
    want, kept = tf.fused_backward_reference(packed, pc, t4, cls, g, wrong, tie=1.0,
                                             max_tries=4)
    assert kept == [] and worst(wrong, want) > 1.0


def test_backward_reference_flips_copies_of_a_tie_together():
    # The attention's first relu takes its point-wise product repeated over
    # the k slots of each point: when that product lies within rounding of
    # 0, all k copies are one decision, which the reference takes as one.
    # Here the first SA attention's product is moved next to 0 at cloud 0,
    # point 0, channel 0 (through its bias) and a backward that decided
    # those copies the other way is held to the reference.
    cfg = _narrow(j_kp_config)
    net = _perturbed_net(cfg, seed=3)
    packed = tf.pack_weights(net, tf.build_spec(cfg, N))
    gen = torch.Generator().manual_seed(4)
    pc, g = torch.randn((2, N, 3), generator=gen), torch.randn((2, N, 3), generator=gen)
    with torch.no_grad():
        t4 = net.t_embedder(torch.tensor([7, 600]))
        cls = net.class_emb(torch.tensor([1, 9]))
    sa = packed.layout["sa"][0]
    k, width = sa["k"], sa["att"]["w_norm_1"]["c"]
    seen = _relu_inputs(packed, *(t.double() for t in (pc, t4, cls, packed.flat)))
    call = next(i for i, x in enumerate(seen) if x.numel() == 2 * N * k * width)
    copies = [slot * width for slot in range(k)]         # cloud 0, point 0, channel 0
    flat = packed.flat.clone()
    flat[sa["att"]["feat_conv"]["b"]] -= float(seen[call][0])
    inputs64 = [t.double() for t in (pc, t4, cls, flat)]
    x = _relu_inputs(packed, *inputs64)[call]
    assert len(set(x[copies].tolist())) == 1 and abs(float(x[0])) < 1e-6

    def flipped(x, calls=[0]):
        mask = x > 0
        if calls[0] == call:
            mask = mask.clone().view(-1)
            mask[copies] = ~mask[copies]
            mask = mask.view(x.shape)
        calls[0] += 1
        return x * mask

    leaves = [t.requires_grad_(True) for t in inputs64]
    out = tf.fused_forward_plain(None, packed, *leaves, relu=flipped)
    tied = tuple(d.float() for d in torch.autograd.grad(out, leaves, g.double()))
    want, kept = tf.fused_backward_reference(packed, pc, t4, cls, g, tied, flat)
    assert [(i, j) for i, j, _ in kept] == [(call, j) for j in copies]
    for a, w in zip(tied, want):
        assert float((a.double() - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


# ---------------------------------------------------------------------------
# One train step, Adam, EMA


def test_train_step_matches_jax():
    cfg = _narrow(j_kp_config)
    full = keypoint_ddpm_config()
    trainset = full["shapenet_psr_dataset_config"]
    jnet = JNet(cfg)
    params = flax_params_of(_perturbed_net(cfg, seed=0))
    sched_j = j_sched(1000, 1e-4, 0.02)
    opt = optax.adam(2e-4)
    jstate = jdriver._init_state(params, opt, (0.999,))
    pts = _clouds(b=4, n=128, seed=5)
    label = np.array([0, 0, 3, 5], np.int32)
    batch = {"points": jnp.asarray(pts), "normals": jnp.asarray(pts), "label": jnp.asarray(label)}
    key = jax.random.key(11)
    jstep = jdriver.make_train_step(jnet, sched_j, opt, (0.999,), "keypoint_generation", trainset)
    jnew, jloss = jax.jit(jstep)(jstate, batch, key)
    _, k_loss = jax.random.split(key)
    k_t, k_z = jax.random.split(k_loss)
    ts = np.asarray(jax.random.randint(k_t, (4,), 0, 1000))
    z = np.asarray(jax.random.normal(k_z, (4, N, 3)))

    net = load_flax_params(ConditionalPointNet2(cfg), params)
    optimizer = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.9, 0.999), eps=1e-8)
    state = tdriver.TrainState(net=net, optimizer=optimizer,
                               ema=tema.ema_init(list(net.parameters()), (0.999,)),
                               ema_rates=(0.999,))
    step = tdriver.make_train_step(net, calc_diffusion_hyperparams(1000, 1e-4, 0.02),
                                   "keypoint_generation", trainset,
                                   fused_apply=tf.make_fused_train_fn(cfg, net, N))
    loss = step(state, {"points": torch.as_tensor(pts), "label": torch.as_tensor(label)},
                torch.Generator(), draws=(torch.as_tensor(ts), torch.as_tensor(z)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    adam = tdriver.adam_state_tree(state)
    assert int(adam[0][0]) == int(jnew.opt_state[0].count) == 1
    # Adam's first moment after one step is 0.1 g
    _assert_trees_close(adam[0][1], jnew.opt_state[0].mu, rtol=5e-3, atol=1e-5)


def test_torch_adam_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(5)]
    opt = optax.adam(2e-4)
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    tp = [torch.nn.Parameter(torch.as_tensor(p.copy())) for p in params]
    topt = torch.optim.Adam(tp, lr=2e-4, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.as_tensor(x)
        topt.step()
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[i]), atol=1e-6, rtol=0)
        st = topt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(js[0].mu[i]), atol=1e-6)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(js[0].nu[i]),
                                   atol=1e-6)
        assert int(st["step"]) == int(js[0].count) == 5


def test_ema_matches_jax():
    rng = np.random.default_rng(6)
    params = [rng.standard_normal((4, 3)).astype(np.float32), rng.standard_normal(5).astype(
        np.float32)]
    rates = (0.999, 0.9)
    jsh = jema.ema_init([jnp.asarray(p) for p in params], rates)
    tparams = [torch.as_tensor(p) for p in params]
    tsh = tema.ema_init(tparams, rates)
    for _ in range(3):
        params = [p + rng.standard_normal(p.shape).astype(np.float32) for p in params]
        jsh = jema.ema_update(jsh, [jnp.asarray(p) for p in params], rates)
        tema.ema_update(tsh, [torch.as_tensor(p) for p in params], rates)
    for js, ts in zip(jsh, tsh):
        for j, t in zip(js, ts):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7, rtol=0)
    for n in (0, 100, 5000):
        assert tema.ema_maturity(0.999, n) == jema.ema_maturity(0.999, n)
        assert tema.select_eval_params("p", ["a", "b"], rates, n)[1] == \
            jema.select_eval_params("p", ["a", "b"], rates, n)[1]


# ---------------------------------------------------------------------------
# Checkpoints


def test_unpickler_keeps_the_adam_state():
    path = str(DEFAULT_CKPTS["kp"])
    with open(path, "rb") as f:
        want = jax.tree.leaves(pickle.load(f)["optimizer_state_dict"])
    got = flax_leaves(read_checkpoint(path)["optimizer_state_dict"])
    assert len(got) == len(want) == 319
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_port_checkpoint_is_read_by_the_jax_package(tmp_path):
    from slide_tpu.cli.main import load_inference_params as j_load_inference
    cfg = keypoint_ddpm_config()["pointnet_config"]
    net = ConditionalPointNet2(cfg)
    tdriver.init_params(net, torch.Generator().manual_seed(0))
    optimizer = torch.optim.Adam(net.parameters(), lr=2e-4)
    state = tdriver.TrainState(net=net, optimizer=optimizer,
                               ema=tema.ema_init(list(net.parameters()), (0.999, 0.9999)),
                               ema_rates=(0.999, 0.9999))
    gen = torch.Generator().manual_seed(1)
    for p in net.parameters():       # distinct values, so a transposed moment shows
        p.grad = torch.randn(p.shape, generator=gen)
    optimizer.step()
    tdriver._save(state, str(tmp_path), 7, 3, None)
    ckpt = jckpt.load_checkpoint(str(tmp_path))
    assert ckpt["iter"] == 7 and len(ckpt["ema_state_list"]) == 2
    # the resume check of the JAX package's run_training
    fresh = jax.tree.leaves(optax.adam(2e-4).init(ckpt["model_state_dict"]))
    saved = jax.tree.leaves(ckpt["optimizer_state_dict"])
    assert len(saved) == len(fresh)
    assert all(jnp.shape(s) == jnp.shape(f) for s, f in zip(saved, fresh))
    assert saved[0].dtype == np.int32 and int(saved[0]) == 1
    jax.tree.unflatten(jax.tree.structure(optax.adam(2e-4).init(ckpt["model_state_dict"])),
                       saved)
    params = j_load_inference(str(tmp_path / "pointnet_ckpt_7.pkl"))
    _assert_trees_close(module_to_flax(net), params, rtol=0, atol=0)
    # and the port reads it back: parameters, moments, EMA
    net2 = ConditionalPointNet2(cfg)
    state2 = tdriver.TrainState(net=net2, optimizer=torch.optim.Adam(net2.parameters()),
                                ema=tema.ema_init(list(net2.parameters()), (0.999, 0.9999)),
                                ema_rates=(0.999, 0.9999))
    tdriver.load_adam_state(state2, ckpt["optimizer_state_dict"])
    load_flax_params(net2, ckpt["model_state_dict"])
    for a, b in zip(flax_leaves(tdriver.adam_state_tree(state2)),
                    flax_leaves(tdriver.adam_state_tree(state))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Data and the driver


def test_synthetic_tree_and_batches_equal_jax(tmp_path):
    kw = dict(categories=("02691156", "03001627"), models_per_split=3, num_points=600,
              seed=2, shape_variety=True)
    j_write_synthetic(str(tmp_path / "j"), **kw)
    tdata.write_synthetic_shapenet_psr(str(tmp_path / "t"), **kw)
    cmp = filecmp.dircmp(str(tmp_path / "j"), str(tmp_path / "t"))
    assert cmp.left_only == cmp.right_only == [] and cmp.diff_files == []
    for c in kw["categories"]:
        for split in ("train", "val", "test"):
            assert filecmp.cmp(tmp_path / "j" / c / f"{split}.lst",
                               tmp_path / "t" / c / f"{split}.lst", shallow=False)
        for m in os.listdir(tmp_path / "j" / c):
            if m.endswith(".lst"):
                continue
            for f in ("pointcloud.npz", "psr.npz"):
                with np.load(tmp_path / "j" / c / m / f) as a, \
                        np.load(tmp_path / "t" / c / m / f) as b:
                    for k in a.files:
                        np.testing.assert_array_equal(a[k], b[k])
    assert filecmp.cmp(tmp_path / "j" / "metadata.yaml", tmp_path / "t" / "metadata.yaml",
                       shallow=False)
    ds_cfg = dict(keypoint_ddpm_config(batch_size=4)["shapenet_psr_dataset_config"],
                  data_dir=str(tmp_path / "t"), categories=list(kw["categories"]),
                  npoints=128, repeat_dataset=2)
    jb = next(iter(j_get_dataloader(ds_cfg, phase="train", seed=3)))
    tb = next(iter(tdata.get_dataloader(ds_cfg, phase="train", seed=3)))
    assert sorted(jb) == sorted(tb)
    for k in jb:
        if isinstance(jb[k], list):
            assert jb[k] == tb[k]
        else:
            np.testing.assert_array_equal(jb[k], tb[k])
    # psr_from_points solves DPSR on the card unless the caller asks for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdata.write_synthetic_shapenet_psr(str(tmp_path / "p"), psr_from_points=True)


def test_train_position_ddpm_checkpoints_and_resumes(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=8,
                                              num_points=600)
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    cfg["pointnet_config"] = _narrow(lambda: keypoint_ddpm_config())
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, npoints=256)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    state, losses = tdriver.train_position_ddpm(cfg, data_dir=root, max_iters=3,
                                                device="cpu", verbose=False)
    assert [i for i, _ in losses] == [0, 1, 2] and np.isfinite([l for _, l in losses]).all()
    assert state.step == 3
    ckpt_dir = str(tmp_path / "exp" / "T1000_betaT0.02_keypoint_ddpm_airplane" / "checkpoint")
    # two batches an epoch: saved at iteration 1 on the cadence, 2 at the end
    assert sorted(os.listdir(ckpt_dir)) == ["pointnet_ckpt_1.pkl", "pointnet_ckpt_2.pkl"]
    assert find_max_iter(ckpt_dir) == 2
    state2, losses2 = tdriver.train_position_ddpm(cfg, data_dir=root, max_iters=5,
                                                  device="cpu", verbose=False)
    assert losses2[0][0] == 3 and state2.step == 5
    # the JAX package reads and would resume from the port's checkpoint
    ckpt = jckpt.load_checkpoint(ckpt_dir)
    assert ckpt["iter"] == 4
    assert len(jax.tree.leaves(ckpt["optimizer_state_dict"])) == \
        len(jax.tree.leaves(optax.adam(2e-4).init(ckpt["model_state_dict"])))
