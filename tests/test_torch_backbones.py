"""The alternate backbones and the denoiser's remaining options in the port
against the JAX package on the CPU: `PVCNN2` (`models/pvcnn.py`, the narrow
net of `tests/test_pvcnn.py`), `PointwiseNet` and `variance_schedule`
(`models/pointwise_net.py`), `GlobalAttention` in both modes
(`nn/attention.py`), an SA level's neighbour statistics against JAX's sown
collection (`nn/modules.py`), and `train/driver.py::build_network`: one
train step of each new `network_type` against JAX's jitted step on its
replayed draws, then `train_position_ddpm` with its evaluation hook.

The weights are the port's `init_params` draws, perturbed, read by both
packages through `weights.py` (strictly, both ways).  The FP levels'
3-NN weights 1 / (d + 1e-8) read the rounding noise of a query's zero
distance to itself (its level's centres are a subset of its points): the
port replays JAX's 3-NN picks and distances after checking that its own
picks are JAX's and its squared distances within 1e-6 of the clouds'
largest squared norm of JAX's (the matmul form |a|^2 + |b|^2 - 2 a.b leaves
a zero distance a rounding noise of that order, 3e-4 and more once its
square root is taken).

Tolerances: forwards 5e-5 absolute + 1e-5 relative (`tests/torch_models_cases.py`'s
ATOL); a step's loss rtol 1e-5 and its gradient, read as Adam's first
moment (0.1 g), rtol 5e-3, atol 1e-5 (`tests/test_torch_conditional.py`'s);
the schedule 0; the neighbour statistics equal."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.diffusion import calc_diffusion_hyperparams as j_sched
from slide_tpu.models import pointwise_net as jpw
from slide_tpu.models import pvcnn as jpv
from slide_tpu.nn import attention as jatt
from slide_tpu.nn import modules as jmod
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import keypoint_ddpm_config
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams
from slide_tpu_torch.models import pvcnn as tpv
from slide_tpu_torch.nn import attention as tatt
from slide_tpu_torch.nn import modules as tmod
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train import ema as tema
from slide_tpu_torch.weights import flax_leaves, load_flax_params, module_to_flax
from torch_port_helpers import assert_close, fast_jit, perturb, run_pair, to_np

ATOL = 5e-5
THREE_NN_SQDIST_RTOL = 1e-6

# the narrow PVCNN2 of tests/test_pvcnn.py
TINY_PVD = dict(out_dim=3, embed_dim=16, use_att=True,
                sa_blocks=(((8, 1, 8), (64, 0.2, 8, (8, 16))),
                           (None, (4, 0.4, 8, (16, 32)))),
                fp_blocks=(((16, 16), (16, 1, 8)), ((8, 8), (8, 1, 8))))
TINY_POINTWISE = dict(pnet_global_feature_architecture=((3, 16, 32), (64, 64)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(seed, *shape, scale=0.4):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _port_net(net, seed):
    """`net` with `init_params`' draws, perturbed, and its flax tree."""
    tdriver.init_params(net, torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(net), seed)
    load_flax_params(net, params)
    return net, params


def _record_three_nn(monkeypatch):
    calls = []
    real = jpv.three_nn

    def recording(unknown, known):
        dist, idx = real(unknown, known)
        jax.debug.callback(lambda *a: calls.append([np.array(v) for v in a]),
                           unknown, known, dist, idx, ordered=True)
        return dist, idx

    monkeypatch.setattr(jpv, "three_nn", recording)
    return calls


def _replay_three_nn(monkeypatch, calls):
    """The port's PVCNN2 gets JAX's 3-NN picks and distances, after its own
    picks on the same clouds are checked equal and its distances close."""
    replay = iter(calls)
    real = tpv.three_nn

    def replaying(unknown, known):
        j_unknown, j_known, j_dist, j_idx = next(replay)
        np.testing.assert_allclose(to_np(unknown), j_unknown, atol=1e-5, rtol=1e-5)
        dist, idx = real(torch.as_tensor(j_unknown), torch.as_tensor(j_known))
        np.testing.assert_array_equal(to_np(idx), j_idx)
        scale = max(float((j_unknown ** 2).sum(-1).max()), float((j_known ** 2).sum(-1).max()))
        np.testing.assert_allclose(to_np(dist) ** 2, j_dist ** 2,
                                   atol=THREE_NN_SQDIST_RTOL * scale)
        return torch.as_tensor(j_dist).to(unknown.dtype), torch.as_tensor(j_idx)

    monkeypatch.setattr(tpv, "three_nn", replaying)
    return replay


def test_pvcnn2_forward_matches_jax(monkeypatch):
    net, params = _port_net(tpv.PVCNN2(in_dim=3, **TINY_PVD), 2)
    x, cond = _x(0, 2, 128, 3), _x(1, 2, 32, 3)
    ts = np.array([3, 7], np.int32)
    calls = _record_three_nn(monkeypatch)
    jnet = jpv.PVCNN2(**TINY_PVD)
    jout = fast_jit(lambda p: jnet.apply({"params": p}, x, cond, ts), params)
    assert len(calls) == 2
    replay = _replay_three_nn(monkeypatch, calls)
    with torch.no_grad():
        tout = net(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(ts))
    assert next(replay, None) is None
    assert tout.shape == (2, 128, 3)
    assert_close(jout, tout, ATOL)
    # the bridge both ways, strictly: the same leaves, the conv kernels too
    back = module_to_flax(net)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = flax_leaves(back)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="does not match"):
        bad = copy.deepcopy(back)
        bad["sa0_pv0"]["se"]["Dense_2"] = bad["sa0_pv0"]["se"].pop("Dense_1")
        load_flax_params(net, bad)


def test_pointwise_net_and_schedule_match_jax():
    t_var = tm.variance_schedule(100, 1e-4, 0.05)
    j_var = jpw.variance_schedule(100, 1e-4, 0.05)
    assert set(t_var) == set(j_var)
    for k in j_var:
        np.testing.assert_array_equal(t_var[k].numpy(), np.asarray(j_var[k]))
    for residual in (True, False):
        args = dict(TINY_POINTWISE, residual=residual)
        net, params = _port_net(tm.get_pointwise_net(args), 4)
        assert [name for name, _ in net.named_children()][:2] == ["global_pnet", "layers_0"]
        jnet = jpw.get_pointwise_net(args)
        x, cond = _x(2, 3, 40, 3), _x(3, 3, 16, 3)
        ts = np.array([0, 17, 999], np.int32)
        jout = fast_jit(lambda p: jnet.apply({"params": p}, x, cond, ts), params)
        with torch.no_grad():
            tout = net(torch.as_tensor(x), torch.as_tensor(cond), torch.as_tensor(ts))
        assert_close(jout, tout, ATOL)


def test_global_attention_both_modes_match_jax():
    feat = _x(5, 2, 12, 16 + 3, scale=1.0)
    for intended in (False, True):
        for bn, last in ((True, True), (False, True), (True, False)):
            kw = dict(additional_dim=3, attention_bn=bn, last_activation=last,
                      use_intended_attention=intended)
            jout, tout, params = run_pair(jatt.GlobalAttention(16, **kw),
                                          tatt.GlobalAttention(16, **kw), (feat,),
                                          seed=int(intended))
            assert_close(jout, tout, ATOL)
            # the weight stack's parameters exist in both trees, used or not
            assert "w_conv_2" in params and ("w_norm_1" in params) == bn


def test_sa_level_neighbor_stats_match_jax_sown_collection():
    xyz = _x(6, 2, 96, 3, scale=0.5)
    feats = _x(7, 2, 96, 4, scale=1.0)
    kw = dict(npoint=24, nsample=8, radius=0.3, neighbor_def="radius", bias=True,
              record_neighbor_stats=True)
    jsa = jmod.SAModule(mlp_spec=(4, 8, 16), **kw)
    tsa = tmod.SAModule(mlp_spec=(4, 8, 16), **kw)
    variables = fast_jit(lambda k: jsa.init(k, xyz, feats), jax.random.key(0))
    params = perturb(variables["params"], 0)
    (jxyz, jout), sown = jsa.apply({"params": params}, xyz, feats,
                                   mutable=["neighbor_stats"])
    load_flax_params(tsa, params)
    with torch.no_grad():
        txyz, tout = tsa(torch.as_tensor(xyz), torch.as_tensor(feats))
    assert_close(jout, tout, ATOL)
    stats = sown["neighbor_stats"]
    counts = np.asarray(stats["min_mean_max"][0])
    assert counts[0] < counts[2]               # the radius gives varied counts
    for key in ("min_mean_max", "quantile"):
        np.testing.assert_array_equal(to_np(tsa.neighbor_stats[key]),
                                      np.asarray(stats[key][0]))
    assert tmod.collect_neighbor_stats(tsa) == {"": tsa.neighbor_stats}


def _backbone_config(network_type):
    """The kp preset's dataset and schedule with a narrow backbone of
    `network_type` over 64-point clouds without normals: `generation` for
    "pvd", `keypoint_conditional_generation` for "pointwise_net"."""
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    pc = {"network_type": network_type, "in_fea_dim": 0, "model_name": network_type}
    if network_type == "pvd":
        pc["network_args"] = copy.deepcopy(TINY_PVD)
        task = "generation"
    else:
        pc["network_args"] = copy.deepcopy(TINY_POINTWISE)
        task = "keypoint_conditional_generation"
    cfg["pointnet_config"] = pc
    cfg["train_config"]["task"] = task
    cfg["shapenet_psr_dataset_config"].update(npoints=64, include_normals=False,
                                              repeat_dataset=1, num_samples_tested=4,
                                              eval_batch_size=4)
    return cfg


@pytest.mark.parametrize("network_type", ["pvd", "pointwise_net"])
def test_build_network_step_and_training_match_jax(network_type, monkeypatch, tmp_path):
    cfg = _backbone_config(network_type)
    pc, trainset = cfg["pointnet_config"], cfg["shapenet_psr_dataset_config"]
    task = cfg["train_config"]["task"]
    net = tdriver.build_network(pc)
    assert type(net).__name__ == type(jdriver.build_network(pc)).__name__
    assert tdriver.maybe_fused_train_apply(pc, 64, net) is None
    net, params = _port_net(net, 3)
    rng = np.random.default_rng(7)
    batch = {"points": rng.standard_normal((4, 64, 3)).astype(np.float32) * 0.4,
             "normals": rng.standard_normal((4, 64, 3)).astype(np.float32),
             "label": np.array([0, 0, 3, 5], np.int32)}
    key = jax.random.key(13)
    calls = _record_three_nn(monkeypatch) if network_type == "pvd" else None
    opt = optax.adam(2e-4)
    jstate = fast_jit(lambda p: jdriver._init_state(p, opt, (0.999,)), params)
    jstep = jdriver.make_train_step(jdriver.build_network(pc), j_sched(1000, 1e-4, 0.02), opt,
                                    (0.999,), task, trainset)
    jnew, jloss = fast_jit(jstep, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    k_t, k_z = jax.random.split(jax.random.split(key)[1])
    ts = np.array(jax.random.randint(k_t, (4,), 0, 1000))
    z = np.array(jax.random.normal(k_z, (4, 64, 3)))
    if calls is not None:
        replay = _replay_three_nn(monkeypatch, calls)
    net.train()
    optimizer = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.9, 0.999), eps=1e-8)
    state = tdriver.TrainState(net=net, optimizer=optimizer,
                               ema=tema.ema_init(list(net.parameters()), (0.999,)),
                               ema_rates=(0.999,))
    tstep = tdriver.make_train_step(net, calc_diffusion_hyperparams(1000, 1e-4, 0.02), task,
                                    trainset)
    loss = tstep(state, {k: torch.as_tensor(v) for k, v in batch.items()}, torch.Generator(),
                 draws=(torch.as_tensor(ts), torch.as_tensor(z)))
    if calls is not None:
        assert next(replay, None) is None
        monkeypatch.undo()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    adam = tdriver.adam_state_tree(state)
    jl = jax.tree_util.tree_flatten_with_path(jnew.opt_state[0].mu)[0]
    tl = flax_leaves(adam[0][1])
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=5e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))

    # train_position_ddpm: two steps (one epoch), a checkpoint, the evaluation hook's
    # files for the raw weights and the EMA shadow
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=8,
                                              num_points=200)
    cfg["diffusion_config"]["T"] = 5
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1, ema_rate=[0.999])
    state, losses = tdriver.train_position_ddpm(cfg, data_dir=root, max_iters=2,
                                                device="cpu", eval_hook="auto", verbose=False)
    assert [i for i, _ in losses] == [0, 1] and np.isfinite([l for _, l in losses]).all()
    exp = tmp_path / "exp" / f"T5_betaT0.02_{network_type}"
    files = sorted(p.relative_to(exp).as_posix() for p in exp.rglob("*.npz"))
    assert files == ["eval_result/model_ema_0.99900/shapenet_psr_generated_data_64_pts_iter_1.npz",
                     "eval_result/shapenet_psr_generated_data_64_pts_iter_1.npz"]
    with np.load(exp / files[1]) as d:
        assert d["points"].shape == (4, 64, 3) and np.isfinite(d["points"]).all()
