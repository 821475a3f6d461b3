"""The conditional position tasks and the activation dtype in the port
(`slide_tpu_torch/models/denoiser.py`: the condition towers, the global
feature, `encode_condition`, positional encoding, the concatenated-partial
variant; `models/encoder.py`'s positional encoding; `train/driver.py`'s
`_prepare_x` and steps for `generation` and `keypoint_conditional_generation`;
`eval/generation.py`'s condition-cloud route; `nn/precision.py`) against
the JAX package on the CPU.  The dual-tower net is
`torch_port_helpers.conditional_config` (the JAX package's own test net),
its weights drawn by the port's `init_params` and perturbed.

Tolerances: forwards ATOL 5e-5 (+ rtol 1e-5), as `tests/torch_models_cases.py`,
the narrow encoder 3e-4 (`tests/torch_ae_cases.py`'s ENC_ATOL); what passes
through the global PNet of the condition 5e-4 between the packages
(GLOBAL_ATOL: its GroupNorms normalise single channels over 24 points, and
JAX's fp32 statistics put its global feature 1.5e-4 from the port's float64
run, the port's own 4.1e-6), while the port stays within ATOL of its
float64 run; the cached
forward against the direct one 1e-5 (the JAX package's contract test); one
train step's loss rtol 1e-5 and its gradient, read as Adam's first moment
(0.1 g), rtol 5e-3, atol 1e-5; the conditional evaluation's npz 2e-5
(`tests/torch_eval_cases.py`'s CHAIN_ATOL); in bf16, every neighbour and FPS
pick whose input equals the fp32 run's is the fp32 run's pick."""

import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.diffusion import calc_diffusion_hyperparams as j_sched
from slide_tpu.diffusion import x0 as jx0
from slide_tpu.eval import generation as j_gen
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.models.encoder import PointNetEncoder as JEncoder
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import autoencoder_config, keypoint_ddpm_config
from slide_tpu_torch.diffusion import X0Schedule, calc_diffusion_hyperparams
from slide_tpu_torch.eval import generation as t_gen
from slide_tpu_torch.nn import neighborhood
from slide_tpu_torch.nn import precision as tp
from slide_tpu_torch.nn.layers import GroupNorm, Linear
from slide_tpu_torch.ops import calc_cd, pairwise_sqdist
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train import ema as tema
from slide_tpu_torch.weights import flax_leaves, load_flax_params, module_to_flax
from torch_port_helpers import (assert_close, conditional_config, fast_jit, perturb,
                                small_ae_config, to_np)

ATOL = 5e-5
ENC_ATOL = 3e-4
GLOBAL_ATOL = 5e-4
CHAIN_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_net(cls, pc, seed):
    """A port module with `init_params`' draws, perturbed, and its flax tree."""
    net = tdriver.init_params(cls(pc), torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(net), seed)
    load_flax_params(net, params)
    return net.eval(), params


def _x(seed, *shape, scale=0.4):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _cache_np(cache):
    out = {}
    for k, v in cache.items():
        out[k] = [to_np(a) for a in v] if isinstance(v, (list, tuple)) \
            else to_np(v)
    return out


def test_dual_tower_forward_and_condition_cache_match_jax():
    pc = conditional_config()["pointnet_config"]
    net, params = _port_net(tm.ConditionalPointNet2, pc, 0)
    x, cond, cond2 = _x(1, 2, 16, 3), _x(2, 2, 24, 3), _x(3, 2, 24, 3)
    ts, label = np.array([5, 100], np.int32), np.array([0, 3], np.int32)
    jnet = JNet(pc)

    def jrun(p):
        v = {"params": p}
        cache = jnet.apply(v, cond, method="encode_condition")
        return (jnet.apply(v, x, condition=cond, ts=ts, label=label), cache,
                jnet.apply(v, x, ts=ts, label=label, cond_cache=cache))

    jdirect, jcache, jcached = fast_jit(jrun, params)
    t = {k: torch.as_tensor(v) for k, v in dict(x=x, c=cond, c2=cond2, ts=ts,
                                               label=label).items()}
    net64 = copy.deepcopy(net).double()
    with torch.no_grad():
        direct = net(t["x"], ts=t["ts"], label=t["label"], condition=t["c"])
        cache = net.encode_condition(t["c"])
        cached = net(t["x"], ts=t["ts"], label=t["label"], cond_cache=cache)
        other = net(t["x"], ts=t["ts"], label=t["label"], condition=t["c2"])
        cache64 = net64.encode_condition(t["c"].double())
        direct64 = net64(t["x"].double(), ts=t["ts"], label=t["label"],
                         condition=t["c"].double())
    assert set(cache) == set(jcache) == {"global", "l_uvw", "enc", "dec"}
    got, want, f64 = _cache_np(cache), _cache_np(jcache), _cache_np(cache64)
    assert_close(f64["global"], got["global"], ATOL)
    assert_close(want["global"], got["global"], GLOBAL_ATOL)
    for k in ("l_uvw", "enc", "dec"):
        assert len(got[k]) == len(want[k]) == 3
        # the condition's xyz levels are FPS picks: equal
        assert_close(got[k][1:], want[k][1:], 0.0 if k == "l_uvw" else ATOL,
                     rtol=0.0 if k == "l_uvw" else 1e-5)
    assert_close(direct64, direct, ATOL)
    for j, g in ((jdirect, direct), (jcached, cached)):
        assert_close(j, g, GLOBAL_ATOL)
    # the cache contract: the chain's cached net is the net
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), rtol=1e-5, atol=1e-5)
    # the condition matters
    assert float((direct - other).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="condition"):
        net(t["x"], ts=t["ts"], label=t["label"])


def test_position_encoding_and_concate_partial_match_jax():
    """`use_position_encoding` in the denoiser (with the global PNet of the
    condition, which sees the encoding twice) and in the encoder (with its
    global feature), and the single-tower `concate_partial_with_noisy_input`
    (the condition, tagged 1, appended to the input, tagged 0; the output
    is the input's rows)."""
    pos = conditional_config()["pointnet_config"]
    pos.update(include_local_feature=False, use_position_encoding=True,
               position_encoding_multires=2)
    partial = copy.deepcopy(pos)
    partial.update(include_global_feature=False, use_position_encoding=False,
                   concate_partial_with_noisy_input=True, in_fea_dim=1)
    enc = copy.deepcopy(small_ae_config()["decoder_config_list"][0])
    assert enc.get("include_global_feature", False)
    enc.update(use_position_encoding=True, position_encoding_multires=3)
    x, cond = _x(4, 2, 16, 3), _x(5, 2, 24, 3)
    ts, label = np.array([5, 900], np.int32), np.array([1, 2], np.int32)
    kp = _x(6, 2, 16, 3)
    cases = [(JNet, tm.ConditionalPointNet2, pos, (x,), dict(condition=cond, ts=ts, label=label)),
             (JNet, tm.ConditionalPointNet2, partial, (x,),
              dict(condition=cond, ts=ts, label=label)),
             (JEncoder, tm.PointNetEncoder, enc, (kp,), dict(label=label))]
    for i, (jcls, tcls, pc, args, kw) in enumerate(cases):
        net, params = _port_net(tcls, pc, 10 + i)
        jout = fast_jit(lambda p: jcls(pc).apply({"params": p}, *args, **kw), params)
        with torch.no_grad():
            tout = net(*(torch.as_tensor(a) for a in args),
                       **{k: torch.as_tensor(v) for k, v in kw.items()})
        if tcls is tm.PointNetEncoder:
            assert_close(jout[0], tout[0], ENC_ATOL)
            assert_close(list(jout[1]), list(tout[1]), 0.0, rtol=0.0)
        else:
            assert tout.shape == (2, 16, 3)
            assert_close(jout, tout, ATOL)
    with pytest.raises(ValueError, match="requires a condition"):
        net_p, _ = _port_net(tm.ConditionalPointNet2, partial, 0)
        net_p(torch.as_tensor(x), ts=torch.as_tensor(ts), label=torch.as_tensor(label))
    with pytest.raises(ValueError, match="excludes"):
        tm.ConditionalPointNet2(dict(partial, include_global_feature=True))


def _task_setting(task):
    """(pointnet_config, dataset config, x0 block or None) of a task's step:
    `generation` through the x0 engine on clouds with normals (the feature
    chamfer, "cos"), `keypoint_conditional_generation` through the eps
    engine with the dual-tower net's condition towers and feature maps.
    Its global PNet stays out of the step: its max over the condition's
    points meets near-ties whose gradient goes to whichever point rounding
    favours (two XLA compilations of JAX's own step part by 0.0059 of 0.031
    in its second MLP's kernel); its forward is held to JAX above.  Each
    tower has one level here (the forward test runs two), which halves
    JAX's compile of the step."""
    if task == "generation":
        pc = copy.deepcopy(keypoint_ddpm_config()["pointnet_config"])
        pc.update(t_dim=16, class_condition_dim=16, in_fea_dim=3, out_dim=6)
        pc["architecture"].update(npoint=[16], nsample=[8], radius=[0],
                                  feature_dim=[16, 32], decoder_feature_dim=[16, 32],
                                  mlp_depth=2, decoder_mlp_depth=2)
        sdc = {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
               "num_diffusion_timesteps": 1000, "data_clamp_range": 1.0,
               "model_output_scale_factor": 1.0, "loss_type": "cd_p",
               "normal_loss_type": "cos"}
    else:
        pc = conditional_config()["pointnet_config"]
        pc.update(in_fea_dim=3, out_dim=6, include_global_feature=False)
        pc["architecture"].update(npoint=[16], nsample=[8], radius=[0], feature_dim=[8, 16],
                                  decoder_feature_dim=[16, 16])
        pc["condition_net_architecture"].update(npoint=[8], nsample=[4], radius=[0],
                                                feature_dim=[8, 8],
                                                decoder_feature_dim=[8, 8])
        pc["feature_mapper_architecture"].update(
            encoder_feature_map_dim=[8], encoder_radius=[0], encoder_nsample=[4],
            decoder_feature_map_dim=[8, 8], decoder_radius=[0, 0], decoder_nsample=[4, 4])
        sdc = None
    trainset = dict(keypoint_ddpm_config()["shapenet_psr_dataset_config"], npoints=64)
    return pc, trainset, sdc


@pytest.mark.parametrize("task", ["generation", "keypoint_conditional_generation"])
def test_conditional_task_step_matches_jax(task):
    pc, trainset, sdc = _task_setting(task)
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((4, 64, 3)).astype(np.float32)
    normals = rng.standard_normal((4, 64, 3)).astype(np.float32)
    label = np.array([0, 0, 3, 5], np.int32)
    key = jax.random.key(13)
    k_prep, k_loss = jax.random.split(key)

    # the targets
    # jitted: op by op, each eager operation is a compile of its own
    jx, jcond = fast_jit(lambda p, n, k: jdriver._prepare_x(task, trainset, p, n, k),
                         jnp.asarray(pts), jnp.asarray(normals), k_prep)
    tx, tcond = tdriver._prepare_x(task, trainset, torch.as_tensor(pts),
                                   torch.as_tensor(normals), torch.Generator())
    assert tx.shape == (4, 64, 6)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert (tcond is None) == (jcond is None) == (task == "generation")
    if tcond is not None:
        np.testing.assert_allclose(tcond.numpy(), np.asarray(jcond), atol=1e-7)
        no_normals = dict(trainset, include_normals=False)
        assert tdriver._prepare_x(task, no_normals, torch.as_tensor(pts),
                                  torch.as_tensor(normals), None)[0].shape == (4, 64, 3)

    # one step, JAX's draws replayed
    net, params = _port_net(tm.ConditionalPointNet2, pc, 3)
    opt = optax.adam(2e-4)
    jstate = fast_jit(lambda p: jdriver._init_state(p, opt, (0.999,)), params)
    batch = {"points": jnp.asarray(pts), "normals": jnp.asarray(normals),
             "label": jnp.asarray(label)}
    if sdc is None:
        jstep = jdriver.make_train_step(JNet(pc), j_sched(1000, 1e-4, 0.02), opt, (0.999,),
                                        task, trainset)
        tstep = tdriver.make_train_step(net, calc_diffusion_hyperparams(1000, 1e-4, 0.02),
                                        task, trainset)
    else:
        jstep = jdriver.make_x0_train_step(JNet(pc), jx0.X0Schedule.from_config(sdc), sdc,
                                           opt, (0.999,), task, trainset)
        tstep = tdriver.make_x0_train_step(net, X0Schedule.from_config(sdc), sdc, task,
                                           trainset)
    jnew, jloss = fast_jit(jstep, jstate, batch, key)
    k_t, k_z = jax.random.split(k_loss)
    ts = np.asarray(jax.random.randint(k_t, (4,), 0, 1000))
    z = np.asarray(jax.random.normal(k_z, (4, 64, 6)))
    net.train()
    optimizer = torch.optim.Adam(net.parameters(), lr=2e-4, betas=(0.9, 0.999), eps=1e-8)
    state = tdriver.TrainState(net=net, optimizer=optimizer,
                               ema=tema.ema_init(list(net.parameters()), (0.999,)),
                               ema_rates=(0.999,))
    loss = tstep(state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()},
                 torch.Generator(), draws=(torch.as_tensor(ts), torch.as_tensor(z)))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    adam = tdriver.adam_state_tree(state)
    assert int(adam[0][0]) == int(jnew.opt_state[0].count) == 1
    jl = jax.tree_util.tree_flatten_with_path(jnew.opt_state[0].mu)[0]
    tl = flax_leaves(adam[0][1])
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=5e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_conditional_generation_eval_matches_jax(tmp_path):
    """`evaluate_per_rank` for `keypoint_conditional_generation` (the JAX
    package's own test's setting): the keypoints of each shape, noised,
    condition the chain; JAX's draws are replayed (each batch's keypoint
    noise, then its chain); the towers are encoded once per chain; the npz
    holds points, keypoint and gt_points."""
    pc = conditional_config()["pointnet_config"]
    net, params = _port_net(tm.ConditionalPointNet2, pc, 5)
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "ds"), categories=("02691156",),
                                              models_per_split=4, num_points=300,
                                              with_psr=False)
    cfg = dict(keypoint_ddpm_config()["shapenet_psr_dataset_config"], data_dir=root,
               npoints=24, num_keypoints=24, eval_batch_size=2, num_samples_tested=4,
               num_workers=0, repeat_dataset=1, keypoint_noise_magnitude=0.02)
    t_steps, seed = 3, 2
    task = "keypoint_conditional_generation"
    want = j_gen.evaluate_per_rank(JNet(pc), params, cfg, j_sched(t_steps, 1e-4, 0.02),
                                   str(tmp_path / "jax"), task, point_feature_dim=3,
                                   seed=seed)
    key, draws = jax.random.key(seed), []
    for _ in range(2):
        key, k2 = jax.random.split(key)
        draws.append(jax.random.normal(k2, (2, 24, 3)))
        key, k_s = jax.random.split(key)
        for _ in range(t_steps + 1):
            k_s, k = jax.random.split(k_s)
            draws.append(jax.random.normal(k, (2, 24, 3)))
    it = iter([torch.as_tensor(np.array(d)) for d in draws])
    encodes = []
    real = net.encode_condition
    net.encode_condition = lambda c: encodes.append(c.shape) or real(c)
    got = t_gen.evaluate_per_rank(net, cfg, calc_diffusion_hyperparams(t_steps, 1e-4, 0.02),
                                  str(tmp_path / "port"), task, point_feature_dim=3,
                                  seed=seed, device="cpu", noise_fn=lambda shape: next(it))
    assert next(it, None) is None
    assert encodes == [(2, 24, 3)] * 2
    assert os.path.basename(got) == os.path.basename(want)
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        assert {"points", "keypoint", "gt_points"} <= set(g.files)
        assert g["points"].shape == (4, 24, 3) and g["gt_points"].shape == (4, 24, 6)
        for k in w.files:
            if k == "timing":
                continue
            if w[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], atol=CHAIN_ATOL, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_activation_dtype_switch(monkeypatch):
    """`tests/test_precision.py`'s five checks against the port, the
    environment's switch, the `activation_dtype` route through
    `run_training`, and a bf16 round trip that keeps the neighbour picks
    (`_check_bf16_picks`)."""
    # Linear: the output follows the switch, the parameters stay fp32
    x = torch.ones(2, 8)
    layer = Linear(8, 4)
    assert layer.weight.dtype == torch.float32 and layer(x).dtype == torch.float32
    with tp.activation_dtype_scope("bfloat16"):
        assert layer(x).dtype == torch.bfloat16 and layer.weight.dtype == torch.float32
        # a float64 run is a reference and stays float64
        assert Linear(8, 4).double()(x.double()).dtype == torch.float64
    assert tp.activation_dtype() is None
    # GroupNorm: bf16 output, fp32 scale
    with tp.activation_dtype_scope("bfloat16"):
        gn = GroupNorm(2, 8)
        assert gn(torch.ones(2, 5, 8)).dtype == torch.bfloat16
        assert gn.weight.dtype == torch.float32
    with pytest.raises(ValueError):
        tp.set_activation_dtype("float8")
    # neighbour distances stay fp32
    xb = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 16, 3))).bfloat16()
    with tp.activation_dtype_scope("bfloat16"):
        assert pairwise_sqdist(xb, xb).dtype == torch.float32
    # the environment's switch: read at import, a typo warns and keeps fp32
    import importlib
    try:
        os.environ["SLIDE_TPU_ACT_DTYPE"] = "float8"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            importlib.reload(tp)
        assert tp.activation_dtype() is None and any("float8" in str(w.message)
                                                     for w in caught)
        os.environ["SLIDE_TPU_ACT_DTYPE"] = "bf16"
        importlib.reload(tp)
        assert tp.activation_dtype() == torch.bfloat16
    finally:
        os.environ.pop("SLIDE_TPU_ACT_DTYPE", None)
        importlib.reload(tp)
    assert tp.activation_dtype() is None

    # the AE step of test_ae_train_step_finite_bf16 (at full width on the
    # card, chip_smoke.py's train_bf16), here the narrow AE at batch 2;
    # params and Adam's state stay fp32
    b, npts = 2, 256
    cfg = autoencoder_config("airplane", batch_size=b)
    cfg["pointnet_config"] = small_ae_config()
    cfg["shapenet_psr_dataset_config"]["npoints"] = npts
    gen = torch.Generator().manual_seed(1)
    batch = {"points": torch.randn((b, npts, 3), generator=gen),
             "normals": torch.randn((b, npts, 3), generator=gen),
             "label": torch.zeros(b, dtype=torch.int64)}
    with tp.activation_dtype_scope("bfloat16"):
        state, step = tdriver.build_ae_training(cfg, device="cpu")
        loss = step(state, batch, torch.Generator().manual_seed(7))
    assert np.isfinite(float(loss))
    assert all(p.dtype == torch.float32 for p in state.net.parameters())
    assert all(v.dtype == torch.float32 for st in state.optimizer.state.values()
               for k, v in st.items() if k != "step")

    # run_training takes the config's dtype for the run and restores the
    # one before it
    seen = []
    cfg = {"train_config": {"activation_dtype": "bfloat16", "device_data": False},
           "shapenet_psr_dataset_config": {}}
    real = tdriver._run_training
    try:
        tdriver._run_training = lambda *a, **k: seen.append(tp.activation_dtype())
        tdriver.run_training(cfg, None, None)
        tdriver.run_training({**cfg, "train_config": {}}, None, None)
        # device_data is ported (tests/test_torch_device_corpus.py): it runs
        # under the same scope
        tdriver.run_training({**cfg, "train_config": {"activation_dtype": "bfloat16",
                                                      "device_data": True}}, None, None)
    finally:
        tdriver._run_training = real
    assert seen == [torch.bfloat16, None, torch.bfloat16] and tp.activation_dtype() is None
    _check_bf16_picks(monkeypatch)


def _record_picks(monkeypatch):
    """Record every kNN search and FPS call of the autoencoder: (inputs,
    picks) on the host."""
    import slide_tpu_torch.models.autoencoder as t_ae
    import slide_tpu_torch.models.upsample_decoder as t_updec
    import slide_tpu_torch.nn.modules as t_modules
    calls = []
    real_knn, real_fps = neighborhood.knn_points, t_modules.furthest_point_sample

    def knn(query, points, k):
        sqd, idx = real_knn(query, points, k)
        calls.append(("knn", (query.detach().clone(), points.detach().clone()), idx))
        return sqd, idx

    def fps(xyz, k, start_idx=0, num_forced=0):
        idx = real_fps(xyz, k, start_idx=start_idx, num_forced=num_forced)
        calls.append(("fps", (xyz.detach().clone(),), idx))
        return idx

    monkeypatch.setattr(neighborhood, "knn_points", knn)
    for mod in (t_modules, t_updec, t_ae):
        monkeypatch.setattr(mod, "furthest_point_sample", fps)
    return calls


def _check_bf16_picks(monkeypatch):
    """The narrow autoencoder's round trip in bf16 and in fp32 on the same
    cloud and draws: every kNN search and FPS call whose input is the fp32
    run's picks what the fp32 run picked (the encoder's calls, on the input
    cloud, all are such calls); the first decoder level's cloud lies within
    bf16 rounding of fp32's (chamfer: measured 2.9e-3 of a cloud of size
    1; the later levels trim at picks that bf16 moved), every level is
    finite."""
    from slide_tpu_torch.models import build_autoencoder
    ae = build_autoencoder(small_ae_config())
    tdriver.init_params(ae, torch.Generator().manual_seed(0))
    cloud = torch.as_tensor(np.concatenate([_x(8, 2, 256, 3, scale=1.0),
                                            _x(9, 2, 256, 3, scale=1.0)], axis=-1))
    kp = torch.as_tensor(_x(10, 2, 16, 3))
    label = torch.tensor([0, 3])
    calls = _record_picks(monkeypatch)
    with torch.no_grad():
        ae.encoder(cloud, label=label)
    n_enc = len(calls)
    assert n_enc > 0
    runs = {}
    for dt in (None, "bfloat16"):
        calls.clear()
        gen = torch.Generator().manual_seed(3)
        with tp.activation_dtype_scope(dt), torch.no_grad():
            l_xyz, _ = ae(cloud, kp, label=label, loss_type="cd_p",
                          noise_fn=lambda shape: torch.randn(shape, generator=gen),
                          start_fn=lambda b, n: torch.zeros(b, dtype=torch.int32))
        runs[dt] = (list(calls), l_xyz)
    (c32, out32), (c16, out16) = runs[None], runs["bfloat16"]
    assert [c[0] for c in c32] == [c[0] for c in c16]
    same = [i for i, (a, b) in enumerate(zip(c32, c16))
            if all(torch.equal(x, y) for x, y in zip(a[1], b[1]))]
    assert same[:n_enc] == list(range(n_enc))
    for i in same:
        assert torch.equal(c32[i][2], c16[i][2]), (i, c32[i][0])
    assert len(same) < len(c32)      # the decoder's clouds carry bf16 rounding
    gap = calc_cd(out16[1].float(), out32[1])["cd_p"]
    size = float(out32[1][..., :3].abs().max())
    assert float(gap.max()) < 1e-2 * size, (gap, size)
    assert all(bool(torch.isfinite(c).all()) for c in out16)
