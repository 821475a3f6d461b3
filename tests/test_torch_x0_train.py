"""The x0 engine's training in the port (`slide_tpu_torch/diffusion/x0.py`:
`X0Schedule`, `x0_training_loss`, `diffuse`, `diffuse_t_steps`;
`ops/chamfer.py::calc_cd`; `train/driver.py::make_x0_train_step`, the x0
branch of `build_position_ddpm` and the x0 sampler of
`make_generation_eval_hook`) against the JAX package on the CPU.

Tolerances: the schedule's coefficients 1e-7 (the same float64 numpy, cast
to fp32); the forward diffusions 1e-6 on replayed noise; the losses rtol
1e-5 and their gradients rtol 5e-3, atol 1e-4 (`tests/torch_train_cases.py`'s);
one train step's loss rtol 1e-5 and its gradient, read as Adam's first
moment (0.1 g), at rtol 5e-3, atol 1e-5."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.diffusion import x0 as jx0
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.ops import calc_cd as j_calc_cd
from slide_tpu.train import checkpoint as jckpt
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch.configs import keypoint_ddpm_config
from slide_tpu_torch.diffusion import x0 as tx0
from slide_tpu_torch.eval import evaluate_per_rank
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.models import fused_denoiser as tf
from slide_tpu_torch.ops import calc_cd
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train import ema as tema
from slide_tpu_torch.train.checkpoint import find_max_iter, load_checkpoint
from slide_tpu_torch.weights import flax_leaves, load_flax_params, module_to_flax
from torch_port_helpers import fast_jit, perturb

N = 16
BASE = {"beta_schedule": "linear", "beta_start": 1e-4, "beta_end": 0.02,
        "num_diffusion_timesteps": 1000, "data_clamp_range": 1.0,
        "model_output_scale_factor": 1.0}
# the x0 block of tests/test_train_e2e.py::test_x0_engine_position_training
E2E_X0 = dict(BASE, loss_type="mixed_cd_t_epsilon_mse", t_trunction=100,
              normal_loss_type="mse")
LOSS_TYPES = ("cd_p", "cd_t", "x0_mse", "epsilon_mse", "mixed_cd_p_epsilon_mse",
              "mixed_cd_t_epsilon_mse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow_pc():
    cfg = copy.deepcopy(keypoint_ddpm_config()["pointnet_config"])
    cfg.update(t_dim=16, class_condition_dim=16)
    cfg["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                               mlp_depth=2, decoder_mlp_depth=2)
    return cfg


def _draws(key, shape):
    """JAX's draws inside `x0_training_loss`: ts, then z."""
    k_t, k_z = jax.random.split(key)
    return (np.asarray(jax.random.randint(k_t, (shape[0],), 0, 1000)),
            np.asarray(jax.random.normal(k_z, shape)))


def _assert_trees_close(got, want, rtol, atol):
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], flax_leaves(got)
    assert len(jl) == len(tl)
    for (path, w), g in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_schedule_and_forward_diffusion_match_jax():
    fields = ("alphas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_mean_coef1", "posterior_mean_coef2",
              "sqrt_alphas", "sqrt_one_minus_alphas", "logvar")
    cases = [dict(BASE, loss_type="cd_p", model_var_type="fixedlarge"),
             # the reference's misspelt key; scale_loss_terms
             dict(E2E_X0, scale_loss_terms=True),
             # from the coefficient, for both mixed types
             dict(BASE, loss_type="mixed_cd_p_epsilon_mse", xt_coefficient_trunction=1.2),
             dict(BASE, loss_type="mixed_cd_t_epsilon_mse", xt_coefficient_trunction=3.0,
                  beta_schedule="quad"),
             # only the mixed types read a truncation
             dict(BASE, loss_type="x0_mse", t_trunction=100)]
    truncs = []
    for cfg in cases:
        js, ts_ = jx0.X0Schedule.from_config(cfg), tx0.X0Schedule.from_config(cfg)
        for k in ("T", "data_clamp_range", "model_output_scale_factor", "scale_loss_terms",
                  "t_truncation"):
            assert getattr(ts_, k) == getattr(js, k), k
        for k in fields:
            np.testing.assert_allclose(getattr(ts_, k).numpy(), np.asarray(getattr(js, k)),
                                       rtol=1e-7, atol=1e-7, err_msg=k)
        truncs.append(ts_.t_truncation)
    assert truncs[1] == 100 and truncs[4] == 0 and truncs[2] > 0 and truncs[3] > truncs[2]
    sr = tx0.X0Schedule.from_config(cases[2]).sqrt_recip_alphas_cumprod.numpy()
    assert sr[truncs[2] - 1] < 1.2 <= sr[truncs[2]]

    # step-by-step forward diffusion and the one-shot jump on JAX's noise
    sched_j = jx0.X0Schedule.from_config(dict(BASE, num_diffusion_timesteps=20))
    sched_t = tx0.X0Schedule.from_config(dict(BASE, num_diffusion_timesteps=20))
    x0 = np.random.default_rng(0).standard_normal((2, N, 3)).astype(np.float32)
    for curr, n in ((0, None), (5, 7), (15, 30)):
        key = jax.random.key(curr)
        want = jx0.diffuse(key, jnp.asarray(x0), sched_j, curr_step=curr, n_steps=n)
        steps = (20 - curr) if n is None or curr + n > 20 else n
        noise, k = [], key
        for _ in range(steps):
            k, k_n = jax.random.split(k)
            noise.append(torch.as_tensor(np.array(jax.random.normal(k_n, x0.shape))))
        it = iter(noise)
        got = tx0.diffuse(torch.as_tensor(x0), sched_t, lambda shape: next(it),
                          curr_step=curr, n_steps=n)
        assert next(it, None) is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tx0.diffuse(torch.as_tensor(x0), sched_t, torch.randn, curr_step=20)
    for t in (0, 7, 19):
        key = jax.random.key(100 + t)
        want = jx0.diffuse_t_steps(key, jnp.asarray(x0), t, sched_j)
        noise = torch.as_tensor(np.array(jax.random.normal(key, x0.shape)))
        got = tx0.diffuse_t_steps(torch.as_tensor(x0), t, sched_t, noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_calc_cd_f1_and_normal_losses_match_jax():
    """`calc_cd` as the x0 loss calls it: the F-score at 1e-4 and the
    feature ("normal") terms of 6-channel clouds, "cos" and "mse", values
    and gradients; some points within 1e-2 of their target so that the
    F-score is neither 0 nor 1."""
    rng = np.random.default_rng(3)
    gt = rng.standard_normal((3, 40, 6)).astype(np.float32)
    out = (gt[:, ::-1] + 0.3 * rng.standard_normal((3, 40, 6))).astype(np.float32)
    out[:, :10, :3] = gt[:, 30:, :3] + 2e-3 * rng.standard_normal((3, 10, 3))
    keys = ("cd_p", "cd_t", "cd_feature_p", "cd_feature_t", "f1")
    normals = ("cos", "mse")

    def jsum(o, normal):
        r = j_calc_cd(o, jnp.asarray(gt), calc_f1=True, f1_threshold=1e-4,
                      normal_loss_type=normal)
        return sum(jnp.sum(r[k]) for k in keys[:4]), r

    # one compile for both (op by op, each operation would be one)
    jax_runs = fast_jit(lambda o: [jax.value_and_grad(jsum, has_aux=True)(o, n)
                                   for n in normals], jnp.asarray(out))
    for normal, ((_, want), jgrad) in zip(normals, jax_runs):
        o = torch.tensor(out, requires_grad=True)
        got = calc_cd(o, torch.as_tensor(gt), calc_f1=True, f1_threshold=1e-4,
                      normal_loss_type=normal)
        sum(torch.sum(got[k]) for k in keys[:4]).backward()
        assert 0 < float(want["f1"].max()) < 1
        for k in keys:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{normal} {k}")
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=5e-3, atol=1e-4,
                                   err_msg=normal)


def test_x0_training_loss_matches_jax():
    """All six loss types, with and without `scale_loss_terms`, on 6-channel
    clouds (the feature terms, "cos" and "mse"): every returned term and the
    gradient of the training loss to the stand-in net's weight; the draws
    are JAX's, the truncation falls between them."""
    rng = np.random.default_rng(4)
    x = (0.5 * rng.standard_normal((4, N, 6))).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 6))).astype(np.float32)
    key = jax.random.key(5)
    ts, z = _draws(key, x.shape)
    assert (ts < 500).any() and (ts >= 500).any()
    cases = [(lt, scale, ("cos", "mse")[i % 2]) for i, lt in enumerate(LOSS_TYPES)
             for scale in (False, True)]

    def jloss(wj, lt, scale, normal):
        js = jx0.X0Schedule.from_config(dict(BASE, loss_type=lt, t_trunction=500,
                                             scale_loss_terms=scale))
        out = jx0.x0_training_loss(lambda xt, t: jnp.tanh(xt @ wj), key, jnp.asarray(x), js,
                                   loss_type=lt, normal_loss_type=normal)
        return out["training_loss"], out

    # the twelve cases in one compile (op by op, each operation would be one)
    jax_runs = fast_jit(lambda wj: [jax.value_and_grad(jloss, has_aux=True)(wj, *c)
                                    for c in cases], jnp.asarray(w))
    for (lt, scale, normal), ((_, want), jgrad) in zip(cases, jax_runs):
        tsch = tx0.X0Schedule.from_config(dict(BASE, loss_type=lt, t_trunction=500,
                                               scale_loss_terms=scale))
        wt = torch.tensor(w, requires_grad=True)
        got = tx0.x0_training_loss(lambda xt, t: torch.tanh(xt @ wt),
                                   torch.as_tensor(x), tsch, loss_type=lt,
                                   normal_loss_type=normal, ts=torch.as_tensor(ts),
                                   z=torch.as_tensor(z))
        got["training_loss"].backward()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{lt} {scale} {k}")
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgrad), rtol=5e-3,
                                   atol=1e-4, err_msg=f"{lt} {scale}")
    with pytest.raises(ValueError):
        tx0.x0_training_loss(lambda xt, t: xt, torch.as_tensor(x), tsch, loss_type="cd",
                             ts=torch.as_tensor(ts), z=torch.as_tensor(z))


def test_x0_train_step_matches_jax():
    """One x0 step of `keypoint_generation` (the e2e test's loss block, with
    the truncation at 500 so that the batch's draws take both terms)
    against JAX's jitted step, the port's step run with the fused
    denoiser's plain version and with the module."""
    cfg = _narrow_pc()
    trainset = keypoint_ddpm_config()["shapenet_psr_dataset_config"]
    sdc = dict(E2E_X0, t_trunction=500)
    net = tdriver.init_params(ConditionalPointNet2(cfg), torch.Generator().manual_seed(0))
    params = perturb(module_to_flax(net), 0)
    opt = optax.adam(2e-4)
    jstate = fast_jit(lambda p: jdriver._init_state(p, opt, (0.999,)), params)
    pts = np.random.default_rng(5).standard_normal((4, 128, 3)).astype(np.float32)
    label = np.array([0, 0, 3, 5], np.int32)
    batch = {"points": jnp.asarray(pts), "normals": jnp.asarray(pts),
             "label": jnp.asarray(label)}
    key = jax.random.key(12)
    jstep = jdriver.make_x0_train_step(JNet(cfg), jx0.X0Schedule.from_config(sdc), sdc, opt,
                                       (0.999,), "keypoint_generation", trainset)
    jnew, jloss = fast_jit(jstep, jstate, batch, key)
    ts, z = _draws(jax.random.split(key)[1], (4, N, 3))
    assert (ts < 500).any() and (ts >= 500).any()

    grads = {}
    for mode in ("fused", "module"):
        tnet = load_flax_params(ConditionalPointNet2(cfg), params)
        optimizer = torch.optim.Adam(tnet.parameters(), lr=2e-4, betas=(0.9, 0.999),
                                     eps=1e-8)
        state = tdriver.TrainState(net=tnet, optimizer=optimizer,
                                   ema=tema.ema_init(list(tnet.parameters()), (0.999,)),
                                   ema_rates=(0.999,))
        fused_apply = tf.make_fused_train_fn(cfg, tnet, N) if mode == "fused" else None
        step = tdriver.make_x0_train_step(tnet, tx0.X0Schedule.from_config(sdc), sdc,
                                          "keypoint_generation", trainset,
                                          fused_apply=fused_apply)
        loss = step(state, {"points": torch.as_tensor(pts), "label": torch.as_tensor(label)},
                    torch.Generator(), draws=(torch.as_tensor(ts), torch.as_tensor(z)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, err_msg=mode)
        adam = tdriver.adam_state_tree(state)
        assert int(adam[0][0]) == int(jnew.opt_state[0].count) == 1
        _assert_trees_close(adam[0][1], jnew.opt_state[0].mu, rtol=5e-3, atol=1e-5)
        grads[mode] = adam[0][1]
    _assert_trees_close(grads["fused"], grads["module"], rtol=5e-3, atol=1e-5)


def test_train_position_ddpm_x0_checkpoints_resumes_and_evaluates(tmp_path):
    """`train_position_ddpm` with `standard_diffusion_config`: checkpoints
    the JAX package reads, a resume, and the x0 hook's files for the raw
    weights and both EMA shadows, each equal to `evaluate_per_rank` with an
    x0 chain of the module loaded from that checkpoint's weights."""
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=8,
                                              num_points=600, with_psr=False)
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    cfg["pointnet_config"] = _narrow_pc()
    t_steps = 6
    cfg["standard_diffusion_config"] = dict(E2E_X0, num_diffusion_timesteps=t_steps,
                                            t_trunction=3)
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, npoints=256,
                                              eval_batch_size=2, num_samples_tested=4)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    state, losses = tdriver.train_position_ddpm(cfg, data_dir=root, max_iters=3,
                                                device="cpu", eval_hook="auto",
                                                verbose=False)
    assert [i for i, _ in losses] == [0, 1, 2] and np.isfinite([l for _, l in losses]).all()
    exp_root, ckpt_dir = tdriver.experiment_dirs(cfg)
    assert sorted(os.listdir(ckpt_dir)) == ["pointnet_ckpt_1.pkl", "pointnet_ckpt_2.pkl"]
    state2, losses2 = tdriver.train_position_ddpm(cfg, data_dir=root, max_iters=4,
                                                  device="cpu", verbose=False)
    assert losses2[0][0] == 3 and state2.step == 4 and find_max_iter(ckpt_dir) == 3
    ckpt = jckpt.load_checkpoint(ckpt_dir)
    assert ckpt["iter"] == 3 and len(ckpt["ema_state_list"]) == 2
    assert len(jax.tree.leaves(ckpt["optimizer_state_dict"])) == \
        len(jax.tree.leaves(optax.adam(2e-4).init(ckpt["model_state_dict"])))

    name = "shapenet_psr_generated_data_16_pts_iter_1.npz"
    base = os.path.join(exp_root, "eval_result")
    files = {"raw": os.path.join(base, name)}
    files.update({i: os.path.join(base, f"model_ema_{r:.5f}", name)
                  for i, r in enumerate(cfg["train_config"]["ema_rate"])})
    saved = load_checkpoint(ckpt_dir, 1)
    trainset = dict(cfg["shapenet_psr_dataset_config"], data_dir=root)
    x0_sched = tx0.X0Schedule.from_config(cfg["standard_diffusion_config"])
    for which, path in files.items():
        net = ConditionalPointNet2(cfg["pointnet_config"])
        load_flax_params(net, saved["model_state_dict"] if which == "raw"
                         else saved["ema_state_list"][which])
        net.eval()

        def sampler(noise_fn, label, condition, net=net):
            return tx0.x0_denoise(lambda x, t: net(x, ts=t, label=label),
                                  (label.shape[0], N, 3), x0_sched, noise_fn)
        want = evaluate_per_rank(net, trainset, None, str(tmp_path / f"again_{which}"),
                                 "keypoint_generation", ckpt_info="_iter_1", device="cpu",
                                 custom_sampler=sampler)
        with np.load(path) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files)
            assert g["points"].shape == (4, N, 3) and np.isfinite(g["points"]).all()
            # the hook ran the fused denoiser's plain version, this the module
            np.testing.assert_allclose(g["points"], w["points"], atol=1e-5, rtol=0)
            np.testing.assert_array_equal(g["label"], w["label"])
