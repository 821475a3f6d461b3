"""SAP upsampler training in the port (`train/driver.py::train_upsampler`,
`make_upsampler_train_step`, the synthetic writer's DPSR grids) against the
JAX package on the CPU.

One module fixture writes the JAX package's synthetic tree and the port's
(DPSR grids from the points) and runs the JAX package's own
`make_upsampler_train_step`, jitted, once per setting: the preset's
mirrored and permuted cloud with the tanh-MSE, and the frozen autoencoder's
round trip with `split_before_refine` noise, `only_original_points_split`
and the plain MSE.  Its optimizer is a transformation that keeps the
gradient as its state, so one call gives JAX's loss and gradient.  Its FPS
picks, posterior noises, keypoint noise, round-trip noise and permutation
are replayed into the port.  The nets are `train_sap_config`'s (narrow, two
SA levels of 128 channels: see there) over `train_ae_config`'s autoencoder,
DPSR at 16^3.

Tolerances, each from a measurement (`pytest -rP` prints the distances):
  - the grids of the two trees: DPSR's CPU gap, 2e-6 (measured 3.6e-7);
  - the loss: 5e-5 relative to JAX's and 3e-5 to the port's float64 run
    (measured 2.0e-5 and 1.3e-5, the round trip's MSE of ~35);
  - the gradient: each element within GRAD_TOL of the tree's largest
    element from JAX's, and within GRAD_F64_TOL of it from the port's own
    float64 run on the same kNN searches (measured: the two fp32 runs 3.3e-4
    and 8.4e-5 apart; the port 2.6e-3 and 1.9e-5 from float64, JAX 2.6e-3
    and 8.6e-5: in the mirrored setting both fp32 runs part from float64 in
    the same elements);
  - one Adam step: `assert_one_adam_step` at the gradient tolerance;
  - the ties: 1e-5 of the largest element (measured 2.9e-7)"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.data.synthetic import write_synthetic_shapenet_psr as j_write_tree
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.sap import DPSR as JDPSR
from slide_tpu.sap import network_output_to_dpsr_grid as j_network_output_to_dpsr_grid
from slide_tpu.train import build_autoencoder as j_build_ae
from slide_tpu.train import checkpoint as jckpt
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import autoencoder_config, upsampler_config
from slide_tpu_torch.pipeline import DEFAULT_CKPTS
from slide_tpu_torch.sap import DPSR, network_output_to_dpsr_grid
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train.checkpoint import find_max_iter
from slide_tpu_torch.weights import (flax_leaves, load_flax_params, module_to_flax,
                                     read_checkpoint)
from torch_port_helpers import (DECODE_ATOL, assert_one_adam_step, assert_trees_close,
                                perturb, record_jax_fps, record_jax_posterior_noise,
                                replay_fps_in_port, train_ae_config, train_sap_config)

B, N, RES = 2, 100, 16
AE_POINTS = 200         # the round trip's decoded cloud
LR = 2e-4
TREE_PSR_ATOL = 2e-6
LOSS_RTOL, LOSS_F64_RTOL = 5e-5, 3e-5
GRAD_TOL, GRAD_F64_TOL = 2e-3, 5e-3
TIE_GRAD_TOL = 1e-5
SETTINGS = ("mirrored", "ae_round_trip")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # narrow nets: one thread runs them as fast and leaves the cores to the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setting_config(setting: str) -> dict:
    cfg = train_sap_config()
    cfg["dpsr_config"]["grid_res"] = RES
    trainset = cfg["shapenet_psr_dataset_config"]
    trainset.update(batch_size=B, npoints=N)
    if setting == "ae_round_trip":
        ae = autoencoder_config()
        ae["pointnet_config"] = train_ae_config()
        ae["noise_magnitude"] = 0.02
        cfg["autoencoder_config"] = ae
        cfg["dpsr_config"].update(split_before_refine=True, split_factor=2,
                                  only_original_points_split=True, psr_tanh=False)
        trainset["keypoint_noise_magnitude"] = 0.04
    return cfg


def _grad_keeper():
    """An optax transformation whose update is zero and whose state is the
    gradient it was handed: one train step returns JAX's gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _batch_from_tree(root: str) -> dict:
    """The first B airplane models of a synthetic tree: N of their points,
    their normals off unit length (the step normalises them), the grid."""
    out = {"points": [], "normals": [], "psr": []}
    for i in range(B):
        mdir = os.path.join(root, "02691156", f"train_model_{i}")
        with np.load(os.path.join(mdir, "pointcloud.npz")) as d:
            out["points"].append(d["points"][:N])
            out["normals"].append(1.7 * d["normals"][:N])
        with np.load(os.path.join(mdir, "psr.npz")) as d:
            out["psr"].append(d["psr"])
    out = {k: np.stack(v).astype(np.float32) for k, v in out.items()}
    out["label"] = np.array([0, 3], np.int32)
    return out


def _jax_step(cfg, params, ae_params, batch, key):
    """The JAX package's step on `params`, jitted: (loss, gradient, FPS
    calls, posterior noises)."""
    pc, dc = cfg["pointnet_config"], cfg["dpsr_config"]
    ae = None
    if ae_params is not None:
        ae = j_build_ae(cfg["autoencoder_config"]["pointnet_config"])
    step = jdriver.make_upsampler_train_step(
        JNet(pc), JDPSR((RES,) * 3, sig=dc["psr_sigma"]), _grad_keeper(), (),
        cfg["shapenet_psr_dataset_config"], dc, pc, ae=ae, ae_params=ae_params,
        noise_magnitude=cfg.get("autoencoder_config", {}).get("noise_magnitude", 0.0))
    mp = pytest.MonkeyPatch()
    try:
        calls = record_jax_fps(mp)
        noises = record_jax_posterior_noise(mp)
        new, loss = jax.jit(step)(jdriver._init_state(params, _grad_keeper(), ()), batch, key)
        jax.effects_barrier()
    finally:
        mp.undo()
    return float(loss), new.opt_state, calls, noises


@pytest.fixture(scope="module")
def upsampler_steps(tmp_path_factory):
    """The two packages' synthetic trees, a batch from the port's, and per
    setting the JAX step's loss, gradient and draws on perturbed weights;
    optax's Adam step on the first setting's gradient."""
    tmp = tmp_path_factory.mktemp("upsampler")
    kw = dict(models_per_split=2, num_points=600, psr_res=RES, shape_variety=True,
              psr_from_points=True)
    j_root = j_write_tree(str(tmp / "jax"), **kw)
    t_root = tdata.write_synthetic_shapenet_psr(str(tmp / "port"), device="cpu", **kw)
    batch = _batch_from_tree(t_root)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.key(11)
    k_kp, _, k_noise, k_perm = jax.random.split(key, 4)
    steps = {}
    for setting in SETTINGS:
        cfg = _setting_config(setting)
        dc = cfg["dpsr_config"]
        net = tdriver.init_params(tm.ConditionalPointNet2(cfg["pointnet_config"]),
                                  torch.Generator().manual_seed(0))
        params = perturb(module_to_flax(net), 0, scale=0.05)
        ae_params, draws, n_in = None, {}, N
        if setting == "ae_round_trip":
            ae = tdriver.init_params(
                tm.build_autoencoder(cfg["autoencoder_config"]["pointnet_config"]),
                torch.Generator().manual_seed(1))
            ae_params = perturb(module_to_flax(ae), 1, scale=0.05)
        loss, grads, calls, noises = _jax_step(cfg, params, ae_params, jbatch, key)
        if setting == "ae_round_trip":
            sf = dc["split_factor"]
            n_in = AE_POINTS * sf
            draws.update(
                keypoint_noise=np.asarray(jax.random.normal(jax.random.split(k_kp)[1],
                                                            (B, 16, 3))),
                posterior=noises,
                ae_noise=np.asarray(jax.random.normal(k_noise, (B, AE_POINTS, sf, 6))))
        if not dc.get("only_original_points_split", False):
            draws["perm"] = np.asarray(jax.random.permutation(k_perm, 2 * n_in))
        steps[setting] = dict(cfg=cfg, params=params, ae_params=ae_params, calls=calls,
                              draws=draws, loss=loss, grads=grads)
    assert len(steps["ae_round_trip"]["draws"]["posterior"]) == 2
    adam = optax.adam(LR)

    @jax.jit
    def adam_step(g, p):
        updates, opt_state = adam.update(g, adam.init(p), p)
        return optax.apply_updates(p, updates), opt_state

    first = steps[SETTINGS[0]]
    return dict(j_root=j_root, t_root=t_root, batch=batch, steps=steps,
                adam=adam_step(first["grads"], first["params"]))


def test_synthetic_tree_with_dpsr_grids_matches_jax(upsampler_steps, tmp_path):
    # the same seed gives the same clouds (the grids draw nothing from it)
    # and grids within DPSR's CPU gap
    j_root, t_root = upsampler_steps["j_root"], upsampler_steps["t_root"]
    worst = 0.0
    for split in ("train", "val", "test"):
        for i in range(2):
            for name in ("pointcloud", "psr"):
                rel = os.path.join("02691156", f"{split}_model_{i}", name + ".npz")
                with np.load(os.path.join(j_root, rel)) as a, \
                        np.load(os.path.join(t_root, rel)) as b:
                    assert sorted(a.files) == sorted(b.files)
                    for key in a.files:
                        assert a[key].dtype == b[key].dtype == np.float32
                        if name == "pointcloud":
                            np.testing.assert_array_equal(b[key], a[key])
                        else:
                            worst = max(worst, float(np.abs(b[key] - a[key]).max()))
    print(f"grids port vs jax: {worst}")
    assert worst <= TREE_PSR_ATOL
    with np.load(os.path.join(t_root, "02691156", "train_model_0", "psr.npz")) as d:
        psr = d["psr"]
    assert psr.shape == (RES,) * 3 and abs(psr[0, 0, 0]) == pytest.approx(0.5, abs=1e-6)
    # a tree without grids has the same clouds
    bare = tdata.write_synthetic_shapenet_psr(str(tmp_path / "bare"), models_per_split=2,
                                              num_points=600, shape_variety=True,
                                              with_psr=False)
    rel = os.path.join("02691156", "test_model_1", "pointcloud.npz")
    with np.load(os.path.join(bare, rel)) as a, np.load(os.path.join(t_root, rel)) as b:
        np.testing.assert_array_equal(a["points"], b["points"])


def _knn_searches(monkeypatch, calls=None):
    """Record the port's kNN searches (the neighbour sets and their fp32
    squared distances) into a list, or with `calls`, hand the recorded ones
    to a float64 run in order, as float64: the mirrored cloud is full of
    exact ties, which a float64 run's own searches may break otherwise."""
    import slide_tpu_torch.nn.neighborhood as nb
    real = nb.knn_points
    if calls is None:
        calls = []

        def search(query, points, k):
            sqd, idx = real(query, points, k)
            calls.append((sqd, idx))
            return sqd, idx
    else:
        it = iter(calls)

        def search(query, points, k):
            sqd, idx = next(it)
            return sqd.to(query.dtype), idx

    monkeypatch.setattr(nb, "knn_points", search)
    return calls


def _port_step(case, batch, monkeypatch, dtype=torch.float32):
    """The port's step on the JAX step's weights, batch and draws (its FPS
    picks replayed): (state, loss)."""
    cfg = case["cfg"]
    pc, dc = cfg["pointnet_config"], cfg["dpsr_config"]
    net = load_flax_params(tm.ConditionalPointNet2(pc), case["params"]).to(dtype)
    ae = None
    if case["ae_params"] is not None:
        ae = tm.build_autoencoder(cfg["autoencoder_config"]["pointnet_config"])
        ae = load_flax_params(ae, case["ae_params"]).to(dtype).eval().requires_grad_(False)
    state = tdriver._new_state(net, {"learning_rate": LR})
    step = tdriver.make_upsampler_train_step(
        net, DPSR((RES,) * 3, sig=dc["psr_sigma"]).to(dtype),
        cfg["shapenet_psr_dataset_config"], dc, pc, ae=ae,
        noise_magnitude=cfg.get("autoencoder_config", {}).get("noise_magnitude", 0.0))
    calls = case["calls"]
    # the SAP net's SA levels run on a mirrored cloud, which holds ties
    n_sap = len(pc["architecture"]["npoint"])
    replay = replay_fps_in_port(monkeypatch, calls, DECODE_ATOL,
                                tie_calls=range(len(calls) - n_sap, len(calls)))

    def cast(v):
        v = np.array(v)
        return torch.as_tensor(v, dtype=dtype if v.dtype.kind == "f" else torch.int64)

    draws = {k: [cast(x) for x in v] if isinstance(v, list) else cast(v)
             for k, v in case["draws"].items()}
    loss = step(state, {k: cast(v) for k, v in batch.items()}, torch.Generator(),
                draws=draws)
    assert next(replay, None) is None
    return state, loss


def _grad_tree(state):
    return module_to_flax(state.net, {n: p.grad for n, p in state.net.named_parameters()})


@pytest.mark.parametrize("setting", SETTINGS)
def test_upsampler_loss_and_gradient_match_jax(upsampler_steps, monkeypatch, setting):
    case = upsampler_steps["steps"][setting]
    batch = upsampler_steps["batch"]
    # the SAP net's SA levels, after the AE encoder's two and its decode's four
    n_sap = len(case["cfg"]["pointnet_config"]["architecture"]["npoint"])
    assert len(case["calls"]) == (0 if setting == "mirrored" else 2 + 4) + n_sap
    searches = _knn_searches(monkeypatch)
    state, loss = _port_step(case, batch, monkeypatch)
    _knn_searches(monkeypatch, searches)
    state64, loss64 = _port_step(case, batch, monkeypatch, torch.float64)
    got, got64 = flax_leaves(_grad_tree(state)), flax_leaves(_grad_tree(state64))
    want = [np.asarray(x) for x in jax.tree.leaves(case["grads"])]
    size = max(float(np.abs(g).max()) for g in got64)
    dist = {name: max(float(np.abs(a - b).max()) for a, b in zip(x, y)) / size
            for name, x, y in (("port vs float64", got, got64), ("jax vs float64", want, got64),
                               ("port vs jax", got, want))}
    print(f"{setting}: loss port {float(loss)}, jax {case['loss']}, float64 {float(loss64)}; "
          f"gradient of size {size}, distances in that size {dist}")
    assert float(loss) == pytest.approx(case["loss"], rel=LOSS_RTOL)
    assert float(loss) == pytest.approx(float(loss64), rel=LOSS_F64_RTOL)
    assert dist["port vs float64"] <= GRAD_F64_TOL
    assert_trees_close(_grad_tree(state), case["grads"], rtol=0, atol=GRAD_TOL * size)


def test_upsampler_train_step_matches_optax(upsampler_steps, monkeypatch):
    case = upsampler_steps["steps"]["mirrored"]
    state, _ = _port_step(case, upsampler_steps["batch"], monkeypatch)
    size = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(case["grads"]))
    new_params, opt_state = upsampler_steps["adam"]
    # the step's sign is beyond doubt where |g| is ten times the gate
    assert_one_adam_step(state, new_params, opt_state, rtol=0, atol=GRAD_TOL * size,
                         sure=10 * GRAD_TOL * size)


def test_dpsr_grid_gradient_at_the_ties_matches_jax():
    # Three coordinates sit on ties of the map into DPSR's cube: one maps
    # exactly to 0 (the clip's lower bound, also a grid plane), one exactly
    # to 0.99 (the upper bound), one exactly onto the grid plane 0.5.
    # jnp.clip passes half the gradient at a bound where torch.clamp passes
    # all of it, and jnp.abs's derivative at 0 is +1 where torch.abs's is 0:
    # the port writes both as the JAX package computes them
    rng = np.random.default_rng(3)
    pc = upsampler_config()["pointnet_config"]
    n, f = 40, 7
    d = rng.standard_normal((1, n, 3))
    x = np.concatenate([rng.uniform(-0.4, 0.4, (1, n, 3)),
                        d / np.linalg.norm(d, axis=-1, keepdims=True),
                        np.where(rng.uniform(size=(1, n, 1)) < 0.5, 1.0, -1.0)], -1)
    disp = rng.standard_normal((1, n, 5 * (f - 1)))
    ties = [(0, 0, -1.2), (1, 1, 1.176), (2, 2, 0.0)]        # (point, axis, coordinate)
    for i, axis, value in ties:
        x[0, i, axis] = value
        disp[0, i, axis::f - 1] = 0.0                      # every copy stays on the tie
    x, disp = x.astype(np.float32), disp.astype(np.float32)
    g = rng.standard_normal((1,) + (RES,) * 3).astype(np.float32)

    def j_loss(xx, dd):
        grid = j_network_output_to_dpsr_grid(xx, dd, JDPSR((RES,) * 3, sig=2), 1, pc,
                                             last_dim_as_indicator=True)[0]
        return jnp.sum(jnp.tanh(grid) * g)

    jx, jd = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(disp))
    tx = torch.tensor(x, requires_grad=True)
    td = torch.tensor(disp, requires_grad=True)
    grid, points, _ = network_output_to_dpsr_grid(tx, td, DPSR((RES,) * 3, sig=2), 1, pc,
                                                  last_dim_as_indicator=True)
    points = points.detach()
    assert float(points.min()) == 0.0 and float(points.max()) == np.float32(0.99)
    assert bool((points == 0.5).any())
    torch.sum(torch.tanh(grid) * torch.as_tensor(g)).backward()
    jx, jd = np.asarray(jx), np.asarray(jd)
    print("at the ties, d x: port", [float(tx.grad[0, i, a]) for i, a, _ in ties],
          "jax", [float(jx[0, i, a]) for i, a, _ in ties])
    size = max(np.abs(jx).max(), np.abs(jd).max())
    print(f"everywhere, of the largest element {size}: d x "
          f"{np.abs(tx.grad.numpy() - jx).max() / size}, d disp "
          f"{np.abs(td.grad.numpy() - jd).max() / size}")
    np.testing.assert_allclose(tx.grad.numpy(), jx, atol=TIE_GRAD_TOL * size, rtol=0)
    np.testing.assert_allclose(td.grad.numpy(), jd, atol=TIE_GRAD_TOL * size, rtol=0)


def test_upsampler_checkpoints_both_ways(tmp_path):
    from slide_tpu.cli.main import load_inference_params as j_load_inference
    cfg = upsampler_config()
    # the JAX package's: the committed SAP checkpoint, parameters and Adam state
    ckpt = read_checkpoint(str(DEFAULT_CKPTS["sap"]))
    net = tm.ConditionalPointNet2(cfg["pointnet_config"])
    state = tdriver._new_state(net, cfg["train_config"])
    tdriver.load_adam_state(state, ckpt["optimizer_state_dict"])
    load_flax_params(net, ckpt["model_state_dict"])
    assert state.ema_rates == () and ckpt.get("ema_state_list") is None
    for a, b in zip(flax_leaves(tdriver.adam_state_tree(state)),
                    flax_leaves(ckpt["optimizer_state_dict"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(flax_leaves(module_to_flax(net)), flax_leaves(ckpt["model_state_dict"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the port's, one step on, read by the JAX package
    gen = torch.Generator().manual_seed(1)
    for p in net.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    tdriver._save(state, str(tmp_path), 10000, 3, None)
    jc = jckpt.load_checkpoint(str(tmp_path))
    assert jc["iter"] == 10000 and "ema_state_list" not in jc
    fresh = jax.eval_shape(optax.adam(LR).init, jc["model_state_dict"])
    saved = jax.tree.leaves(jc["optimizer_state_dict"])
    assert [np.shape(s) for s in saved] == [np.shape(f) for f in jax.tree.leaves(fresh)]
    assert int(saved[0]) == int(np.asarray(flax_leaves(ckpt["optimizer_state_dict"])[0])) + 1
    assert_trees_close(module_to_flax(net),
                       j_load_inference(str(tmp_path / "pointnet_ckpt_10000.pkl")), 0, 0)


def test_train_upsampler_checkpoints_and_resumes(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=4,
                                              num_points=600, psr_res=RES, shape_variety=True,
                                              psr_from_points=True, device="cpu")
    cfg = _setting_config("mirrored")
    cfg["shapenet_psr_dataset_config"].update(categories=["02691156"], repeat_dataset=1)
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    state, losses = tdriver.train_upsampler(cfg, data_dir=root, max_iters=3, device="cpu",
                                            verbose=False)
    assert [i for i, _ in losses] == [0, 1, 2] and np.isfinite([l for _, l in losses]).all()
    assert state.step == 3 and state.ema_rates == ()
    ckpt_dir = str(tmp_path / "exp" / cfg["pointnet_config"]["model_name"] / "checkpoint")
    assert sorted(os.listdir(ckpt_dir)) == ["pointnet_ckpt_1.pkl", "pointnet_ckpt_2.pkl"]
    # resumed, with the checkpoint-time evaluation (the DPSR-grid L2 on the
    # val split) at the checkpoint of the cadence that the step to 4 ends in
    state2, losses2 = tdriver.train_upsampler(cfg, data_dir=root, max_iters=4, device="cpu",
                                              eval_hook="auto", verbose=False)
    assert losses2[0][0] == 3 and state2.step == 4 and find_max_iter(ckpt_dir) == 3
    # the JAX package would resume from it
    assert jckpt.load_checkpoint(ckpt_dir)["iter"] == 3
    out = str(tmp_path / "exp" / cfg["pointnet_config"]["model_name"] / "eval_result")
    assert "shapenet_psr_dpsr_eval_result.pkl" in os.listdir(out)
    with open(os.path.join(out, "shapenet_psr_dpsr_eval_result.pkl"), "rb") as f:
        history = pickle.load(f)
    assert history["iter"] == [3] and history["epoch"] == [0]
    assert np.isfinite(history["dpsr_grid_L2_loss"]).all()
