"""The port's evaluation (`slide_tpu_torch/ops/emd.py`, `eval/`, the label
and npz datasets, the samplers' eval options) against the JAX package on
the CPU, on the same numpy inputs, weights (drawn by the port's
`init_params`, perturbed, read by both) and replayed draws.

Tolerances, each from a measurement (`pytest -rP` prints the gaps):
  - EMD (JAX jitted): the match within EMD_MATCH_ATOL (measured up to
    1.1e-5: at level -4^7 a rounding gap delta in a squared distance is a
    relative gap of 16384 delta in its weight), the distance within
    EMD_RTOL relative (measured 4.4e-7), its gradient within EMD_GRAD_ATOL
    of the largest element (measured 7.3e-6);
  - the metric matrices (CD and EMD over 64-point clouds): METRIC_RTOL
    relative (measured 2.2e-6); the classifier's and the coverage's
    decisions equal;
  - the chains (narrow nets, T of 4-10): CHAIN_ATOL (measured 8.3e-7);
  - the autoencoder evaluation's pickles: AE_ATOL.
The latent evaluation decodes with a closed form and the autoencoder
evaluation runs a closed-form stand-in of the round trip: the decode and
the round trip are held to JAX's in tests/test_torch_models.py and
tests/test_torch_ae.py, and run by the port's hooks in
tests/test_torch_eval_hooks.py; here the evaluations' loaders, keypoints,
draws, batching and files are.
  - the SAP grid L2 at 32^3: SAP_LOSS_RTOL relative (measured 1.0e-5)."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu.configs import (autoencoder_config as j_ae_config,
                               keypoint_ddpm_config as j_kp_config,
                               latent_ddpm_config as j_lat_config)
from slide_tpu.data import dummy as j_dummy
from slide_tpu.data import npz_dataset as j_npz
from slide_tpu.diffusion import eps as jeps
from slide_tpu.diffusion import x0 as jx0
from slide_tpu.diffusion.latent import latent_denoise_and_reconstruct as j_latent_sample
from slide_tpu.eval import ae_eval as j_ae_eval
from slide_tpu.eval import generation as j_gen
from slide_tpu.eval import mesh_recon as j_mesh_recon
from slide_tpu.eval import metrics as jm
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.ops import emd as jemd
from slide_tpu.sap import DPSR as JDPSR
from slide_tpu_torch import data as tdata
from slide_tpu_torch import diffusion as td
from slide_tpu_torch.eval import ae_eval as t_ae_eval
from slide_tpu_torch.eval import generation as t_gen
from slide_tpu_torch.eval import mesh_recon as t_mesh_recon
from slide_tpu_torch.eval import metrics as tm
from slide_tpu_torch.models import ConditionalPointNet2 as TNet
from slide_tpu_torch.ops import emd as temd
from slide_tpu_torch.sap import DPSR, marching_tetrahedra_numpy
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.weights import load_flax_params, module_to_flax
from mesh_compare import assert_same_mesh
from torch_port_helpers import (perturb, record_jax_fps, replay_fps_in_port, to_np,
                                train_sap_config)

EMD_MATCH_ATOL = 5e-5
EMD_RTOL = 2e-5
EMD_GRAD_ATOL = 2e-5
METRIC_RTOL = 2e-5
CHAIN_ATOL = 2e-5
AE_ATOL = 5e-5
SAP_LOSS_RTOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # small shapes: one thread runs them as fast and leaves the cores to the
    # other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clouds(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.3


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# EMD


@pytest.mark.parametrize("n,m", [(64, 64), (96, 32), (32, 96)])
def test_emd_matches_jax(n, m):
    a, b = _clouds(n, 3, n, 3), _clouds(m + 1, 3, m, 3)
    # one compile: the match, the distance and its gradient
    j_match, (j_d, j_grads) = jax.jit(lambda x, y: (jemd.approx_match(x, y), jax.value_and_grad(
        lambda u, v: jemd.earth_mover_distance(u, v).sum(), argnums=(0, 1))(x, y)))(
        jnp.asarray(a), jnp.asarray(b))
    t_match = to_np(temd.approx_match(torch.as_tensor(a), torch.as_tensor(b)))
    match_gap = float(np.abs(t_match - np.asarray(j_match)).max())

    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    t_d = temd.earth_mover_distance(ta, tb).sum()
    t_d.backward()
    d_gap = _rel(to_np(t_d), j_d)
    grad_gap = max(_rel(to_np(g), w) for g, w in zip((ta.grad, tb.grad), j_grads))
    print(f"emd n={n} m={m}: match {match_gap:.2e}, distance {d_gap:.2e}, "
          f"gradient {grad_gap:.2e}")
    assert match_gap <= EMD_MATCH_ATOL
    assert d_gap <= EMD_RTOL
    assert grad_gap <= EMD_GRAD_ATOL


# ---------------------------------------------------------------------------
# The metrics


@pytest.fixture(scope="module")
def metric_sets():
    rng = np.random.default_rng(3)
    samples = (rng.standard_normal((6, 64, 3)) * [0.3, 0.2, 0.1]).astype(np.float32)
    refs = (rng.standard_normal((5, 64, 3)) * [0.25, 0.2, 0.15]).astype(np.float32)
    return samples, refs


def test_paired_metrics_match_jax(metric_sets):
    samples, refs = metric_sets
    want = jm.emd_cd(samples[:5], refs)
    got = tm.emd_cd(samples[:5], refs, device="cpu")
    for k in ("CD", "EMD", "fscore"):
        gap = _rel(to_np(got[k]), want[k]) if k != "fscore" else \
            float(np.abs(to_np(got[k]) - np.asarray(want[k])).max())
        print(f"emd_cd {k}: {gap:.2e}")
        assert gap <= METRIC_RTOL, k


@pytest.mark.parametrize("with_emd", [True, False])
def test_pairwise_matrices_match_jax(metric_sets, with_emd):
    samples, refs = metric_sets
    want_cd, want_emd = jm.pairwise_emd_cd(samples, refs, batch_size=4, with_emd=with_emd)
    got_cd, got_emd = tm.pairwise_emd_cd(samples, refs, batch_size=4, with_emd=with_emd,
                                         device="cpu")
    assert got_cd.shape == got_emd.shape == (6, 5)
    print(f"pairwise with_emd={with_emd}: CD {_rel(got_cd, want_cd):.2e}" +
          (f", EMD {_rel(got_emd, want_emd):.2e}" if with_emd else ""))
    assert _rel(got_cd, want_cd) <= METRIC_RTOL
    if with_emd:
        assert _rel(got_emd, want_emd) <= METRIC_RTOL
    else:
        assert np.isnan(got_emd).all() and np.isnan(want_emd).all()


def test_two_sample_metrics_match_jax(metric_sets):
    samples, refs = metric_sets
    want = jm.compute_all_metrics(samples, refs, batch_size=8)
    got = tm.compute_all_metrics(samples, refs, batch_size=8, device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        # MMD values are distances; COV and the 1-NN accuracies are counts of
        # decisions, which must be equal
        if "mmd" in k:
            assert abs(got[k] - v) <= METRIC_RTOL * abs(v), k
        else:
            assert got[k] == v, k
    rng = np.random.default_rng(5)
    mats = [rng.random(s) for s in ((4, 4), (4, 3), (3, 3))]
    for k in (1, 3):
        for sqrt in (False, True):
            assert tm.knn_classifier(*mats, k=k, sqrt=sqrt) == \
                jm.knn_classifier(*mats, k=k, sqrt=sqrt)
    assert tm.lgan_mmd_cov(mats[1]) == jm.lgan_mmd_cov(mats[1])


def test_jsd_matches_jax(metric_sets):
    samples, refs = metric_sets
    samples = samples * 2.0          # some points outside the unit sphere
    for res in (8, 28):
        assert tm.jsd_between_point_cloud_sets(samples, refs, res) == \
            jm.jsd_between_point_cloud_sets(samples, refs, res)
    for in_sphere in (False, True):
        t_ent, t_cnt = tm.entropy_of_occupancy_grid(samples, 10, in_sphere)
        j_ent, j_cnt = jm.entropy_of_occupancy_grid(samples, 10, in_sphere)
        assert t_ent == j_ent and np.array_equal(t_cnt, j_cnt)
    for clip in (False, True):
        t_grid, t_sp = tm.unit_cube_grid_point_cloud(6, clip)
        j_grid, j_sp = jm.unit_cube_grid_point_cloud(6, clip)
        assert t_sp == j_sp and np.array_equal(t_grid, j_grid)
    with pytest.raises(ValueError):
        tm.jensen_shannon_divergence([1.0, -1.0], [1.0, 1.0])


# ---------------------------------------------------------------------------
# The datasets


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "shapenet_psr")
    return tdata.write_synthetic_shapenet_psr(root, categories=("02691156", "03001627"),
                                              models_per_split=6, num_points=400,
                                              with_psr=False)


@pytest.mark.parametrize("world_size", [1, 3])
def test_datasets_match_jax(tree, tmp_path, world_size):
    rng = np.random.default_rng(world_size)
    npz = str(tmp_path / "gen.npz")
    np.savez(npz, points=rng.standard_normal((7, 20, 6)).astype(np.float32),
             label=np.arange(7), keypoint=rng.standard_normal((7, 4, 3)))
    for rank in range(world_size):
        kw = dict(rank=rank, world_size=world_size, seed=11)
        _assert_items_equal(
            _items(tdata.DummyShapesDataset(tree, 8, categories=["03001627", "02691156"], **kw)),
            _items(j_dummy.DummyShapesDataset(tree, 8, categories=["03001627", "02691156"],
                                              **kw)))
        _assert_items_equal(_items(tdata.DummyLabelDataset(8, **kw)),
                            _items(j_dummy.DummyLabelDataset(8, **kw)))
        _assert_items_equal(_items(tdata.ShapeNpzDataset(npz, scale=2, **kw)),
                            _items(j_npz.ShapeNpzDataset(npz, scale=2, **kw)))
        split = dict(data_key_split_names=["points", "normals"], data_key_split_dims=[0, 3, 6])
        _assert_items_equal(_items(tdata.GeneralNpzDataset(npz, scale=2, **split, **kw)),
                            _items(j_npz.GeneralNpzDataset(npz, scale=2, **split, **kw)))


# ---------------------------------------------------------------------------
# The samplers' eval options


def _chain_noise(key, shape, steps):
    """A JAX chain's draws: x_T (or the warm start's) from the first split,
    then one per step, each from a fresh split of the carried key."""
    key, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape)]
    for _ in range(steps):
        key, k = jax.random.split(key)
        draws.append(jax.random.normal(k, shape))
    return [torch.as_tensor(np.array(d)) for d in draws]


def _replay(draws):
    it = iter(draws)
    return lambda shape: next(it)


def test_eps_chain_slices_and_warm_start_match_jax():
    def jnet(x, ts):
        return 0.3 * jnp.tanh(x) + 1e-3 * ts[:, None, None].astype(jnp.float32)

    def tnet(x, ts):
        return 0.3 * torch.tanh(x) + 1e-3 * ts[:, None, None].float()

    shape, t_steps, key = (2, 16, 3), 10, jax.random.key(31)
    js, ts_ = (m.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02) for m in (jeps, td))
    want, want_sl = jeps.diffusion_sampling(jnet, key, shape, js, t_slices=[9, 4, 0, 12])
    got, got_sl = td.diffusion_sampling(tnet, shape, ts_,
                                        _replay(_chain_noise(key, shape, t_steps)),
                                        t_slices=[9, 4, 0, 12])
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=CHAIN_ATOL)
    assert sorted(got_sl) == sorted(want_sl)
    for t in want_sl:
        np.testing.assert_allclose(to_np(got_sl[t]), np.asarray(want_sl[t]), atol=CHAIN_ATOL)
    x_t = _clouds(4, *shape)
    want = jeps.diffusion_sampling(jnet, key, shape, js, xT=jnp.asarray(x_t), start_step=6)
    got = td.diffusion_sampling(tnet, shape, ts_, _replay(_chain_noise(key, shape, 6)),
                                xT=torch.as_tensor(x_t), start_step=6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=CHAIN_ATOL)
    with pytest.raises(ValueError):
        td.diffusion_sampling(tnet, shape, ts_, None, xT=torch.as_tensor(x_t))


def test_latent_fastdpm_sampler_matches_fast_x0_denoise():
    from slide_tpu_torch.diffusion.fastdpm import fast_x0_denoise
    sched = td.X0Schedule.from_config(dict(j_lat_config()["standard_diffusion_config"],
                                           num_diffusion_timesteps=100))
    kp = torch.as_tensor(_clouds(6, 2, 16, 3))

    def tnet(x, ts):
        return 0.3 * torch.tanh(x)

    draws = [torch.as_tensor(_clouds(100 + i, 2, 16, 9)) for i in range(12)]
    kw = dict(length=5, schedule="quadratic", kappa=0.5)
    cloud, k, f = td.latent_denoise_and_reconstruct(
        tnet, lambda a, b, lbl: torch.cat([a, b], -1), 2, 3, (16, 9), sched, _replay(draws),
        keypoint=kp, sampler="fastdpm", fastdpm_kw=kw)
    want = fast_x0_denoise(tnet, (2, 16, 9), sched, _replay(draws), keypoint=kp,
                           keypoint_dim=3, **kw)
    assert torch.equal(cloud, want) and torch.equal(k, kp)
    with pytest.raises(ValueError, match="full-chain"):
        td.latent_denoise_and_reconstruct(tnet, None, 2, 3, (16, 9), sched, None,
                                          keypoint=kp, sampler="fastdpm", curr_step=5)


# ---------------------------------------------------------------------------
# Generation evaluation


def _narrow_pair(cfg_fn, in_fea_dim, out_dim, seed):
    """A narrow denoiser in both packages on one set of weights."""
    pc = cfg_fn()["pointnet_config"]
    pc.update(in_fea_dim=in_fea_dim, out_dim=out_dim, t_dim=32, class_condition_dim=16)
    pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                              mlp_depth=2, decoder_mlp_depth=2)
    tnet = init_params(TNet(pc), torch.Generator().manual_seed(seed))
    params = perturb(module_to_flax(tnet), seed)
    load_flax_params(tnet, params)
    return JNet(pc), params, tnet.eval(), pc


def _assert_npz_equal(got_file, want_file, atol):
    with np.load(got_file) as g, np.load(want_file) as w:
        assert sorted(g.files) == sorted(w.files)
        gaps = {k: float(np.abs(g[k] - w[k]).max()) for k in w.files
                if k != "timing" and w[k].dtype.kind in "fc"}
        print(f"npz gaps: {gaps}")
        for k in w.files:
            if k == "timing":
                assert g[k].shape == w[k].shape
            elif k in gaps:
                assert gaps[k] <= atol, k
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_keypoint_generation_eval_matches_jax(tree, tmp_path):
    jnet, params, tnet, _ = _narrow_pair(j_kp_config, 0, 3, 7)
    cfg = j_kp_config("airplane")["shapenet_psr_dataset_config"]
    cfg.update(data_dir=tree, categories=["02691156", "03001627"], eval_batch_size=4,
               num_samples_tested=8)
    t_steps, seed = 4, 3
    want = j_gen.evaluate_per_rank(jnet, params, cfg, jeps.calc_diffusion_hyperparams(
        t_steps, 1e-4, 0.02), str(tmp_path / "jax"), "keypoint_generation",
        ckpt_info="_iter_9", seed=seed)
    key, draws = jax.random.key(seed), []
    for _ in range(2):
        key, k_s = jax.random.split(key)
        draws += _chain_noise(k_s, (4, 16, 3), t_steps)
    got = t_gen.evaluate_per_rank(
        tnet, cfg, td.calc_diffusion_hyperparams(t_steps, 1e-4, 0.02), str(tmp_path / "port"),
        "keypoint_generation", ckpt_info="_iter_9", seed=seed, device="cpu",
        noise_fn=_replay(draws))
    assert os.path.basename(got) == os.path.basename(want) == \
        "shapenet_psr_generated_data_16_pts_iter_9.npz"
    _assert_npz_equal(got, want, CHAIN_ATOL)
    with pytest.raises(NotImplementedError, match="item 19"):
        t_gen.evaluate_per_rank(tnet, cfg, None, str(tmp_path), "keypoint_generation",
                                device="cpu", mesh=object())
    # the condition-cloud route runs (held to JAX with the dual-tower net in
    # tests/test_torch_conditional.py); this net takes no condition
    cond = t_gen.evaluate_per_rank(
        tnet, dict(cfg, npoints=32, num_samples_tested=4),
        td.calc_diffusion_hyperparams(2, 1e-4, 0.02), str(tmp_path / "cond"),
        "keypoint_conditional_generation", device="cpu")
    with np.load(cond) as d:
        assert d["points"].shape == (4, 32, 3) and np.isfinite(d["points"]).all()
        assert d["keypoint"].shape == (4, 16, 3) and d["gt_points"].shape == (4, 32, 6)


def test_generation_eval_options_match_jax(tmp_path):
    # closed-form samplers (no nets, no draws): external keypoints over two
    # ranks, a custom sampler whose 6 channels are split into points and
    # normals, and local resampling, whose rows start at the rank's global
    # row
    rng = np.random.default_rng(2)
    ext = str(tmp_path / "keypoints.npz")
    np.savez(ext, points=rng.standard_normal((5, 16, 3)).astype(np.float32),
             label=np.arange(5), category=np.array(["c"] * 5),
             category_name=np.array(["airplane"] * 5))
    complete = rng.standard_normal((5, 16, 19)).astype(np.float32)
    mask = (rng.random((5, 16)) > 0.5).astype(np.float32)
    cfg = dict(j_kp_config("airplane")["shapenet_psr_dataset_config"], eval_batch_size=4,
               keypoint_noise_magnitude=0)

    def j_custom(key, label, cond):
        return jnp.concatenate([cond, jnp.tanh(cond)], -1) * label[:, None, None]

    def t_custom(noise_fn, label, cond):
        return torch.cat([cond, torch.tanh(cond)], -1) * label[:, None, None]

    def j_latent(key, label, keypoint, local_resampling, complete_x0, keypoint_mask):
        pts = complete_x0 * keypoint_mask[..., None] + keypoint.sum()
        return pts, keypoint, pts[..., 3:]

    def t_latent(noise_fn, start_fn, label, keypoint, local_resampling, complete_x0,
                 keypoint_mask):
        pts = complete_x0 * keypoint_mask[..., None] + keypoint.sum()
        return pts, keypoint, pts[..., 3:]

    for rank in range(2):
        common = dict(rank=rank, world_size=2, ckpt_info="_x", test_external_keypoint=True,
                      external_keypoint_file=ext)
        want = j_gen.evaluate_per_rank(None, None, cfg, None, str(tmp_path / "j"),
                                       "keypoint_conditional_generation",
                                       custom_sampler=j_custom,
                                       split_points_and_normals=True, **common)
        got = t_gen.evaluate_per_rank(None, cfg, None, str(tmp_path / "t"),
                                      "keypoint_conditional_generation",
                                      custom_sampler=t_custom, split_points_and_normals=True,
                                      device="cpu", **common)
        assert os.path.basename(got) == os.path.basename(want)
        _assert_npz_equal(got, want, 1e-6)
        want = j_gen.evaluate_per_rank(None, None, cfg, None, str(tmp_path / "jl"),
                                       "latent_keypoint_conditional_generation",
                                       latent_sampler=j_latent, local_resampling=True,
                                       complete_x0=complete, keypoint_mask=mask,
                                       save_keypoint_feature=True, **common)
        got = t_gen.evaluate_per_rank(None, cfg, None, str(tmp_path / "tl"),
                                      "latent_keypoint_conditional_generation",
                                      latent_sampler=t_latent, local_resampling=True,
                                      complete_x0=complete, keypoint_mask=mask,
                                      save_keypoint_feature=True, device="cpu", **common)
        _assert_npz_equal(got, want, 1e-5)


def test_rank_files_gather_as_jax(tmp_path):
    rng = np.random.default_rng(0)
    for rank in range(3):
        np.savez(tmp_path / f"shapenet_psr_generated_data_16_pts_rank_{rank}_iter_2.npz",
                 points=rng.standard_normal((2, 16, 3)), label=np.arange(2) + rank)
    saved = {p.name: np.load(p) for p in tmp_path.iterdir()}
    j_dir, t_dir = tmp_path / "j", tmp_path / "t"
    for d in (j_dir, t_dir):
        d.mkdir()
        for name, data in saved.items():
            np.savez(d / name, **data)
    want = j_gen.gather_generated_results(str(j_dir), 3, 16, "_iter_2")
    got = t_gen.gather_generated_results(str(t_dir), 3, 16, "_iter_2")
    assert os.listdir(t_dir) == [os.path.basename(got)] == [os.path.basename(want)]
    _assert_npz_equal(got, want, 0.0)
    # the AE's rank pickles
    stem = "shapenet_psr_autoencoder_visualization_result_iteration_00000007_epoch_0003"
    for d in (j_dir, t_dir):
        for rank in range(2):
            with open(d / f"{stem}_rank_{rank}.pkl", "wb") as f:
                pickle.dump({"hierarchical_pointcloud": [np.full((2, 4, 3), rank + i)
                                                         for i in range(3)],
                             "label": np.arange(2) + rank, "category": ["a", "b"]}, f)
    want = j_ae_eval.gather_ae_visual_results(str(j_dir), 7, 3, 2)
    got = t_ae_eval.gather_ae_visual_results(str(t_dir), 7, 3, 2)
    assert os.path.basename(got) == os.path.basename(want) == stem + ".pkl"
    with open(got, "rb") as f, open(want, "rb") as g:
        g_res, w_res = pickle.load(f), pickle.load(g)
    assert g_res["category"] == w_res["category"] == ["a", "b", "a", "b"]
    np.testing.assert_array_equal(g_res["label"], w_res["label"])
    for a, b in zip(g_res["hierarchical_pointcloud"], w_res["hierarchical_pointcloud"]):
        np.testing.assert_array_equal(a, b)
    # the checkpoint picked by the gathered evaluation's lowest avg_cd
    from slide_tpu.train.checkpoint import find_max_iter as j_find
    from slide_tpu_torch.train.checkpoint import find_max_iter as t_find
    ckpt, ev = tmp_path / "exp" / "checkpoint", tmp_path / "eval_result"
    ckpt.mkdir(parents=True)
    ev.mkdir()
    with open(ev / "gathered_eval_result.pkl", "wb") as f:
        pickle.dump({"iter": [9, 19, 29], "avg_cd": [0.3, 0.1, 0.2]}, f)
    assert t_find(str(ckpt), mode="best") == j_find(str(ckpt), mode="best") == 19


def _j_decode(kp, feat, label, key):
    """A closed-form decode (the AE's decode is held to JAX's in
    tests/test_torch_models.py): four points per keypoint."""
    rep = jnp.concatenate([kp, jnp.tanh(feat[..., :3])], axis=-1)
    return jnp.tile(rep, (1, 4, 1)) * (1.0 + label[:, None, None])


def _t_decode(kp, feat, label):
    rep = torch.cat([kp, torch.tanh(feat[..., :3])], dim=-1)
    return rep.repeat(1, 4, 1) * (1.0 + label[:, None, None])


def test_latent_generation_eval_matches_jax(tree, tmp_path):
    jnet, params, tnet, pc = _narrow_pair(j_lat_config, 16, 19, 8)
    cfg = j_lat_config("airplane")["shapenet_psr_dataset_config"]
    cfg.update(data_dir=tree, categories=["02691156", "03001627"], eval_batch_size=3,
               num_samples_tested=6, npoints=200)
    t_steps, seed, task = 5, 4, "latent_keypoint_conditional_generation"
    sdc = dict(j_lat_config()["standard_diffusion_config"], num_diffusion_timesteps=t_steps)

    @jax.jit
    def j_sampler(key, label, keypoint):
        return j_latent_sample(
            lambda x, ts: jnet.apply({"params": params}, x, ts=ts, label=label), _j_decode,
            key, label.shape[0], 3, (16, 19), jx0.X0Schedule.from_config(sdc), label=label,
            keypoint=keypoint)

    want = j_gen.evaluate_per_rank(jnet, params, cfg, None, str(tmp_path / "jax"), task,
                                   latent_sampler=j_sampler, seed=seed,
                                   save_keypoint_feature=True)
    # each batch's chain: the sampler's key split in three, the second
    key, draws = jax.random.key(seed), []
    for _ in range(2):
        key, k_s = jax.random.split(key)
        draws += _chain_noise(jax.random.split(k_s, 3)[1], (3, 16, 19), t_steps)
    tsched = td.X0Schedule.from_config(sdc)

    def t_sampler(noise_fn, start_fn, label, keypoint):
        return td.latent_denoise_and_reconstruct(
            lambda x, ts: tnet(x, ts=ts, label=label), _t_decode, label.shape[0], 3,
            (16, 19), tsched, noise_fn, label=label, keypoint=keypoint)

    got = t_gen.evaluate_per_rank(tnet, cfg, None, str(tmp_path / "port"), task,
                                  latent_sampler=t_sampler, seed=seed, device="cpu",
                                  save_keypoint_feature=True, noise_fn=_replay(draws))
    assert os.path.basename(got) == os.path.basename(want)
    _assert_npz_equal(got, want, CHAIN_ATOL)


# ---------------------------------------------------------------------------
# Autoencoder evaluation


def _j_standin_ae():
    """A closed-form stand-in for the JAX autoencoder's `apply` (the round
    trip itself is held to JAX's in tests/test_torch_ae.py): two levels and
    their losses, and the keypoint feature."""
    class StandIn:
        def apply(self, variables, x, kp, *, label, loss_type, rngs,
                  return_keypoint_feature=False):
            levels = [kp, jnp.tanh(x) * (1.0 + label[:, None, None])]
            losses = [{"cd_p": jnp.abs(v).mean((1, 2)), "cd_t": (v ** 2).mean((1, 2))}
                      for v in levels]
            return (levels, losses, 2.0 * kp) if return_keypoint_feature \
                else (levels, losses)
    return StandIn()


def _t_standin_ae(x, kp, label, loss_type, noise_fn, start_fn,
                  return_keypoint_feature=False):
    levels = [kp, torch.tanh(x) * (1.0 + label[:, None, None])]
    losses = [{"cd_p": v.abs().mean((1, 2)), "cd_t": (v ** 2).mean((1, 2))} for v in levels]
    return (levels, losses, 2.0 * kp) if return_keypoint_feature else (levels, losses)


def _ae_noise(n_batches, seed, kp_shape):
    """The port's noise_fn replaying an AE evaluation's keypoint noise (the
    key splits of the JAX package's `_prepare_ae_batch`)."""
    key, draws = jax.random.key(seed), []
    for _ in range(n_batches):
        key, k_prep, _, _ = jax.random.split(key, 4)
        draws.append(torch.as_tensor(np.array(jax.random.normal(jax.random.split(k_prep)[1],
                                                                kp_shape))))
    return _replay(draws)


def test_ae_evals_write_jax_pickles(tree, tmp_path):
    cfg = j_ae_config("airplane")["shapenet_psr_dataset_config"]
    cfg.update(data_dir=tree, categories=["02691156"], eval_batch_size=3, npoints=300,
               repeat_dataset=1)
    assert cfg["keypoint_noise_magnitude"] > 0
    from slide_tpu.data import get_dataloader as j_loader
    from slide_tpu_torch.data import get_dataloader as t_loader
    j_vis = j_ae_eval.ae_visual_eval(_j_standin_ae(), None, j_loader(cfg, phase="val", seed=1),
                                     str(tmp_path / "jax"), 7, 0, cfg, seed=1,
                                     save_reconstructed_pcd=True, save_keypoint_feature=True)
    t_vis = t_ae_eval.ae_visual_eval(_t_standin_ae, t_loader(cfg, phase="val", seed=1),
                                     str(tmp_path / "port"), 7, 0, cfg, seed=1,
                                     save_reconstructed_pcd=True, save_keypoint_feature=True,
                                     device="cpu", noise_fn=_ae_noise(2, 1, (3, 16, 3)))
    assert os.path.basename(t_vis) == os.path.basename(j_vis)
    with open(t_vis, "rb") as f, open(j_vis, "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert sorted(got) == sorted(want)
    gaps = [float(np.abs(lg - lw).max()) for lg, lw in
            zip(got["hierarchical_pointcloud"], want["hierarchical_pointcloud"])]
    print(f"ae levels: {gaps}")
    assert len(gaps) == len(want["hierarchical_pointcloud"]) and max(gaps) <= AE_ATOL
    for k in ("label", "category", "category_name", "model", "gt_points"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    _assert_npz_equal(str(tmp_path / "port" / "reconstructed_pcd.npz"),
                      str(tmp_path / "jax" / "reconstructed_pcd.npz"), AE_ATOL)

    j_q = j_ae_eval.ae_quantitative_eval(_j_standin_ae(), None,
                                         j_loader(cfg, phase="val", seed=1),
                                         str(tmp_path / "jax"), 7, 0, cfg, seed=1)
    t_q = t_ae_eval.ae_quantitative_eval(_t_standin_ae, t_loader(cfg, phase="val", seed=1),
                                         str(tmp_path / "port"), 7, 0, cfg, seed=1,
                                         device="cpu", noise_fn=_ae_noise(2, 1, (3, 16, 3)))
    assert sorted(t_q) == sorted(j_q)
    gaps = {k: abs(t_q[k] - v) / max(1.0, abs(v)) for k, v in j_q.items()}
    print(f"ae quantitative: {gaps}")
    assert max(gaps.values()) <= AE_ATOL
    name = "shapenet_psr_autoencoder_quantitative_eval_result.pkl"
    with open(tmp_path / "port" / name, "rb") as f, open(tmp_path / "jax" / name, "rb") as g:
        assert sorted(pickle.load(f)) == sorted(pickle.load(g))


# ---------------------------------------------------------------------------
# SAP evaluation and mesh reconstruction


@pytest.fixture(scope="module")
def sap_setting(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("psr") / "shapenet_psr")
    tdata.write_synthetic_shapenet_psr(root, categories=("02691156",), models_per_split=4,
                                       num_points=600, psr_res=32, shape_variety=True,
                                       psr_from_points=True, device="cpu")
    cfg = train_sap_config()
    cfg["dpsr_config"]["grid_res"] = 32
    cfg["shapenet_psr_dataset_config"].update(data_dir=root, categories=["02691156"],
                                              eval_batch_size=4, npoints=200, load_psr=True)
    tnet = init_params(TNet(cfg["pointnet_config"]), torch.Generator().manual_seed(9))
    params = perturb(module_to_flax(tnet), 9, scale=0.05)
    load_flax_params(tnet, params)
    return cfg, JNet(cfg["pointnet_config"]), params, tnet.eval()


def test_sap_grid_eval_matches_jax(sap_setting, tmp_path, monkeypatch):
    from slide_tpu.data import get_dataloader as j_loader
    from slide_tpu_torch.data import get_dataloader as t_loader
    cfg, jnet, params, tnet = sap_setting
    trainset, dc = cfg["shapenet_psr_dataset_config"], cfg["dpsr_config"]
    calls = record_jax_fps(monkeypatch)
    want = j_mesh_recon.sap_grid_eval(jnet, params, JDPSR((32,) * 3, sig=2),
                                      j_loader(trainset, phase="val", seed=2),
                                      cfg["pointnet_config"], dc, trainset,
                                      str(tmp_path / "jax"), 5, 0, seed=2)
    key = jax.random.key(2)
    key, k_b = jax.random.split(key)
    perm = torch.as_tensor(np.array(jax.random.permutation(jax.random.split(k_b)[1], 400)))
    replay = replay_fps_in_port(monkeypatch, calls, 1e-5, tie_calls=range(len(calls)))
    got = t_mesh_recon.sap_grid_eval(tnet, DPSR((32,) * 3, sig=2),
                                     t_loader(trainset, phase="val", seed=2),
                                     cfg["pointnet_config"], dc, trainset,
                                     str(tmp_path / "port"), 5, 0, seed=2, device="cpu",
                                     perm_fn=lambda n: perm)
    print(f"sap grid L2: port {got:.6e}, JAX {want:.6e}, {abs(got - want) / want:.2e}")
    assert abs(got - want) <= SAP_LOSS_RTOL * want
    assert next(replay, None) is None
    replay_fps_in_port(monkeypatch, calls, 1e-5, tie_calls=range(len(calls)))
    got2 = t_mesh_recon.sap_grid_eval(tnet, DPSR((32,) * 3, sig=2),
                                      t_loader(trainset, phase="val", seed=2),
                                      cfg["pointnet_config"], dc, trainset,
                                      str(tmp_path / "port"), 6, 0, seed=2, device="cpu",
                                      perm_fn=lambda n: perm)
    with open(tmp_path / "port" / "shapenet_psr_dpsr_eval_result.pkl", "rb") as f:
        history = pickle.load(f)
    assert history == {"iter": [5, 6], "dpsr_grid_L2_loss": [got, got2], "epoch": [0, 0]}


def test_reconstruct_meshes_match_the_numpy_oracle(sap_setting, tmp_path, monkeypatch):
    # the meshes as extracted (before the move back to each cloud's scale;
    # the PLY text keeps 6 decimals, too few for the gate's face comparison
    # at 1e-4 grid units) against the numpy oracle on the grids extracted
    from slide_tpu_torch.data import get_dataloader as t_loader
    import slide_tpu_torch.eval.mesh_recon as mr
    cfg, _, _, tnet = sap_setting
    trainset, dc = cfg["shapenet_psr_dataset_config"], cfg["dpsr_config"]
    trainset = dict(trainset, eval_batch_size=3)
    grids, meshes, saved = [], [], {}
    real_march, real_host, real_save = mr.marching_tetrahedra_device, mr.mesh_to_host, \
        mr.save_mesh_ply

    def marching(grid):
        grids.append(grid.clone())
        return real_march(grid)

    def to_host(mesh, i):
        meshes.append(real_host(mesh, i))
        return meshes[-1]

    def saving(path, v, f, n):
        saved[os.path.basename(path)] = v
        return real_save(path, v, f, n)

    monkeypatch.setattr(mr, "marching_tetrahedra_device", marching)
    monkeypatch.setattr(mr, "mesh_to_host", to_host)
    monkeypatch.setattr(mr, "save_mesh_ply", saving)
    vis = t_mesh_recon.reconstruct_meshes(
        tnet, DPSR((32,) * 3, sig=2), t_loader(trainset, phase="val", seed=0),
        cfg["pointnet_config"], dc, trainset, str(tmp_path), iteration=3, device="cpu",
        do_sample_points_from_mesh=True, return_original_scale=True)
    assert os.path.basename(vis) == "visualization_results_at_iteration_00000003_epoch_0000"
    vols = torch.cat(grids).numpy()
    names = [f"airplane_{i:05d}.ply" for i in range(4)]
    assert len(vols) == len(meshes) == 4 and sorted(saved) == names
    assert sorted(os.listdir(os.path.join(vis, "reconstructed_mesh"))) == names
    data = [d["points"] for d in t_loader(trainset, phase="val", seed=0)]
    clouds = np.concatenate(data)
    for i, name in enumerate(names):
        assert_same_mesh(meshes[i], marching_tetrahedra_numpy(vols[i]), scale=32)
        # back at the input's scale: the mesh's extent is its cloud's
        v, pts = saved[name], clouds[i]
        np.testing.assert_allclose((v.max(0) - v.min(0)).max(),
                                   (pts.max(0) - pts.min(0)).max(), rtol=1e-5)
    for sub in ("noisy_pcd", "refined_pcd", "points_sampled_from_mesh"):
        assert len(os.listdir(os.path.join(vis, sub))) == 4
    for npz in ("points_sampled_from_mesh.npz", "uniform_points_sampled_from_mesh.npz"):
        with np.load(os.path.join(vis, npz)) as d:
            assert d["points"].shape == d["normals"].shape == (4, 2048, 3)
            assert d["label"].shape == (4,)
