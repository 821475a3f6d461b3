"""The checkpoint-time eval hooks of the port's training driver
(`slide_tpu_torch/train/driver.py`: `make_generation_eval_hook`,
`make_latent_eval_hook`; the autoencoder's and the SAP net's hooks are run
by `tests/test_torch_ae.py` and `tests/test_torch_upsampler_train.py`) on
the CPU: `train_*(eval_hook="auto")` takes a few steps with one checkpoint
of the cadence and writes the files that the JAX package's hooks name
(`slide_tpu/train/driver.py::make_generation_eval_hook` /
`make_latent_eval_hook`: <experiment root>/eval_result/, the EMA shadows
under model_ema_<rate:.5f>/, `_iter_<n>` tags), for the raw weights and
every EMA shadow.  Each file must equal `evaluate_per_rank` run on a net
loaded from that checkpoint's weights, so the hook evaluated the weights
it names."""

import os

import numpy as np
import pytest
import torch

from slide_tpu_torch import data as tdata
from slide_tpu_torch import models as tm
from slide_tpu_torch.configs import keypoint_ddpm_config, latent_ddpm_config
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams
from slide_tpu_torch.eval import evaluate_per_rank
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.train.checkpoint import load_checkpoint
from slide_tpu_torch.train.ema import select_eval_params_from_ckpt
from slide_tpu_torch.weights import load_flax_params, module_to_flax
from torch_port_helpers import perturb, train_ae_config

T = 4
RATES = (0.999, 0.9999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "shapenet_psr")
    return tdata.write_synthetic_shapenet_psr(root, models_per_split=8, num_points=600,
                                              with_psr=False)


def _narrow(pc, in_fea_dim=None, out_dim=None):
    pc.update(t_dim=16, class_condition_dim=16)
    if in_fea_dim is not None:
        pc.update(in_fea_dim=in_fea_dim, out_dim=out_dim)
    pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                              mlp_depth=2, decoder_mlp_depth=2)


def _common(cfg, tmp_path):
    cfg["shapenet_psr_dataset_config"].update(repeat_dataset=1, npoints=256,
                                              eval_batch_size=2, num_samples_tested=4)
    # two batches of 4 an epoch: one checkpoint of the cadence in 3 steps
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               epochs_per_ckpt=1)
    assert tuple(cfg["train_config"]["ema_rate"]) == RATES
    return cfg


def _hook_files(exp_root: str, name: str) -> dict:
    """The files the JAX package's hook writes at iteration 1: raw weights
    under eval_result/, each shadow under eval_result/model_ema_<rate>/."""
    base = os.path.join(exp_root, "eval_result")
    files = {"raw": os.path.join(base, name)}
    for i, rate in enumerate(RATES):
        files[i] = os.path.join(base, f"model_ema_{rate:.5f}", name)
    return files


def _ckpt_net(cfg, ckpt, which):
    net = tm.ConditionalPointNet2(cfg["pointnet_config"])
    load_flax_params(net, ckpt["model_state_dict"] if which == "raw"
                     else ckpt["ema_state_list"][which])
    return net.eval()


def _assert_same_npz(got_file, want_file):
    with np.load(got_file) as g, np.load(want_file) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            if k != "timing":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_position_ddpm_eval_hook(tree, tmp_path):
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    _narrow(cfg["pointnet_config"])
    cfg["diffusion_config"]["T"] = T
    cfg = _common(cfg, tmp_path)
    state, _ = tdriver.train_position_ddpm(cfg, data_dir=tree, max_iters=3, device="cpu",
                                           eval_hook="auto", verbose=False)
    exp_root, ckpt_dir = tdriver.experiment_dirs(cfg)
    files = _hook_files(exp_root, "shapenet_psr_generated_data_16_pts_iter_1.npz")
    assert all(os.path.isfile(f) for f in files.values())
    ckpt = load_checkpoint(ckpt_dir, 1)
    sched = calc_diffusion_hyperparams(T, 1e-4, 0.02)
    trainset = dict(cfg["shapenet_psr_dataset_config"], data_dir=tree)
    for which, path in files.items():
        want = evaluate_per_rank(_ckpt_net(cfg, ckpt, which), trainset, sched,
                                 str(tmp_path / f"again_{which}"), "keypoint_generation",
                                 ckpt_info="_iter_1", device="cpu")
        _assert_same_npz(path, want)
        with np.load(path) as d:
            assert d["points"].shape == (4, 16, 3) and np.isfinite(d["points"]).all()
    with np.load(files["raw"]) as a, np.load(files[0]) as b:
        assert not np.array_equal(a["points"], b["points"])
    # the shadows are 3 updates old: each maturity is below 0.95, so the
    # checkpoint's pick is the raw weights
    params, which = select_eval_params_from_ckpt(ckpt)
    assert which == "raw" and params is ckpt["model_state_dict"]


def test_eval_hook_cadence(tree, tmp_path):
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    _narrow(cfg["pointnet_config"])
    cfg["diffusion_config"]["T"] = T
    cfg = _common(cfg, tmp_path)
    cfg["train_config"].update(eval_per_ckpt=2, epochs_per_ckpt=0.5, ema_rate=[])
    tdriver.train_position_ddpm(cfg, data_dir=tree, max_iters=4, device="cpu",
                                eval_hook="auto", verbose=False)
    # a checkpoint every step, an evaluation at every second one
    out = os.path.join(tdriver.experiment_dirs(cfg)[0], "eval_result")
    assert sorted(os.listdir(out)) == [f"shapenet_psr_generated_data_16_pts_iter_{i}.npz"
                                       for i in (1, 3)]


def test_latent_ddpm_eval_hook(tree, tmp_path):
    cfg = latent_ddpm_config("airplane", batch_size=4)
    cfg["autoencoder_config"]["pointnet_config"] = train_ae_config()
    _narrow(cfg["pointnet_config"], in_fea_dim=16, out_dim=19)
    cfg["pointnet_config"]["architecture"]["nsample"] = [6, 16]
    cfg["standard_diffusion_config"]["num_diffusion_timesteps"] = T
    cfg = _common(cfg, tmp_path)
    ae = tdriver.init_params(tm.build_autoencoder(train_ae_config()),
                             torch.Generator().manual_seed(1))
    ae_params = perturb(module_to_flax(ae), 1, scale=0.05)
    tdriver.train_latent_ddpm(cfg, ae_params, data_dir=tree, max_iters=3, device="cpu",
                              eval_hook="auto", verbose=False)
    exp_root, ckpt_dir = tdriver.experiment_dirs(cfg)
    files = _hook_files(exp_root, "shapenet_psr_generated_data_256_pts_iter_1.npz")
    assert all(os.path.isfile(f) for f in files.values())
    ckpt = load_checkpoint(ckpt_dir, 1)
    written = {}
    for which, path in files.items():
        with np.load(path) as d:
            assert sorted(d.files) == ["category", "category_name", "gt_points", "keypoint",
                                       "label", "points", "timing"]
            # named by the dataset's npoints, as in JAX; the decode gives 200
            assert d["points"].shape == (4, 200, 6) and np.isfinite(d["points"]).all()
            assert d["keypoint"].shape == (4, 16, 3)
            written[which] = {k: d[k] for k in d.files}
    # a hook of its own, run on a net loaded from each of the checkpoint's
    # weight sets (no shadows: it writes the raw file), writes that file
    hook = tdriver.make_latent_eval_hook(cfg, ae_params, data_dir=tree)
    for which, want in written.items():
        hook(_ckpt_net(cfg, ckpt, which), [], 1)
        with np.load(files["raw"]) as d:
            for k in want:
                if k != "timing":
                    np.testing.assert_array_equal(d[k], want[k], err_msg=f"{which} {k}")
    assert not np.array_equal(written["raw"]["points"], written[0]["points"])


def test_fastdpm_generation_eval(tree, tmp_path):
    # sampler="fastdpm": each batch one S-step FastDPM chain (the fused
    # denoiser's plain version here) on the draws it is handed, as
    # `fast_sampling` over the module gives them (atol 1e-4: the fused plain
    # version and the module sum in other orders)
    from slide_tpu_torch.diffusion import diffusion_config_of, fast_sampling
    cfg = keypoint_ddpm_config("airplane")
    _narrow(cfg["pointnet_config"])
    net = tdriver.init_params(tm.ConditionalPointNet2(cfg["pointnet_config"]),
                              torch.Generator().manual_seed(3)).eval()
    trainset = dict(cfg["shapenet_psr_dataset_config"], data_dir=tree, eval_batch_size=3,
                    num_samples_tested=5)
    sched = calc_diffusion_hyperparams(100, 1e-4, 0.02)
    kw = dict(length=5, sampling_method="step", schedule="quadratic", kappa=0.5)
    gen = torch.Generator().manual_seed(4)
    draws = [torch.randn((b, 16, 3), generator=gen) for b in (3,) * 6 + (2,) * 6]
    got = evaluate_per_rank(net, trainset, sched, str(tmp_path), "keypoint_generation",
                            sampler="fastdpm", fastdpm_kw=kw, device="cpu",
                            noise_fn=lambda shape, it=iter(draws): next(it))
    it = iter(draws)
    with np.load(got) as d:
        labels = torch.as_tensor(d["label"])
        for lo, b in ((0, 3), (3, 2)):
            lab = labels[lo:lo + b]
            with torch.no_grad():
                want = fast_sampling(lambda x, ts: net(x, ts=ts, label=lab), (b, 16, 3), sched,
                                     diffusion_config_of(sched), lambda shape: next(it), **kw)
            np.testing.assert_allclose(d["points"][lo:lo + b], want.numpy(), atol=1e-4)
