"""The training corpus on the device (`slide_tpu_torch/data/device_corpus.py`)
and `run_training`'s `device_data` branch against the JAX package on the
CPU: the corpus's rows (each unique model read once, its repeats mapped
onto it), the refusal of a non-uniform point count, the PSR gather;
`assemble` on the JAX package's own draws (rebuilt from its
`jax.random.split(key, 5)` streams) without and with every augmentation;
the model-index batch of every iteration, the checkpoints and the resume
against JAX's `run_training`; one device-data step against the loader
path's step on the same batch; the autoencoder and SAP tasks on the corpus
(the position DDPM runs above, the latent DDPM in
`tests/test_torch_latent_train.py`).

Tolerances: gathers (the subsample, labels, grids, the unaugmented cloud)
bit for bit; the augmented cloud 1e-6 absolute + 1e-6 relative (a mean over
the points and a few products, summed in another order than XLA's)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.data import device_corpus as jdc
from slide_tpu.data.shapenet_psr import ShapesPSRDataset as JDataset
from slide_tpu.train import driver as jdriver
from slide_tpu_torch import data as tdata
from slide_tpu_torch.configs import keypoint_ddpm_config
from slide_tpu_torch.data import device_corpus as tdc
from slide_tpu_torch.train import driver as tdriver
from torch_ae_cases import _tiny_ae_config
from torch_upsampler_train_cases import RES, _setting_config

AUG_ATOL = 1e-6
CATEGORIES = ["02691156", "03001627"]
P = 120          # points a model in the tree
NPOINTS = 64     # the subsample


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdata.write_synthetic_shapenet_psr(
        str(tmp_path_factory.mktemp("corpus") / "data"), categories=CATEGORIES,
        models_per_split=4, num_points=P, psr_res=8, shape_variety=True)


def _dataset_kw(repeat=1, load_psr=True):
    return dict(split="train", categories=CATEGORIES, scale=1, num_gt_points=NPOINTS,
                load_psr=load_psr, repeat_dataset=repeat, seed=0)


def test_corpus_reads_each_model_once(tree, tmp_path):
    tds = tdata.ShapesPSRDataset(tree, **_dataset_kw(repeat=3))
    corpus = tdc.DeviceCorpus.from_dataset(tds)
    jcorpus = jdc.DeviceCorpus.from_dataset(JDataset(tree, **_dataset_kw(repeat=3)))
    # 8 unique models, 24 entries: each read once, its repeats map onto it
    assert len(corpus) == len(jcorpus) == 24 and corpus.points.shape == (8, P, 3)
    assert corpus.psr.shape == (8, 8, 8, 8)
    for name, want in (("points", jcorpus.points), ("normals", jcorpus.normals),
                       ("psr", jcorpus.psr)):
        np.testing.assert_array_equal(getattr(corpus, name)[corpus.rows].numpy(), want)
    np.testing.assert_array_equal(corpus.labels[corpus.rows].numpy(), jcorpus.labels)
    assert corpus.nbytes == sum(t.numel() * t.element_size()
                                for t in (corpus.points, corpus.normals, corpus.labels,
                                          corpus.rows, corpus.psr))
    assert corpus.nbytes < jcorpus.nbytes        # JAX stacks the repeats
    assert corpus.to("cpu").device == torch.device("cpu")
    # the grids' gather: assemble hands back each entry's grid
    batch = tdc.make_assemble_fn({"npoints": NPOINTS, "scale": 1})(
        corpus, torch.tensor([0, 9, 23], dtype=torch.int32), torch.Generator())
    np.testing.assert_array_equal(batch["psr"].numpy(), jcorpus.psr[[0, 9, 23]])
    np.testing.assert_array_equal(batch["label"].numpy(), jcorpus.labels[[0, 9, 23]])
    # a model with another point count is refused
    odd = os.path.join(tree, "03001627", tds.models[-1]["model"], "pointcloud.npz")
    saved = dict(np.load(odd))
    try:
        np.savez(odd, points=saved["points"][:-1], normals=saved["normals"][:-1])
        with pytest.raises(ValueError, match="uniform point count"):
            tdc.DeviceCorpus.from_dataset(tds)
    finally:
        np.savez(odd, **saved)


def _jax_draws(trainset, key, b):
    """The draws JAX's `assemble` makes from `key`, rebuilt stream by
    stream: the permutation's head, the flip, the two noises, the
    translation and the scale of each model."""
    aug = trainset.get("augmentation") or {}
    sc = aug.get("augm_scale", 0)

    def one(k):
        k_sel, k_mir, k_noise, k_tr, k_sc = jax.random.split(k, 5)
        kp_, kn_ = jax.random.split(k_noise)
        out = {"sel": jax.random.permutation(k_sel, P)[:NPOINTS],
               "noise_points": jax.random.normal(kp_, (NPOINTS, 3)),
               "noise_normals": jax.random.normal(kn_, (NPOINTS, 3)),
               "translation": jax.random.normal(k_tr, (1, 3))}
        if aug.get("mirror_prob", 0) > 0:
            out["flip"] = jax.random.uniform(k_mir) < aug["mirror_prob"]
        if sc > 1:
            out["scale"] = jax.random.uniform(k_sc, minval=1.0 / sc, maxval=sc)
        return out

    draws = jax.jit(jax.vmap(one))(jax.random.split(key, b))
    return {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("augmented", [False, True])
def test_assemble_matches_jax_on_its_draws(tree, augmented):
    trainset = {"npoints": NPOINTS, "scale": 0.5 if augmented else 1}
    if augmented:
        trainset.update(centered_to_centroid=True,
                        augmentation={"mirror_prob": 0.5, "noise_magnitude": 0.01,
                                      "translation_magnitude": 0.1, "augm_scale": 1.2})
    ds = tdata.ShapesPSRDataset(tree, **_dataset_kw(repeat=2))
    corpus = tdc.DeviceCorpus.from_dataset(ds)
    jcorpus = jdc.DeviceCorpus.from_dataset(JDataset(tree, **_dataset_kw(repeat=2)))
    idx = np.array([3, 15, 0, 8, 8, 12], np.int32)
    key = jax.random.key(5)
    jbatch = jax.jit(jdc.make_assemble_fn(trainset))(jcorpus.device_put(), jnp.asarray(idx),
                                                     key)
    draws = _jax_draws(trainset, key, len(idx))
    if augmented:
        assert 0 < int(draws["flip"].sum()) < len(idx)      # both branches ran
    batch = tdc.make_assemble_fn(trainset)(corpus, torch.as_tensor(idx), draws=draws)
    for name in ("label", "psr"):
        np.testing.assert_array_equal(batch[name].numpy(), np.asarray(jbatch[name]))
    for name in ("points", "normals"):
        got, want = batch[name].numpy(), np.asarray(jbatch[name])
        if augmented:
            np.testing.assert_allclose(got, want, atol=AUG_ATOL, rtol=AUG_ATOL)
        else:
            np.testing.assert_array_equal(got, want)
    # the generator's own draws: the same shapes, a subsample without repeats
    own = tdc.make_assemble_fn(trainset)(corpus, torch.as_tensor(idx),
                                         torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in batch.items()}
    sel = tdc.draw_assembly(trainset, 6, P, torch.Generator().manual_seed(0))["sel"]
    assert all(len(set(row.tolist())) == NPOINTS for row in sel)


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Linear(1, 1)


def _index_runs(tree, tmp_path, monkeypatch, max_iters):
    """The model-index batch of every iteration of JAX's `run_training` and
    the port's under device_data (a step that only counts), and their
    checkpoint directories."""
    cfg = j_kp_config("airplane", batch_size=3)
    cfg["shapenet_psr_dataset_config"].update(data_dir=tree, npoints=NPOINTS,
                                              categories=CATEGORIES, repeat_dataset=2)
    cfg["train_config"].update(iters_per_logging=1, epochs_per_ckpt=2, device_data=True,
                               steps_per_dispatch=4, root_directory=str(tmp_path / "jax"),
                               ema_rate=None)
    seen = {"jax": [], "port": []}
    real_j, real_t = jdc.make_assemble_fn, tdriver.make_assemble_fn

    def j_make(trainset):
        assemble = real_j(trainset)

        def recording(corpus, idx, key):
            jax.debug.callback(lambda i: seen["jax"].append(np.array(i)), idx, ordered=True)
            return assemble(corpus, idx, key)
        return recording

    def t_make(trainset):
        assemble = real_t(trainset)

        def recording(corpus, idx, generator=None, draws=None):
            seen["port"].append(idx.numpy().copy())
            return assemble(corpus, idx, generator, draws)
        return recording

    monkeypatch.setattr(jdc, "make_assemble_fn", j_make)
    monkeypatch.setattr(tdriver, "make_assemble_fn", t_make)
    opt = optax.adam(1e-3)
    jstate = jdriver._init_state({"w": jnp.zeros((1,))}, opt, ())

    def j_step(state, batch, key):
        return state.replace(step=state.step + 1), jnp.sum(batch["points"])

    mesh = jdriver.make_data_mesh(jax.devices()[:1])
    _, jl = jdriver.run_training(cfg, jstate, j_step, mesh=mesh, max_iters=max_iters,
                                 verbose=False)
    tcfg = copy.deepcopy(cfg)
    tcfg["train_config"]["root_directory"] = str(tmp_path / "port")
    state = tdriver._new_state(_Linear(), {"learning_rate": 1e-3})

    def t_step(state, batch, generator):
        state.step += 1
        return batch["points"].sum()

    _, tl = tdriver.run_training(tcfg, state, t_step, max_iters=max_iters, verbose=False)
    dirs = [tdriver.experiment_dirs(c)[1] for c in (cfg, tcfg)]
    return seen, (jl, tl), [sorted(os.listdir(d)) for d in dirs]


def test_device_data_batches_checkpoints_and_resume_match_jax(tree, tmp_path, monkeypatch):
    # 16 entries at batch 3: 5 full batches an epoch (the tail of 1 dropped),
    # the loader's 6 batches an epoch set the cadence (a checkpoint every 12)
    seen, losses, ckpts = _index_runs(tree, tmp_path, monkeypatch, 14)
    assert len(seen["jax"]) == len(seen["port"]) == 14
    for it, (j, t) in enumerate(zip(seen["jax"], seen["port"])):
        np.testing.assert_array_equal(t, j, err_msg=f"iteration {it}")
        assert t.dtype == np.int32
    assert [i for i, _ in losses[0]] == [i for i, _ in losses[1]] == list(range(14))
    assert ckpts[0] == ckpts[1] == ["pointnet_ckpt_11.pkl", "pointnet_ckpt_13.pkl"]
    # resumed from iteration 13: epochs restart from the seed's first
    # permutation in both packages
    seen, losses, ckpts = _index_runs(tree, tmp_path, monkeypatch, 17)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for j, t in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(t, j)
    assert [i for i, _ in losses[1]] == [14, 15, 16]
    assert ckpts[0] == ckpts[1] == ["pointnet_ckpt_11.pkl", "pointnet_ckpt_13.pkl",
                                    "pointnet_ckpt_16.pkl"]


def test_device_data_step_is_the_loader_step(tree, tmp_path, monkeypatch):
    cfg = keypoint_ddpm_config("airplane", batch_size=4)
    pc = cfg["pointnet_config"]
    pc.update(t_dim=16, class_condition_dim=16)
    pc["architecture"].update(feature_dim=[16, 32, 32], decoder_feature_dim=[16, 32, 32],
                              mlp_depth=2, decoder_mlp_depth=2)
    cfg["shapenet_psr_dataset_config"].update(npoints=NPOINTS, categories=CATEGORIES,
                                              repeat_dataset=1,
                                              augmentation={"noise_magnitude": 0.01})
    cfg["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1,
                               device_data=True)
    batches = []
    real = tdriver.make_assemble_fn

    def keeping(trainset):
        assemble = real(trainset)

        def run(*args, **kw):
            batches.append(assemble(*args, **kw))
            return batches[-1]
        return run

    monkeypatch.setattr(tdriver, "make_assemble_fn", keeping)
    state, _ = tdriver.train_position_ddpm(cfg, data_dir=tree, max_iters=1, device="cpu",
                                           verbose=False)
    batch = batches[0]
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        "points": ((4, NPOINTS, 3), torch.float32), "normals": ((4, NPOINTS, 3), torch.float32),
        "label": ((4,), torch.int64)}
    # the loader path's step on that batch, from the same start and draws
    fresh, step = tdriver.build_position_ddpm(cfg, device="cpu")
    step(fresh, batch, torch.Generator().manual_seed(1))
    for (name, a), b in zip(state.net.named_parameters(), fresh.net.parameters()):
        assert torch.equal(a, b), name


def test_autoencoder_and_sap_train_on_the_corpus(tmp_path):
    root = tdata.write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=4,
                                              num_points=600, psr_res=RES, shape_variety=True,
                                              psr_from_points=True, device="cpu")
    ae = _tiny_ae_config(tmp_path)
    sap = _setting_config("mirrored")
    sap["shapenet_psr_dataset_config"].update(categories=["02691156"], repeat_dataset=1)
    sap["train_config"].update(root_directory=str(tmp_path / "exp"), iters_per_logging=1)
    for cfg, train in ((ae, tdriver.train_autoencoder), (sap, tdriver.train_upsampler)):
        cfg["train_config"]["device_data"] = True
        state, losses = train(cfg, data_dir=root, max_iters=2, device="cpu", verbose=False)
        assert [i for i, _ in losses] == [0, 1] and np.isfinite([l for _, l in losses]).all()
        assert state.step == 2
