"""The port's command line and its helpers (`slide_tpu_torch/cli/`,
`config.py`, `utils/`, `vis/pcd.py`, `vis/plot.py`, and the options that
`reconstruct` passes to `eval/mesh_recon.py::reconstruct_meshes`) against
the JAX package on the CPU.

Tolerances:
  - the config files, the .xyz dumps, the renders, the scalar records, the
    parsers' options and `normalize_point_cloud` / `read_eval_result`:
    equal (bytes, pixels, values);
  - `evaluate`'s report against JAX's `cmd_evaluate` on the same two npz
    files: EVAL_RTOL relative, per metric (the metrics' own tests measure
    the gaps);
  - `train`, `generate`, `encode` and `decode` through the port's command
    line: equal to the port function each calls, with the same generator;
  - `reconstruct_meshes` with `label_number`, `explicit_normalize`, an
    autoencoder round trip (`ae_fns`, a closed-form stand-in on both sides)
    and `noise_magnitude`, JAX's FPS picks, noise and permutation
    replayed: the DPSR grid within GRID_ATOL (measured 6.7e-7 on a grid of
    values up to 1) and the noisy clouds within PLY_ATOL (the PLY text's six
    decimals)."""

import argparse
import copy
import filecmp
import importlib
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_tpu import config as j_config
from slide_tpu import utils as j_utils
from slide_tpu.configs import keypoint_ddpm_config as j_kp_config
from slide_tpu.eval import mesh_recon as j_mesh_recon
from slide_tpu.models import ConditionalPointNet2 as JNet
from slide_tpu.sap import DPSR as JDPSR
from slide_tpu.vis import pcd as j_pcd
from slide_tpu.vis import plot as j_plot
from slide_tpu_torch import config as t_config
from slide_tpu_torch import data as tdata
from slide_tpu_torch import utils as t_utils
from slide_tpu_torch.configs import keypoint_ddpm_config
from slide_tpu_torch.data import BatchLoader, GeneralNpzDataset
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams
from slide_tpu_torch.eval import evaluate_per_rank
from slide_tpu_torch.eval import mesh_recon as t_mesh_recon
from slide_tpu_torch.models import ConditionalPointNet2 as TNet
from slide_tpu_torch.models import build_autoencoder
from slide_tpu_torch.ops import sample_keypoints
from slide_tpu_torch.pipeline import seeded_draws
from slide_tpu_torch.sap import DPSR
from slide_tpu_torch.train import driver as tdriver
from slide_tpu_torch.vis import pcd as t_pcd
from slide_tpu_torch.vis import plot as t_plot
from slide_tpu_torch.weights import load_flax_params, module_to_flax
from ddp_worker import ae_config, position_config
from torch_port_helpers import (perturb, record_jax_fps, replay_fps_in_port,
                                train_sap_config)

# the modules (each package's `cli.main` name is its function)
j_main = importlib.import_module("slide_tpu.cli.main")
t_main = importlib.import_module("slide_tpu_torch.cli.main")

EVAL_RTOL = 1e-5
GRID_ATOL = 1e-5
PLY_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The config helpers, normalize_point_cloud, read_eval_result


def test_config_helpers_match_jax(tmp_path):
    cfg = j_kp_config("airplane")
    assert t_config.stringify_lists(cfg) == j_config.stringify_lists(cfg)
    for style in (False, True):
        j_path, t_path = tmp_path / f"j_{style}_config.json", tmp_path / f"t_{style}_config.json"
        j_config.write_json_file(str(j_path), cfg, reference_style=style)
        t_config.write_json_file(str(t_path), cfg, reference_style=style)
        assert filecmp.cmp(j_path, t_path, shallow=False)
        assert t_config.read_json_file(str(j_path)) == j_config.read_json_file(str(j_path)) \
            == json.loads(json.dumps(cfg))
    # discovery: the named file, else the config with the largest number
    for name in ("run_config_10.json", "run_config_200.json", "notes.json"):
        (tmp_path / "d").mkdir(exist_ok=True)
        (tmp_path / "d" / name).write_text("{}")
    for arg in (str(tmp_path / "d"), str(tmp_path / "d" / "missing_config.json"),
                str(tmp_path / "d" / "run_config_10.json")):
        assert t_config.find_config_file(arg) == j_config.find_config_file(arg)
    with pytest.raises(FileNotFoundError):
        t_config.find_config_file(str(tmp_path / "nowhere"))
    # the autoencoder's encoder and decoder config files
    enc = {"pointnet_config": {"model_name": "enc", "npoint": [4, 2]}}
    decs = [{"pointnet_config": {"model_name": f"dec{i}", "k": [i]}} for i in range(2)]
    j_config.write_json_file(str(tmp_path / "enc.json"), enc, reference_style=True)
    for i, d in enumerate(decs):
        j_config.write_json_file(str(tmp_path / f"dec{i}.json"), d, reference_style=True)
    main = {"pointnet_config": {"encoder_config_file": "enc.json",
                                "decoder_config_file": ["dec0.json", "dec1.json"]}}
    assert t_config.autoencoder_read_config(str(tmp_path), main) == \
        j_config.autoencoder_read_config(str(tmp_path), main)


@pytest.mark.parametrize("mode", ["per_shape_axis", "per_shape", "box", "global"])
def test_normalize_point_cloud_matches_jax(mode):
    pts = np.random.default_rng(3).standard_normal((4, 50, 3)).astype(np.float32) * 2 + 0.5
    kw = {"per_shape_axis": {}, "per_shape": {"normalize_std_per_axis": False},
          "box": {"normalize_per_shape": False, "box_per_shape": True},
          "global": {"normalize_per_shape": False}}[mode]
    for got, want in zip(t_main.normalize_point_cloud(pts, **kw),
                         j_main.normalize_point_cloud(pts, **kw)):
        np.testing.assert_array_equal(got, want)
    mean, std = np.float32(0.1), np.float32(2.0)
    np.testing.assert_array_equal(
        t_main.normalize_point_cloud(pts, all_points_mean=mean, all_points_std=std)[0],
        j_main.normalize_point_cloud(pts, all_points_mean=mean, all_points_std=std)[0])


def test_read_eval_result_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "history.pkl")
    with open(path, "wb") as f:
        pickle.dump({"iter": [9, 19, 29], "dpsr_grid_L2_loss": [0.3, 0.1, 0.2],
                     "epoch": [0, 1, 2], "note": "ab", "seconds": 7}, f)
    want = j_main.read_eval_result(path)
    want_out = capsys.readouterr().out
    # every key indexable at the lowest entry's index (here a string too)
    assert t_main.read_eval_result(path) == want == {"iter": 19, "dpsr_grid_L2_loss": 0.1,
                                                     "epoch": 1, "note": "b"}
    assert capsys.readouterr().out == want_out
    assert t_main.main(["read-eval", "--file", path, "--loss", "iter"])["iter"] == 9
    with pytest.raises(SystemExit, match="not in"):
        t_main.read_eval_result(path, "cd_p")


# ---------------------------------------------------------------------------
# vis: the .xyz dumps and the renders


def test_visualize_pcd_writes_jax_files(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {"points": rng.standard_normal((3, 20, 3)).astype(np.float32),
              "normals": rng.standard_normal((3, 20, 3)).astype(np.float32),
              "label": np.array([0, 4, 12]),
              "category_name": np.array(["airplane", "car", "chair"]),
              "keypoint": rng.standard_normal((3, 5, 3)).astype(np.float32),
              "gt_points": rng.standard_normal((3, 20, 6)).astype(np.float32)}
    lean = {"points": arrays["points"]}
    for name, payload in (("full", arrays), ("lean", lean)):
        for idx in (True, False):
            dirs = []
            for side, fn in (("j", j_pcd.visualize_pcd), ("t", t_pcd.visualize_pcd)):
                d = tmp_path / side / f"{name}_{idx}"
                d.mkdir(parents=True)
                np.savez(d / "gen.npz", **payload)
                dirs.append(fn(str(d / "gen.npz"), include_idx_to_save_name=idx))
            files = sorted(os.listdir(dirs[0]))
            assert files and files == sorted(os.listdir(dirs[1]))
            match, mismatch, errors = filecmp.cmpfiles(dirs[0], dirs[1], files, shallow=False)
            assert not mismatch and not errors
    levels = [rng.standard_normal((2, n, 6)).astype(np.float32) for n in (4, 8, 16)]
    for payload in (levels, {"l_xyz": levels}):
        dirs = []
        for side, fn in (("j", j_pcd.visualize_hierarchical_pcd),
                         ("t", t_pcd.visualize_hierarchical_pcd)):
            d = tmp_path / f"h_{side}_{type(payload).__name__}"
            d.mkdir()
            with open(d / "levels.pkl", "wb") as f:
                pickle.dump(payload, f)
            dirs.append(fn(str(d / "levels.pkl"), offset=2.0))
        files = sorted(os.listdir(dirs[0]))
        assert files == ["hierarchy_000.xyz", "hierarchy_001.xyz"]
        assert filecmp.cmpfiles(dirs[0], dirs[1], files, shallow=False)[0] == files


def test_plots_render_jax_figures(tmp_path):
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(5)
    npz = tmp_path / "gen.npz"
    np.savez(npz, points=rng.standard_normal((2, 64, 3)).astype(np.float32),
             category_name=np.array(["airplane", "chair"]))
    got = t_plot.plot_npz(str(npz), str(tmp_path / "t"))
    want = j_plot.plot_npz(str(npz), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == \
        ["airplane_000.png", "chair_001.png"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(plt.imread(g), plt.imread(w))
    pts = rng.standard_normal((32, 6))
    g = t_plot.plot_pcd(pts, str(tmp_path / "t.png"), elev=30, azim=10, title="x", color="r")
    w = j_plot.plot_pcd(pts, str(tmp_path / "j.png"), elev=30, azim=10, title="x", color="r")
    np.testing.assert_array_equal(plt.imread(g), plt.imread(w))


# ---------------------------------------------------------------------------
# utils


def test_logging_timing_and_model_size_match_jax(tmp_path, monkeypatch):
    loggers = {}
    for side, mod in (("j", j_utils), ("t", t_utils)):
        log = mod.ScalarLogger(str(tmp_path / side))
        meter = mod.AverageMeter("loss")
        for step, v in enumerate([3.0, 1.0, 2.0]):
            meter.update(v, n=2, logger=log, global_step=step)
        log.scalar("lr", np.float32(1e-3), 0)
        log.close()
        assert (meter.val, meter.avg, meter.sum, meter.count) == (2.0, 2.0, 12.0, 6)
        loggers[side] = log
    records = {}
    for side, log in loggers.items():
        with open(log.path) as f:
            records[side] = [{k: v for k, v in json.loads(line).items() if k != "time"}
                             for line in f]
    assert records["t"] == records["j"] and len(records["t"]) == 4
    import matplotlib.pyplot as plt
    np.testing.assert_array_equal(plt.imread(loggers["t"].plot("loss")),
                                  plt.imread(loggers["j"].plot("loss")))

    # the step timer: JAX's summary keys; with a card it waits for it on
    # entry and exit (counted here through a stand-in)
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    timers = [t_utils.StepTimer(skip_first=1, device="cuda"), j_utils.StepTimer(skip_first=1)]
    for _ in range(3):
        for timer in timers:
            with timer:
                pass
    assert len(synced) == 6 and all(d == torch.device("cuda") for d in synced)
    assert sorted(timers[0].summary()) == sorted(timers[1].summary())
    assert timers[0].summary()["n"] == 2 and t_utils.StepTimer().summary() == {}
    with t_utils.StepTimer(device="cpu"):
        pass
    assert len(synced) == 6

    # parameter counts: the port's net, its flax tree, and JAX's count of it
    net = TNet(position_config(4)["pointnet_config"])
    tree = module_to_flax(net)
    n = j_utils.param_count(tree)
    assert t_utils.param_count(net) == t_utils.param_count(tree) == \
        t_utils.param_count(net.state_dict()) == n == sum(p.numel() for p in net.parameters())
    assert t_utils.print_size(net) == n


def test_finiteness_checks_name_jax_paths(tmp_path):
    net = TNet(position_config(4)["pointnet_config"])
    tree = jax.tree.map(np.array, module_to_flax(net))
    assert t_utils.tree_nonfinite_paths(tree) == j_utils.tree_nonfinite_paths(tree) == []
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    for i in (0, len(leaves) // 2):
        np.asarray(leaves[i][1]).flat[0] = np.nan
    tree["extra"] = [np.zeros(2), np.array([np.inf]), np.arange(3)]
    want = j_utils.tree_nonfinite_paths(tree)
    assert len(want) == 3 and t_utils.tree_nonfinite_paths(tree) == want
    with pytest.raises(FloatingPointError, match="in step 3"):
        t_utils.assert_tree_finite(tree, "step 3")
    with torch.no_grad():
        net.t_embedder.fc_t1.bias[0] = float("inf")
    assert t_utils.tree_nonfinite_paths(net) == ["t_embedder.fc_t1.bias"]
    assert t_utils.tree_nonfinite_paths(net.state_dict()) == ["t_embedder.fc_t1.bias"]
    finite = {"a": torch.ones(2)}
    assert t_utils.assert_tree_finite(finite) is finite


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    with t_utils.trace_profile(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# The parsers


class _Stop(Exception):
    pass


def _option_table(parser) -> dict:
    """{subcommand: {option strings: (dest, default, type, choices,
    required, action, help)}}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    table = {}
    for name, sp in sub.choices.items():
        table[name] = {tuple(a.option_strings): (
            a.dest, a.default, getattr(a.type, "__name__", a.type), a.choices, a.required,
            type(a).__name__, a.help) for a in sp._actions}
    return table


def test_parsers_match_jax(monkeypatch):
    made = []

    def parse_args(self, args=None, namespace=None):
        made.append(self)
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Stop):
        j_main.main([])
    monkeypatch.undo()
    want = _option_table(made[0])
    got = _option_table(t_main.build_parser())
    assert list(got) == list(want) == [
        "train", "generate", "latent-generate", "encode", "decode", "reconstruct", "gather",
        "read-eval", "correct-labels", "evaluate"]
    for cmd in want:
        extra = {k: v for k, v in got[cmd].items() if k not in want[cmd]}
        assert {k: v for k, v in got[cmd].items() if k in want[cmd]} == want[cmd], cmd
        if cmd in ("gather", "read-eval", "correct-labels"):
            assert extra == {}, cmd
        else:
            assert list(extra) == [("--device",)] and extra[("--device",)][1] == "cuda", cmd


# ---------------------------------------------------------------------------
# evaluate against JAX's


def test_evaluate_report_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(6)
    gen, ref = tmp_path / "gen.npz", tmp_path / "ref.npz"
    np.savez(gen, points=rng.standard_normal((6, 64, 6)).astype(np.float32) * 0.3)
    np.savez(ref, points=rng.standard_normal((7, 64, 3)).astype(np.float32) * 0.3)
    common = ["evaluate", "--gen", str(gen), "--ref", str(ref), "--all-metrics",
              "--batch_size", "4"]
    for extra in ([], ["--normalize"]):
        j_main.main(common + extra + ["--out", str(tmp_path / "j.json")])
        got = t_main.main(common + extra + ["--out", str(tmp_path / "t.json"), "--device",
                                            "cpu"])
        with open(tmp_path / "j.json") as f, open(tmp_path / "t.json") as g:
            want, written = json.load(f), json.load(g)
        assert written == got and sorted(got) == sorted(want)
        gaps = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items()}
        print(f"evaluate {extra}: {gaps}")
        assert max(gaps.values()) <= EVAL_RTOL
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The subcommands on the CPU against the port functions they call


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tdata.write_synthetic_shapenet_psr(str(tmp_path_factory.mktemp("cli") / "data"),
                                              models_per_split=8, num_points=600)


def _kp_config(tree, root, t_steps=5):
    cfg = position_config(4)
    cfg["diffusion_config"]["T"] = t_steps
    cfg["shapenet_psr_dataset_config"].update(data_dir=tree, repeat_dataset=1, npoints=256,
                                              eval_batch_size=3, num_samples_tested=5)
    cfg["train_config"].update(root_directory=root, iters_per_logging=1, epochs_per_ckpt=1)
    return cfg


def test_cli_train_and_generate_match_the_port(tree, tmp_path):
    cfg = _kp_config(tree, str(tmp_path / "cli"))
    path = str(tmp_path / "kp_config.json")
    t_config.write_json_file(path, cfg, reference_style=True)
    state, losses = t_main.main(["train", "-c", path, "--max_iters", "3", "--seed", "2",
                                 "--device", "cpu"])
    ref_state, ref_losses = tdriver.train_position_ddpm(
        _kp_config(tree, str(tmp_path / "direct")), max_iters=3, seed=2, device="cpu",
        verbose=False)
    assert losses == ref_losses and len(losses) == 3
    for p, q in zip(state.net.parameters(), ref_state.net.parameters()):
        assert torch.equal(p, q)
    ckpt = os.path.join(tdriver.experiment_dirs(cfg)[1], "pointnet_ckpt_2.pkl")
    assert os.path.isfile(ckpt)

    # generate with that checkpoint's EMA shadow 0, against evaluate_per_rank
    out = t_main.main(["generate", "-c", path, "--ckpt", ckpt, "--ema_idx", "0", "--seed", "4",
                       "--save_dir", str(tmp_path / "gen"), "--device", "cpu"])
    net = TNet(cfg["pointnet_config"])
    load_flax_params(net, t_main.load_inference_params(ckpt, 0))
    want = evaluate_per_rank(net.eval(), dict(cfg["shapenet_psr_dataset_config"]),
                             calc_diffusion_hyperparams(5, 1e-4, 0.02), str(tmp_path / "ref"),
                             "keypoint_generation", split_points_and_normals=True, seed=4,
                             device="cpu")
    assert os.path.basename(out) == os.path.basename(want)
    with np.load(out) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        assert g["points"].shape == (5, 16, 3)
        for k in g.files:
            if k != "timing":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    vis = os.path.splitext(out)[0] + "_visualization"
    assert len(os.listdir(vis)) == 5 and not os.path.isdir(
        os.path.splitext(want)[0] + "_visualization")
    # the ranked form writes the rank's file and no dump; gather merges
    for rank in range(2):
        t_main.main(["generate", "-c", path, "--ckpt", ckpt, "--num_samples", "4",
                     "--batch_size", "2", "--rank", str(rank), "--world_size", "2",
                     "--save_dir", str(tmp_path / "ranked"), "--device", "cpu"])
    merged = t_main.main(["gather", "--save_dir", str(tmp_path / "ranked"), "--world_size",
                          "2", "--num_points", "16"])
    with np.load(merged) as d:
        assert d["points"].shape == (4, 16, 3)
    assert sorted(os.listdir(tmp_path / "ranked")) == [os.path.basename(merged)]


def test_cli_encode_and_decode_match_the_autoencoder(tmp_path):
    cfg = ae_config(4)
    ae = tdriver.init_params(build_autoencoder(cfg["pointnet_config"]),
                             torch.Generator().manual_seed(3)).eval()
    ckpt = str(tmp_path / "ae.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump({"model_state_dict": module_to_flax(ae)}, f)
    path = str(tmp_path / "ae_config.json")
    t_config.write_json_file(path, cfg)
    rng = np.random.default_rng(7)
    v = rng.standard_normal((5, 256, 3)).astype(np.float32)
    normals = v / np.linalg.norm(v, axis=-1, keepdims=True)
    data = str(tmp_path / "clouds.npz")
    np.savez(data, points=0.4 * normals, normals=normals, label=np.array([0, 1, 2, 0, 1]))
    enc = t_main.main(["encode", "-c", path, "--ckpt", ckpt, "--dataset_path", data,
                       "--save_dir", str(tmp_path / "enc"), "--batch_size", "3", "--seed", "5",
                       "--save_keypoint_feature", "--device", "cpu"])
    assert os.path.basename(enc) == "autoencoder_reconstruction.npz"
    _, noise_fn, start_fn = seeded_draws(torch.device("cpu"), 5)
    want = {"points": [], "keypoint": [], "keypoint_feature": []}
    with torch.no_grad():
        for rows in (slice(0, 3), slice(3, 5)):
            pts = torch.as_tensor(0.4 * normals[rows])
            x = torch.cat([pts, torch.as_tensor(normals[rows])], -1)
            label = torch.as_tensor([0, 1, 2, 0, 1][rows])
            kp, _ = sample_keypoints(pts, cfg["shapenet_psr_dataset_config"]["num_keypoints"])
            feat = ae.encode(x, kp, label=label, noise_fn=noise_fn)
            want["points"].append(ae.decode(kp, feat, label=label, start_fn=start_fn))
            want["keypoint"].append(kp)
            want["keypoint_feature"].append(feat)
    with np.load(enc) as d:
        assert sorted(d.files) == ["keypoint", "keypoint_feature", "label", "points"]
        assert d["points"].shape == (5, 200, 6)
        np.testing.assert_array_equal(d["label"], [0, 1, 2, 0, 1])
        for k, parts in want.items():
            np.testing.assert_array_equal(d[k], torch.cat(parts).numpy(), err_msg=k)
    dec = t_main.main(["decode", "-c", path, "--ckpt", ckpt, "--dataset_path", enc,
                       "--save_dir", str(tmp_path / "dec"), "--batch_size", "5", "--seed", "6",
                       "--device", "cpu"])
    _, _, start_fn = seeded_draws(torch.device("cpu"), 6)
    with np.load(enc) as e, np.load(dec) as d, torch.no_grad():
        recon = ae.decode(torch.as_tensor(e["keypoint"]), torch.as_tensor(e["keypoint_feature"]),
                          label=torch.as_tensor(e["label"]).long(), start_fn=start_fn)
        assert sorted(d.files) == ["keypoint", "label", "points"]
        np.testing.assert_array_equal(d["points"], recon.numpy())
        np.testing.assert_array_equal(d["keypoint"], e["keypoint"])


# ---------------------------------------------------------------------------
# reconstruct_meshes' options against JAX's


def _ply_vertices(path) -> np.ndarray:
    with open(path) as f:
        lines = f.read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    return np.array([[float(v) for v in line.split()] for line in body])


def test_reconstruct_meshes_options_match_jax(tree, tmp_path, monkeypatch):
    # a cloud npz without labels (label_number), explicit normalisation,
    # an autoencoder round trip (a closed-form stand-in that reads the
    # keypoints) and its noise, one batch of 3 clouds at DPSR 32^3
    cfg = train_sap_config()
    pc, dc = cfg["pointnet_config"], dict(cfg["dpsr_config"], grid_res=32)
    trainset = dict(cfg["shapenet_psr_dataset_config"], num_keypoints=16)
    batch = next(iter(tdata.get_dataloader(dict(
        trainset, data_dir=tree, categories=["02691156"], npoints=200, eval_batch_size=3),
        phase="val", seed=0)))
    npz = str(tmp_path / "clouds.npz")
    np.savez(npz, points=np.concatenate([batch["points"], batch["normals"]], -1))
    tnet = tdriver.init_params(TNet(pc), torch.Generator().manual_seed(9))
    params = perturb(module_to_flax(tnet), 9, scale=0.05)
    load_flax_params(tnet, params)
    opts = dict(do_sample_points_from_mesh=False, explicit_normalize=True, label_number=3,
                noise_magnitude=0.01, seed=5)

    def loader(ds_mod):
        return ds_mod.BatchLoader(ds_mod.GeneralNpzDataset(
            npz, scale=1, noise_magnitude=0, data_key="points",
            data_key_split_names=["points", "normals"], data_key_split_dims=[0, 3, 6]),
            3, shuffle=False)

    def j_ae(x, keypoint, label, key):
        m = jnp.mean(keypoint, axis=1, keepdims=True)
        return x * 0.9 + 0.1 * jnp.concatenate([m, m], -1) + 0.01 * label[:, None, None]

    def t_ae(x, keypoint, label, noise_fn):
        m = keypoint.mean(dim=1, keepdim=True)
        return x * 0.9 + 0.1 * torch.cat([m, m], -1) + 0.01 * label[:, None, None]

    import slide_tpu.data as j_data
    j_grids = []
    real_mc = j_mesh_recon.mc_from_device_psr

    def mc(grid, transfer_dtype=None):
        j_grids.append(np.asarray(grid))
        return real_mc(grid, transfer_dtype=transfer_dtype)

    monkeypatch.setattr(j_mesh_recon, "mc_from_device_psr", mc)
    calls = record_jax_fps(monkeypatch)
    j_vis = j_mesh_recon.reconstruct_meshes(
        JNet(pc), params, JDPSR((32,) * 3, sig=dc["psr_sigma"]), loader(j_data), pc, dc,
        trainset, str(tmp_path / "jax"), ae_fns=j_ae, transfer_dtype=None, **opts)
    # JAX's draws for the batch: the round trip's key, the noise, the
    # permutation, each split from the batch key
    _, k_b = jax.random.split(jax.random.key(5))
    _, key = jax.random.split(k_b)
    key, k_n = jax.random.split(key)
    noise = np.array(jax.random.normal(k_n, (3, 200, 6)))
    perm = np.array(jax.random.permutation(jax.random.split(key)[1], 400))

    t_grids = []
    real_march = t_mesh_recon.marching_tetrahedra_device

    def march(grid):
        t_grids.append(grid.numpy().copy())
        return real_march(grid)

    monkeypatch.setattr(t_mesh_recon, "marching_tetrahedra_device", march)
    replay = replay_fps_in_port(monkeypatch, calls, 1e-5, tie_calls=range(len(calls)))
    t_vis = t_mesh_recon.reconstruct_meshes(
        tnet.eval(), DPSR((32,) * 3, sig=dc["psr_sigma"]), loader(tdata), pc, dc, trainset,
        str(tmp_path / "port"), ae_fns=t_ae, device="cpu",
        noise_fn=lambda shape: torch.as_tensor(noise), perm_fn=lambda n: torch.as_tensor(perm),
        **opts)
    assert next(replay, None) is None
    gap = float(np.abs(t_grids[0] - j_grids[0]).max())
    print(f"grid gap {gap:.2e} (largest {np.abs(j_grids[0]).max():.2e})")
    assert len(j_grids) == len(t_grids) == 1 and gap <= GRID_ATOL
    for sub in ("noisy_pcd", "refined_pcd", "reconstructed_mesh"):
        names = sorted(os.listdir(os.path.join(j_vis, sub)))
        assert names and names == sorted(os.listdir(os.path.join(t_vis, sub))), sub
    for name in sorted(os.listdir(os.path.join(j_vis, "noisy_pcd"))):
        np.testing.assert_allclose(_ply_vertices(os.path.join(t_vis, "noisy_pcd", name)),
                                   _ply_vertices(os.path.join(j_vis, "noisy_pcd", name)),
                                   atol=PLY_ATOL, rtol=0)
