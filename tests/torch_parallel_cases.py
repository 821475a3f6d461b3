"""Several processes and several devices in the port
(`slide_tpu_torch/parallel/`, `train/driver.py::run_training` under a
process group, `eval/generation.py::evaluate_per_rank(mesh=, visualize=)`)
on the CPU.

  - the draw helpers outside a data-parallel step draw what torch draws,
    and inside one a rank's rows of the global batch's draw (equal);
  - two ranks as two processes joined over `gloo` (`tests/ddp_worker.py`,
    modelled on `tests/test_multihost_sim.py`): `world_info` and
    `process_allgather`; the keypoint DDPM's and the autoencoder's
    step on each rank's rows against one process's step on all of them,
    same draws: every gradient element within STEP_RTOL of the largest
    (measured 2.7e-7 and 1.2e-6), the losses within 1e-6, the parameters
    after Adam bit-equal on both ranks; `train_position_ddpm` over two
    ranks: equal parameters on both, checkpoints from rank 0 only, a
    resume on both from the same checkpoint, the indivisible batch's
    error;
  - generation with the denoiser over two and three devices (the CPU each
    time) against one, a batch that does not divide: within MESH_ATOL,
    JAX's own tolerance for its sharded generation
    (`tests/test_multichip_generation.py`); the .xyz dump of the file."""

import filecmp
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from slide_tpu_torch import parallel
from slide_tpu_torch.data import write_synthetic_shapenet_psr
from slide_tpu_torch.diffusion import calc_diffusion_hyperparams
from slide_tpu_torch.eval import evaluate_per_rank
from slide_tpu_torch.models import ConditionalPointNet2
from slide_tpu_torch.parallel import sharded as dp
from slide_tpu_torch.train.driver import init_params
from slide_tpu_torch.vis import visualize_pcd
from ddp_worker import position_config

STEP_RTOL = 1e-5
MESH_ATOL = 2e-4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ddp_worker.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_ranks(check: str, out_dir: str, world: int = 2, device: str = "cpu",
              backend: str = "gloo", timeout: int = 240) -> list:
    """`tests/ddp_worker.py <check>` as `world` processes joined at a free
    local port; each rank's JSON."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, WORKER, check, str(r), str(world),
                               f"127.0.0.1:{port}", device, backend, out_dir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def test_draws_are_the_global_batch_rows():
    gen = torch.Generator().manual_seed(3)
    want = (torch.randn((6, 5, 3), generator=gen),
            torch.randint(0, 7, (6,), generator=gen, dtype=torch.int32))
    gen = torch.Generator().manual_seed(3)
    got = (dp.batch_randn((6, 5, 3), gen), dp.batch_randint(7, (6,), gen, dtype=torch.int32))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dp.current_shard() is None
    for rank in range(3):
        gen = torch.Generator().manual_seed(3)
        token = dp._SHARD.set(dp.Shard(rank, 3))
        try:
            rows = (dp.batch_randn((2, 5, 3), gen),
                    dp.batch_randint(7, (2,), gen, dtype=torch.int32))
        finally:
            dp._SHARD.reset(token)
        for g, w in zip(rows, want):
            assert torch.equal(g, w[2 * rank:2 * rank + 2])
    # without a shard nothing is reduced
    t = torch.ones(3)
    dp.all_reduce_mean([t])
    assert torch.equal(t, torch.ones(3))


def test_single_process_world():
    assert parallel.maybe_initialize_distributed(None) is False
    assert not parallel.process_group_active()
    assert parallel.world_info()[:2] == (0, 1)
    gathered = parallel.process_allgather({"a": np.arange(3), "b": [np.ones(2)]})
    assert gathered["a"].shape == (1, 3) and gathered["b"][0].shape == (1, 2)
    batch = parallel.global_batch_from_local(
        {"points": np.zeros((2, 4, 3), np.float32), "names": ["a", "b"]}, "cpu")
    assert batch["names"] == ["a", "b"] and batch["points"].shape == (2, 4, 3)
    with pytest.raises(ValueError, match="num_processes"):
        parallel.maybe_initialize_distributed("127.0.0.1:1", device="cpu")


def test_two_rank_steps_equal_one_process_step(tmp_path):
    ranks = run_ranks("steps", str(tmp_path))
    for r, res in enumerate(ranks):
        assert res["world_info"] == [r, 2, 1, 2] and res["gathered"] == [0, 1]
    for task in ("kp", "ae"):
        ref = ranks[0][task]
        print(f"{task}: gradient gap {ref['gap']:.2e} of {ref['largest']:.2e}, losses "
              f"{ref['loss']} / {ref['ref_loss']}")
        assert ref["gap"] <= STEP_RTOL * ref["largest"]
        assert abs(ref["loss"] - ref["ref_loss"]) <= 1e-6 * abs(ref["ref_loss"])
        assert ranks[1][task]["digest"] == ref["digest"]
        assert ranks[1][task]["loss"] == ref["loss"]


def test_two_rank_training_run(tmp_path):
    write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=8, num_points=600)
    ranks = run_ranks("run", str(tmp_path))
    for run, logged in (("first", [0, 1, 2]), ("resumed", [3, 4])):
        assert ranks[0][run]["logged"] == ranks[1][run]["logged"] == logged
        assert ranks[0][run]["losses"] == ranks[1][run]["losses"]
        assert ranks[0][run]["digest"] == ranks[1][run]["digest"]
        assert ranks[1][run]["saved"] == []
    # two batches of 2 a rank an epoch: saved at each epoch's end
    assert ranks[0]["first"]["saved"] == [1, 2] and ranks[0]["resumed"]["saved"] == [3, 4]
    assert ranks[0]["resumed"]["step"] == 5
    ckpt_dir = tmp_path / "exp" / "T1000_betaT0.02_keypoint_ddpm_airplane" / "checkpoint"
    assert sorted(os.listdir(ckpt_dir)) == [f"pointnet_ckpt_{i}.pkl" for i in range(1, 5)]
    for res in ranks:
        assert "not divisible by the 2 ranks" in res["indivisible"]


def test_generation_over_devices_matches_one_device(tmp_path):
    cfg = position_config(4)
    net = init_params(ConditionalPointNet2(cfg["pointnet_config"]),
                      torch.Generator().manual_seed(4)).eval()
    # the unconditional loader reads only the labels' metadata
    root = write_synthetic_shapenet_psr(str(tmp_path / "data"), models_per_split=1,
                                        num_points=100)
    trainset = dict(cfg["shapenet_psr_dataset_config"], eval_batch_size=3,
                    num_samples_tested=5, data_dir=root)
    sched = calc_diffusion_hyperparams(4, 1e-4, 0.02)
    files = {}
    for name, mesh in (("one", None), ("two", ["cpu", "cpu"]), ("three", ["cpu"] * 3)):
        files[name] = evaluate_per_rank(net, trainset, sched, str(tmp_path / name),
                                        "keypoint_generation", seed=2, device="cpu",
                                        mesh=mesh, visualize=name == "one")
    with np.load(files["one"]) as one:
        assert one["points"].shape == (5, 16, 3)
        for name in ("two", "three"):
            with np.load(files[name]) as other:
                np.testing.assert_allclose(other["points"], one["points"], atol=MESH_ATOL,
                                           rtol=0)
                np.testing.assert_array_equal(other["label"], one["label"])
    dumped = os.path.splitext(files["one"])[0] + "_visualization"
    names = sorted(os.listdir(dumped))
    assert len(names) == 5
    assert not os.path.isdir(os.path.splitext(files["two"])[0] + "_visualization")
    os.makedirs(tmp_path / "copy")
    shutil.copy(files["one"], tmp_path / "copy")
    again = visualize_pcd(str(tmp_path / "copy" / os.path.basename(files["one"])))
    assert filecmp.cmpfiles(dumped, again, names, shallow=False)[0] == names
