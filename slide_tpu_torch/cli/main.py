"""The command line (counterpart: `slide_tpu/cli/main.py`): the same ten
subcommands, options and defaults, plus `--device` (default `cuda`; the
CPU runs the kernels' plain versions).  See the package docstring for the
command map."""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from slide_tpu_torch.weights import load_inference_params

__all__ = ["main", "load_inference_params", "normalize_point_cloud", "read_eval_result"]


def normalize_point_cloud(all_points, normalize_std_per_axis: bool = True,
                          normalize_per_shape: bool = True,
                          all_points_mean=None, all_points_std=None,
                          input_dim: int = 3, box_per_shape: bool = False):
    """Clouds (B, N, input_dim) centred and scaled: by the given mean and
    std; else per shape (std per axis or over all coordinates); else by
    each shape's box (min, extent); else over the whole set.  Returns
    (normalized, mean, std)."""
    pts = np.asarray(all_points)
    if all_points_mean is not None and all_points_std is not None:
        mean, std = all_points_mean, all_points_std
    elif normalize_per_shape:
        b, n = pts.shape[:2]
        mean = pts.mean(axis=1).reshape(b, 1, input_dim)
        if normalize_std_per_axis:
            std = pts.reshape(b, n, -1).std(axis=1).reshape(b, 1, input_dim)
        else:
            std = pts.reshape(b, -1).std(axis=1).reshape(b, 1, 1)
    elif box_per_shape:
        b = pts.shape[0]
        mean = pts.min(axis=1).reshape(b, 1, input_dim)
        std = (pts.max(axis=1) - pts.min(axis=1)).reshape(b, 1, input_dim)
    else:
        mean = pts.reshape(-1, input_dim).mean(axis=0).reshape(1, 1, input_dim)
        if normalize_std_per_axis:
            std = pts.reshape(-1, input_dim).std(axis=0).reshape(1, 1, input_dim)
        else:
            std = pts.reshape(-1).std().reshape(1, 1, 1)
    return (pts - mean) / std, mean, std


def read_eval_result(file: str, loss: str = "dpsr_grid_L2_loss") -> dict:
    """The evaluation history's entry at the lowest value of `loss`: every
    key's value at that index."""
    with open(file, "rb") as f:
        data = pickle.load(f)
    if loss not in data:
        raise SystemExit(f"key {loss!r} not in {sorted(data.keys())}")
    y = np.asarray(data[loss], dtype=np.float64)
    idx = int(np.argmin(y))
    print(f"The lowest {loss} is at index {idx}")
    report = {}
    for key, vals in data.items():
        try:
            report[key] = vals[idx]
        except (TypeError, IndexError, KeyError):
            continue
        print(key, report[key])
    return report


def _read_config(path: str) -> dict:
    from slide_tpu_torch.config import read_json_file
    return read_json_file(path)


def _fused() -> bool:
    """The chains' fused denoiser (K1 on the card), unless SLIDE_TPU_FUSED=0."""
    return os.environ.get("SLIDE_TPU_FUSED", "1") != "0"


def _device(args):
    from slide_tpu_torch.pipeline import resolve_device
    return resolve_device(args.device)


def _setup_rank(args):
    """(rank, world_size) of this process.  `--coordinator_address` joins
    the `torch.distributed` group (one process per card; `train` is then
    data parallel, generate / latent-generate write per-rank npz files,
    merged afterwards with `gather`); `--rank/--world_size` override, for
    file-sharded evaluation by independent processes."""
    from slide_tpu_torch.parallel import maybe_initialize_distributed, world_info
    maybe_initialize_distributed(getattr(args, "coordinator_address", None),
                                 getattr(args, "num_processes", None),
                                 getattr(args, "process_id", None),
                                 device=getattr(args, "device", None))
    rank, world = world_info()[:2]
    if getattr(args, "rank", None) is not None:
        rank = args.rank
    if getattr(args, "world_size", None) is not None:
        world = args.world_size
    return rank, world


def _load_net(config: dict, args, dev):
    from slide_tpu_torch.models import ConditionalPointNet2
    from slide_tpu_torch.weights import load_flax_params
    net = ConditionalPointNet2(config["pointnet_config"])
    load_flax_params(net, load_inference_params(args.ckpt, args.ema_idx))
    return net.to(dev).eval()


def _test_set(config: dict, args) -> dict:
    ts_cfg = dict(config["shapenet_psr_dataset_config"])
    if args.num_samples:
        ts_cfg["num_samples_tested"] = args.num_samples
    if args.batch_size:
        ts_cfg["eval_batch_size"] = args.batch_size
    return ts_cfg


def cmd_train(args):
    _setup_rank(args)
    from slide_tpu_torch.train.driver import (train_autoencoder, train_latent_ddpm,
                                              train_position_ddpm, train_upsampler)
    config = _read_config(args.config)
    task = config["train_config"]["task"]
    kw = dict(max_iters=args.max_iters, seed=args.seed, device=args.device)
    if task in ("generation", "keypoint_generation", "keypoint_conditional_generation"):
        return train_position_ddpm(config, **kw)
    if task == "autoencode":
        return train_autoencoder(config, **kw)
    if task in ("latent_generation", "latent_keypoint_conditional_generation"):
        ae_ckpt = args.ae_ckpt or config["autoencoder_config"]["ckpt"]
        return train_latent_ddpm(config, load_inference_params(ae_ckpt), **kw)
    if task == "upsample":
        ae_params = load_inference_params(args.ae_ckpt) if args.ae_ckpt else None
        return train_upsampler(config, ae_params=ae_params, **kw)
    raise SystemExit(f"unknown task {task}")


def cmd_generate(args):
    from slide_tpu_torch.diffusion import calc_diffusion_hyperparams
    from slide_tpu_torch.eval import evaluate_per_rank
    rank, world = _setup_rank(args)
    dev = _device(args)
    config = _read_config(args.config)
    dc = config["diffusion_config"]
    sched = calc_diffusion_hyperparams(dc["T"], dc["beta_0"], dc["beta_T"], dev)
    net = _load_net(config, args, dev)
    return evaluate_per_rank(net, _test_set(config, args), sched, args.save_dir,
                             config["train_config"]["task"],
                             point_feature_dim=3 + config["pointnet_config"]["in_fea_dim"],
                             rank=rank, world_size=world, split_points_and_normals=True,
                             seed=args.seed, visualize=not args.no_visualize,
                             sampler=args.sampler,
                             fastdpm_kw={"length": args.fastdpm_s,
                                         "sampling_method": args.fastdpm_method,
                                         "schedule": args.fastdpm_schedule,
                                         "kappa": args.fastdpm_kappa},
                             fused=_fused(), device=dev)


def cmd_latent_generate(args):
    from slide_tpu_torch.diffusion import X0Schedule, latent_denoise_and_reconstruct
    from slide_tpu_torch.eval import evaluate_per_rank
    from slide_tpu_torch.models import build_autoencoder, decode_params
    from slide_tpu_torch.models.fused_denoiser import make_fused_net_fn
    from slide_tpu_torch.weights import load_flax_params
    rank, world = _setup_rank(args)
    dev = _device(args)
    config = _read_config(args.config)
    sched = X0Schedule.from_config(config["standard_diffusion_config"], dev)
    net = _load_net(config, args, dev)
    ae = build_autoencoder(config["autoencoder_config"]["pointnet_config"], decode_only=True)
    ae_ckpt = args.ae_ckpt or config["autoencoder_config"]["ckpt"]
    load_flax_params(ae, decode_params(load_inference_params(ae_ckpt)))
    ae = ae.to(dev).eval()
    ts_cfg = _test_set(config, args)
    k = ts_cfg["num_keypoints"]
    feat_dim = config["pointnet_config"]["in_fea_dim"]
    fused = make_fused_net_fn(config["pointnet_config"], net, k) if _fused() else None

    sampler_kw = {}
    if args.sampler == "fastdpm":
        sampler_kw = {"sampler": "fastdpm",
                      "fastdpm_kw": {"length": args.fastdpm_s,
                                     "schedule": args.fastdpm_schedule,
                                     "kappa": args.fastdpm_kappa}}

    def latent_sampler(noise_fn, start_fn, label, keypoint, **resample_kw):
        def net_fn(x, ts):
            if fused is not None:
                return fused(x, ts, label)
            return net(x, ts=ts, label=label)

        def decode_fn(kp, feat, lbl):
            return ae.decode(kp, feat, label=lbl, start_fn=start_fn)

        return latent_denoise_and_reconstruct(
            net_fn, decode_fn, label.shape[0], 3, (k, 3 + feat_dim), sched, noise_fn,
            label=label, keypoint=keypoint, **resample_kw, **sampler_kw)

    # partial shape editing: only the masked keypoints' latents sampled anew
    local_resampling = args.local_resampling_file is not None
    complete_x0 = keypoint_mask = None
    if local_resampling:
        with np.load(args.local_resampling_file) as d:
            complete_x0 = d["complete_x0"]
            keypoint_mask = d["keypoint_mask"]

    return evaluate_per_rank(net, ts_cfg, None, args.save_dir, config["train_config"]["task"],
                             point_feature_dim=feat_dim, rank=rank, world_size=world,
                             latent_sampler=latent_sampler,
                             test_external_keypoint=args.external_keypoint_file is not None,
                             external_keypoint_file=args.external_keypoint_file,
                             save_keypoint_feature=args.save_keypoint_feature,
                             split_points_and_normals=True, seed=args.seed,
                             visualize=not args.no_visualize,
                             local_resampling=local_resampling, complete_x0=complete_x0,
                             keypoint_mask=keypoint_mask, device=dev)


def _load_ae(args, config, dev):
    from slide_tpu_torch.models import build_autoencoder
    from slide_tpu_torch.weights import load_flax_params
    ae = build_autoencoder(config["pointnet_config"])
    load_flax_params(ae, load_inference_params(args.ckpt))
    return ae.to(dev).eval()


def _save_npz(save_dir: str, name: str, out: dict) -> str:
    os.makedirs(save_dir, exist_ok=True)
    save = os.path.join(save_dir, name)
    np.savez(save, **{k: np.concatenate(v, axis=0) for k, v in out.items() if v})
    return save


def cmd_encode(args):
    import torch
    from slide_tpu_torch.data import BatchLoader, GeneralNpzDataset
    from slide_tpu_torch.ops import sample_keypoints
    from slide_tpu_torch.pipeline import seeded_draws
    dev = _device(args)
    config = _read_config(args.config)
    ae = _load_ae(args, config, dev)
    loader = BatchLoader(GeneralNpzDataset(args.dataset_path, scale=1, noise_magnitude=0),
                         args.batch_size, shuffle=False)
    k = config["shapenet_psr_dataset_config"]["num_keypoints"]
    _, noise_fn, start_fn = seeded_draws(dev, args.seed)
    out = {"points": [], "keypoint": [], "keypoint_feature": [], "label": []}
    with torch.no_grad():
        for data in loader:
            pts = torch.as_tensor(data["points"], dtype=torch.float32, device=dev)
            x = pts
            if "normals" in data:
                x = torch.cat([pts, torch.as_tensor(data["normals"], dtype=torch.float32,
                                                    device=dev)], dim=-1)
            label = torch.as_tensor(np.asarray(data["label"]), dtype=torch.int64, device=dev)
            if args.keypoint_source == "farthest_points_sampling" or "keypoint" not in data:
                kp, _ = sample_keypoints(pts[..., :3], k, add_centroid=True)
            else:
                kp = torch.as_tensor(data["keypoint"], dtype=torch.float32, device=dev)
            feat = ae.encode(x, kp, label=label, noise_fn=noise_fn)
            recon = ae.decode(kp, feat, label=label, start_fn=start_fn)
            out["points"].append(recon.cpu().numpy())
            out["keypoint"].append(kp.cpu().numpy())
            out["keypoint_feature"].append(feat.cpu().numpy())
            out["label"].append(label.cpu().numpy().astype(np.int32))
    if not args.save_keypoint_feature:
        out.pop("keypoint_feature")
    save = _save_npz(args.save_dir, "autoencoder_reconstruction.npz", out)
    print(f"reconstructions saved to {save}")
    return save


def cmd_decode(args):
    import torch
    from slide_tpu_torch.data import BatchLoader, GeneralNpzDataset
    from slide_tpu_torch.pipeline import seeded_draws
    dev = _device(args)
    config = _read_config(args.config)
    ae = _load_ae(args, config, dev)
    loader = BatchLoader(GeneralNpzDataset(args.dataset_path, scale=1, noise_magnitude=0,
                                           data_key="keypoint"),
                         args.batch_size, shuffle=False)
    _, _, start_fn = seeded_draws(dev, args.seed)
    out = {"points": [], "keypoint": [], "label": []}
    with torch.no_grad():
        for data in loader:
            kp = torch.as_tensor(data["keypoint"], dtype=torch.float32, device=dev)
            feat = torch.as_tensor(data["keypoint_feature"], dtype=torch.float32, device=dev)
            label = torch.as_tensor(np.asarray(data["label"]), dtype=torch.int64, device=dev)
            recon = ae.decode(kp, feat, label=label, start_fn=start_fn)
            out["points"].append(recon.cpu().numpy())
            out["keypoint"].append(kp.cpu().numpy())
            out["label"].append(label.cpu().numpy().astype(np.int32))
    save = _save_npz(args.save_dir, "decoded_from_keypoints.npz", out)
    print(f"decoded clouds saved to {save}")
    return save


def cmd_reconstruct(args):
    from slide_tpu_torch.data import BatchLoader, GeneralNpzDataset
    from slide_tpu_torch.eval import reconstruct_meshes
    from slide_tpu_torch.sap import DPSR
    dev = _device(args)
    config = _read_config(args.config)
    net = _load_net(config, args, dev)
    dpsr_config = config["dpsr_config"]
    dpsr = DPSR((dpsr_config["grid_res"],) * 3, sig=dpsr_config["psr_sigma"]).to(dev)
    ds = GeneralNpzDataset(args.dataset_path, scale=1, noise_magnitude=0, data_key="points",
                           data_key_split_names=["points", "normals"],
                           data_key_split_dims=[0, 3, 6])
    vis_dir = reconstruct_meshes(
        net, dpsr, BatchLoader(ds, args.batch_size, shuffle=False), config["pointnet_config"],
        dpsr_config, config["shapenet_psr_dataset_config"], args.save_dir,
        do_sample_points_from_mesh=True, explicit_normalize=True,
        return_original_scale=args.return_original_scale, label_number=args.label_number,
        seed=args.seed, device=dev)
    print(f"meshes saved under {vis_dir}")
    return vis_dir


def cmd_evaluate(args):
    import torch
    from slide_tpu_torch.ops import calc_cd
    dev = _device(args)
    with np.load(args.gen) as d:
        gen = d["points"][..., :3].astype(np.float32)
    with np.load(args.ref) as d:
        ref = d["points"][..., :3].astype(np.float32)
    n = min(len(gen), len(ref))
    gen, ref = gen[:n], ref[:n]
    if args.normalize:
        gen, _, _ = normalize_point_cloud(gen)
        ref, _, _ = normalize_point_cloud(ref)
    if args.batch_size < 1:
        raise SystemExit("--batch_size must be >= 1")
    # the paired metrics in --batch_size chunks: calc_cd forms a (B, N, N)
    # distance tensor
    chunks = []
    with torch.no_grad():
        for i in range(0, n, args.batch_size):
            r = calc_cd(torch.as_tensor(gen[i:i + args.batch_size], device=dev),
                        torch.as_tensor(ref[i:i + args.batch_size], device=dev), calc_f1=True)
            chunks.append({k: v.cpu().numpy() for k, v in r.items()})
    report = {k: float(np.mean(np.concatenate([c[k] for c in chunks]))) for k in chunks[0]}
    if args.all_metrics:
        from slide_tpu_torch.eval import compute_all_metrics, jsd_between_point_cloud_sets
        report.update({k: float(v) for k, v in compute_all_metrics(
            gen, ref, batch_size=args.batch_size, device=dev).items()})
        try:
            report["JSD"] = float(jsd_between_point_cloud_sets(gen, ref))
        except ValueError as e:
            print(f"JSD skipped: {e}")
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


def cmd_read_eval(args):
    return read_eval_result(args.file, args.loss)


def cmd_correct_labels(args):
    """Remap npz labels from the folder-listing order to the sorted
    categories' order."""
    from slide_tpu_torch.data.tools import remap_labels_to_sorted
    out = remap_labels_to_sorted(args.npz, args.dataset_folder, args.out)
    print(f"remapped labels saved to {out}")
    return out


def cmd_gather(args):
    from slide_tpu_torch.eval import gather_generated_results
    out = gather_generated_results(args.save_dir, args.world_size, num_points=args.num_points)
    print(f"merged {args.world_size} rank shards into {out}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="slide_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the default) or cpu")

    def common(sp, config=True, ckpt=False):
        if config:
            sp.add_argument("-c", "--config", required=True)
        if ckpt:
            sp.add_argument("--ckpt", required=True)
            sp.add_argument("--ema_idx", type=int, default=-1)
        sp.add_argument("--seed", type=int, default=0)
        # several processes: the torch.distributed rendezvous (one a card)
        sp.add_argument("--coordinator_address", type=str, default=None)
        sp.add_argument("--num_processes", type=int, default=None)
        sp.add_argument("--process_id", type=int, default=None)
        device(sp)

    def ranked(sp):
        # file-sharded evaluation by independent processes
        sp.add_argument("--rank", type=int, default=None)
        sp.add_argument("--world_size", type=int, default=None)

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--max_iters", type=int, default=None)
    sp.add_argument("--ae_ckpt", type=str, default=None)
    sp.set_defaults(fn=cmd_train)

    def fastdpm_args(sp, methods=("var", "step")):
        sp.add_argument("--sampler", choices=("ddpm", "fastdpm"), default="ddpm")
        sp.add_argument("--fastdpm_s", type=int, default=50,
                        help="number of accelerated reverse steps")
        sp.add_argument("--fastdpm_method", choices=methods, default=methods[-1])
        sp.add_argument("--fastdpm_schedule", choices=("linear", "quadratic"),
                        default="quadratic")
        sp.add_argument("--fastdpm_kappa", type=float, default=1.0)

    sp = sub.add_parser("generate")
    common(sp, ckpt=True)
    sp.add_argument("--num_samples", type=int, default=None)
    sp.add_argument("--batch_size", type=int, default=None)
    sp.add_argument("--save_dir", default="ddpm_generated_point_clouds")
    sp.add_argument("--no_visualize", action="store_true")
    fastdpm_args(sp)
    ranked(sp)
    sp.set_defaults(fn=cmd_generate)

    sp = sub.add_parser("latent-generate")
    common(sp, ckpt=True)
    sp.add_argument("--ae_ckpt", type=str, default=None)
    sp.add_argument("--num_samples", type=int, default=None)
    sp.add_argument("--batch_size", type=int, default=None)
    sp.add_argument("--save_dir", default="latent_generated_point_clouds")
    sp.add_argument("--external_keypoint_file", type=str, default=None)
    sp.add_argument("--local_resampling_file", type=str, default=None,
                    help="npz with complete_x0 (B,K,3+F) and keypoint_mask "
                         "(B,K): re-generate only masked keypoints' latents "
                         "(partial shape editing)")
    sp.add_argument("--save_keypoint_feature", action="store_true")
    sp.add_argument("--no_visualize", action="store_true")
    fastdpm_args(sp, methods=("step",))   # the x0 engine: STEP only
    ranked(sp)
    sp.set_defaults(fn=cmd_latent_generate)

    sp = sub.add_parser("encode")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--dataset_path", required=True)
    sp.add_argument("--save_dir", required=True)
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--keypoint_source", default="farthest_points_sampling")
    sp.add_argument("--save_keypoint_feature", action="store_true")
    sp.set_defaults(fn=cmd_encode)

    sp = sub.add_parser("decode")
    common(sp)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--dataset_path", required=True)
    sp.add_argument("--save_dir", required=True)
    sp.add_argument("--batch_size", type=int, default=32)
    sp.set_defaults(fn=cmd_decode)

    sp = sub.add_parser("reconstruct")
    common(sp, ckpt=True)
    sp.add_argument("--dataset_path", required=True)
    sp.add_argument("--save_dir", required=True)
    sp.add_argument("--batch_size", type=int, default=8)
    sp.add_argument("--return_original_scale", action="store_true")
    sp.add_argument("--label_number", type=int, default=0)
    sp.set_defaults(fn=cmd_reconstruct)

    sp = sub.add_parser("gather")
    sp.add_argument("--save_dir", required=True)
    sp.add_argument("--world_size", type=int, required=True)
    sp.add_argument("--num_points", type=int, default=2048)
    sp.set_defaults(fn=cmd_gather)

    sp = sub.add_parser("read-eval")
    sp.add_argument("--file", required=True,
                    help="eval-history pickle (e.g. *_eval_result.pkl)")
    sp.add_argument("--loss", default="dpsr_grid_L2_loss")
    sp.set_defaults(fn=cmd_read_eval)

    sp = sub.add_parser("correct-labels")
    sp.add_argument("--npz", required=True)
    sp.add_argument("--dataset_folder", required=True)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_correct_labels)

    sp = sub.add_parser("evaluate")
    sp.add_argument("--gen", required=True)
    sp.add_argument("--ref", required=True)
    sp.add_argument("--normalize", action="store_true")
    sp.add_argument("--all-metrics", dest="all_metrics", action="store_true")
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--out", type=str, default=None)
    device(sp)
    sp.set_defaults(fn=cmd_evaluate)
    return p


def main(argv=None):
    """Parse `argv` (the process's arguments by default) and run the
    subcommand; returns what it returns (a path, a report, or the training
    state and losses)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


def run() -> None:
    """The console script `slide-torch`: `main` on the process's arguments."""
    main()


if __name__ == "__main__":
    run()
