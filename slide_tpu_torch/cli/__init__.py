"""The command line (counterpart: `slide_tpu/cli/`), one entry point for
training, sampling, the autoencoder's round trip, the meshes and the
metrics:

  python -m slide_tpu_torch.cli train       -c config.json        (task-dispatched)
  python -m slide_tpu_torch.cli generate    -c config.json --ckpt … --ema_idx …
  python -m slide_tpu_torch.cli latent-generate -c config --ckpt … --ae_ckpt …
  python -m slide_tpu_torch.cli encode      -c config --ckpt … --dataset_path …
  python -m slide_tpu_torch.cli decode      -c config --ckpt … --dataset_path …
  python -m slide_tpu_torch.cli reconstruct -c config --ckpt … --dataset_path …
  python -m slide_tpu_torch.cli evaluate    --gen a.npz --ref b.npz [--all-metrics]
  python -m slide_tpu_torch.cli gather      --save_dir … --world_size N
  python -m slide_tpu_torch.cli read-eval   --file history.pkl
  python -m slide_tpu_torch.cli correct-labels --npz … --dataset_folder …

Every computing subcommand runs on the card unless given `--device cpu`.
Several cards: launch the same command once per card with
`--coordinator_address host:port --num_processes N --process_id i`; each
process joins the `torch.distributed` group (NCCL) on card `i % cards`.
`train` is then data parallel (each rank its split of the data at batch
`batch_size / N`, the gradients all-reduced, rank 0's checkpoints), and
generate / latent-generate write per-rank npz files (`_rank_<r>`), merged
afterwards with `gather`.  Independent processes take `--rank/--world_size`
instead.
"""

from slide_tpu_torch.cli.main import load_inference_params, main, normalize_point_cloud

__all__ = ["main", "load_inference_params", "normalize_point_cloud"]
