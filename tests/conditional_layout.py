"""The layouts of the conditional position tasks' nets: the JAX package's
own dual-tower test net (`tests/test_conditional_denoiser.py::
conditional_config`) and that layout with the main tower at the keypoint
preset's widths, for `generation` and `keypoint_conditional_generation` on
clouds with normals (no preset of either package names these tasks).  It
imports neither JAX nor the JAX package, so the CPU tests, the card tests
and `chip_smoke.py` share it."""

from slide_tpu_torch.configs import keypoint_ddpm_config

CONDITION_NET = {
    "npoint": [8, 4], "radius": [0, 0], "neighbor_definition": "nn",
    "nsample": [4, 4], "feature_dim": [8, 8, 8], "mlp_depth": 3,
    "decoder_feature_dim": [8, 8, 8], "decoder_mlp_depth": 2,
    "include_grouper": False, "use_knn_FP": True, "K": 4,
}
FEATURE_MAPPER = {
    "neighbor_definition": "nn",
    "encoder_feature_map_dim": [8, 8], "encoder_mlp_depth": 2,
    "encoder_radius": [0, 0], "encoder_nsample": [4, 4],
    "decoder_feature_map_dim": [8, 8, 8], "decoder_mlp_depth": 2,
    "decoder_radius": [0, 0, 0], "decoder_nsample": [4, 4, 4],
}


def conditional_config():
    """The JAX package's dual-tower test net: the keypoint preset with the
    condition towers, a global PNet of the condition and narrow widths."""
    cfg = keypoint_ddpm_config("airplane", num_keypoints=16)
    pc = cfg["pointnet_config"]
    pc.update(include_local_feature=True, include_global_feature=True,
              t_dim=32, partial_in_fea_dim=0,
              pnet_global_feature_architecture=[[3, 8, 8], [16, 16]])
    pc["architecture"].update(npoint=[16, 8], nsample=[8, 8],
                              feature_dim=[8, 16, 16],
                              decoder_feature_dim=[16, 16, 16],
                              radius=[0, 0])
    pc["condition_net_architecture"] = dict(CONDITION_NET)
    pc["feature_mapper_architecture"] = dict(FEATURE_MAPPER)
    cfg["train_config"]["task"] = "keypoint_conditional_generation"
    return cfg


def conditional_task_config(task: str, batch_size: int = 32):
    """A position-DDPM training config of `task` over 2048-point clouds with
    normals (in_fea_dim 3, out_dim 6): `conditional_config`'s layout with
    the keypoint preset's widths (feature_dim [32, 64, 128], decoder [64, 64,
    128], t_dim and class width 128); the condition towers, the mapper and
    the global PNet for `keypoint_conditional_generation`, none for
    `generation`, which has no condition."""
    if task not in ("generation", "keypoint_conditional_generation"):
        raise ValueError(task)
    cfg = keypoint_ddpm_config("airplane", num_keypoints=16, batch_size=batch_size)
    pc = cfg["pointnet_config"]
    pc.update(model_name=f"{task}_airplane", in_fea_dim=3, out_dim=6)
    pc["architecture"].update(npoint=[16, 8], nsample=[8, 8], radius=[0, 0])
    if task == "keypoint_conditional_generation":
        pc.update(include_local_feature=True, include_global_feature=True,
                  partial_in_fea_dim=0,
                  pnet_global_feature_architecture=[[3, 8, 8], [16, 16]])
        pc["condition_net_architecture"] = dict(CONDITION_NET)
        pc["feature_mapper_architecture"] = dict(FEATURE_MAPPER)
    cfg["train_config"]["task"] = task
    return cfg


def sa_fps_launches(arch: dict, n: int) -> int:
    """The FPS calls of an SA tower over n points: one at each level whose
    input holds more points than the level keeps."""
    count = 0
    for npoint in arch["npoint"]:
        if n > npoint:
            count, n = count + 1, npoint
    return count


def fps_launches_per_step(cfg: dict) -> int:
    """The FPS launches of one position step of `cfg`'s task, from the
    config: the keypoints (the keypoint tasks), the main tower's SA levels
    over the target, the condition tower's over the keypoints."""
    task = cfg["train_config"]["task"]
    pc, data = cfg["pointnet_config"], cfg["shapenet_psr_dataset_config"]
    k = data["num_keypoints"]
    n = k if task == "keypoint_generation" else data["npoints"]
    count = int(task != "generation") + sa_fps_launches(pc["architecture"], n)
    if pc.get("include_local_feature", True):
        count += sa_fps_launches(pc["condition_net_architecture"], k)
    return count
