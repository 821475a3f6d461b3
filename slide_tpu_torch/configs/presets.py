"""Config presets of the generation path (a copy of the position DDPM, feature
DDPM, autoencoder and SAP refine+upsample presets of
`slide_tpu/configs/presets.py`; the port keeps its own copy and imports
nothing of the JAX package).

Hyperparameters mirror
`pointnet2/configs/shapenet_psr_configs/ddpm_keypoint_training_configs/
config_standard_attention_batchsize_32_s3_ema_model_keypoint_<cat>.json`
and friends.
"""

from __future__ import annotations

import copy

# The 5 trained categories (plus the full 13-class label space used by the
# class embedding, metadata.yaml ordering).
SHAPENET_CATEGORIES = {
    "airplane": "02691156",
    "cabinet": "02933112",
    "car": "02958343",
    "chair": "03001627",
    "lamp": "03636649",
}

_ATTENTION = {
    "use_attention_module": True,
    "attention_bn": True,
    "transform_grouped_feat_out": True,
    "last_activation": True,
    "add_attention_to_FeatureMapper_module": True,
}


def _ae_encoder_pointnet_config() -> dict:
    """`autoencoder_configs/test_configs_latent_dim_16_32/config_encoder.json`."""
    return {
        "model_name": "ae_encoder",
        "in_fea_dim": 3,
        "include_t": False,
        "t_dim": 128,
        "model.use_xyz": True,
        "attach_position_to_input_feature": True,
        "include_abs_coordinate": True,
        "include_center_coordinate": True,
        "record_neighbor_stats": False,
        "bn_first": False,
        "bias": True,
        "res_connect": True,
        "include_class_condition": True,
        "num_class": 13,
        "class_condition_dim": 128,
        "bn": True,
        "include_global_feature": False,
        "global_feature_remove_last_activation": False,
        "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
        "attention_setting": copy.deepcopy(_ATTENTION),
        "architecture": {
            "npoint": [1024, 256, 64, 32],
            "radius": [0, 0, 0, 0],
            "neighbor_definition": "nn",
            "nsample": [32, 32, 32, 32],
            "feature_dim": [32, 64, 128, 256, 512],
            "mlp_depth": 3,
        },
        "condition_net_architecture": None,
        "feature_mapper_architecture": None,
    }


def _ae_decoder_level_config(level: int) -> dict:
    """`decoder_level_{1,2,3}.json`.  Level 1 is the keypoint-encoder level
    (PointNetEncoder backbone + global feature); levels 2-3 are
    ConditionalPointNet2 backbones with local/global features off."""
    base = {
        "model_name": f"ae_decoder_level_{level}",
        "out_dim": 6,
        "include_t": False,
        "t_dim": 128,
        "model.use_xyz": True,
        "attach_position_to_input_feature": True,
        "include_abs_coordinate": True,
        "include_center_coordinate": True,
        "record_neighbor_stats": False,
        "bn_first": False,
        "bias": True,
        "res_connect": True,
        "include_class_condition": True,
        "num_class": 13,
        "class_condition_dim": 128,
        "bn": True,
        "condition_net_architecture": None,
        "feature_mapper_architecture": None,
    }
    att = copy.deepcopy(_ATTENTION)
    if level == 1:
        att["last_activation"] = False
        base.update({
            "in_fea_dim": 0,
            "in_position_and_normal_dim": 3,
            "include_global_feature": True,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[3, 32, 32], [64, 64]],
            "attention_setting": att,
            "architecture": {
                "npoint": [16, 16], "radius": [0, 0],
                "neighbor_definition": "nn", "nsample": [16, 16],
                "feature_dim": [16, 16, 16], "mlp_depth": 3,
            },
            "feature_mapper_setting": {
                "radius": 0, "neighbor_definition": "nn", "nsample": 32,
                "mlp_depth": 2, "out_dim": 32,
            },
            "upsampling_setting": {
                "point_upsample_factor": 32,
                "first_refine_coarse_points": False,
                "include_displacement_center_to_final_output": False,
                "output_scale_factor": 0.03, "num_output_points": 256,
            },
        })
    elif level == 2:
        base.update({
            "in_fea_dim": 3,
            "transform_output": False,
            "include_local_feature": False,
            "include_global_feature": False,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
            "attention_setting": att,
            "architecture": {
                "npoint": [128, 64, 16], "radius": [0, 0, 0],
                "neighbor_definition": "nn", "nsample": [32, 32, 32],
                "feature_dim": [32, 64, 128, 256], "mlp_depth": 3,
                "decoder_feature_dim": [128, 128, 256, 256],
                "include_grouper": False, "decoder_mlp_depth": 2,
                "use_knn_FP": True, "K": 8,
            },
            "feature_mapper_setting": {
                "radius": 0, "neighbor_definition": "nn", "nsample": 4,
                "mlp_depth": 2, "out_dim": 256,
            },
            "upsampling_setting": {
                "point_upsample_factor": 8,
                "first_refine_coarse_points": False,
                "include_displacement_center_to_final_output": False,
                "output_scale_factor": 0.003, "num_output_points": 1024,
            },
        })
    elif level == 3:
        base.update({
            "in_fea_dim": 3,
            "transform_output": False,
            "include_local_feature": False,
            "include_global_feature": False,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
            "attention_setting": att,
            "architecture": {
                "npoint": [256, 64, 16], "radius": [0, 0, 0],
                "neighbor_definition": "nn", "nsample": [32, 32, 32],
                "feature_dim": [32, 64, 128, 128], "mlp_depth": 3,
                "decoder_feature_dim": [64, 64, 128, 128],
                "include_grouper": False, "decoder_mlp_depth": 2,
                "use_knn_FP": True, "K": 8,
            },
            "feature_mapper_setting": {
                "radius": 0, "neighbor_definition": "nn", "nsample": 16,
                "mlp_depth": 2, "out_dim": 128,
            },
            "upsampling_setting": {
                "point_upsample_factor": 4,
                "first_refine_coarse_points": False,
                "include_displacement_center_to_final_output": False,
                "output_scale_factor": 0.001, "num_output_points": 2048,
            },
        })
    else:
        raise ValueError(level)
    return base


def autoencoder_config(category: str = "airplane", *, batch_size: int = 32) -> dict:
    """Full AE training config mirroring
    `config_autoencoder_s3_kl_1e-5_16_keypoints_latent_dim_16_32_…_<cat>.json`,
    with the encoder/decoder sub-configs INLINED under pointnet_config
    (`encoder_config` / `decoder_config_list`) rather than file pointers."""
    synset = SHAPENET_CATEGORIES.get(category, category)
    return {
        "pointnet_config": {
            "model_name": f"ae_{category}_kl_1e-5_latent_16_32",
            "apply_kl_regularization": True,
            "kl_weight": 1e-5,
            "encoder_config": _ae_encoder_pointnet_config(),
            "decoder_config_list": [_ae_decoder_level_config(i) for i in (1, 2, 3)],
            "feature_weight": [0, 0, 0.1],
        },
        "train_config": {
            "task": "autoencode",
            "dataset": "shapenet_psr_dataset",
            "root_directory": f"exps/autoencoder/{category}",
            "output_directory": "checkpoint",
            "tensorboard_directory": "tensorboard",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 20,
            "iters_per_logging": 50,
            "n_epochs": 601,
            "eval_start_epoch": 0,
            "eval_per_ckpt": 1,
            "learning_rate": 0.001,
            "loss_type": "mse",
            "conditioned_on_cloud": False,
            "split_dataset_to_multi_gpus": True,
        },
        "shapenet_psr_dataset_config": {
            "dataset": "shapenet_psr_dataset",
            "data_dir": "data/shapenet_psr",
            "categories": [synset],
            "repeat_dataset": 10,
            "npoints": 2048,
            "scale": 1,
            "batch_size": batch_size,
            "eval_batch_size": 64,
            "num_workers": 4,
            "num_samples_tested": 128,
            "num_keypoints": 16,
            "keypoint_noise_magnitude": 0.04,
            "keypoints_source": "farthest_points_sampling",
            "augmentation": {"mirror_prob": 0.5, "translation_magnitude": 0.1,
                             "augm_scale": 1.2},
        },
        "dist_config": {"dist_backend": "jax", "CUDA_VISIBLE_DEVICES": None},
    }


def upsampler_config(*, batch_size: int = 32) -> dict:
    """SAP refine+upsample network config mirroring
    `refine_and_upsample_configs/config_refine_and_upsample_standard_attention_
    s3_noise_0.02_symmetry.json` (trained on ALL categories)."""
    return {
        "pointnet_config": {
            "model_name": "sap_refine_upsample_noise_0.02_symmetry",
            "in_fea_dim": 4,           # normals(3) + mirror indicator(1)
            "out_dim": 6,
            "include_t": False,
            "t_dim": 128,
            "model.use_xyz": True,
            "attach_position_to_input_feature": True,
            "include_abs_coordinate": True,
            "include_center_coordinate": True,
            "record_neighbor_stats": False,
            "bn_first": False,
            "bias": True,
            "res_connect": True,
            "include_class_condition": True,
            "num_class": 13,
            "class_condition_dim": 128,
            "bn": True,
            "include_local_feature": False,
            "include_global_feature": False,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
            "attention_setting": copy.deepcopy(_ATTENTION),
            "architecture": {
                "npoint": [1024, 256, 64, 16],
                "radius": [0.1, 0.2, 0.4, 0.8],
                "neighbor_definition": "nn",
                "nsample": [32, 32, 32, 32],
                "feature_dim": [32, 64, 128, 256, 512],
                "mlp_depth": 3,
                "decoder_feature_dim": [128, 128, 256, 256, 512],
                "include_grouper": False,
                "decoder_mlp_depth": 2,
                "use_knn_FP": True,
                "K": 8,
            },
            "point_upsample_factor": 5,
            "first_refine_coarse_points": False,
            "include_displacement_center_to_final_output": False,
            "output_scale_factor": 0.001,
            "condition_net_architecture": None,
            "feature_mapper_architecture": None,
        },
        "dpsr_config": {
            "grid_res": 128,
            "psr_sigma": 2,
            "psr_tanh": True,
            "mirror_before_upsampling": True,
            "only_original_points_split": False,
        },
        "train_config": {
            "task": "upsample",
            "dataset": "shapenet_psr_dataset",
            "root_directory": "exps/sap_upsampler",
            "output_directory": "checkpoint",
            "tensorboard_directory": "tensorboard",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 10,
            "iters_per_logging": 50,
            "n_epochs": 1000,
            "eval_start_epoch": 0,
            "eval_per_ckpt": 1,
            "learning_rate": 0.0002,
            "loss_type": "mse",
            "conditioned_on_cloud": False,
            "split_dataset_to_multi_gpus": True,
        },
        "shapenet_psr_dataset_config": {
            "dataset": "shapenet_psr_dataset",
            "data_dir": "data/shapenet_psr",
            "categories": None,        # all 13 categories
            "npoints": 2048,
            "scale": 1,
            "batch_size": batch_size,
            "eval_batch_size": 32,
            "num_workers": 4,
            "num_samples_tested": 128,
            "load_psr": True,
            "centered_to_centroid": False,
            "num_keypoints": 16,
            "keypoints_source": "farthest_points_sampling",
            "augmentation": {"noise_magnitude": 0.02},
        },
        "dist_config": {"dist_backend": "jax", "CUDA_VISIBLE_DEVICES": None},
    }


def latent_ddpm_config(category: str = "airplane", *, num_keypoints: int = 16,
                       latent_dim: int = 48, batch_size: int = 32) -> dict:
    """Feature (latent) DDPM config mirroring
    `latent_ddpm_training_configs/config_latent_ddpm_s3_dim_16_32_…_<cat>.json`.
    The frozen autoencoder's config is inlined under `autoencoder_config`."""
    synset = SHAPENET_CATEGORIES.get(category, category)
    ae = autoencoder_config(category, batch_size=batch_size)
    return {
        "standard_diffusion_config": {
            "beta_schedule": "linear",
            "num_diffusion_timesteps": 1000,
            "beta_start": 0.0001,
            "beta_end": 0.02,
            "data_clamp_range": -1,
            "model_var_type": "fixedsmall",
            "model_output_scale_factor": 1.0,
            "loss_type": None,
            "keypoint_position_loss_weight": 0.0,
            "feature_loss_weight": 1.0,
            "keypoint_conditional": True,
        },
        "autoencoder_config": {
            "pointnet_config": ae["pointnet_config"],
            "ckpt": None,   # path to the trained AE checkpoint
        },
        "pointnet_config": {
            "model_name": f"latent_ddpm_{category}",
            "in_fea_dim": latent_dim,
            "out_dim": 3 + latent_dim,
            "include_t": True,
            "t_dim": 128,
            "model.use_xyz": True,
            "attach_position_to_input_feature": True,
            "include_abs_coordinate": True,
            "include_center_coordinate": True,
            "record_neighbor_stats": False,
            "bn_first": False,
            "bias": True,
            "res_connect": True,
            "include_class_condition": True,
            "num_class": 13,
            "class_condition_dim": 128,
            "bn": True,
            "include_local_feature": False,
            "include_global_feature": False,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
            "attention_setting": copy.deepcopy(_ATTENTION),
            "architecture": {
                "npoint": [num_keypoints, num_keypoints],
                "radius": [0, 0],
                "neighbor_definition": "nn",
                "nsample": [num_keypoints, num_keypoints],
                "feature_dim": [128, 256, 512],
                "mlp_depth": 3,
                "decoder_feature_dim": [128, 256, 512],
                "include_grouper": False,
                "decoder_mlp_depth": 2,
                "use_knn_FP": True,
                "K": 8,
            },
            "condition_net_architecture": None,
            "feature_mapper_architecture": None,
        },
        "train_config": {
            "task": "latent_keypoint_conditional_generation",
            "dataset": "shapenet_psr_dataset",
            "root_directory": f"exps/latent_ddpm/{category}",
            "output_directory": "checkpoint",
            "tensorboard_directory": "tensorboard",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 20,
            "iters_per_logging": 50,
            "n_epochs": 1000,
            "eval_start_epoch": 0,
            "eval_per_ckpt": 1,
            "learning_rate": 0.0002,
            "loss_type": "mse",
            "conditioned_on_cloud": False,
            "split_dataset_to_multi_gpus": True,
            "ema_rate": [0.999, 0.9999],
        },
        "shapenet_psr_dataset_config": {
            "dataset": "shapenet_psr_dataset",
            "data_dir": "data/shapenet_psr",
            "categories": [synset],
            "repeat_dataset": 10,
            "npoints": 2048,
            "scale": 1,
            "batch_size": batch_size,
            "eval_batch_size": 64,
            "num_workers": 4,
            "num_samples_tested": 128,
            "num_keypoints": num_keypoints,
            "keypoints_source": "farthest_points_sampling",
            "test_external_keypoint": False,
            "external_keypoint_file": None,
        },
        "dist_config": {"dist_backend": "jax", "CUDA_VISIBLE_DEVICES": None},
    }


def keypoint_ddpm_config(category: str = "airplane", *, num_keypoints: int = 16,
                         batch_size: int = 32) -> dict:
    """Position (keypoint) DDPM training config — the smallest end-to-end
    model: unconditional diffusion over K latent point positions."""
    synset = SHAPENET_CATEGORIES.get(category, category)
    return {
        "diffusion_config": {"T": 1000, "beta_0": 0.0001, "beta_T": 0.02},
        "pointnet_config": {
            "model_name": f"keypoint_ddpm_{category}",
            "in_fea_dim": 0,
            "out_dim": 3,
            "include_t": True,
            "t_dim": 128,
            "model.use_xyz": True,
            "attach_position_to_input_feature": True,
            "include_abs_coordinate": True,
            "include_center_coordinate": True,
            "record_neighbor_stats": False,
            "bn_first": False,
            "bias": True,
            "res_connect": True,
            "include_class_condition": True,
            "num_class": 13,
            "class_condition_dim": 128,
            "bn": True,
            "include_local_feature": False,
            "include_global_feature": False,
            "global_feature_remove_last_activation": False,
            "pnet_global_feature_architecture": [[4, 128, 256], [512, 1024]],
            "attention_setting": copy.deepcopy(_ATTENTION),
            "architecture": {
                "npoint": [num_keypoints, num_keypoints],
                "radius": [0, 0],
                "neighbor_definition": "nn",
                "nsample": [num_keypoints, num_keypoints],
                "feature_dim": [32, 64, 128],
                "mlp_depth": 3,
                "decoder_feature_dim": [64, 64, 128],
                "include_grouper": False,
                "decoder_mlp_depth": 2,
                "use_knn_FP": True,
                "K": 8,
            },
            "condition_net_architecture": None,
            "feature_mapper_architecture": None,
        },
        "train_config": {
            "task": "keypoint_generation",
            "dataset": "shapenet_psr_dataset",
            "root_directory": f"exps/keypoint_ddpm/{category}",
            "output_directory": "checkpoint",
            "tensorboard_directory": "tensorboard",
            "ckpt_iter": "max",
            "epochs_per_ckpt": 10,
            "iters_per_logging": 50,
            "n_epochs": 1001,
            "eval_start_epoch": 0,
            "eval_per_ckpt": 1,
            "learning_rate": 0.0002,
            "loss_type": "mse",
            "conditioned_on_cloud": False,
            "split_dataset_to_multi_gpus": True,
            "ema_rate": [0.999, 0.9999],
        },
        "shapenet_psr_dataset_config": {
            "dataset": "shapenet_psr_dataset",
            "data_dir": "data/shapenet_psr",
            "categories": [synset],
            "npoints": 2048,
            "scale": 1,
            "batch_size": batch_size,
            "eval_batch_size": 64,
            "num_workers": 4,
            "num_samples_tested": 128,
            "centered_to_centroid": False,
            "num_keypoints": num_keypoints,
            "keypoints_source": "farthest_points_sampling",
            "repeat_dataset": 10,
        },
        "dist_config": {"dist_backend": "jax", "CUDA_VISIBLE_DEVICES": None},
    }
