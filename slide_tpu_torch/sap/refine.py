"""Refine+upsample glue: the SAP net's displacements -> an upsampled oriented
point cloud -> the DPSR indicator grid (counterpart: `slide_tpu/sap/refine.py`)."""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from slide_tpu_torch.models.upsample_decoder import point_upsample


def compute_center_and_max_length(x: torch.Tensor):
    """Bounding-box center and max extent: x (B, N, 3) -> (center (B, 1, 3),
    max_length (B, 1, 1))."""
    minn = torch.amin(x, dim=1, keepdim=True)
    maxx = torch.amax(x, dim=1, keepdim=True)
    center = (maxx + minn) / 2.0
    max_length = torch.amax(maxx - minn, dim=2, keepdim=True)
    return center, max_length


def shapenet_psr_normalize(x: torch.Tensor) -> torch.Tensor:
    """The ShapeNet-PSR bounding-box convention: centered, max extent 0.99."""
    center, max_length = compute_center_and_max_length(x)
    return (x - center) / max_length * 0.99


def network_output_to_dpsr_grid(x: torch.Tensor, displacement: torch.Tensor,
                                dpsr: Callable, scale, pointnet_config: Mapping, *,
                                last_dim_as_indicator: bool = False,
                                only_original_points_split: bool = False,
                                explicit_normalize: bool = False):
    """Split the (optionally mirrored and tagged) cloud by the predicted
    displacements, map it into DPSR's [0, 1) cube (clipped to [0, 0.99]) and
    solve for the indicator grid.

    Returns (psr_grid (B, *res), refined points, refined normals)."""
    if last_dim_as_indicator:
        x_to_refine = x[..., :-1]
        if only_original_points_split:
            n = x.shape[1] // 2
            x_to_refine = x_to_refine[:, :n]
            displacement = displacement[:, :n]
    else:
        x_to_refine = x
    refined = point_upsample(
        x_to_refine, displacement, pointnet_config["point_upsample_factor"],
        include_displacement_center_to_final_output=pointnet_config[
            "include_displacement_center_to_final_output"],
        output_scale_factor_value=pointnet_config["output_scale_factor"],
        first_refine_coarse_points=pointnet_config["first_refine_coarse_points"])
    points = refined[..., :3]
    normals = refined[..., 3:]
    if explicit_normalize:
        points = shapenet_psr_normalize(points)
    else:
        points = points / scale / 2.0
    # jnp.clip's form, max then min: a point exactly at a bound passes half
    # its gradient, as in the JAX package (torch.clamp would pass all of it)
    points = torch.minimum(torch.maximum(points / 1.2 + 0.5, points.new_tensor(0.0)),
                           points.new_tensor(0.99))
    return dpsr(points, normals), points, normals
