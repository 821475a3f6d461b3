"""Output writers (counterpart: `slide_tpu/vis/`): the PLY writers, the
npz -> .xyz dumps and (`vis/plot.py`, which needs matplotlib when called)
the point-cloud renders."""

from slide_tpu_torch.vis.pcd import visualize_hierarchical_pcd, visualize_pcd
from slide_tpu_torch.vis.ply import batch_save_pcd, save_mesh_ply, save_pcd_ply

__all__ = ["batch_save_pcd", "save_mesh_ply", "save_pcd_ply", "visualize_pcd",
           "visualize_hierarchical_pcd"]
