"""Output writers (counterpart: `slide_tpu/vis/`): the PLY writers; the
plots and viewers are not ported (ROADMAP item 19)."""

from slide_tpu_torch.vis.ply import batch_save_pcd, save_mesh_ply, save_pcd_ply

__all__ = ["batch_save_pcd", "save_mesh_ply", "save_pcd_ply"]
