"""Shape-As-Points (counterpart: `slide_tpu/sap/`): DPSR, the spectral
Poisson solver on `torch.fft`; symmetry mirroring; the refine+upsample glue;
marching tetrahedra and mesh sampling on the card (`marching_gpu`) and on
the host in numpy (`marching`, `mesh_sampling`, the oracle)."""

from slide_tpu_torch.sap.dpsr import (DPSR, fftfreqs, grid_interp, point_rasterize,
                                      spec_gaussian_filter)
from slide_tpu_torch.sap.marching import (marching_tetrahedra,
                                          marching_tetrahedra_numpy, mc_from_psr)
from slide_tpu_torch.sap.marching_gpu import (count_cells_and_faces,
                                              extract_and_sample_device,
                                              marching_tetrahedra_device, mesh_to_host,
                                              sample_points_from_mesh_device)
from slide_tpu_torch.sap.mirror import down_sample_points, mirror, mirror_and_concat
from slide_tpu_torch.sap.refine import (compute_center_and_max_length,
                                        network_output_to_dpsr_grid,
                                        shapenet_psr_normalize)

__all__ = [
    "DPSR", "compute_center_and_max_length", "count_cells_and_faces",
    "down_sample_points", "extract_and_sample_device", "fftfreqs", "grid_interp",
    "marching_tetrahedra", "marching_tetrahedra_device", "marching_tetrahedra_numpy",
    "mc_from_psr", "mesh_to_host", "mirror", "mirror_and_concat",
    "network_output_to_dpsr_grid", "point_rasterize", "sample_points_from_mesh_device",
    "shapenet_psr_normalize", "spec_gaussian_filter",
]
