"""Evaluation (counterpart: `slide_tpu/eval/`): sampling loops that write
the JAX package's npz files, the rank-file gather, the autoencoder's and
the SAP net's evaluations and the mesh reconstruction, and the
generative-model metrics."""

from slide_tpu_torch.eval.ae_eval import (ae_quantitative_eval, ae_visual_eval,
                                          gather_ae_visual_results)
from slide_tpu_torch.eval.generation import evaluate_per_rank, gather_generated_results
from slide_tpu_torch.eval.mesh_recon import (merge_current_with_previous_eval_results,
                                             plot_result, reconstruct_meshes, sap_grid_eval)
from slide_tpu_torch.eval.metrics import (compute_all_metrics, emd_cd, knn_classifier,
                                          jsd_between_point_cloud_sets, lgan_mmd_cov,
                                          pairwise_emd_cd)

__all__ = ["ae_quantitative_eval", "ae_visual_eval", "gather_ae_visual_results",
           "evaluate_per_rank", "gather_generated_results", "sap_grid_eval",
           "emd_cd", "pairwise_emd_cd", "knn_classifier", "lgan_mmd_cov",
           "compute_all_metrics", "jsd_between_point_cloud_sets", "reconstruct_meshes",
           "merge_current_with_previous_eval_results", "plot_result"]
