"""Network building blocks (counterpart: `slide_tpu/nn/`), channels-last."""

from slide_tpu_torch.nn.attention import AttentionPool
from slide_tpu_torch.nn.distributions import DiagonalGaussian
from slide_tpu_torch.nn.layers import (GroupNorm, InjectionMLP, SharedMLP,
                                       TailGroupNorm, TimestepEmbedder, calc_t_emb,
                                       swish)
from slide_tpu_torch.nn.modules import (FeatureMapModule, FPModule, KnnFPModule,
                                        SAModule)
from slide_tpu_torch.nn.pnet import PNet2Stage
from slide_tpu_torch.nn.neighborhood import (group_all, group_knn_features,
                                             query_and_group)

__all__ = [
    "AttentionPool", "DiagonalGaussian", "GroupNorm", "InjectionMLP", "SharedMLP",
    "TailGroupNorm", "TimestepEmbedder", "calc_t_emb", "swish", "FeatureMapModule",
    "FPModule", "KnnFPModule", "SAModule", "group_all", "group_knn_features",
    "query_and_group", "PNet2Stage",
]
