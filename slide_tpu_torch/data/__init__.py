"""Data layer (counterpart: `slide_tpu/data/`, the synthetic route, the
label-only and npz datasets): numpy datasets and a thread-prefetching batch
loader, no PyYAML."""

from slide_tpu_torch.data.dummy import DummyLabelDataset, DummyShapesDataset
from slide_tpu_torch.data.loader import BatchLoader, collate, get_dataloader
from slide_tpu_torch.data.npz_dataset import GeneralNpzDataset, ShapeNpzDataset
from slide_tpu_torch.data.shapenet_psr import (ShapesPSRDataset,
                                               augment_points_with_normal,
                                               load_metadata)
from slide_tpu_torch.data.synthetic import (dump_metadata, parse_metadata,
                                            write_synthetic_shapenet_psr)

__all__ = ["BatchLoader", "collate", "get_dataloader", "DummyLabelDataset",
           "DummyShapesDataset", "GeneralNpzDataset", "ShapeNpzDataset", "ShapesPSRDataset",
           "augment_points_with_normal", "load_metadata", "dump_metadata",
           "parse_metadata", "write_synthetic_shapenet_psr"]
