"""Data layer (counterpart: `slide_tpu/data/`): numpy datasets and a
thread-prefetching batch loader (no PyYAML), the synthetic route, the
label-only and npz datasets, the corpus on the device (`device_corpus`),
the dataset tools (`tools`) and object-store IO (`object_io`)."""

from slide_tpu_torch.data.device_corpus import DeviceCorpus, draw_assembly, make_assemble_fn
from slide_tpu_torch.data.dummy import DummyLabelDataset, DummyShapesDataset
from slide_tpu_torch.data.loader import BatchLoader, collate, get_dataloader
from slide_tpu_torch.data.npz_dataset import GeneralNpzDataset, ShapeNpzDataset
from slide_tpu_torch.data.shapenet_psr import (ShapesPSRDataset,
                                               augment_points_with_normal,
                                               load_metadata)
from slide_tpu_torch.data.synthetic import (dump_metadata, parse_metadata,
                                            write_synthetic_shapenet_psr)

__all__ = ["BatchLoader", "collate", "get_dataloader", "DeviceCorpus", "draw_assembly",
           "make_assemble_fn", "DummyLabelDataset",
           "DummyShapesDataset", "GeneralNpzDataset", "ShapeNpzDataset", "ShapesPSRDataset",
           "augment_points_with_normal", "load_metadata", "dump_metadata",
           "parse_metadata", "write_synthetic_shapenet_psr"]
