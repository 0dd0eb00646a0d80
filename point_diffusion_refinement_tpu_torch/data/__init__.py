from .augment import augment_cloud, sample_transforms
from .batches import iterate_batches
from .mirror import generate_mirrored_partials, mirror_and_concat
from .mvp import VIEWS_PER_SHAPE, MVPDataset, MVPDatasetConfig, get_batch_fast
from .synthetic import ArrayDataset, make_synthetic_clouds, synthetic_dataset, write_mvp_style_h5

__all__ = [
    "ArrayDataset",
    "MVPDataset",
    "MVPDatasetConfig",
    "VIEWS_PER_SHAPE",
    "augment_cloud",
    "generate_mirrored_partials",
    "get_batch_fast",
    "iterate_batches",
    "make_synthetic_clouds",
    "mirror_and_concat",
    "sample_transforms",
    "synthetic_dataset",
    "write_mvp_style_h5",
]
