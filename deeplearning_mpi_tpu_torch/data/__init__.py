"""Datasets (byte-level text and synthetic motifs; CIFAR-10 and its
synthetic stand-in; segmentation folders and synthetic shapes / volumes)
and the batch loader."""

from deeplearning_mpi_tpu_torch.data.cifar10 import CIFAR10, SyntheticCIFAR10  # noqa: F401
from deeplearning_mpi_tpu_torch.data.lm_text import ByteTextDataset, SyntheticTokens  # noqa: F401
from deeplearning_mpi_tpu_torch.data.loader import Loader  # noqa: F401
from deeplearning_mpi_tpu_torch.data.segmentation import (  # noqa: F401
    CarvanaDataset,
    SegmentationFolderDataset,
    SyntheticShapesDataset,
    SyntheticVolumesDataset,
)
