"""LM datasets (byte-level text, synthetic motifs) and the batch loader."""

from deeplearning_mpi_tpu_torch.data.lm_text import ByteTextDataset, SyntheticTokens  # noqa: F401
from deeplearning_mpi_tpu_torch.data.loader import Loader  # noqa: F401
