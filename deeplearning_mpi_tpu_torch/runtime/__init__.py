"""Process bootstrap (``torch.distributed``), the 5-axis mesh, collectives
and the distributed smoke test."""
