"""Process bootstrap (``torch.distributed``), the 5-axis mesh, collectives
and the distributed smoke test.

The reference's ``runtime/compat.py`` has no counterpart here: it resolves
JAX API names that moved between releases (``shard_map``, ``pcast``, the
Pallas TPU compiler params) and vetoes buffer donation where XLA:CPU runs
a cache-deserialized program. PyTorch's surface used here does not move
that way and PyTorch donates no buffers, so nothing in it applies.
"""
