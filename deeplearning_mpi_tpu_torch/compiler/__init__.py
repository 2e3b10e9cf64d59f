"""Warmup before traffic: CUDA-graph capture of the serving programs."""
