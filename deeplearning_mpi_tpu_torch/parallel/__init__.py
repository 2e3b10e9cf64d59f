"""Parallel schedules beyond data parallelism: so far expert parallelism
(``parallel.expert_parallel``)."""
