"""Parallel execution (counterpart of ``parallel/``): multi-sequence data
parallelism on one card (``multiseq``)."""
