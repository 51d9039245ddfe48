"""Parallel execution (counterpart of ``parallel/``): multi-sequence data
parallelism on one card or across the ranks of a process group
(``multiseq``), and over ``torch.distributed`` process groups the
tensor-parallel descriptor matcher (``matcher_sharded``), the
point-sharded Schur BA (``ba_sharded``) and the two-stage tracking
pipeline (``pipeline``), with the group plumbing in ``distributed``."""

from .ba_sharded import bucket_observations, bundle_adjust_sharded  # noqa: F401
from .distributed import (  # noqa: F401
    Mesh, global_mesh, initialize_from_env, make_global_array, process_count, process_index,
    replicate, single_process_group, spawn)
from .matcher_sharded import match_descriptors_tp  # noqa: F401
from .pipeline import PipelineResult, make_pipelined_tracker, track_sequential  # noqa: F401
