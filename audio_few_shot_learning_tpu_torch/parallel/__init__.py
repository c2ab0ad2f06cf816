"""Episode-axis data parallelism over ``torch.distributed`` (counterpart of
the JAX package's ``parallel/``): the mesh and its collectives
(``mesh.py``), a launcher of ranks as processes (``spawn.py``) and the
multi-rank dry run (``dryrun.py``)."""

from audio_few_shot_learning_tpu_torch.parallel.mesh import (  # noqa: F401
    EPISODE_AXIS, CrossRankBatchNorm, EpisodeMesh, combine_moments, local_rank, make_mesh,
    maybe_initialize_distributed, process_rank,
)
