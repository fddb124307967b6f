"""Data parallelism over processes, one card a process (counterpart of
`dpcr_agb_tpu/parallel`): explicit collectives that give an N-rank step
the global batch's numbers."""
from .mesh import (all_gather_rows, all_reduce_grads, all_reduce_sum,  # noqa: F401
                   broadcast_state, destroy, is_main, local_rank,
                   maybe_init_distributed, rank, round_after_sum,
                   shard_batch, world_size)
