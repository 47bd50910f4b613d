from .dist import (all_reduce_grads, all_reduce_scalars, global_sum,
                   global_sum_grad, maybe_init_distributed, rank, world_size)

__all__ = ["all_reduce_grads", "all_reduce_scalars", "global_sum",
           "global_sum_grad", "maybe_init_distributed", "rank",
           "world_size"]
