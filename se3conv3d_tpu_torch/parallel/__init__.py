"""Data and point parallelism over ranks of a ``torch.distributed`` group
(counterpart of ``se3conv3d_tpu/parallel``)."""
from .mesh import (DataGroup, joined, launch, local_rows, make_group, pad_batch_to_multiple, points_gather,
                   points_rank, points_size)
from .multihost import (cross_host_sum, host_local, local_batch_size, pad_samples_to,
                        process_count, process_index, process_slice, shard_points)
