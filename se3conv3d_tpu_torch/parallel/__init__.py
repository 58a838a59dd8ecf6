"""Data parallelism over ranks of a ``torch.distributed`` group
(counterpart of ``se3conv3d_tpu/parallel``)."""
from .mesh import DataGroup, joined, launch, make_group, pad_batch_to_multiple
from .multihost import (cross_host_sum, host_local, local_batch_size, pad_samples_to,
                        process_count, process_index, process_slice)
