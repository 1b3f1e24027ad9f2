"""Data parallelism of the port over ``torch.distributed``
(``radar_depth_tpu/parallel``): the mesh, each rank's rows of a batch, the
few collectives the train and eval steps use, and spatial partitioning
(``spatial.py``: row slabs and halo exchanges)."""

from radar_depth_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    DataMesh,
    all_reduce_grad,
    all_reduce_sum,
    assert_replicated,
    broadcast_module,
    check_batch_sizes,
    destroy_mesh,
    global_moments,
    is_distributed,
    local_rows,
    make_mesh,
    make_mesh_2d,
    make_spatial_mesh,
    pad_batch_to,
)
from radar_depth_tpu_torch.parallel.spatial import (
    HALO,
    gather_rows,
    row_range,
    slab,
    spatial_constraint,
    unslab,
)

__all__ = [
    "COLLECTIVES", "DataMesh", "HALO", "gather_rows", "row_range", "slab",
    "unslab", "all_reduce_grad", "all_reduce_sum",
    "assert_replicated", "broadcast_module", "check_batch_sizes",
    "destroy_mesh", "global_moments", "is_distributed", "local_rows",
    "make_mesh", "make_mesh_2d", "make_spatial_mesh", "pad_batch_to",
    "spatial_constraint",
]
