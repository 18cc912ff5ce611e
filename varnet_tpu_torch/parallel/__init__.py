from .mesh import (
    Mesh,
    all_reduce_sum,
    barrier,
    default_device,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_flux,
    shard_hard,
    shard_points,
    shard_quad,
    shard_rows,
)
