from .launch import run_world
from .mesh import (
    Mesh,
    active_mesh,
    gather_samples,
    initialize_distributed,
    make_mesh,
    pairwise_mean,
    pairwise_sum,
    shard_position,
    shard_samples,
    tree_pairwise_mean,
)
