from repro_torch.parallel.sharding import (
    SERVE_LONG_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    MeshShape,
    bytes_of,
    num_workers,
    shard_shape,
    spec_for,
    tree_bytes,
    tree_specs,
)

__all__ = [
    "SERVE_LONG_RULES",
    "SERVE_RULES",
    "TRAIN_RULES",
    "MeshShape",
    "bytes_of",
    "num_workers",
    "shard_shape",
    "spec_for",
    "tree_bytes",
    "tree_specs",
]
