from repro_torch.core.irregular import (
    FORMATS,
    LANE,
    BlockBucket,
    Bucket,
    Bucketed,
    SparseBucket,
    bucket_format,
    bucketize,
    to_block_bucket,
)
from repro_torch.core.parafac2 import (
    Parafac2Options,
    Parafac2State,
    als_step,
    fit,
    init_state,
    w_global,
)

__all__ = [
    "Bucket",
    "Bucketed",
    "BlockBucket",
    "SparseBucket",
    "bucketize",
    "bucket_format",
    "to_block_bucket",
    "FORMATS",
    "LANE",
    "Parafac2Options",
    "Parafac2State",
    "als_step",
    "fit",
    "init_state",
    "w_global",
]
