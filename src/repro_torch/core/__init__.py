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
from repro_torch.core.backend import MttkrpBackend, get_backend
from repro_torch.core.constraints import (
    Constraint,
    available as available_constraints,
    parse_constraint_arg,
    parse_spec as parse_constraint_spec,
)
from repro_torch.core.parafac2 import (
    Parafac2Options,
    Parafac2State,
    als_step,
    constraints_for,
    fit,
    init_state,
    reconstruct_uk,
    w_global,
)
from repro_torch.core.engine import ENGINES, fit_device, make_als_chunk, make_als_while

__all__ = [
    "Constraint",
    "available_constraints",
    "constraints_for",
    "parse_constraint_arg",
    "parse_constraint_spec",
    "ENGINES",
    "fit_device",
    "make_als_chunk",
    "make_als_while",
    "Bucket",
    "Bucketed",
    "BlockBucket",
    "SparseBucket",
    "bucketize",
    "bucket_format",
    "to_block_bucket",
    "FORMATS",
    "LANE",
    "MttkrpBackend",
    "get_backend",
    "Parafac2Options",
    "Parafac2State",
    "als_step",
    "fit",
    "init_state",
    "reconstruct_uk",
    "w_global",
]
