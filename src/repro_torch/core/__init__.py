from repro_torch.core.irregular import Bucket, Bucketed, bucketize
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
    "bucketize",
    "Parafac2Options",
    "Parafac2State",
    "als_step",
    "fit",
    "init_state",
    "w_global",
]
