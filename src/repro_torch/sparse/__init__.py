from repro_torch.sparse.coo import (
    IrregularCOO,
    SubjectCOO,
    from_dense_slices,
    random_irregular,
    random_parafac2,
)
from repro_torch.sparse.bucketing import (
    SCOO_DENSITY_THRESHOLD,
    BucketPlan,
    fixed_plan,
    plan_buckets,
    route_formats,
)

__all__ = [
    "IrregularCOO",
    "SubjectCOO",
    "from_dense_slices",
    "random_irregular",
    "random_parafac2",
    "BucketPlan",
    "fixed_plan",
    "plan_buckets",
    "route_formats",
    "SCOO_DENSITY_THRESHOLD",
]
