"""Distribution and fault tolerance for the ALS fit (``repro.dist``): the
subject-axis rules and collectives of the mesh engine
(:mod:`repro_torch.dist.sharding`), fault injection, retries and a
straggler watchdog (:mod:`repro_torch.dist.fault`), and the supervisor that
wraps the scan and mesh engines' chunks in a recovery ladder
(:mod:`repro_torch.dist.supervisor`).
"""
from repro_torch.dist.sharding import (
    LM_RULES,
    SP_RULES,
    axis_rules,
    current_mesh,
    current_rules,
    psum_subjects,
    shard,
    subject_collectives,
    subject_mesh_axes,
)
from repro_torch.dist.fault import (
    FaultInjector,
    StepWatchdog,
    TransientFault,
    run_with_retries,
)
from repro_torch.dist.supervisor import SupervisorConfig, SupervisorReport, supervised_fit

__all__ = [
    "LM_RULES",
    "SP_RULES",
    "axis_rules",
    "current_mesh",
    "current_rules",
    "psum_subjects",
    "shard",
    "subject_collectives",
    "subject_mesh_axes",
    "FaultInjector",
    "StepWatchdog",
    "TransientFault",
    "run_with_retries",
    "SupervisorConfig",
    "SupervisorReport",
    "supervised_fit",
]
