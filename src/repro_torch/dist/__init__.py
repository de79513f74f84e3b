"""Fault tolerance for the chunked ALS fit (``repro.dist``): fault injection,
retries and a straggler watchdog (:mod:`repro_torch.dist.fault`), and the
supervisor that wraps the scan engine's chunks in a recovery ladder
(:mod:`repro_torch.dist.supervisor`). The reference's subject-axis sharding
(``repro.dist.sharding``) waits for the multi-GPU port (ROADMAP A6).
"""
from repro_torch.dist.fault import (
    FaultInjector,
    StepWatchdog,
    TransientFault,
    run_with_retries,
)
from repro_torch.dist.supervisor import SupervisorConfig, SupervisorReport, supervised_fit

__all__ = [
    "FaultInjector",
    "StepWatchdog",
    "TransientFault",
    "run_with_retries",
    "SupervisorConfig",
    "SupervisorReport",
    "supervised_fit",
]
