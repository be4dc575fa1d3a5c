"""``repro_torch.resilience``: fault injection (``faults``) and the
kill-and-recover harness (``harness``) over the paper trainer's
full-state checkpoints."""
from repro_torch.resilience.faults import FaultPlan, SimulatedFault, fault_hook
from repro_torch.resilience.harness import (RecoveryReport,
                                            elastic_kill_and_recover,
                                            kill_and_recover, tree_compare)

__all__ = ["FaultPlan", "SimulatedFault", "fault_hook", "RecoveryReport",
           "elastic_kill_and_recover", "kill_and_recover", "tree_compare"]
