from repro_torch.runtime.elastic import remesh_state
from repro_torch.runtime.fault import (PreemptionGuard, StepRunner,
                                       retry_transient)

__all__ = ["PreemptionGuard", "remesh_state", "retry_transient",
           "StepRunner"]
