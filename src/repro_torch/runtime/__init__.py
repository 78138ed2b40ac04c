from repro_torch.runtime.fault import (PreemptionGuard, StepRunner,
                                       retry_transient)

__all__ = ["PreemptionGuard", "retry_transient", "StepRunner"]
