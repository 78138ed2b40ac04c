"""Plan-aware serving tier: one session API, continuous batching on top.

Port of ``repro.serving``: :class:`~repro_torch.serving.session.
ServeSession` (params version, steps, caches, ``plan_policy``),
:class:`~repro_torch.serving.scheduler.Engine` (slot admission,
prefill/decode interleaving; ``admission="lockstep"`` is the static
baseline), ``plan_cache`` (one encode per params version, process-wide)
and :func:`~repro_torch.serving.stream.synthetic_requests`.
"""
from repro_torch.serving import plan_cache  # noqa: F401
from repro_torch.serving.scheduler import (  # noqa: F401
    ADMISSION_MODES,
    Engine,
    Request,
    RequestRecord,
    ServeReport,
)
from repro_torch.serving.session import ServeSession  # noqa: F401
from repro_torch.serving.steps import (  # noqa: F401
    PLAN_POLICIES,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serving.stream import max_seq_for, synthetic_requests  # noqa: F401
