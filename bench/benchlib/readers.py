"""What the per-layer metrics' readers (``bench/metrics/*.py``) share.
Each takes the harness's ``Context``: the traced window
(``benchlib.trace.Window``), the count of one iteration
(``bench/counts/<config>.py``: its FLOPs, the peak of the configuration's
precision, the least times of the compact products) and the peak of
allocated device memory. A reader that finds nothing to read returns
None."""
from __future__ import annotations

PLAN_ENCODE = ("plan_assign_kernel", "rank_kernel", "place_kernel")


def idle_percent(ctx) -> float:
    """The device's idle share of the traced window: 1 - the union of
    its activity over the window's wall time, in %."""
    w = ctx.window
    return 100.0 * (1.0 - w.busy_s / w.window_s)


def kernels_per_iter(ctx) -> float:
    """Device kernels the profiler recorded an iteration."""
    return ctx.window.kernels / ctx.window.iters


def mfu_percent(ctx) -> float:
    """The count's FLOPs an iteration over the window's time an
    iteration, as a share of the peak of the configuration's precision,
    in %."""
    w = ctx.window
    return 100.0 * ctx.count["flops"] * w.iters / w.window_s \
        / ctx.count["peak_flops"]


def _share(least_s: float, t: float, iters: int) -> float | None:
    if t <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s * iters / t


def roofline_percent(ctx, kernels) -> float | None:
    """The least time of the forward compact products over the device
    time of the forward launches of ``kernels`` (a recomputation in the
    backward left out), in %; None where no such launch ran."""
    w = ctx.window
    return _share(ctx.count["compact_s"], w.forward_seconds(kernels),
                  w.host_iters)


def scope_roofline_percent(ctx, scope: str, least: str) -> float | None:
    """The count's ``least`` seconds over the device time of everything
    launched within the host op ``scope``, in %; None where it ran
    nothing."""
    w = ctx.window
    return _share(ctx.count.get(least, 0.0), w.by_scope.get(scope, 0.0),
                  w.host_iters)


def device_ms_per_iter(ctx, kernels) -> float | None:
    """Device ms an iteration of ``kernels``; None where none ran."""
    t = ctx.window.device_seconds(kernels)
    return None if t <= 0 else 1e3 * t / ctx.window.iters


def peak_gb(ctx) -> float | None:
    return None if not ctx.peak_bytes else ctx.peak_bytes / 1e9
