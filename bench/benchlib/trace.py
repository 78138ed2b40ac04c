"""The traced run: ``torch.profiler`` over whole iterations, reduced to
what the per-layer metrics and the breakdown read.

Two passes. The first records device activity alone (CUDA, no host
ops: a host-bound loop slows when every aten op is recorded) over
``iters`` iterations; its union of device
intervals gives ``busy_s``, its wall ``window_s``, and its events the
kernels' device times. The second records host ops too, over one
iteration: what the host was doing while the device was idle, and which
host op launched each kernel (the profiler links a kernel to the
innermost op open at its launch), so that a kernel's time splits into
its launches in the forward and in the autograd engine's backward, and
a host op's scope (``_GroupedCoreBackward``) owns the device time of
everything launched within it.
"""
from __future__ import annotations

import dataclasses
import re
import time

import torch

_COPY = ("Memcpy", "Memset")      # device events that are not kernels
# host records that are no op of the program: CUDA runtime and driver
# calls, the profiler's own
_NOT_OPS = re.compile(r"^(cuda|cu[A-Z]|Activity Buffer|ProfilerStep)")
# the autograd engine's record around each backward node it runs
BACKWARD = "autograd::engine::evaluate_function: "
LINKED = ""         # the scope of every device event linked to a host op


def kernel_name(name: str) -> str:
    """A kernel's base name from the profiler's (demangled) one:
    ``void (anonymous namespace)::grouped_bmm_f32_kernel<64>(float
    const*, ...)`` -> ``grouped_bmm_f32_kernel``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = re.sub(r"<.*", "", head).strip()
    return head.split(" ")[-1].split("::")[-1]


def union_seconds(intervals) -> float:
    """Length of the union of (start_us, end_us) intervals, in s."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


def idle_gaps(device, lo: float, hi: float) -> list:
    """The (start_us, end_us) stretches of [lo, hi] no device interval
    covers."""
    gaps, at = [], lo
    for s, e in sorted(device):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, host) -> dict:
    """Idle seconds by what the host was doing at each gap's middle: the
    innermost host op (the latest to start of those open then; CUDA
    runtime calls and the profiler's records left out), under the outermost span of ``host``'s
    (name, start_us, end_us) records; ``"(python)"`` where no op ran."""
    host = sorted((h for h in host if not _NOT_OPS.match(h[0])),
                  key=lambda h: h[1])
    out: dict = {}
    active: list = []
    i = 0
    for s, e in sorted(gaps):
        mid = (s + e) / 2
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        if active:
            outer = min(active, key=lambda h: h[1])[0]
            inner = max(active, key=lambda h: h[1])[0]
            label = outer if outer == inner else f"{outer} > {inner}"
        else:
            label = "(python)"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


@dataclasses.dataclass
class Window:
    """The first pass's reduction."""
    iters: int
    window_s: float
    busy_s: float
    kernels: int                    # device events that are kernels
    by_kernel: dict                 # kernel base name -> device seconds
    by_op: dict                     # device event name -> device seconds
    idle_by_host: dict = dataclasses.field(default_factory=dict)
    host_pass: dict = dataclasses.field(default_factory=dict)
    # the second pass's, over ``host_iters`` iterations: each kernel base
    # name's device seconds of the launches outside the autograd engine,
    # and each host op's (by name, the engine's prefix cut) device
    # seconds of every device event launched within it
    host_iters: int = 1
    fwd_by_kernel: dict = dataclasses.field(default_factory=dict)
    by_scope: dict = dataclasses.field(default_factory=dict)

    def device_seconds(self, names) -> float:
        """Device seconds of the kernels whose base name is in
        ``names``."""
        return sum(self.by_kernel.get(n, 0.0) for n in names)

    def forward_seconds(self, names) -> float:
        """Device seconds, over the second pass, of the forward launches
        (not in the autograd engine's backward, so no recomputation) of
        the kernels whose base name is in ``names``."""
        return sum(self.fwd_by_kernel.get(n, 0.0) for n in names)


def _profile(step, iters: int, host: bool):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, cpu = [], []
    events = prof.events()
    for e in events:
        rec = (e.name, e.time_range.start, e.time_range.end)
        (dev if e.device_type == DeviceType.CUDA else cpu).append(rec)
    # with host ops recorded, each ``record_function`` span is also drawn
    # on the device's timeline, over all it launched: no device work
    host_names = {n for n, _, _ in cpu}
    dev = [r for r in dev if r[0] not in host_names]
    launched = _launched(events, host_names) if host else ({}, {})
    return wall, dev, cpu, launched


def _launched(events, host_names) -> tuple:
    """(forward seconds by kernel base name, seconds by host scope) of
    the kernels the profiler linked to a host op (see :class:`Window`)."""
    from torch.autograd import DeviceType
    fwd: dict = {}
    scope: dict = {}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels \
                or _NOT_OPS.match(e.name):
            continue
        names, up = {LINKED}, e
        while up is not None:
            names.add(up.name[len(BACKWARD):]
                      if up.name.startswith(BACKWARD) else up.name)
            backward = up.name.startswith(BACKWARD)
            up = up.cpu_parent
            if backward:
                names.add(BACKWARD)
        for k in e.kernels:
            if k.name in host_names:
                continue
            sec = k.duration / 1e6
            for n in names:
                scope[n] = scope.get(n, 0.0) + sec
            if BACKWARD not in names and not k.name.startswith(_COPY):
                b = kernel_name(k.name)
                fwd[b] = fwd.get(b, 0.0) + sec
    return fwd, scope


def record(step, iters: int) -> Window:
    """Profile ``iters`` calls of ``step`` (each one whole iteration,
    ending in its host sync), then one more with host ops for the idle
    gaps' labels (the spans ``step`` opens with
    ``torch.profiler.record_function`` name the outer parts)."""
    wall, dev, _, _ = _profile(step, iters, host=False)
    by_op: dict = {}
    by_kernel: dict = {}
    kernels = 0
    for name, s, e in dev:
        sec = (e - s) / 1e6
        by_op[name] = by_op.get(name, 0.0) + sec
        if not name.startswith(_COPY):
            kernels += 1
            k = kernel_name(name)
            by_kernel[k] = by_kernel.get(k, 0.0) + sec
    win = Window(iters=iters, window_s=wall,
                 busy_s=union_seconds((s, e) for _, s, e in dev),
                 kernels=kernels, by_kernel=by_kernel, by_op=by_op)
    wall2, dev2, cpu2, (win.fwd_by_kernel, win.by_scope) = \
        _profile(step, 1, host=True)
    if cpu2:
        lo = min(s for _, s, _ in cpu2)
        hi = max(e for _, _, e in cpu2)
        gaps = idle_gaps([(s, e) for _, s, e in dev2], lo, hi)
        win.idle_by_host = label_gaps(gaps, cpu2)
        longest = sorted(dev2, key=lambda r: r[1] - r[2])[:3]
        win.host_pass = {
            "wall_s": wall2, "host_span_s": (hi - lo) / 1e6,
            "busy_s": union_seconds((s, e) for _, s, e in dev2),
            "idle_s": sum(e - s for s, e in gaps) / 1e6,
            "longest_device_events": [[n[:80], (e - s) / 1e6]
                                      for n, s, e in longest],
            "linked_s": win.by_scope.get(LINKED, 0.0),
            "backward_s": win.by_scope.get(BACKWARD, 0.0)}
    return win


def breakdown(win: Window, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most
    time and the idle time by what the host was doing, each as measured
    (seconds over the traced iterations; the idle labels over one)."""
    def first(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": first(win.by_op),
            "idle_gaps": first(win.idle_by_host)}
