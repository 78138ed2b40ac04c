"""Runtime trace and step-signature contracts.

Port of ``repro.analysis.contracts``. The repo's amortization claims are
count claims: ``make_plan`` runs once per FLGW layer per refresh and
zero times per decode step; a step runs at one input signature for a
whole run. This module holds the shared checks:

* :func:`trace_counter` -- the counting monkeypatch as a context manager
  (count, reset, call-through), as in the reference;
* :func:`assert_max_traces` -- the count assertion in one line;
* :func:`no_retrace` -- the eager counterpart of the reference's
  compile monitor. JAX compiles a jitted step once a new abstract
  signature and a mid-run recompile is a silent stall; eager PyTorch
  compiles nothing, but the same shape instability shows as a step
  called at a new signature (shapes, dtypes, devices of its tensors),
  which defeats a CUDA graph capture and re-plans every kernel route.
  Each step that a ``make_*_step`` factory builds (the train, prefill
  and decode steps) and the async pipeline's actor and learner steps
  report their calls through :func:`record`; inside the context every
  call's signature is kept, and leaving it raises :class:`RetraceError`
  if a step ran at more than ``max_compiles`` signatures. It is the
  engine of the opt-in ``debug_contracts=True`` on ``ServeSession``,
  ``Engine`` and ``marl.async_train``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "ContractViolation", "RetraceError", "TraceCounter", "CompileMonitor",
    "trace_counter", "assert_max_traces", "no_retrace", "record",
    "signature",
]


class ContractViolation(AssertionError):
    """A runtime trace/compile contract did not hold."""


class RetraceError(ContractViolation):
    """A step ran at more signatures than ``no_retrace`` allows."""


# ---------------------------------------------------------------------------
# trace counting (the make_plan idiom, shared)
# ---------------------------------------------------------------------------

@dataclass
class TraceCounter:
    """Live handle yielded by :func:`trace_counter`: ``count`` ticks on
    every call of the wrapped attribute."""
    module: object = None
    attr: str = ""
    count: int = 0
    calls: List[Tuple[tuple, dict]] = field(default_factory=list)

    def reset(self) -> None:
        self.count = 0
        self.calls.clear()

    def __int__(self) -> int:
        return self.count


@contextlib.contextmanager
def trace_counter(module, attr: str, *, record_args: bool = False):
    """Count calls to ``module.attr`` while delegating to the original::

        with trace_counter(grouped, "make_plan") as calls:
            step(state, batch)
        assert calls.count == n_layers

    The original attribute is restored on exit even if the body raises.
    ``record_args=True`` also keeps ``(args, kwargs)`` per call on
    ``calls.calls``.
    """
    real = getattr(module, attr)
    counter = TraceCounter(module=module, attr=attr)

    def counting(*a, **kw):
        counter.count += 1
        if record_args:
            counter.calls.append((a, kw))
        return real(*a, **kw)

    counting.__name__ = getattr(real, "__name__", attr)
    counting.__wrapped__ = real
    setattr(module, attr, counting)
    try:
        yield counter
    finally:
        setattr(module, attr, real)


@contextlib.contextmanager
def assert_max_traces(module, attr: str, n: int, *,
                      exactly: bool = False):
    """At most (or exactly) ``n`` calls of ``module.attr`` inside the
    block, else :class:`ContractViolation`."""
    with trace_counter(module, attr) as counter:
        yield counter
    if exactly and counter.count != n:
        raise ContractViolation(
            f"{getattr(module, '__name__', module)}.{attr} traced "
            f"{counter.count} time(s); contract requires exactly {n}")
    if counter.count > n:
        raise ContractViolation(
            f"{getattr(module, '__name__', module)}.{attr} traced "
            f"{counter.count} time(s); contract allows at most {n}")


# ---------------------------------------------------------------------------
# step-signature guard
# ---------------------------------------------------------------------------

def signature(*args, **kwargs) -> tuple:
    """The abstract signature of a call: every tensor's shape, dtype and
    device, in the order of a walk of the arguments (dicts by key,
    sequences, named tuples and dataclasses by position); other leaves
    by type only
    (their values are data, as a traced scalar's would be)."""
    out: list = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), str(x.dtype), str(x.device)))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                out.append(str(k))
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            out.append(len(x))
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            walk([getattr(x, f.name) for f in dataclasses.fields(x)])
        else:
            out.append(type(x).__name__)
    walk((args, kwargs))
    return tuple(out)


@dataclass
class CompileEvent:
    name: str          # the step's name
    message: str       # its signature, rendered


class CompileMonitor:
    """The step calls seen inside a ``no_retrace`` block: one event per
    new (step, signature)."""

    def __init__(self) -> None:
        self.events: List[CompileEvent] = []
        self._seen: set = set()
        self._lock = threading.Lock()

    def observe(self, name: str, sig: tuple) -> None:
        with self._lock:
            if (name, sig) in self._seen:
                return
            self._seen.add((name, sig))
            self.events.append(CompileEvent(name, f"{name}{sig}"))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.name] = out.get(ev.name, 0) + 1
        return out

    def shapes(self, name: str) -> List[str]:
        return [ev.message for ev in self.events if ev.name == name]


# the monitors of the open no_retrace blocks, process-wide (the async
# pipeline's actor thread reports into the same ones)
_MONITORS: List[CompileMonitor] = []


def record(name: str, *args, static: tuple = (), **kwargs) -> None:
    """Report one call of step ``name`` to every open :func:`no_retrace`
    block (nothing to do, and no cost beyond a list test, outside one).
    ``static``: Python values that shape the step's work (a batch size),
    kept by value, as a jitted step's static arguments are."""
    if not _MONITORS:
        return
    sig = signature(*args, **kwargs) + tuple(static)
    for mon in list(_MONITORS):
        mon.observe(name, sig)


@contextlib.contextmanager
def no_retrace(*, max_compiles: int = 1, allow: Tuple[str, ...] = (),
               label: str = "", monitor: Optional[CompileMonitor] = None):
    """Fail if any step runs at more than ``max_compiles`` signatures
    inside the block.

    The contract of the serving and async hot loops: after the first
    call of each step, every later call comes at the same shapes, dtypes
    and devices. A second signature means the loop feeds shape-unstable
    inputs. Step names in ``allow`` are exempt. Usage::

        with no_retrace(label="Engine.run") as mon:
            for _ in range(steps):
                tok, cache = session.decode(cache, tok, pos)

    ``max_compiles=0`` forbids any step call at all. Nesting is safe; the
    monitor sees the calls made while the block is open, on any thread.
    """
    mon = monitor if monitor is not None else CompileMonitor()
    _MONITORS.append(mon)
    try:
        yield mon
    finally:
        _MONITORS.remove(mon)
    offenders = {name: n for name, n in mon.counts().items()
                 if n > max_compiles and name not in allow}
    if offenders:
        where = f" in {label}" if label else ""
        lines = []
        for name, n in sorted(offenders.items()):
            lines.append(f"  {name}: {n} signatures "
                         f"(allowed {max_compiles})")
            for msg in mon.shapes(name):
                lines.append(f"    - {msg}")
        raise RetraceError(
            f"signature contract violated{where}: a step ran at a new "
            f"signature mid-run\n" + "\n".join(lines))
