"""Fault tolerance: preemption hooks, transient-error retry, step runner.

Port of ``repro.runtime.fault``. The data pipeline is a pure function of
the step, so fault tolerance reduces to three small mechanisms:

* ``PreemptionGuard``: SIGTERM/SIGINT sets a flag; the loop checkpoints
  at the *next step boundary* and exits cleanly. Its ``restore`` puts
  the previous handlers back; a caller that outlives the loop calls it
  (in a ``finally``), or a later SIGTERM would only set the flag.
* ``retry_transient``: re-runs a call on errors whose message looks
  transient (a collective timeout, a connection reset).
* ``StepRunner``: wires them together with periodic and on-preemption
  checkpoints; on restart it resumes from the latest manifest. A state
  on a mesh (DTensors) stops and saves at the same step boundary on
  every rank: the stop flag is agreed by an all-reduce each step.

Unlike the JAX package's, the port's train step writes the params and
optimizer moments in place (``repro_torch.train.step``). A step that
raises after the optimizer began writing leaves a half-updated state,
and a retry would carry on from it silently. So ``StepRunner.run`` never
retries a step marked ``mutates_state``: the error propagates, and the
restart resumes from the latest checkpoint, as after any failure (the
deterministic replay makes the two equivalent). Steps that return a new
state and leave their input alone are retried as in the JAX package.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.sharding import collectives, partition

TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED",
                     "RESOURCE_EXHAUSTED: Socket", "connection reset")


class PreemptionGuard:
    """Latches SIGTERM/SIGINT; ``should_stop`` is polled at step boundaries."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._flag = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:          # not in main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def should_stop(self) -> bool:
        return self._flag

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


def retry_transient(fn: Callable, *args, retries: int = 3,
                    backoff_s: float = 1.0, on_retry=None, **kwargs):
    """Run ``fn``; retry on errors whose message looks transient."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — classify then re-raise
            msg = str(e)
            transient = any(m in msg for m in TRANSIENT_MARKERS)
            if not transient or attempt >= retries:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * attempt)


class StepRunner:
    """Checkpointing step loop: periodic saves, preemption-safe exit,
    restart-from-latest. ``step_fn(state, batch) -> (state, metrics)``;
    a ``step_fn`` whose ``mutates_state`` attribute is true is never
    retried (module docstring)."""

    def __init__(self, step_fn, ckpt_dir, *, save_every: int = 100,
                 keep: int = 3, guard: Optional[PreemptionGuard] = None):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.guard = guard or PreemptionGuard()

    def restore_or(self, state, shardings=None, restore_fn=None):
        """Resume from the latest checkpoint if one exists.

        ``restore_fn(state, shardings) -> (state, step)`` overrides the
        plain full-tree restore: the TrainState path passes
        ``repro_torch.train.state.restore_state`` here so derived leaves
        (cached FLGW plans) are re-encoded from the restored params
        rather than loaded stale, and pre-plans manifests migrate.
        ``shardings``: the placements tree of a state on a mesh (see
        ``checkpoint.restore_checkpoint``).
        """
        if ckpt.latest_step(self.ckpt_dir) is None:
            return state, 0
        if restore_fn is not None:
            return restore_fn(state, shardings)
        return ckpt.restore_checkpoint(self.ckpt_dir, state,
                                       shardings=shardings)

    @staticmethod
    def _agreed(stop: bool, state) -> bool:
        """A state on a mesh stops (and saves) on every rank together:
        the flag is the maximum over the ranks, one scalar all-reduce."""
        mesh = partition.mesh_of(state)
        if mesh is None or not dist.is_initialized():
            return stop
        dev = partition.leaves(state)[0].device
        flag = torch.tensor([float(stop)], device=dev)
        return bool(collectives.all_reduce(flag, dist.group.WORLD)[0] > 0)

    def run(self, state, batches, *, start_step: int = 0,
            max_steps: Optional[int] = None, log_every: int = 0):
        step = start_step
        history = []
        in_place = getattr(self.step_fn, "mutates_state", False)
        for batch in batches:
            if max_steps is not None and step >= max_steps:
                break
            if in_place:
                state, metrics = self.step_fn(state, batch)
            else:
                state, metrics = retry_transient(self.step_fn, state, batch)
            step += 1
            history.append(metrics)
            # read before the log line: a signal sent on seeing "step N:"
            # stops the loop at the next boundary, never at N's
            stop = self._agreed(self.guard.should_stop, state)
            if log_every and step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"step {step}: {m}", flush=True)
            if stop or step % self.save_every == 0:
                ckpt.save_checkpoint(self.ckpt_dir, step, state,
                                     keep=self.keep)
            if stop:
                break
        return state, step, history
