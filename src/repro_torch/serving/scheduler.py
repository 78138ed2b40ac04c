"""Continuous-batching request scheduler over a per-slot decode cache.

Port of ``repro.serving.scheduler``: the decode batch is ``capacity``
slots; a request holds one slot from admission to completion, and a
freed slot is recycled (``transformer.reset_slots``) for the next queued
request while the others keep decoding. Every step feeds each active
slot one token: the next prompt token while it is prefilling, its last
generated token once decoding. Admission is a request boundary, where
the session certifies the cache's plans. ``admission="lockstep"`` admits
only into an all-free engine: the static-batching baseline on the same
step. The clock is the tick (one step), fast-forwarded over idle
stretches; arrivals are open-loop tick offsets.

Generated tokens stay on the device: a decoding slot's next input is
fed back with ``torch.where``, and token values reach the host in one
fetch per completion boundary.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.models import transformer

ADMISSION_MODES = ("continuous", "lockstep")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt in, ``max_new_tokens`` greedy out."""
    rid: int
    prompt: np.ndarray            # (P,) int32 token ids, P >= 1
    max_new_tokens: int
    arrival: int = 0              # tick at which the request becomes visible

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")


@dataclasses.dataclass
class RequestRecord:
    """Per-request lifecycle and output, as the engine observed it."""
    rid: int
    arrival: int
    prompt_len: int = 0
    admitted: int = -1
    first_token: int = -1
    completed: int = -1
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    arrival_wall: float = float("nan")
    completed_wall: float = float("nan")

    @property
    def latency_ticks(self) -> int:
        return self.completed - self.arrival

    @property
    def latency_s(self) -> float:
        return self.completed_wall - self.arrival_wall


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one engine run (``Engine.run``)."""
    admission: str
    capacity: int
    steps: int
    wall_s: float
    generated_tokens: int
    records: List[RequestRecord]

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def slot_utilization(self) -> float:
        """Fraction of slot-steps that fed a live request."""
        if self.steps == 0:
            return 0.0
        busy = sum(r.prompt_len + len(r.tokens) - 1
                   for r in self.records if r.completed >= 0)
        return busy / (self.steps * self.capacity)

    def latency_percentiles(self, qs=(50, 99)) -> dict:
        lats = [r.latency_s for r in self.records if r.completed >= 0]
        ticks = [r.latency_ticks for r in self.records if r.completed >= 0]
        out = {}
        for q in qs:
            out[f"p{q}_s"] = float(np.percentile(lats, q)) if lats else None
            out[f"p{q}_ticks"] = (float(np.percentile(ticks, q))
                                  if ticks else None)
        return out

    def summary(self) -> dict:
        return {"admission": self.admission, "capacity": self.capacity,
                "requests": len(self.records), "steps": self.steps,
                "wall_s": self.wall_s,
                "generated_tokens": self.generated_tokens,
                "tokens_per_s": self.tokens_per_s,
                "slot_utilization": self.slot_utilization,
                **self.latency_percentiles()}


@dataclasses.dataclass
class _Slot:
    """Host-side state of one occupied batch row."""
    req: Request
    record: RequestRecord
    fed: int = 0
    gen: int = 0

    @property
    def done_prefill(self) -> bool:
        return self.fed >= len(self.req.prompt)


class Engine:
    """Slot-based serving engine over one :class:`~repro_torch.serving.
    session.ServeSession`. ``capacity`` is the decode-batch width;
    ``max_seq`` bounds one request's prompt plus generation.
    ``debug_contracts`` (None: the session's) runs each :meth:`run` under
    ``repro_torch.analysis.contracts.no_retrace``: the decode step may
    run at one signature; a second (a shape instability in the tick
    loop) raises ``RetraceError``."""

    def __init__(self, session, capacity: int, max_seq: int, *,
                 admission: str = "continuous",
                 debug_contracts: Optional[bool] = None):
        if admission not in ADMISSION_MODES:
            raise ValueError(
                f"admission must be one of {ADMISSION_MODES}, "
                f"got {admission!r}")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.session = session
        self.capacity = capacity
        self.max_seq = max_seq
        self.admission = admission
        self.debug_contracts = (
            getattr(session, "debug_contracts", False)
            if debug_contracts is None else debug_contracts)

    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve ``requests`` to completion; deterministic given the
        session's params and the request list."""
        if self.debug_contracts:
            with contracts.no_retrace(label="Engine.run"):
                return self._run(requests)
        return self._run(requests)

    @torch.inference_mode()
    def _run(self, requests: Sequence[Request]) -> ServeReport:
        for r in requests:
            need = len(r.prompt) + r.max_new_tokens
            if need > self.max_seq:
                raise ValueError(
                    f"request {r.rid} needs {need} cache positions, "
                    f"engine max_seq is {self.max_seq}")
        b = self.capacity
        dev = self.session.device
        pending = deque(sorted(requests, key=lambda r: (r.arrival, r.rid)))
        records = {r.rid: RequestRecord(rid=r.rid, arrival=r.arrival,
                                        prompt_len=len(r.prompt))
                   for r in requests}
        order = [r.rid for r in requests]
        unstamped = deque(sorted(records.values(), key=lambda c: c.arrival))

        cache = self.session.new_cache(b, self.max_seq, per_slot=True)
        slots: List[Optional[_Slot]] = [None] * b
        pos = np.zeros(b, np.int64)    # host mirror of cache["pos"]
        tick = steps = generated = 0
        wall0 = time.perf_counter()

        prev_out = None                           # (b, 1) last step's tokens
        outs_dev: List[torch.Tensor] = []         # per-step (b,) columns
        events: List[Tuple[RequestRecord, int, int]] = []
        outs_base = 0

        def now() -> float:
            return time.perf_counter() - wall0

        def stamp_arrivals():
            t = now()
            while unstamped and unstamped[0].arrival <= tick:
                unstamped.popleft().arrival_wall = t

        def flush_tokens():
            """One host fetch for every step since the last boundary."""
            nonlocal outs_base
            if events:
                stacked = torch.stack(outs_dev).cpu().numpy()
                for rec, step_idx, slot_i in events:
                    rec.tokens.append(
                        int(stacked[step_idx - outs_base, slot_i]))
                events.clear()
            outs_dev.clear()
            outs_base = steps

        stamp_arrivals()
        while pending or any(slots):
            if not any(slots) and pending and pending[0].arrival > tick:
                tick = pending[0].arrival
                stamp_arrivals()

            can_admit = self.admission == "continuous" or not any(slots)
            admitted = []
            if can_admit:
                for i in range(b):
                    if slots[i] is not None:
                        continue
                    if not pending or pending[0].arrival > tick:
                        break
                    req = pending.popleft()
                    rec = records[req.rid]
                    rec.admitted = tick
                    rec.slot = i
                    slots[i] = _Slot(req=req, record=rec)
                    admitted.append(i)
            if admitted:
                cache = self.session.refresh(cache)
                mask = np.zeros(b, bool)
                mask[admitted] = True
                cache = transformer.reset_slots(cache, mask)
                pos[admitted] = 0

            tok = np.zeros(b, np.int64)
            fb = np.zeros(b, bool)     # rows fed from device feedback
            for i, s in enumerate(slots):
                if s is None:
                    continue
                if s.done_prefill:
                    fb[i] = True
                else:
                    tok[i] = int(s.req.prompt[s.fed])
            tok_dev = torch.as_tensor(tok[:, None], device=dev)
            if prev_out is not None and fb.any():
                tok_dev = torch.where(torch.as_tensor(fb[:, None], device=dev),
                                      prev_out.long(), tok_dev)
            next_tok, cache = self.session.decode(
                cache, tok_dev, torch.as_tensor(pos[:, None], device=dev))
            prev_out = next_tok
            outs_dev.append(next_tok[:, 0])
            steps += 1
            tick += 1
            pos += 1
            stamp_arrivals()

            completed_now = []
            for i, s in enumerate(slots):
                if s is None:
                    continue
                s.fed += 1
                if s.done_prefill:
                    events.append((s.record, steps - 1, i))
                    s.gen += 1
                    generated += 1
                    if s.record.first_token < 0:
                        s.record.first_token = tick
                    if s.gen >= s.req.max_new_tokens:
                        s.record.completed = tick
                        completed_now.append(s.record)
                        slots[i] = None
            if completed_now:
                flush_tokens()
                t = now()
                for rec in completed_now:
                    rec.completed_wall = t

        flush_tokens()
        wall = time.perf_counter() - wall0
        return ServeReport(admission=self.admission, capacity=b,
                           steps=steps, wall_s=wall,
                           generated_tokens=generated,
                           records=[records[rid] for rid in order])
