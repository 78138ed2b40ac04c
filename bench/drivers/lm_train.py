"""Cells of LM training: the port's train step, steps back to back.

The configuration file's ``model`` is the port's ``ModelConfig`` as run
(its pattern a list of slots, its dtype by name); the traffic adds the
batch, the sequence length and FLGW's groups, path and targets. The
benchmark draws the parameters on the card from the seed in the shapes
of the port's state (``train.state.abstract_state``), builds the
``TrainState`` from them (AdamW moments at zero, the plans of the
initial grouping matrices on the grouped path) and makes every batch:
``seq + 1`` token ids uniform over the vocabulary a row, each step's
rows new, positions ``0..seq-1``.

Set-up runs the first ``STEPS`` steps through the window's own call,
reads the first gradient from AdamW's first moment after one step and
the parameters' change after the steps, and hands the state on; each
step ends in one host sync, reading its loss. After the window the
reference follows those steps (``bench/reference/<config>.py``).
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from benchlib import compare, plain, weights
from repro_torch.core.flgw import FLGWConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig, SlotSpec
from repro_torch.optim.optimizers import adamw_init
from repro_torch.train import state as state_lib
from repro_torch.train import step as step_lib

STEPS = 3                 # the set-up steps the reference follows
METRIC = "train_tokens_per_s"


def scale(name: str, shape) -> float:
    """A leaf's standard deviation: 0.02 for the embedding, N(0, 1/fan_in)
    for weights and the router, N(0, 1) grouping matrices, 0.1 for the
    norms' scales."""
    if name == "embed.embedding":
        return 0.02
    if name.endswith((".w", ".router")):
        return shape[-2] ** -0.5
    if name.endswith((".ig", ".og")):
        return 1.0
    return 0.1


def model_config(config: dict, traffic: dict) -> ModelConfig:
    m = dict(config["model"])
    pattern = tuple(SlotSpec(**s) for s in m.pop("pattern"))
    dtype = getattr(torch, m.pop("dtype"))
    fl = {}
    if traffic["flgw_groups"] > 1:
        fl = dict(flgw_groups=traffic["flgw_groups"],
                  flgw_path=traffic["flgw_path"],
                  flgw_targets=tuple(traffic["flgw_targets"]))
    return ModelConfig(pattern=pattern, dtype=dtype, **m, **fl)


class Trainer:
    """The program: the port's train step and its state, fed by the
    benchmark's generator."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        o = config["optimizer"]
        self.cfg = model_config(config, traffic)
        self.traffic = traffic
        shapes = state_lib.abstract_state(self.cfg).params
        self.shapes = {n: t for n, t in weights.flatten(shapes).items()}
        params = weights.unflatten(weights.make(shapes, seed, device, scale))
        grouped = self.cfg.flgw_groups > 1 and \
            self.cfg.flgw_path == "grouped"
        with torch.no_grad():
            plans = transformer.encode_plans(params, self.cfg) if grouped \
                else ()
        self.state = state_lib.TrainState(
            params=params, opt=adamw_init(params),
            step=torch.zeros((), dtype=torch.int32, device=device),
            plans=plans)
        fl, port = config["flgw"], FLGWConfig()
        if (fl["capacity_slack"], fl["ste_temperature"]) != \
                (port.capacity_slack, port.ste_temperature):
            raise ValueError("the port's FLGW slack or temperature is not "
                             "the config's")
        self.step_fn = step_lib.make_train_step(self.cfg, optimizer="adamw",
                                                lr=o["lr"], clip=o["clip"])
        self.gen = weights.generator(seed, weights.TRAFFIC, device)

    def batch(self) -> dict:
        b, s = self.traffic["batch"], self.traffic["seq"]
        dev = self.gen.device
        toks = torch.randint(0, self.cfg.vocab, (b, s + 1),
                             generator=self.gen, device=dev)
        return {"tokens": toks[:, :-1].contiguous(),
                "targets": toks[:, 1:].contiguous(),
                "positions": torch.arange(s, device=dev).expand(b, s)
                .contiguous()}

    def step(self):
        """One training step; returns (its loss, its batch)."""
        with record_function("batch"):
            batch = self.batch()
        with record_function("train_step"):
            self.state, metrics = self.step_fn(self.state, batch)
        with record_function("sync"):
            loss = float(metrics["loss"])
        return loss, batch

    def hist(self) -> dict:
        """Each FLGW projection's group sizes of the mask from IG and
        OG (stacked blocks and experts lead)."""
        flat = weights.flatten(self.state.params)
        return {n[:-3]: plain.argmax_hist(t, flat[n[:-3] + ".og"])
                for n, t in flat.items() if n.endswith(".ig")}


def work(config: dict, traffic: dict) -> int:
    """Tokens a step trains: B x S."""
    return traffic["batch"] * traffic["seq"]


def program_steps(cell, steps: int = STEPS):
    """Build the trainer and run its first ``steps`` steps. Returns
    (trainer, its readings, the inputs the reference replays)."""
    t0 = time.perf_counter()
    prog = Trainer(cell.config, cell.traffic, cell.seed, cell.device)
    phases = {"program_start_s": t0 - cell.t_start,
              "build_s": time.perf_counter() - t0}
    b1 = cell.config["optimizer"]["b1"]
    losses, inputs = [], []
    for k in range(steps):
        loss, batch = prog.step()
        losses.append(loss)
        inputs.append(batch)
        if k == 0:     # AdamW's first moment after one step: (1-b1) g
            grad_norms = {n: compare.diff_norm(m) / (1 - b1) for n, m in
                          weights.flatten(prog.state.opt.mu).items()}
    phases["steps_s"] = time.perf_counter() - t0 - phases["build_s"]
    params = weights.flatten(prog.state.params)
    p0 = weights.make(prog.shapes, cell.seed, cell.device, scale)
    changes = {n: compare.diff_norm(p, p0[n]) for n, p in params.items()}
    del p0
    phases["snapshot_s"] = time.perf_counter() - t0 - phases["build_s"] \
        - phases["steps_s"]
    return prog, dict(phases=phases, losses=losses, grad_norms=grad_norms,
                      change_norms=changes, shapes=prog.shapes), inputs


def judge(cell, measured: dict, inputs: list) -> dict:
    """The reference's run of the same steps from the same weights, and
    the numbers compared."""
    p0 = weights.make(measured["shapes"], cell.seed, cell.device, scale)
    ref = cell.reference.follow(cell.config, cell.traffic, p0, inputs)
    del p0
    return compare.training_gaps(measured, ref)
