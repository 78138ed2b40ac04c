"""Cells of the IC3Net learner: the port's A2C iterations in a closed loop.

One iteration is the body of ``repro_torch.marl.train.train``'s loop:
the plan refresh (``maybe_refresh_plans``), a reset of B episodes, one
``train_step`` (the rollout under autograd, the A2C loss, its gradients
and RMSprop) and the one host sync that fetches the iteration's metrics.
The benchmark makes the inputs: the weights, the reset states and the
sampler's uniforms, all from the seed (its sampler takes the place of
the port's, with the same Gumbel-max and Bernoulli draws).

Set-up builds the learner, runs its first ``STEPS`` iterations through
the same call with their inputs recorded, reads the first gradient from
RMSprop's state and the parameters' change after the steps, and hands
the learner on to the window. After the window the reference follows
those steps (``bench/reference/<config>.py``).
"""
from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from benchlib import compare, plain, weights
from repro_torch.marl import envs, train
from repro_torch.marl.envs.predator_prey import EnvState
from repro_torch.marl.ic3net import IC3Net, IC3NetConfig
from repro_torch.optim.optimizers import rmsprop_init

STEPS = 3                 # the set-up iterations the reference follows
METRIC = "env_steps_per_s"
METRICS = ("success", "return", "loss", "mask_sparsity")   # train()'s


def scale(name: str, shape) -> float:
    """A leaf's standard deviation: N(0, 1/fan_in) weights, N(0, 1)
    grouping matrices, 0.1 for the LSTM bias."""
    if name.endswith(".w"):
        return shape[-2] ** -0.5
    if name.endswith((".ig", ".og")):
        return 1.0
    return 0.1


class Sampler:
    """Actions by Gumbel-max over the logits and gates by a Bernoulli of
    the gate softmax, from the benchmark's generator; ``log``, when a
    list, keeps each step's (u, v, action, gate)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen
        self.log = None

    def __call__(self, t, logits, gate_logits):
        logits, gate_logits = logits.detach(), gate_logits.detach()
        dev = logits.device
        u = torch.rand(logits.shape, generator=self.gen, device=dev)
        action = (logits - torch.log(-torch.log(u))).argmax(-1)
        v = torch.rand(logits.shape[:2], generator=self.gen, device=dev)
        gate = (v < torch.softmax(gate_logits, dim=-1)[..., 1]).float()
        if self.log is not None:
            self.log.append((u, v, action, gate))
        return action, gate


class Learner:
    """The program: the port's IC3Net, its RMSprop state and plans, fed
    by the benchmark's generator."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        m, o = config["model"], config["optimizer"]
        self.env, self.ecfg = envs.make(
            "predator_prey", n_agents=m["n_agents"], size=m["size"],
            vision=m["vision"], max_steps=m["max_steps"],
            step_penalty=m["step_penalty"], prey_reward=m["prey_reward"])
        if (self.env.obs_dim(self.ecfg), self.env.n_actions(self.ecfg)) != \
                (m["obs_dim"], m["n_actions"]):
            raise ValueError("the config's obs_dim and n_actions are not "
                             "the environment's")
        cfg = IC3NetConfig(hidden=m["hidden"], n_agents=m["n_agents"],
                           n_actions=m["n_actions"], obs_dim=m["obs_dim"],
                           flgw_groups=traffic["flgw_groups"],
                           flgw_path=traffic["flgw_path"],
                           comm_detach=m["comm_detach"])
        fl = cfg.flgw
        if fl is not None and (fl.capacity_slack, fl.ste_temperature) != \
                (m["capacity_slack"], m["ste_temperature"]):
            raise ValueError("the port's FLGW slack or temperature is not "
                             "the config's")
        self.tcfg = train.TrainConfig(
            batch=traffic["batch"], lr=o["lr"], gamma=o["gamma"],
            value_coef=o["value_coef"], entropy_coef=o["entropy_coef"],
            gate_coef=o["gate_coef"])
        self.model = IC3Net(cfg, seed=0, device=device)
        drawn = weights.make(self.model.params, seed, device, scale)
        with torch.no_grad():
            for name, p in weights.flatten(self.model.params).items():
                p.copy_(drawn[name])
        self.opt = rmsprop_init(self.model.params)
        with torch.no_grad():
            self.plans = self.model.encode_plans()
        self.gen = weights.generator(seed, weights.TRAFFIC, device)
        self.sampler = Sampler(self.gen)
        self.it = 0

    def reset(self) -> EnvState:
        b, a, size = self.tcfg.batch, self.ecfg.n_agents, self.ecfg.size
        dev = self.gen.device
        prey = torch.randint(0, size, (b, 2), generator=self.gen, device=dev)
        pos = torch.randint(0, size, (b, a, 2), generator=self.gen,
                            device=dev)
        return EnvState(pos=pos, prey=prey,
                        arrived=torch.zeros((b, a), dtype=torch.bool,
                                            device=dev),
                        t=torch.zeros((b,), dtype=torch.int64, device=dev))

    def step(self, log=None):
        """One learner iteration; returns (its loss, its inputs: the
        reset state and, with a ``log`` list, its decisions)."""
        with record_function("refresh"):
            self.plans = train.maybe_refresh_plans(self.model, self.plans,
                                                   self.it, None)
        with record_function("reset"):
            state = self.reset()
        self.sampler.log = log
        with record_function("train_step"):
            self.opt, metrics = train.train_step(
                self.model, self.opt, self.env, self.ecfg, self.tcfg, state,
                self.sampler, self.it, None, self.plans)
        with record_function("sync"):
            vals = torch.stack([metrics[k].float() for k in METRICS]
                               ).tolist()
        self.sampler.log = None
        self.it += 1
        return vals[METRICS.index("loss")], \
            {"pos": state.pos, "prey": state.prey, "decisions": log}

    def hist(self) -> dict:
        """Each FLGW layer's group sizes of the mask from IG and OG."""
        return {n: plain.argmax_hist(p["ig"], p["og"])
                for n, p in self.model.params.items()
                if isinstance(p, dict) and "ig" in p}


def work(config: dict, traffic: dict) -> int:
    """Env steps an iteration trains: B episodes of max_steps."""
    return traffic["batch"] * config["model"]["max_steps"]


def program_steps(cell, steps: int = STEPS):
    """Build the learner and run its first ``steps`` iterations. Returns
    (learner, its readings, the inputs the reference replays)."""
    t0 = time.perf_counter()
    prog = Learner(cell.config, cell.traffic, cell.seed, cell.device)
    phases = {"program_start_s": t0 - cell.t_start,
              "build_s": time.perf_counter() - t0}
    decay = cell.config["optimizer"]["decay"]
    losses, inputs = [], []
    for k in range(steps):
        loss, inp = prog.step([])
        losses.append(loss)
        inputs.append(inp)
        if k == 0:     # RMSprop's square average after one step: (1-d) g^2
            grad_norms = {n: math.sqrt(float(s.double().sum()) / (1 - decay))
                          for n, s in weights.flatten(prog.opt).items()}
    phases["steps_s"] = time.perf_counter() - t0 - phases["build_s"]
    params = weights.flatten(prog.model.params)
    p0 = weights.make(params, cell.seed, cell.device, scale)
    changes = {n: compare.diff_norm(p, p0[n]) for n, p in params.items()}
    del p0
    shapes = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
              for n, p in params.items()}
    phases["snapshot_s"] = time.perf_counter() - t0 - phases["build_s"] \
        - phases["steps_s"]
    return prog, dict(phases=phases, losses=losses, grad_norms=grad_norms,
                      change_norms=changes, shapes=shapes), inputs


def judge(cell, measured: dict, inputs: list) -> dict:
    """The reference's run of the same steps from the same weights,
    replaying the decisions in ``inputs``, and the numbers compared."""
    p0 = weights.make(measured["shapes"], cell.seed, cell.device, scale)
    ref = cell.reference.follow(cell.config, cell.traffic, p0, inputs)
    return {"action_gap": ref["action_gap"], "gate_gap": ref["gate_gap"],
            **compare.training_gaps(measured, ref)}
