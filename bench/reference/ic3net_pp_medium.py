"""Plain float32 reference of the ``ic3net_pp_medium`` learner.

IC3Net (Singh et al., arXiv:1812.09755) as LearningGroup trains it
(section IV-A), on Predator-Prey, written out again from the
description: per agent (weights shared) an observation encoder, an LSTM
whose input adds the gated mean of the other agents' communication
vectors (the previous step's hidden state, detached, through the
communication projection), a policy head, a value head and a
communication-gate head. A2C over whole episodes (returns-to-go with
gamma, advantage policy gradient, value regression, entropy bonus, a
gate penalty; the gate head's log-probabilities are not in the loss),
RMSprop. With FLGW every projection but the value and gate heads is
``x @ (W * Mask)``, the mask re-derived from the grouping matrices at the
top of every step (``benchlib.plain``).

The rollout replays the decisions it is given (teacher forcing: the
program's actions and gates, drawn by the benchmark's sampler from the
program's logits and the benchmark's uniforms), and judges them: at
every step the widest gap by which the reference's Gumbel-perturbed
logit of the taken action lies below its best, and by which a gate
decision lies on the wrong side of the reference's gate probability.
With ``own=True`` it draws its own decisions from the same uniforms
(the reference put in the program's place: the controls).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchlib.plain import Precision, grouped_linear, groups_of, rmsprop, \
    tf32_off

FLGW_LAYERS = ("enc", "lstm_x", "lstm_h", "comm", "policy")
# actions: stay, up, down, left, right as (row, column) moves
MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def observe(pos, prey, m):
    """(B, A, obs_dim): own row and column one-hot, the prey's offset
    one-hot within ``vision`` (zeros when unseen), the seen flag."""
    size, vis = m["size"], m["vision"]
    w = 2 * vis + 1
    off = prey[:, None, :] - pos
    seen = (off.abs() <= vis).all(-1)
    cell = ((off[..., 0] + vis) * w + off[..., 1] + vis).clamp(0, w * w - 1)
    return torch.cat([F.one_hot(pos[..., 0], size).float(),
                      F.one_hot(pos[..., 1], size).float(),
                      F.one_hot(cell, w * w).float() * seen[..., None],
                      seen[..., None].float()], dim=-1)


def env_step(pos, prey, arrived, t, action, m):
    """Predators move unless arrived (an arrived predator stays on the
    prey), clamped to the grid; reward prey_reward once arrived, else
    step_penalty; done when all arrived or at max_steps."""
    moves = torch.tensor(MOVES, device=pos.device)[action]
    pos = (pos + moves * (~arrived)[..., None]).clamp(0, m["size"] - 1)
    arrived = arrived | (pos == prey[:, None, :]).all(-1)
    reward = torch.where(arrived, m["prey_reward"], m["step_penalty"])
    t = t + 1
    return pos, arrived, t, reward, arrived.all(-1) | (t >= m["max_steps"])


class _Net:
    def __init__(self, p, groups, m, prec):
        self.p, self.groups, self.m, self.prec = p, groups, m, prec

    def proj(self, name, x):
        p = self.p
        if name in self.groups:
            rows, cols = self.groups[name]
            return grouped_linear(x, p[f"{name}.w"], p[f"{name}.ig"],
                                  p[f"{name}.og"], rows, cols,
                                  self.m["ste_temperature"], self.prec)
        return self.prec.mm(x, p[f"{name}.w"])

    def step(self, obs, h, c, gate_prev):
        a = self.m["n_agents"]
        comm = self.proj("comm", h.detach()) * gate_prev[..., None]
        comm_in = (comm.sum(1, keepdim=True) - comm) / max(a - 1, 1)
        e = torch.tanh(self.proj("enc", obs))
        z = self.proj("lstm_x", e + comm_in) + self.proj("lstm_h", h) \
            + self.p["lstm_b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (self.proj("policy", h), self.proj("value", h)[..., 0],
                self.proj("gate", h), h, c)


def _episode(net, m, pos, prey, decisions, own):
    """The rollout of B episodes; returns the loss terms, the decisions
    taken and the two decision gaps."""
    b, a = pos.shape[:2]
    hid = m["hidden"]
    h = torch.zeros(b, a, hid, device=pos.device)
    c = torch.zeros_like(h)
    gate = torch.ones(b, a, device=pos.device)
    done = torch.zeros(b, dtype=torch.bool, device=pos.device)
    arrived = torch.zeros(b, a, dtype=torch.bool, device=pos.device)
    t = torch.zeros(b, dtype=torch.int64, device=pos.device)
    terms, taken = [], []
    act_gap = gate_gap = torch.zeros((), device=pos.device)
    for step in range(m["max_steps"]):
        u, v, action, new_gate = decisions[step]
        logits, value, gate_logits, h, c = net.step(
            observe(pos, prey, m), h, c, gate)
        z = logits.detach() - torch.log(-torch.log(u))
        p_gate = torch.softmax(gate_logits.detach(), dim=-1)[..., 1]
        if own:
            action, new_gate = z.argmax(-1), (v < p_gate).float()
        act_gap = torch.maximum(act_gap, (z.amax(-1) - z.gather(
            -1, action[..., None])[..., 0]).amax())
        wrong = torch.where(new_gate > 0, v - p_gate, p_gate - v)
        gate_gap = torch.maximum(gate_gap, wrong.clamp(min=0).amax())
        taken.append((u, v, action, new_gate))
        logp = F.log_softmax(logits, dim=-1)
        entropy = -(logp.exp() * logp).sum(-1)
        npos, narr, nt, reward, ndone = env_step(pos, prey, arrived, t,
                                                 action, m)
        reward = torch.where(done[:, None], 0.0, reward)
        keep = done[:, None]
        pos = torch.where(keep[..., None], pos, npos)
        arrived = torch.where(keep, arrived, narr)
        t = torch.where(done, t, nt)
        terms.append((reward, logp.gather(-1, action[..., None])[..., 0],
                      value, entropy, new_gate))
        done = done | ndone
        gate = new_gate
    rew, logp, val, ent, gates = (torch.stack(x, dim=1) for x in zip(*terms))
    return (rew, logp, val, ent, gates), taken, act_gap, gate_gap


def _loss(terms, o, half_batch: bool):
    rew, logp, val, ent, gates = terms
    if half_batch:                     # a fault: half the envs left out
        keep = rew.shape[0] // 2
        rew, logp, val, ent, gates = (x[:keep] for x in terms)
    ret, carry = [], torch.zeros_like(rew[:, 0])
    for i in range(rew.shape[1] - 1, -1, -1):
        carry = rew[:, i] + o["gamma"] * carry
        ret.append(carry)
    adv = torch.stack(ret[::-1], dim=1) - val
    return (-(logp * adv.detach()).mean()
            + o["value_coef"] * (adv ** 2).mean()
            - o["entropy_coef"] * ent.mean()
            + o["gate_coef"] * gates.mean())


def follow(config: dict, traffic: dict, params: dict, inputs: list, *,
           precision: str = "f32", own: bool = False,
           half_batch: bool = False) -> dict:
    """Follow the program's first ``len(inputs)`` learner iterations
    from the initial ``params`` (flat names, any float dtype; copied to
    float32). ``inputs[k]``: the iteration's reset state ``pos``,
    ``prey`` and its per-step ``decisions`` [(u, v, action, gate)].

    Returns ``losses``, the first step's gradient norm a leaf
    (``grad_norms``), the change norm a leaf after the steps
    (``change_norms``), the decision gaps over every step
    (``action_gap``, ``gate_gap``) and ``inputs`` with the decisions
    taken (for a judge to replay)."""
    tf32_off()
    m, o = config["model"], config["optimizer"]
    prec = Precision(precision)
    p0 = {k: v.detach().float().clone() for k, v in params.items()}
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    sq = {k: torch.zeros_like(v) for k, v in p.items()}
    grouped = traffic["flgw_groups"] > 1
    out = {"losses": [], "inputs": []}
    gaps = []
    for k, inp in enumerate(inputs):
        groups = {n: groups_of(p[f"{n}.ig"], p[f"{n}.og"],
                               m["capacity_slack"])
                  for n in FLGW_LAYERS} if grouped else {}
        net = _Net(p, groups, m, prec)
        terms, taken, ag, gg = _episode(net, m, inp["pos"], inp["prey"],
                                        inp["decisions"], own)
        loss = _loss(terms, o, half_batch)
        got = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {n: torch.zeros_like(v) if g is None else g
                 for (n, v), g in zip(p.items(), got)}
        if k == 0:
            out["grad_norms"] = {n: float(g.double().norm())
                                 for n, g in grads.items()}
        rmsprop(p, grads, sq, o["lr"], o["decay"], o["eps"])
        out["losses"].append(float(loss.detach()))
        out["inputs"].append(dict(inp, decisions=taken))
        gaps.append((float(ag), float(gg)))
    out["change_norms"] = {n: float((p[n].detach() - p0[n]).double().norm())
                           for n in p}
    out["action_gap"] = max(a for a, _ in gaps)
    out["gate_gap"] = max(g for _, g in gaps)
    return out
