"""Plain float32 reference of the ``mixtral_8x22b_l1`` training step.

A decoder of the configuration's slots, written out again from the
description (Mixtral, arXiv:2401.04088, with the departures the port's
LM family makes and the configuration file lists): token embedding
scaled by sqrt(d); per slot an RMSNorm (scaled by ``1 + scale``), GQA
attention with RoPE over a causal (and, when set, sliding) mask, the
residual, an RMSNorm, a token-choice top-k mixture of experts and the
residual; a final RMSNorm and cross-entropy over the tied embedding.
The router is float32: softmax over the experts, the top k by a stable
descending sort, their weights renormalised, a Switch-style balance
loss; each expert keeps the first ``capacity`` of the assignments sorted
by expert (token-major), and its FFN is GeGLU (tanh GELU). With FLGW on
a target every projection of it is ``x @ (W * Mask)``, the mask
re-derived each step (``benchlib.plain``). The loss is the mean NLL plus
``aux_coef`` times the balance losses; the gradients are clipped by
their global norm and AdamW (decay on every leaf) updates the float32
parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchlib.compare import diff_norm
from benchlib.plain import (Precision, adamw, clip, grouped_linear, groups_of,
                            tf32_off)


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, pos, theta):
    """x (B, S, H, D) rotated by position, the two halves of D paired."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class _Block:
    """One block's slots over the stacked leaves' slice ``i``."""

    def __init__(self, leaves: dict, m: dict, groups: dict, tau: float,
                 prec: Precision):
        self.p, self.m, self.groups, self.prec = leaves, m, groups, prec
        self.tau = tau
        self.experts: dict = {}

    def leaf(self, key: str, expert=None):
        """A leaf, or its expert's slice (each stacked leaf unbound once,
        so its gradient is stacked once)."""
        if expert is None:
            return self.p[key]
        if key not in self.experts:
            self.experts[key] = self.p[key].unbind(0)
        return self.experts[key][expert]

    def lin(self, name: str, x, expert=None):
        """x @ W of the projection ``name`` (of expert ``expert``)."""
        w = self.leaf(f"{name}.w", expert)
        if f"{name}.ig" not in self.p:
            return self.prec.mm(x, w)
        rows, cols = self.groups[(name, expert)]
        return grouped_linear(x, w, self.leaf(f"{name}.ig", expert),
                              self.leaf(f"{name}.og", expert), rows, cols,
                              self.tau, self.prec)

    def attention(self, slot: str, x, pos, spec: dict):
        m, prec = self.m, self.prec
        b, s, _ = x.shape
        h, hk, d = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        pre = f"{slot}.mixer"
        q = _rope(self.lin(f"{pre}.q", x).reshape(b, s, h, d), pos,
                  m["rope_theta"]).reshape(b, s, hk, h // hk, d)
        k = _rope(self.lin(f"{pre}.k", x).reshape(b, s, hk, d), pos,
                  m["rope_theta"])
        v = self.lin(f"{pre}.v", x).reshape(b, s, hk, d)
        scores = torch.einsum("bsgqd,btgd->bgqst", prec.operand(q),
                              prec.operand(k)) * d ** -0.5
        qp, kp = pos[:, None, None, :, None], pos[:, None, None, None, :]
        allowed = kp <= qp
        if spec.get("window", 0) > 0:
            allowed = allowed & (kp > qp - spec["window"])
        probs = torch.softmax(scores.masked_fill(~allowed, -math.inf), -1)
        out = torch.einsum("bgqst,btgd->bsgqd", prec.operand(probs),
                           prec.operand(v))
        return self.lin(f"{pre}.o", out.reshape(b, s, h * d))

    def moe(self, slot: str, x):
        m = self.m
        b, s, d = x.shape
        t, e, k = b * s, m["n_experts"], m["top_k"]
        pre = f"{slot}.moe"
        xf = x.reshape(t, d)
        probs = torch.softmax(xf @ self.p[f"{pre}.router"], dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        gate_w, gate_e = top_w[:, :k], top_e[:, :k]
        gate_w = gate_w / gate_w.sum(-1, keepdim=True)
        aux = e * (probs.mean(0)
                   * F.one_hot(gate_e[:, 0], e).float().mean(0)).sum()
        flat_e = gate_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        st = torch.arange(t, device=x.device).repeat_interleave(k)[order]
        sw = gate_w.reshape(-1)[order]
        run = torch.arange(t * k, device=x.device) - torch.searchsorted(
            se, se)
        kept = run < capacity_of(t, m)
        out = torch.zeros_like(xf)
        for j in range(e):
            sel = kept & (se == j)
            tok = st[sel]
            xe = xf[tok]
            up = self.lin(f"{pre}.up", xe, j)
            gate = F.gelu(self.lin(f"{pre}.gate", xe, j), approximate="tanh")
            y = self.lin(f"{pre}.down", gate * up, j)
            out = out.index_add(0, tok, y * sw[sel][:, None])
        return out.reshape(b, s, d), aux

    def apply(self, x, pos):
        m, eps = self.m, self.m["norm_eps"]
        aux = torch.zeros((), device=x.device)
        for j, spec in enumerate(m["pattern"]):
            slot = f"slot{j}"
            x = x + self.attention(
                slot, _rmsnorm(x, self.p[f"{slot}.norm1.scale"], eps), pos,
                spec)
            y, a = self.moe(slot, _rmsnorm(x, self.p[f"{slot}.norm2.scale"],
                                           eps))
            x, aux = x + y, aux + a
        return x, aux


def capacity_of(t: int, m: dict) -> int:
    """Each expert's slots for ``t`` tokens: ``round(t k / E * factor)``
    (Python's round), at least 1 and at most t."""
    return min(int(max(1, round(t * m["top_k"] / m["n_experts"]
                                * m["capacity_factor"]))), t)


def _groups(p: dict, m: dict, slack: float) -> list:
    """Each block's {(projection, expert): (row groups, column groups)}."""
    out = []
    for i in range(m["n_layers"] // len(m["pattern"])):
        g = {}
        for name, ig in p.items():
            if not name.endswith(".ig"):
                continue
            base = name[len("blocks."):-len(".ig")]
            og = p[f"blocks.{base}.og"][i]
            ig = ig[i]
            if ig.dim() == 3:          # experts
                for j in range(ig.shape[0]):
                    g[(base, j)] = groups_of(ig[j], og[j], slack)
            else:
                g[(base, None)] = groups_of(ig, og, slack)
        out.append(g)
    return out


def _loss(p: dict, batch: dict, config: dict, traffic: dict,
          prec: Precision):
    m = config["model"]
    tokens, targets = batch["tokens"], batch["targets"]
    pos = batch["positions"]
    groups = _groups(p, m, config["flgw"]["capacity_slack"]) \
        if traffic["flgw_groups"] > 1 else None
    x = p["embed.embedding"][tokens] * math.sqrt(m["d_model"])
    blocks = {k[len("blocks."):]: v.unbind(0) for k, v in p.items()
              if k.startswith("blocks.")}
    aux = torch.zeros((), device=x.device)
    for i in range(m["n_layers"] // len(m["pattern"])):
        leaves = {k: v[i] for k, v in blocks.items()}
        blk = _Block(leaves, m, groups[i] if groups else {},
                     config["flgw"]["ste_temperature"], prec)
        x, a = blk.apply(x, pos)
        aux = aux + a
    h = _rmsnorm(x, p["final_norm.scale"], m["norm_eps"])
    logits = prec.mm(h, p["embed.embedding"].T)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, targets[..., None])[..., 0]
    return nll.mean() + config["loss"]["aux_coef"] * aux


def follow(config: dict, traffic: dict, params: dict, inputs: list, *,
           precision: str = "f32", own: bool = False,
           half_batch: bool = False) -> dict:
    """Follow the program's first ``len(inputs)`` steps (``inputs[k]``:
    the step's batch) from the initial ``params`` (flat names; kept as
    given for the change, trained in float32 copies). ``own`` has no
    meaning here (no decision is sampled). Returns ``losses``, the first
    step's clipped gradient norm a leaf (``grad_norms``), the change norm
    a leaf after the steps (``change_norms``) and ``inputs``."""
    tf32_off()
    o = config["optimizer"]
    prec = Precision(precision)
    p = {k: v.detach().float().clone().requires_grad_()
         for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": [], "inputs": inputs}
    for step, batch in enumerate(inputs, start=1):
        if half_batch:                 # a fault: half the rows left out
            keep = batch["tokens"].shape[0] // 2
            batch = {k: v[:keep] for k, v in batch.items()}
        loss = _loss(p, batch, config, traffic, prec)
        got = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        grads = {n: torch.zeros_like(v) if g is None else g
                 for (n, v), g in zip(p.items(), got)}
        del got
        clip(grads, o["clip"])
        if step == 1:
            out["grad_norms"] = {n: diff_norm(g) for n, g in grads.items()}
        adamw(p, grads, mu, nu, step, o["lr"], o["b1"], o["b2"], o["eps"],
              o["weight_decay"])
        del grads
        out["losses"].append(float(loss.detach()))
    del mu, nu
    out["change_norms"] = {n: diff_norm(p[n], params[n]) for n in p}
    return out
