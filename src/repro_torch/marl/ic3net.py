"""IC3Net (Singh et al., '19), the MARL network LearningGroup trains.

Port of ``repro.marl.ic3net``. Per agent (weights shared across agents):
an observation encoder, an LSTM whose input is the encoded observation
plus a gated mean of the other agents' communication vectors, a policy
head, a value head and a communication gate head. Every projection but
the value and gate heads carries IG/OG grouping matrices when
``flgw_groups > 1``.

Where the JAX function takes one env's (A, ...) arrays and is vmapped,
:class:`IC3Net` takes (B, A, ...) tensors; its projections see the B*A
rows flattened, and the communication mean runs over the agents of each
env. On an agent-split mesh (``marl.train``'s ``Shard``) a rank holds
some of each env's agents: its (B, A_local, ...) tensors are its shard,
and the communication sum is the one collective, an all-reduce over the
agent group.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import encoder
from repro_torch.core.flgw import FLGWConfig
from repro_torch.models.layers import dense_init, plan_of, proj
from repro_torch.sharding import collectives

_PROJECTIONS = ("enc", "lstm_x", "lstm_h", "comm", "policy", "value", "gate")


@dataclasses.dataclass(frozen=True)
class IC3NetConfig:
    hidden: int = 128
    n_agents: int = 3
    n_actions: int = 5
    obs_dim: int = 0              # filled from the env at init time
    flgw_groups: int = 1
    flgw_path: str = "masked"
    comm_detach: bool = True      # IC3Net detaches comm grads across agents

    @property
    def flgw(self) -> FLGWConfig | None:
        if self.flgw_groups <= 1:
            return None
        return FLGWConfig(groups=self.flgw_groups, path=self.flgw_path)


class IC3Net(nn.Module):
    """The IC3Net parameters, named as the JAX param tree is
    (``enc.w``, ``enc.ig``, ..., ``lstm_b``), and its forward step.

    Weights are drawn from ``seed`` on the CPU and then moved, so a seed
    gives the same weights on every device. ``device=None`` means the
    CUDA card (and raises without one).
    """

    def __init__(self, cfg: IC3NetConfig, *, seed: int = 0, device=None):
        super().__init__()
        if cfg.obs_dim <= 0:
            raise ValueError("IC3NetConfig.obs_dim must be set from the env")
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden
        shapes = {"enc": (cfg.obs_dim, h), "lstm_x": (h, 4 * h),
                  "lstm_h": (h, 4 * h), "comm": (h, h),
                  "policy": (h, cfg.n_actions), "value": (h, 1),
                  "gate": (h, 2)}
        gen = torch.Generator().manual_seed(seed)
        for name in _PROJECTIONS:
            fl = cfg.flgw if name not in ("value", "gate") else None
            p = dense_init(gen, *shapes[name], flgw=fl)
            setattr(self, name, nn.ParameterDict(
                {k: nn.Parameter(v) for k, v in p.items()}))
        self.lstm_b = nn.Parameter(torch.zeros(4 * h))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.lstm_b.device

    @property
    def params(self) -> dict:
        """The parameters as the JAX package's nested param dict."""
        tree = {name: dict(getattr(self, name).items())
                for name in _PROJECTIONS}
        tree["lstm_b"] = self.lstm_b
        return tree

    def flops_per_step(self) -> float:
        """Dense-equivalent FLOPs of one forward policy step of one env
        (all agents): 2*M*N per projection, the paper's Fig. 11
        accounting."""
        cfg, h = self.cfg, self.cfg.hidden
        per_agent = 2 * (cfg.obs_dim * h          # encoder
                         + h * 4 * h * 2          # LSTM x/h gates
                         + h * h                  # comm projection
                         + h * cfg.n_actions + h + h * 2)  # policy/value/gate
        return float(cfg.n_agents * per_agent)

    def encode_plans(self) -> encoder.PlanState:
        """One encode pass: the PlanState of every FLGW layer, or the
        empty state unless the compact ``grouped`` path is on."""
        fl = self.cfg.flgw
        if fl is None or fl.path != "grouped":
            return encoder.empty_state(self.device)
        return encoder.encode_plans(self.params, fl)

    def initial_state(self, batch: int, agents: int | None = None):
        """((h, c) zeros (B, A, H), gate ones (B, A)); ``agents`` is a
        rank's local agent count on an agent-split mesh (all of them by
        default)."""
        agents = self.cfg.n_agents if agents is None else agents
        z = torch.zeros((batch, agents, self.cfg.hidden), device=self.device)
        return (z, z), torch.ones((batch, agents), device=self.device)

    def _flgw(self, flgw_path=None):
        """The layers' FLGWConfig, its path overridden by ``flgw_path``
        (the learner's dense warmup runs ``"dense"`` on the same
        parameters)."""
        fl = self.cfg.flgw
        if fl is None or flgw_path is None:
            return fl
        return dataclasses.replace(fl, path=flgw_path)

    def lstm_cell(self, x, hc, plans=None, flgw_path=None):
        h, c = hc
        fl = self._flgw(flgw_path)
        p = self.params
        gates = proj(p["lstm_x"], x, fl, plan=plan_of(plans, "lstm_x")) \
            + proj(p["lstm_h"], h, fl, plan=plan_of(plans, "lstm_h")) \
            + p["lstm_b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def policy_step(self, obs, hc, gate_prev, plans=None, flgw_path=None,
                    agent_group=None):
        """One communication + action step for every agent of B envs.

        obs: (B, A, obs_dim); hc: ((B, A, H), (B, A, H)); gate_prev:
        (B, A) float in [0, 1], the previous step's gate decisions.
        ``flgw_path`` overrides ``cfg.flgw_path`` for this step. With an
        ``agent_group`` (an agent-split mesh) A is this rank's agents and
        the communication sum runs over the group's ranks; the mean still
        divides by the env's ``cfg.n_agents - 1``.
        Returns (action_logits (B, A, n_act), value (B, A),
        gate_logits (B, A, 2), new_hc).
        """
        cfg = self.cfg
        fl = self._flgw(flgw_path)
        p = self.params
        h, c = hc
        comm_src = h.detach() if cfg.comm_detach else h
        cvec = proj(p["comm"], comm_src, fl, plan=plan_of(plans, "comm"))
        cvec = cvec * gate_prev[..., None]
        # gated mean over the *other* agents of the same env
        total = collectives.all_reduce_sum(cvec.sum(1, keepdim=True),
                                           agent_group)
        comm_in = (total - cvec) / max(cfg.n_agents - 1, 1)
        e = torch.tanh(proj(p["enc"], obs, fl, plan=plan_of(plans, "enc")))
        h, c = self.lstm_cell(e + comm_in, (h, c), plans, flgw_path)
        logits = proj(p["policy"], h, fl, plan=plan_of(plans, "policy"))
        value = proj(p["value"], h)[..., 0]
        gate_logits = proj(p["gate"], h)
        return logits, value, gate_logits, (h, c)
