"""ic3net -- the paper's own network (Singh et al., ICLR'19, as used by
LearningGroup section IV-A): per-agent LSTM policy with a gated
communication layer, hidden 128, on Predator-Prey. The same two configs
as ``repro.configs.ic3net``."""
from repro_torch.marl.ic3net import IC3NetConfig


def config() -> IC3NetConfig:
    return IC3NetConfig(hidden=128, n_agents=8, flgw_groups=1)


def smoke() -> IC3NetConfig:
    return IC3NetConfig(hidden=32, n_agents=3, flgw_groups=2)
