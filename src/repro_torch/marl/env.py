"""Back-compat shim: Predator-Prey lives in ``repro_torch.marl.envs``.

Port of ``repro.marl.env``. Importing ``repro_torch.marl.env`` warns and
keeps resolving to the Predator-Prey functions; new code goes through
``repro_torch.marl.envs.get(name)``.
"""
import warnings

warnings.warn(
    "repro_torch.marl.env is a back-compat shim; use repro_torch.marl.envs "
    "(e.g. repro_torch.marl.envs.get('predator_prey')) instead.",
    DeprecationWarning, stacklevel=2)

from repro_torch.marl.envs.predator_prey import (  # noqa: E402,F401
    _MOVES,
    N_ACTIONS,
    EnvConfig,
    EnvState,
    n_actions,
    obs_dim,
    observe,
    reset,
    step,
    success,
)
