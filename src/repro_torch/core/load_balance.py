"""Workload-allocation schemes (paper section III-C, Table I).

Port of ``repro.core.load_balance`` (a copy: the port imports nothing of
``repro``). Three allocators distribute the rows of a masked weight
matrix to C cores:

* :func:`threshold_allocate` -- the paper's *baseline*: walk rows in
  order, filling a core until its assigned non-zero count exceeds
  ``total_nnz / C``, then move to the next core;
* :func:`row_allocate` -- the paper's scheme: deal an equal number of
  *rows* to every core;
* :func:`balanced_allocate` -- the capacity-balanced group assignment of
  ``repro_torch.core.grouped``: every core receives ``capM / C`` rows of
  *each* group.

Each returns the per-core workloads (int64 numpy) so the Table I
deviation metric (max |core_nnz - total_nnz / C|) can be compared. They
take tensors (any device) or numpy arrays; the work is a host loop.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def row_workloads(mask) -> np.ndarray:
    return _np(mask).sum(axis=1)


def threshold_allocate(mask, cores: int) -> np.ndarray:
    """Paper's baseline. Returns nnz per core (len == cores)."""
    wl = row_workloads(mask)
    threshold = wl.sum() / cores
    per_core = np.zeros(cores, dtype=np.int64)
    core = 0
    for w in wl:
        if per_core[core] >= threshold and core < cores - 1:
            core += 1
        per_core[core] += int(w)
    return per_core


def row_allocate(mask, cores: int) -> np.ndarray:
    """Paper's row-based scheme: equal row counts per core (blocks of
    consecutive rows, as the load-allocation unit deals rows in order)."""
    wl = row_workloads(mask)
    per_core = np.zeros(cores, dtype=np.int64)
    splits = np.array_split(np.arange(len(wl)), cores)
    for c, rows in enumerate(splits):
        per_core[c] = int(wl[rows].sum())
    return per_core


def balanced_allocate(row_group, col_group, cores: int,
                      groups: int) -> np.ndarray:
    """Rows dealt per group bucket, so every core receives ``capM/C`` rows
    of *each* group. The remainder row of each group rotates across cores
    (group g's spare goes to core g mod C), so remainders cancel instead
    of piling onto core 0."""
    row_group, col_group = _np(row_group), _np(col_group)
    cols_per_group = np.bincount(col_group, minlength=groups)
    per_core = np.zeros(cores, dtype=np.int64)
    for g in range(groups):
        rows_g = np.where(row_group == g)[0]
        splits = np.array_split(rows_g, cores)
        for c, rows in enumerate(splits):
            per_core[(c + g) % cores] += len(rows) * int(cols_per_group[g])
    return per_core


def deviation(per_core) -> float:
    """Table I metric: max deviation from the theoretical balanced load."""
    per_core = _np(per_core)
    ideal = per_core.sum() / len(per_core)
    return float(np.max(np.abs(per_core - ideal)))
