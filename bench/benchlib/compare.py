"""The numbers that decide ``correct`` for a training cell.

The program's first three steps against the plain reference's: each
step's loss, each leaf's norm of the first gradient as the optimizer got
it, and each leaf's norm of the parameters' change after the steps. A
norm is compared by its gap, ``|program - reference|``, over the larger
of the reference leaf's norm and the median leaf's (some gradients are
all but zero), and the worst leaf is the number.
"""
from __future__ import annotations

import math
import statistics

import torch

from benchlib import plain

QUIET = 1e-3      # a leaf whose reference gradient is under this share
                  # of the median leaf's moves by round-off alone


def loss_gap(program, reference) -> float:
    """The widest relative gap of the steps' losses."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def first_loss_gap(program, reference) -> float:
    """The relative gap of the first step's loss: the forward from the
    same weights, before any update rounds into them."""
    return abs(program[0] - reference[0]) / abs(reference[0])


def quiet_leaves(ref_grad_norms: dict) -> set:
    """Leaves whose reference gradient is nought to rounding: under
    :data:`QUIET` of the median leaf's."""
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v < QUIET * med}


def leaf_gap(program: dict, reference: dict, skip=()) -> tuple:
    """(worst gap, its leaf) over the leaves of ``reference`` not in
    ``skip``."""
    keys = [k for k in reference if k not in skip]
    med = statistics.median(reference[k] for k in keys)
    worst, leaf = 0.0, None
    for k in keys:
        floor = max(reference[k], med)
        gap = abs(program[k] - reference[k]) / floor if floor > 0 else \
            abs(program[k] - reference[k])
        if not gap <= worst:          # NaN counts as the worst
            worst, leaf = gap, k
            if math.isnan(gap):
                break
    return worst, leaf


def diff_norm(a: torch.Tensor, b: torch.Tensor = None) -> float:
    """The L2 norm of ``a - b`` (of ``a`` without ``b``), chunked."""
    return float(plain.sumsq(a, b).sqrt())


def training_gaps(measured: dict, ref: dict) -> dict:
    """The numbers of a training comparison: ``loss_gap``,
    ``first_loss_gap``, ``grad_gap`` and ``change_gap`` (the quiet
    leaves left out of the change), with the worst leaves and the losses
    beside them (keys starting with ``_``); a cell's limits say which
    of the four it compares."""
    quiet = quiet_leaves(ref["grad_norms"])
    grad, grad_leaf = leaf_gap(measured["grad_norms"], ref["grad_norms"])
    change, change_leaf = leaf_gap(measured["change_norms"],
                                   ref["change_norms"], quiet)
    return {"loss_gap": loss_gap(measured["losses"], ref["losses"]),
            "first_loss_gap": first_loss_gap(measured["losses"],
                                             ref["losses"]),
            "grad_gap": grad, "change_gap": change,
            "_worst": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "quiet": sorted(quiet)},
            "_losses": {"program": measured["losses"],
                        "reference": ref["losses"]}}
