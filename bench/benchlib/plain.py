"""Plain PyTorch pieces the references share. Nothing here imports the
port: these are the formulas the program's kernels and layers are judged
against, written out again.

* :func:`balanced_groups`: the FLGW grouping of one side, each item's
  group under the capacity-balanced deal (a frozen copy of the lexsort
  oracle's formula: items by argmax group, strength descending, index
  ascending; each group keeps its ``cap`` strongest, the overflow takes
  the free slots in ascending order);
* :class:`Precision`: every matmul of a reference goes through it, in
  float32 (TF32 off) or with its operands rounded to a lower precision,
  which is how the controls are computed;
* :func:`grouped_linear`: ``x @ (W * Mask)`` with the FLGW
  straight-through gradients of the grouped path (dW on the mask, dIG
  and dOG through the softmax at each item's assigned group, fed by the
  row and column sums of ``dW * W`` on the mask);
* the optimizers' updates and the global-norm clip, in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def capacity(m: int, g: int, slack: float) -> int:
    """Each group's slots: ``ceil(m/g)`` stretched by ``slack``."""
    cap = max(1, -(-m // g))
    return min(m, int(-(-cap * slack // 1))) if slack > 1.0 else cap


def balanced_groups(scores: torch.Tensor, slack: float) -> torch.Tensor:
    """(M, G) preference scores -> (M,) int64, each item's group."""
    m, g = scores.shape
    dev = scores.device
    cap = capacity(m, g, slack)
    pref = scores.argmax(1)
    strength = scores.amax(1)
    by_strength = torch.sort(-strength, stable=True).indices
    order = by_strength[torch.sort(pref[by_strength], stable=True).indices]
    pref_sorted = pref[order]
    first = torch.searchsorted(pref_sorted, torch.arange(g, device=dev))
    rank = torch.arange(m, device=dev) - first[pref_sorted]
    keep = rank < cap
    counts = torch.bincount(pref, minlength=g).clamp(max=cap)
    sidx = torch.arange(g * cap, device=dev)
    taken = (sidx % cap) < counts[sidx // cap]
    free = torch.sort(taken.to(torch.int8), stable=True).indices
    ovf = (~keep).cumsum(0) - 1
    slot = torch.where(keep, pref_sorted * cap + rank.clamp(max=cap - 1),
                       free[ovf.clamp(0, g * cap - 1)])
    group = torch.empty(m, dtype=torch.int64, device=dev)
    group[order] = slot // cap
    return group


def argmax_hist(ig: torch.Tensor, og: torch.Tensor):
    """Group sizes of the mask from IG (..., M, G) and OG (..., G, N):
    (rows (..., G), cols (..., G)), int64 on the host."""
    g = ig.shape[-1]
    rows = F.one_hot(ig.argmax(-1), g).sum(-2)
    cols = F.one_hot(og.argmax(-2), g).sum(-2)
    return rows.cpu(), cols.cpu()


# ---------------------------------------------------------------------------
# Precisions
# ---------------------------------------------------------------------------

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), as the tensor cores round a TF32 matmul's operands."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale a tensor (its largest magnitude at
    e4m3's 448), back in float32: an fp8 matmul's operands."""
    x = x.float()
    amax = x.abs().amax()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).float() * s


ROUNDING = {"tf32": round_tf32, "fp8": round_fp8}


class _RoundedMatmul(torch.autograd.Function):
    """(R, K) @ (K, N) with every operand of the forward and of both
    backward products rounded, float32 accumulation."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, gy):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        g = r(gy)
        return g @ r(b).T, r(a).T @ g, None


class Precision:
    """How a reference multiplies: ``"f32"`` (TF32 off), or ``"tf32"`` or
    ``"fp8"``, the operands rounded (the controls)."""

    def __init__(self, name: str = "f32"):
        if name != "f32" and name not in ROUNDING:
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.rnd = ROUNDING.get(name)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(..., K) @ (K, N)."""
        lead = a.shape[:-1]
        a2 = a.reshape(-1, a.shape[-1])
        y = a2 @ b if self.rnd is None else _RoundedMatmul.apply(a2, b,
                                                                 self.rnd)
        return y.reshape(*lead, b.shape[-1])

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a batched product (attention's cores): rounded
        in the forward, straight through in the backward."""
        if self.rnd is None:
            return x
        return x + (self.rnd(x) - x).detach()


def tf32_off() -> None:
    """Float32 matmuls in float32: the references' setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# FLGW
# ---------------------------------------------------------------------------

class _Grouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ig, og, rows, cols, tau, prec):
        ctx.save_for_backward(x, w, ig, og, rows, cols)
        ctx.tau, ctx.prec = tau, prec
        mask = rows[:, None] == cols[None, :]
        return prec.mm(x, w * mask)

    @staticmethod
    def backward(ctx, gy):
        x, w, ig, og, rows, cols = ctx.saved_tensors
        tau, prec = ctx.tau, ctx.prec
        g = ig.shape[-1]
        mask = rows[:, None] == cols[None, :]
        with torch.enable_grad():
            # the products through the precision's own backward
            xs = x.detach().requires_grad_()
            wm = (w * mask).detach().requires_grad_()
            y = prec.mm(xs, wm)
            dx, dwm = torch.autograd.grad(y, (xs, wm), gy)
        dw = dwm * mask
        s = dw * w
        soft_ig = torch.softmax(ig / tau, dim=-1)                 # (M, G)
        pick = F.one_hot(rows, g).to(soft_ig.dtype)
        sel = (soft_ig * pick).sum(-1, keepdim=True)
        dig = (s.sum(1)[:, None] / tau) * sel * (pick - soft_ig)
        soft_og = torch.softmax(og / tau, dim=0)                   # (G, N)
        pick_c = F.one_hot(cols, g).T.to(soft_og.dtype)
        sel_c = (soft_og * pick_c).sum(0, keepdim=True)
        dog = (s.sum(0)[None, :] / tau) * sel_c * (pick_c - soft_og)
        return dx, dw, dig, dog, None, None, None, None


def grouped_linear(x, w, ig, og, rows, cols, tau: float,
                   prec: Precision) -> torch.Tensor:
    """x (..., M) @ (W (M, N) * Mask), Mask[i, j] = rows[i] == cols[j]."""
    lead = x.shape[:-1]
    y = _Grouped.apply(x.reshape(-1, x.shape[-1]), w, ig, og, rows, cols,
                       tau, prec)
    return y.reshape(*lead, w.shape[-1])


def groups_of(ig: torch.Tensor, og: torch.Tensor, slack: float):
    """(row groups (M,), column groups (N,)) of one layer's grouping
    matrices IG (M, G), OG (G, N)."""
    return (balanced_groups(ig.detach(), slack),
            balanced_groups(og.detach().T, slack))


# ---------------------------------------------------------------------------
# Optimizers, float32
# ---------------------------------------------------------------------------

@torch.no_grad()
def rmsprop(params: dict, grads: dict, sq: dict, lr: float, decay: float,
            eps: float) -> None:
    """RMSprop, in place: ``sq = d sq + (1-d) g^2``, ``p -= lr g /
    (sqrt(sq) + eps)``."""
    for k, p in params.items():
        g = grads[k]
        sq[k].mul_(decay).addcmul_(g, g, value=1.0 - decay)
        p.sub_(lr * g / (torch.sqrt(sq[k]) + eps))


@torch.no_grad()
def sumsq(a: torch.Tensor, b: torch.Tensor = None,
          chunk: int = 1 << 25) -> torch.Tensor:
    """The sum of squares of ``a - b`` (of ``a`` without ``b``) in
    float64, a chunk of the flattened tensors at a time (no whole-size
    temporary)."""
    a = a.detach().reshape(-1)
    b = None if b is None else b.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk].float()
        if b is not None:
            d = d - b[i:i + chunk].float()
        total += d.double().square().sum()
    return total


@torch.no_grad()
def clip(grads: dict, max_norm: float) -> None:
    """Scale every gradient, in place, so that their global norm is at
    most ``max_norm``."""
    norm = torch.sqrt(sum(sumsq(g) for g in grads.values()))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0).float()
    for g in grads.values():
        g.mul_(scale)


@torch.no_grad()
def adamw(params: dict, grads: dict, mu: dict, nu: dict, count: int,
          lr: float, b1: float, b2: float, eps: float, wd: float) -> None:
    """AdamW at step ``count`` (from 1), in place, the decay on every
    leaf: ``p -= lr (m/c1) / (sqrt(v/c2) + eps) + lr wd p``."""
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    for k, p in params.items():
        g = grads[k]
        mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
        nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        step = (mu[k] / c1).div_((nu[k] / c2).sqrt_().add_(eps))
        p.mul_(1.0 - lr * wd).sub_(step, alpha=lr)
