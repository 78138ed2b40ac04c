"""Flash attention on the CUDA kernels of ``csrc/flash_attention.cu``.

``flash_fwd`` returns ``(out, lse)`` and ``flash_bwd`` ``(dq, dk, dv)``,
as the TPU package's functions of those names. ``flash_attention``
returns ``out`` and is what the model calls: a ``torch.autograd.Function``
whose forward is ``flash_fwd`` and whose backward is ``flash_bwd`` (the
``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels), so neither pass stores
the (S, T) logits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import KernelEntry, on_cpu
from repro_torch.kernels.flash_attention import ref as _ref

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FWD = KernelEntry("flash_attention", "flash_fwd",
                  [_P, _P, _P, _P, _P, *[_I] * 6, *[_L] * 9,
                   _F, _I, _I, _F, _I])
_BWD_ARGS = [*[_I] * 6, _F, _I, _I, _F, _I]
DQ = KernelEntry("flash_attention", "flash_bwd_dq", [*[_P] * 7, *_BWD_ARGS])
DKV = KernelEntry("flash_attention", "flash_bwd_dkv", [*[_P] * 8, *_BWD_ARGS])
MAX_HEAD_DIM = 256


def _check(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype or x.dim() != 4 or x.stride(-1) != 1:
        raise ValueError(
            f"{name}: the kernel takes a 4-d {dtype} tensor with a unit last "
            f"stride, got {x.dtype} of shape {tuple(x.shape)} and strides "
            f"{x.stride()}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, S, D); k/v: (B, Hkv, T, D) -> (out, lse). bf16 or f32
    on the card, D a multiple of 4 up to 256; see
    :func:`ref.ref_flash_fwd`."""
    if on_cpu(q, k, v):
        return _ref.ref_flash_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q: the kernel takes bf16 or float32, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.dtype)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape or hq % hkv \
            or not 0 < d <= MAX_HEAD_DIM or d % 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit (Hq a multiple of "
                         f"Hkv, D a multiple of 4 up to {MAX_HEAD_DIM})")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if out.numel():
        FWD(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, hq, hkv, s, t, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            d ** -0.5, int(causal), int(window), float(softcap),
            int(q.dtype == torch.bfloat16))
    return out, lse


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of :func:`flash_fwd`'s ``out`` (with its
    ``lse``) given the cotangent ``do``; see :func:`ref.ref_flash_bwd`.
    On the card ``delta = sum(do * out)`` is a torch op, then
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` run on contiguous copies."""
    if on_cpu(q, k, v, out, lse, do):
        return _ref.ref_flash_bwd(q, k, v, out, lse, do, causal=causal,
                                  window=window, softcap=softcap)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q: the kernel takes bf16 or float32, got {q.dtype}")
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check(name, x, q.dtype)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape or hq % hkv \
            or do.shape != q.shape or out.shape != q.shape \
            or lse.shape != (b, hq, s) or not 0 < d <= MAX_HEAD_DIM or d % 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, out {tuple(out.shape)}, lse "
                         f"{tuple(lse.shape)} and do {tuple(do.shape)} do "
                         "not fit")
    lse = lse.float().contiguous()
    delta = _ref.delta_of(out, do).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    opts = (d ** -0.5, int(causal), int(window), float(softcap),
            int(q.dtype == torch.bfloat16))
    dims = (b, hq, hkv, s, t, d)
    if dq.numel():
        DQ(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims, *opts)
    if dk.numel():
        DKV(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *dims, *opts)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``out`` of :func:`flash_fwd`; the backward is :func:`flash_bwd` on
    the saved ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window,
                             softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, T, D) -> (B, Hq, S, D),
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, float(softcap))
