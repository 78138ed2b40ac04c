"""Flash-attention forward on the CUDA kernel of ``csrc/flash_attention.cu``.

``flash_fwd`` returns ``(out, lse)`` as the TPU kernel's ``flash_fwd``;
``flash_attention`` returns ``out`` and is what the prefill path calls.
There is no backward yet: ``flash_attention`` raises when autograd would
need one, rather than quietly running the plain version.
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hq, S, D); k/v: (B, Hkv, T, D) -> (B, Hq, S, D). Forward
    only: the dq/dkv kernels come with the training slice."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward in repro_torch yet (the dq and "
            "dkv kernels come with the LM training slice); call it under "
            "torch.inference_mode()")
    return flash_fwd(q, k, v, causal=causal, window=window,
                     softcap=softcap)[0]
