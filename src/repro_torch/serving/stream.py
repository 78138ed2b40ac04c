"""Open-loop synthetic request streams for the serving tier.

Port of ``repro.serving.stream``: Geometric(p) arrival gaps (the Traffic
Junction ``arrival_stream`` formula), uniform prompt and generation
lengths from inclusive ranges, uniform prompt token ids. The JAX package
draws them with ``jax.random``, whose stream the port cannot reproduce,
so this draws them from numpy's ``default_rng(seed)``; a comparison of
the two engines hands both the same request list.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.serving.scheduler import Request


def _arrival_ticks(rng: np.random.Generator, n: int,
                  p_arrive: float) -> np.ndarray:
    """(n,) strictly increasing arrival ticks with Geometric(p) gaps, the
    first at tick 0 (``traffic_junction.arrival_stream`` without a cap)."""
    p = min(max(p_arrive, 1e-3), 1.0)
    if p >= 1.0:
        gaps = np.ones(n, np.int64)
    else:
        u = rng.uniform(1e-6, 1.0, n).astype(np.float32)
        gaps = 1 + np.floor(np.log(u) / np.log1p(np.float32(-p))).astype(
            np.int64)
    return np.cumsum(gaps) - gaps[0]


def synthetic_requests(seed: int, n: int, *, vocab: int,
                       p_arrive: float = 0.5,
                       prompt_len: Tuple[int, int] = (4, 12),
                       gen_len: Tuple[int, int] = (2, 16)) -> List[Request]:
    """Draw ``n`` open-loop requests; deterministic in ``seed``."""
    if n < 1:
        return []
    rng = np.random.default_rng(seed)
    arrivals = _arrival_ticks(rng, n, p_arrive)
    plens = rng.integers(prompt_len[0], prompt_len[1] + 1, n)
    glens = rng.integers(gen_len[0], gen_len[1] + 1, n)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, int(plens[i])).astype(
                        np.int32),
                    max_new_tokens=int(glens[i]), arrival=int(arrivals[i]))
            for i in range(n)]


def max_seq_for(requests: List[Request]) -> int:
    """Smallest per-slot ring length that fits every request."""
    return max(len(r.prompt) + r.max_new_tokens for r in requests)
