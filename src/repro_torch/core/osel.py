"""OSEL, the On-chip Sparse data Encoding Loop (paper section III-B).

Port of ``repro.core.osel``:

1. :func:`encode` produces the *sparse row memory* from the two grouping
   index vectors: per-group bitvectors (at most G of them, observation 2),
   per-group workloads and compact non-zero column ids, plus the per-row
   index list. Metadata is O(G*N + M), never M x N. The bitvectors are
   the comparator array's output for the group ids ``0..G-1`` against
   ``og_idx``, so on the card they come from the ``osel_encode`` kernel.
2. :func:`transpose_encode`: the backward-pass encoder, the same loop with
   the IG/OG roles swapped (the paper's weight-transpose support).
3. :func:`cycle_model` / :func:`footprint_model`: the cycle- and
   byte-accurate model of the FPGA encoder and of the paper's baseline,
   copied unchanged (pure Python). They model the FPGA; they measure
   nothing on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.osel_encode.ops import osel_mask


class SparseRowMemory(NamedTuple):
    """Content of the sparse row memory (one tuple per *group*, obs. 2)."""
    bitvectors: torch.Tensor   # (G, N) bool -- row pattern of each group
    nz_indices: torch.Tensor   # (G, capN) int32 -- compact column ids (padded N)
    workloads: torch.Tensor    # (G,) int32 -- nnz per pattern
    index_list: torch.Tensor   # (M,) int32 -- per-row reference into the cache


def encode(ig_idx: torch.Tensor, og_idx: torch.Tensor, groups: int,
           cap_n: int | None = None) -> SparseRowMemory:
    """All (at most G) row patterns in one pass: the comparator array for
    every group id at once, then the in-group columns of each pattern
    first, in index order (a stable sort), padded with ``N``."""
    n = og_idx.shape[0]
    if cap_n is None:
        cap_n = n
    gid = torch.arange(groups, dtype=torch.int32, device=og_idx.device)
    bitvectors = osel_mask(gid, og_idx) != 0                   # (G, N)
    workloads = bitvectors.sum(1).to(torch.int32)
    # stable sort of ~bitvectors on an integer view: in-group columns first
    order = torch.argsort((~bitvectors).to(torch.uint8), dim=1, stable=True)
    valid = torch.arange(n, device=og_idx.device)[None, :] < workloads[:, None]
    nz = torch.where(valid, order, n).to(torch.int32)[:, :cap_n]
    return SparseRowMemory(bitvectors, nz, workloads,
                           ig_idx.to(torch.int32))


def transpose_encode(ig_idx: torch.Tensor, og_idx: torch.Tensor,
                     groups: int) -> SparseRowMemory:
    """Backward-pass encoder: rows of Mask^T are indexed by og_idx and the
    patterns are drawn from ig_idx -- the same loop with roles swapped."""
    return encode(og_idx, ig_idx, groups)


def mask_from_memory(mem: SparseRowMemory) -> torch.Tensor:
    """Reconstruct the full mask from the sparse row memory (for checks)."""
    return mem.bitvectors[mem.index_list.long()]


# ---------------------------------------------------------------------------
# FPGA cycle / footprint models (Fig. 10)
# ---------------------------------------------------------------------------

def cycle_model(m: int, n: int, g: int, *, use_osel: bool = True,
                compare_width: int = 16, base_max_lanes: int = 3,
                weight_width: int = 32) -> dict[str, float]:
    """Cycle count of on-chip sparse data generation + weight compression
    on the paper's FPGA, with OSEL or with the baseline encoder.

    * Baseline: the max-index scan over the grouping matrices is serial
      in G (``base_max_lanes`` elements a cycle), then the bitvector is
      recomputed for every row (``compare_width`` comparators) and every
      tuple stored.
    * OSEL: the comparator array checks the IG max index against all OG
      max indexes in parallel (ceil(G / compare_width) cycles per scan
      element), the bitvector is computed only on a cache miss (at most
      G misses), a hit costs one index-list append.
    * Weight compression streams the m*n/G unmasked weights at
      ``weight_width`` words a cycle and is common to both.
    """
    compression = (m * n) // g // weight_width
    if use_osel:
        max_index = (m + n) * -(-g // compare_width)
        miss = min(g, m) * max(1, n // compare_width)
        hit = m - min(g, m)
        return {"MaxIndex": max_index, "IndexMiss": miss, "Hit": hit,
                "WeightCompression": compression,
                "total": max_index + miss + hit + compression}
    max_index = (m + n) * g / base_max_lanes    # serial max-index scan
    bitgen = m * max(1, n // compare_width)     # recompute every row
    store = m                                   # store every tuple
    return {"MaxIndex": max_index, "BitvectorGen": bitgen, "Store": store,
            "WeightCompression": compression,
            "total": max_index + bitgen + store + compression}


def footprint_model(m: int, n: int, g: int, *, bytes_per_weight: int = 2,
                    bytes_per_grouping: int = 1,
                    use_grouping: bool = True) -> dict[str, float]:
    """On-chip memory footprint (bytes) of the parameters in actual use on
    the paper's FPGA.

    Dense: the full m*n weight matrix. Grouped: unmasked weights (m*n/g) +
    grouping matrices (m*g + g*n, one byte an entry) + the sparse row
    memory, which holds at most G tuples of (bitvector: n bits, workload:
    ceil(log2 n) bits, max index: ceil(log2 g) bits) plus the m-entry index
    list (ceil(log2 g) bits each).
    """
    if not use_grouping or g <= 1:
        return {"weights": m * n * bytes_per_weight, "grouping": 0,
                "sparse_row_memory": 0,
                "total": m * n * bytes_per_weight}
    weights = (m * n // g) * bytes_per_weight
    grouping = (m * g + g * n) * bytes_per_grouping
    bits_wl = int(np.ceil(np.log2(max(n, 2))))
    bits_g = max(1, int(np.ceil(np.log2(max(g, 2)))))
    srm_bits = g * (n + bits_wl + bits_g) + m * bits_g
    srm = srm_bits / 8.0
    return {"weights": weights, "grouping": grouping,
            "sparse_row_memory": srm,
            "total": weights + grouping + srm}
