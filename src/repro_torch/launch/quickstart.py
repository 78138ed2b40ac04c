"""Quickstart: the paper's technique on one layer.

Port of ``examples/quickstart.py``. Builds one FLGW-pruned linear layer,
shows the three execution paths (dense / masked / grouped), the OSEL
sparse metadata, and a few RMSprop steps in which the grouping matrices
learn alongside the weights:

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise: there the
grouped path runs the plan encode and ``grouped_bmm`` kernels, and the
OSEL metadata the mask-encode kernel.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import flgw
from repro_torch.core.osel import encode
from repro_torch.optim.optimizers import rmsprop, rmsprop_init

M, N, G, B = 256, 512, 4, 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((M, N), generator=gen, device=dev) * M ** -0.5
    grouping = flgw.init_grouping(gen, M, N, G)
    ig, og = grouping["ig"], grouping["og"]
    x = torch.randn((B, M), generator=gen, device=dev)

    # --- the mask: O(M*N) index compares, never an IS @ OS matmul --------
    ig_idx, og_idx = flgw.grouping_indices(ig, og)
    sparsity = float(flgw.mask_sparsity(ig_idx, og_idx, groups=G))
    print(f"FLGW G={G}: actual sparsity {sparsity:.3f} "
          f"(expected {1 - 1 / G:.3f})")

    # --- OSEL sparse row memory: <= G tuples describe the whole mask -----
    mem = encode(ig_idx, og_idx, G)
    print(f"OSEL: {mem.bitvectors.shape[0]} cached bitvectors, "
          f"workloads {mem.workloads.tolist()} "
          f"(sum {int(mem.workloads.sum())})")

    # --- three execution paths -------------------------------------------
    with torch.no_grad():
        y_dense = x @ w
        y_masked = flgw.flgw_linear(x, w, ig, og,
                                    flgw.FLGWConfig(groups=G, path="masked"))
        y_grouped = flgw.flgw_linear(x, w, ig, og,
                                     flgw.FLGWConfig(groups=G, path="grouped"))
    masked_err = float((y_masked - y_grouped).abs().max())
    print(f"dense->masked delta {float((y_dense - y_masked).abs().mean()):.4f}"
          f" (masking changes the function)")
    slack = flgw.FLGWConfig().capacity_slack
    print(f"masked vs grouped max|err| {masked_err:.2e} (compact path: "
          f"{G / slack ** 2:.2f}x fewer FLOPs at slack {slack})")

    # --- the grouping matrices TRAIN (the 'fully learnable' part) --------
    cfg = flgw.FLGWConfig(groups=G, path="masked")
    params = {"w": w.clone(), "ig": ig.clone(), "og": og.clone()}
    target = torch.randn((B, N), generator=gen, device=dev)
    opt = rmsprop_init(params)
    losses = []
    for i in range(201):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y = flgw.flgw_linear(x, leaves["w"], leaves["ig"], leaves["og"], cfg)
        loss = ((y - target) ** 2).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params, opt = rmsprop(params, grads, opt, lr=1e-3)
        losses.append(float(loss.detach()))
        if i % 50 == 0:
            moved = float((params["ig"] - ig).abs().mean())
            print(f"step {i:4d} loss {losses[-1]:.4f} |dIG| {moved:.4f}")
    print("grouping matrices received gradient and moved -- mask is learned,"
          " not fixed")
    return dict(sparsity=sparsity, workloads=mem.workloads,
                masked_vs_grouped=masked_err, losses=losses,
                ig_moved=float((params["ig"] - ig).abs().mean()))


if __name__ == "__main__":
    main()
