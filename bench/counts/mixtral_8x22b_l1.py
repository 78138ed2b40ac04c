"""What one ``mixtral_8x22b_l1`` training step has to compute, from the
cell's shapes and the realised masks: the MFU's FLOPs and the least time
of the forward compact products (the roofline's numerator).

FLOPs are 2 a multiply-add, three times a forward for the forward, dX
and dW of every projection (every input of one carries a gradient here)
and of attention's two products, the recomputation not counted:

* the q, k, v, o projections on the B x S tokens;
* attention's QK^T and PV over the causal pairs within the window;
* the router, and each token's top-k experts' up, gate and down
  products, at each projection's mean mask density over the experts
  (the nonzeros of the masks from IG and OG), T k / E tokens an expert;
* the unembedding over the vocabulary.

A compact product's least time (one launch a projection for all
experts): FLOPs 2 x an expert's rows x its mask's nonzeros at the bf16
peak, bytes (x read once, the nonzero weights read once, y written
once, bf16) at HBM's. Its backward's: dX and dW at as many FLOPs each,
bytes x, dy and the nonzero weights read once, dX and dW's nonzeros
written once.
"""
from benchlib.peaks import BF16_FLOPS, least_seconds

EXPERT = {"up": ("d_model", "moe_d_ff"), "gate": ("d_model", "moe_d_ff"),
          "down": ("moe_d_ff", "d_model")}


def causal_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal mask of length ``s`` keeps, a window
    of ``window`` keys (0: all)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def step(config: dict, traffic: dict, hist: dict) -> dict:
    """``flops``, ``peak_flops`` (bf16's), ``compact_s`` and
    ``compact_bwd_s`` of one step; ``hist``: each FLGW projection's
    (rows, cols) group sizes, by its parameter path, stacked over blocks
    (and experts)."""
    m = config["model"]
    b, s = traffic["batch"], traffic["seq"]
    t = b * s
    d, h, hk, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, k = m["n_experts"], m["top_k"]
    blocks = m["n_layers"] // len(m["pattern"])
    per_expert = t * k / e
    fwd = compact = bwd = 0.0
    for i in range(blocks):
        for j, slot in enumerate(m["pattern"]):
            fwd += 2.0 * t * (d * h * hd + 2 * d * hk * hd + h * hd * d)
            fwd += 4.0 * b * h * hd * causal_pairs(s, slot.get("window", 0))
            fwd += 2.0 * t * d * e
            for name, (rin, rout) in EXPERT.items():
                din, dout = m[rin], m[rout]
                key = f"blocks.slot{j}.moe.{name}"
                if key not in hist:
                    fwd += 2.0 * per_expert * e * din * dout
                    continue
                rows, cols = hist[key]
                nnz = (rows[i] * cols[i]).sum(-1).double()      # an expert
                f = 2.0 * per_expert * float(nnz.sum())
                fwd += f
                nbytes = 2.0 * (per_expert * e * (din + dout)
                                + float(nnz.sum()))
                compact += least_seconds(f, nbytes, BF16_FLOPS)
                nbytes = 2.0 * (per_expert * e * (2 * din + dout)
                                + 2 * float(nnz.sum()))
                bwd += least_seconds(2 * f, nbytes, BF16_FLOPS)
    fwd += 2.0 * t * d * m["vocab"]
    return {"flops": 3.0 * fwd, "peak_flops": BF16_FLOPS,
            "compact_s": compact, "compact_bwd_s": bwd}
