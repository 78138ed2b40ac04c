"""What one ``ic3net_pp_medium`` learner iteration has to compute, from the
cell's shapes and the realised masks: the MFU's FLOPs and the least time
of the forward compact products (the roofline's numerator).

A policy step runs seven projections on the B x A agent rows: the
encoder, the LSTM's input and hidden projections, the communication
projection, and the policy, value and gate heads; with FLGW the first
five carry masks. The MFU counts 2 FLOPs a multiply-add of every
projection's forward at its mask's density (the nonzeros of the mask
from IG and OG), its dW where the loss reaches the weight (not the gate
head's: the loss takes no gate log-probability) and its dX where the
input carries a gradient (not the encoder's observations, not the
communication's detached hidden state, not the gate head's); elementwise
work is not counted. A compact product's least time: FLOPs
2 x rows x the mask's nonzeros at the float32 peak, bytes (x read once,
the nonzero weights read once, y written once, float32) at HBM's. Its
backward's: dW (and dX where the input carries a gradient) at as many
FLOPs each, bytes x and dy read once, the nonzero weights read once
where dX is due, dW's nonzeros and dX written once.
"""
from benchlib.peaks import F32_FLOPS, least_seconds

DW = ("enc", "lstm_x", "lstm_h", "comm", "policy", "value")
DX = ("lstm_x", "lstm_h", "policy", "value")


def dims(m: dict) -> dict:
    h = m["hidden"]
    return {"enc": (m["obs_dim"], h), "lstm_x": (h, 4 * h),
            "lstm_h": (h, 4 * h), "comm": (h, h),
            "policy": (h, m["n_actions"]), "value": (h, 1), "gate": (h, 2)}


def nonzeros(rows, cols) -> int:
    """The mask's nonzeros from its groups' sizes."""
    return int((rows * cols).sum())


def step(config: dict, traffic: dict, hist: dict) -> dict:
    """``flops``, ``peak_flops`` (float32's), ``compact_s`` and
    ``compact_bwd_s`` of one learner iteration; ``hist``: each FLGW
    layer's (rows, cols) group sizes (none on the dense path)."""
    m = config["model"]
    rows = traffic["batch"] * m["n_agents"]
    flops = compact = bwd = 0.0
    for name, (a, b) in dims(m).items():
        nnz = nonzeros(*hist[name]) if name in hist else a * b
        fwd = 2.0 * rows * nnz
        flops += fwd * (1 + (name in DW) + (name in DX))
        if name in hist:
            compact += least_seconds(fwd, 4.0 * (rows * a + nnz + rows * b),
                                     F32_FLOPS)
            dx = name in DX
            bwd += least_seconds(
                fwd * (1 + dx),
                4.0 * (rows * a * (1 + dx) + rows * b + nnz * (1 + dx)),
                F32_FLOPS)
    return {"flops": flops * m["max_steps"], "peak_flops": F32_FLOPS,
            "compact_s": compact * m["max_steps"],
            "compact_bwd_s": bwd * m["max_steps"]}
