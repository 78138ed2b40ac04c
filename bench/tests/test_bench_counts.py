"""The counts the MFU and roofline metrics divide by, against hand counts
at small shapes; the trace's reduction and the readers on a made-up
window."""
import pytest
import torch

from bench_small import BENCH  # noqa: F401  (puts bench/ on the path)
from benchlib import harness, peaks, readers, trace

IC3 = harness.load_module("counts", "ic3net_pp_medium")
LM = harness.load_module("counts", "mixtral_8x22b_l1")


def test_ic3net_iteration_by_hand():
    config = {"model": {"hidden": 2, "obs_dim": 3, "n_actions": 2,
                        "n_agents": 2, "max_steps": 2}}
    traffic = {"batch": 3}
    rows = 6                                        # 3 envs x 2 agents
    dense = IC3.step(config, traffic, {})
    # (M, N) of enc 3x2, lstm_x 2x8, lstm_h 2x8, comm 2x2, policy 2x2,
    # value 2x1, gate 2x2; forward x1, dW for all but gate, dX for
    # lstm_x, lstm_h, policy, value
    per = {"enc": (6, 2), "lstm_x": (16, 3), "lstm_h": (16, 3),
           "comm": (4, 2), "policy": (4, 3), "value": (2, 3), "gate": (4, 1)}
    want = sum(2 * rows * mn * k for mn, k in per.values()) * 2
    assert dense["flops"] == want and dense["compact_s"] == 0
    # a mask with groups of sizes rows (2, 1), cols (1, 1) on enc: 3 nonzeros
    hist = {"enc": (torch.tensor([2, 1]), torch.tensor([1, 1]))}
    got = IC3.step(config, traffic, hist)
    assert got["flops"] == want - 2 * 2 * rows * (6 - 3) * 2
    fwd = 2 * rows * 3
    nbytes = 4 * (rows * 3 + 3 + rows * 2)
    assert got["compact_s"] == pytest.approx(
        2 * max(fwd / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES))
    # the encoder's input is the observations: its backward is dW alone
    # (x and dy read, dW's 3 nonzeros written)
    nbytes = 4 * (rows * 3 + rows * 2 + 3)
    assert got["compact_bwd_s"] == pytest.approx(
        2 * max(fwd / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES))
    assert got["peak_flops"] == peaks.F32_FLOPS
    # lstm_h (2 x 8) with groups rows (1, 1), cols (4, 4): 8 nonzeros, and
    # its input carries a gradient: dX and dW
    hist = {"lstm_h": (torch.tensor([1, 1]), torch.tensor([4, 4]))}
    got = IC3.step(config, traffic, hist)
    fwd = 2 * rows * 8
    nbytes = 4 * (2 * rows * 2 + rows * 8 + 2 * 8)
    assert got["compact_bwd_s"] == pytest.approx(
        2 * max(2 * fwd / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES))


def test_causal_pairs():
    assert LM.causal_pairs(4, 0) == 10
    assert LM.causal_pairs(4, 8) == 10
    assert LM.causal_pairs(5, 2) == 1 + 2 * 4


def _lm(d=4, ff=6, e=2, k=1, v=10):
    return {"model": {"d_model": d, "n_heads": 2, "n_kv_heads": 1,
                      "head_dim": 2, "n_experts": e, "top_k": k,
                      "moe_d_ff": ff, "vocab": v, "n_layers": 1,
                      "pattern": [{"window": 0}]}}


def test_lm_step_by_hand():
    b, s = 1, 3
    t = b * s
    got = LM.step(_lm(), {"batch": b, "seq": s}, {})
    attn = 2 * t * (4 * 4 + 2 * 4 * 2 + 4 * 4)
    core = 4 * b * 2 * 2 * 6                       # 6 causal pairs
    router = 2 * t * 4 * 2
    experts = 2 * t * 1 * (4 * 6 * 3)              # T k rows, 3 products
    unembed = 2 * t * 4 * 10
    assert got["flops"] == 3 * (attn + core + router + experts + unembed)
    assert got["compact_s"] == 0


def test_lm_step_counts_the_masks_nonzeros():
    b, s = 2, 2
    cfg, traffic = _lm(), {"batch": b, "seq": s}
    dense = LM.step(cfg, traffic, {})["flops"]
    # every projection's two experts with groups (1, 3) x (3, 3): nnz
    # 1*3 + 3*3 = 12 of 24 for up/gate (4 x 6), and the same for down
    rows = torch.tensor([[[1, 3], [1, 3]]])
    cols = torch.tensor([[[3, 3], [3, 3]]])
    hist = {f"blocks.slot0.moe.{n}": (rows, cols)
            for n in ("up", "gate", "down")}
    got = LM.step(cfg, traffic, hist)
    per_expert = b * s * 1 / 2                     # T k / E
    saved = 3 * 2 * per_expert * 2 * (24 - 12) * 3
    assert got["flops"] == pytest.approx(dense - saved)
    f = 2 * per_expert * 24                        # both experts' nnz
    nbytes = 2 * (per_expert * 2 * (4 + 6) + 24)
    assert got["compact_s"] == pytest.approx(
        3 * max(f / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES))
    # the backward: dX and dW, x, dy and the weights read, dX and dW
    # written, for up, gate (4 -> 6) and down (6 -> 4)
    want = sum(max(2 * f / peaks.BF16_FLOPS,
                   2 * (per_expert * 2 * (2 * a + b) + 2 * 24)
                   / peaks.HBM_BYTES)
               for a, b in ((4, 6), (4, 6), (6, 4)))
    assert got["compact_bwd_s"] == pytest.approx(want)
    assert got["peak_flops"] == peaks.BF16_FLOPS


def test_union_gaps_and_labels():
    dev = [(0, 10), (5, 15), (20, 30), (40, 45)]
    assert trace.union_seconds(dev) == pytest.approx(30e-6)
    gaps = trace.idle_gaps(dev, 0, 50)
    assert gaps == [(15, 20), (30, 40), (45, 50)]
    host = [("train_step", 0, 50), ("aten::mul", 14, 22),
            ("cudaLaunchKernel", 16, 19)]
    got = trace.label_gaps(gaps, host)
    assert got == {"train_step > aten::mul": pytest.approx(5e-6),
                   "train_step": pytest.approx(15e-6)}
    assert trace.label_gaps([(1, 3)], []) == {"(python)": 2e-6}


def test_readers_on_a_window():
    win = trace.Window(iters=2, window_s=1.0, busy_s=0.25, kernels=10,
                       by_kernel={"grouped_bmm_f32_kernel": 0.1,
                                  "plan_assign_kernel": 0.002},
                       by_op={}, host_iters=1,
                       fwd_by_kernel={"grouped_bmm_f32_kernel": 0.02},
                       by_scope={"_GroupedCoreBackward": 0.1})
    ctx = harness.Context(window=win, count={
        "flops": 67e12 * 0.01, "peak_flops": peaks.F32_FLOPS,
        "compact_s": 0.005, "compact_bwd_s": 0.01}, peak_bytes=2e9)
    assert readers.idle_percent(ctx) == 75.0
    assert readers.kernels_per_iter(ctx) == 5.0
    assert readers.mfu_percent(ctx) == pytest.approx(2.0)
    assert readers.roofline_percent(
        ctx, ("grouped_bmm_f32_kernel",)) == pytest.approx(25.0)
    assert readers.roofline_percent(ctx, ("grouped_bmm_tma_kernel",)) is None
    assert readers.scope_roofline_percent(
        ctx, "_GroupedCoreBackward", "compact_bwd_s") == pytest.approx(10.0)
    assert readers.scope_roofline_percent(
        ctx, "_Other", "compact_bwd_s") is None
    assert readers.device_ms_per_iter(ctx, readers.PLAN_ENCODE) == 1.0
    assert readers.peak_gb(ctx) == 2.0
    for name in ("grouped_bmm_f32_roofline", "plan_encode_ms.marl",
                 "mfu.marl", "mfu.lm", "device_idle.lm",
                 "grouped_bwd_roofline.marl"):
        assert harness.metric_reader(name).read(ctx) > 0


def test_a_split_metric_is_read_by_the_file_of_its_stem():
    assert harness.metric_reader("mfu.lm") is harness.metric_reader("mfu")
    assert harness.metric_reader("grouped_bmm_f32_roofline").KERNELS == (
        "grouped_bmm_f32_kernel",)
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.marl")


class _Ev:
    """A made-up profiler event: host op or device kernel."""

    def __init__(self, name, parent=None, kernels=(), device=False):
        from torch.autograd import DeviceType
        self.name, self.cpu_parent = name, parent
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.kernels = [type("K", (), {"name": n, "duration": d})()
                        for n, d in kernels]


def test_kernels_split_into_forward_and_backward_scopes():
    step = _Ev("train_step")
    fwd = _Ev("_GroupedCore", step,
              [("void grouped_bmm_f32_kernel<64>(float const*)", 10.0)])
    engine = _Ev(trace.BACKWARD + "_GroupedCoreBackward", step)
    inner = _Ev("_GroupedCoreBackward", engine)
    bmm = _Ev("aten::bmm", inner, [("sm80_xmma_gemm_f32", 30.0),
                                    ("Memcpy DtoD", 5.0)])
    remat = _Ev(trace.BACKWARD + "CheckpointFunctionBackward", step)
    again = _Ev("_GroupedCore", remat,
                [("void grouped_bmm_f32_kernel<64>(float const*)", 10.0)])
    launch = _Ev("cudaLaunchKernel", fwd, [("ignored", 99.0)])
    events = [step, fwd, engine, inner, bmm, remat, again, launch,
              _Ev("kernel", device=True)]
    got_fwd, scope = trace._launched(events, {"train_step"})
    assert got_fwd == {"grouped_bmm_f32_kernel": pytest.approx(10e-6)}
    assert scope["_GroupedCoreBackward"] == pytest.approx(35e-6)
    assert scope[trace.BACKWARD] == pytest.approx(45e-6)
    assert scope[trace.LINKED] == pytest.approx(55e-6)
    assert scope["train_step"] == pytest.approx(55e-6)
