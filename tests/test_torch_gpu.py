"""Card-only tests of the port's CUDA kernels and of the slice on the card.

Run on a machine with a CUDA card: ``pytest -m gpu tests/test_torch_*.py``.
Without one every test here skips (decided inside the fixture).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

from repro_torch.configs import ic3net as configs  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.flgw_matmul import ref as fm_ref  # noqa: E402
from repro_torch.kernels.plan_encode import ops as pe_ops  # noqa: E402
from repro_torch.kernels.plan_encode import ref as pe_ref  # noqa: E402
from repro_torch.kernels.tiling import compute_cap  # noqa: E402
from repro_torch.marl import envs, ic3net, train  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("lead,m,g,slack,block", [
    ((), 30, 4, 1.25, None), ((), 512, 4, 1.25, None),
    ((2,), 1000, 8, 1.5, None), ((3,), 300, 3, 1.25, 128),
    ((), 5, 4, 1.0, None), ((), 2048, 16, 1.25, 1024)])
def test_plan_encode_kernels_are_bitwise_their_plain_versions(
        cuda, lead, m, g, slack, block):
    gen = torch.Generator(device=cuda).manual_seed(m)
    scores = torch.randn((*lead, m, g), generator=gen, device=cuda)
    pref, strength, bi = pe_ops.preferences(scores, 1, block)
    cap = compute_cap(m, g, slack)
    before = (pe_ops.RANK.launches, pe_ops.PLACE.launches)
    rk, hist = pe_ops.rank(pref, strength, g, bi)
    slot = pe_ops.place(pref, rk, hist, g, cap)
    torch.cuda.synchronize()
    assert (pe_ops.RANK.launches, pe_ops.PLACE.launches) == (
        before[0] + 1, before[1] + 1)
    rk_ref, hist_ref = pe_ref.ref_rank(pref, strength, g, bi)
    assert torch.equal(rk, rk_ref) and torch.equal(hist, hist_ref)
    assert torch.equal(slot, pe_ref.ref_place(pref, rk, hist, g, cap))
    ids, _ = pe_ref.ids_from_slots(slot[:, :m], m, g, cap)
    flat = scores.reshape(-1, m, g)
    for layer, want in enumerate(flat):
        assert torch.equal(ids.reshape(-1, g, cap)[layer],
                           pe_ref.ref_balanced_assign(want, slack))


def _assign_case(case, gen, cuda):
    """(scores, axis) of one plan_assign card case."""
    kind, lead, m, g = case
    shape = (*lead, m, g)
    if kind == "ties":         # many exactly tied argmaxes and strengths
        s = torch.randint(-1, 2, shape, generator=gen, device=cuda).float()
    elif kind == "zeros":      # strengths tie across the sign of zero
        s = torch.where(torch.rand(shape, generator=gen, device=cuda) < 0.5,
                        -0.0, 0.0)
        s[torch.rand(shape, generator=gen, device=cuda) < 0.2] = -1.0
    else:
        s = torch.randn(shape, generator=gen, device=cuda)
    if kind in ("cols", "strided"):
        s = s.transpose(-1, -2).contiguous()          # og: (..., G, N)
        return (s, 0) if kind == "cols" else (s.transpose(-1, -2), 1)
    return s, 1


# IC3Net's five FLGW layers' sides (rows of ig, columns of og), gemma2-2b's
# L = 26 sides at G = 4 (attention and MLP widths, both axes), the route's
# limits (its corner, the most items in the most groups, takes the most
# shared memory), ties, signed zeros and a strided og view (og.T read in place)
ASSIGN_CASES = [
    *[("rows", (), m, 4) for m in (30, 128)],
    *[("cols", (), n, 4) for n in (128, 512, 5)],
    *[("rows", (26,), m, 4) for m in (2304, 9216)],
    *[("cols", (26,), n, 4) for n in (1024, 2048, 2304, 9216)],
    ("rows", (), pe_ops.SORT_MAX_ITEMS, 4),
    ("rows", (), pe_ops.SORT_MAX_ITEMS, pe_ops.SORT_MAX_GROUPS),
    ("rows", (), 4096, 1),
    ("rows", (2,), 4097, pe_ops.SORT_MAX_GROUPS), ("rows", (3,), 700, 3),
    ("ties", (2,), 3000, 4), ("ties", (), 100, 8), ("zeros", (2,), 600, 4),
    ("zeros", (), 9216, 2), ("strided", (), 512, 4),
    ("strided", (26,), 2304, 4),
    # the dense family's d_ff sides in the largest tier (10,241-16,384
    # items): gemma3-12b's 15,360 and internlm2-20b's and paligemma-3b's
    # 16,384 (which fills it), at L = 2 and at paligemma's 18 layers
    *[(kind, (l,), m, 4) for kind in ("rows", "cols")
      for l in (2, 18) for m in (15360, 16384)]]


@pytest.mark.parametrize("slack", [1.0, 1.25])
@pytest.mark.parametrize("case", ASSIGN_CASES, ids=str)
def test_plan_assign_is_bitwise_its_plain_version(cuda, case, slack):
    gen = torch.Generator(device=cuda).manual_seed(case[2])
    scores, axis = _assign_case(case, gen, cuda)
    m, g = case[2], case[3]
    assert pe_ops.assign_route(m, g) == "sort"
    before = (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
              pe_ops.PLACE.launches)
    ids, group = pe_ops.assign(scores, axis, slack)
    torch.cuda.synchronize()
    assert (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
            pe_ops.PLACE.launches) == (before[0] + 1, *before[1:])
    want_ids, want_group = pe_ref.ref_assign(scores, axis, slack)
    cap = compute_cap(m, g, slack)
    assert torch.equal(ids.reshape(-1, g * cap), want_ids)
    assert torch.equal(group.reshape(-1, m), want_group)
    rows = scores if axis else scores.transpose(-1, -2)
    for layer, s in enumerate(rows.reshape(-1, m, g)):
        assert torch.equal(ids.reshape(-1, g, cap)[layer],
                           pe_ref.ref_balanced_assign(s, slack))


def test_past_the_sort_limit_the_tiled_route_runs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for m, g in ((pe_ops.SORT_MAX_ITEMS + 1, 4),
                 (3000, pe_ops.SORT_MAX_GROUPS + 1)):
        assert pe_ops.assign_route(m, g) == "tiled"
        scores = torch.randn((m, g), generator=gen, device=cuda)
        before = (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
                  pe_ops.PLACE.launches)
        ids, group = pe_ops.assign(scores, 1, 1.25)
        torch.cuda.synchronize()
        assert (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
                pe_ops.PLACE.launches) == (before[0], before[1] + 1,
                                           before[2] + 1)
        want_ids, want_group = pe_ref.ref_assign(scores, 1, 1.25)
        assert torch.equal(ids.reshape(1, -1), want_ids)
        assert torch.equal(group.reshape(1, -1), want_group)
        assert torch.equal(ids, pe_ref.ref_balanced_assign(scores, 1.25))


def test_plan_assign_entry_refuses_what_the_shapes_do_not_allow(cuda):
    """The C entry never takes a side past its limits (those go to the
    tiled route), nor a capacity that cannot hold every item; the wrapper
    takes only f32 scores."""
    s = torch.randn((pe_ops.SORT_MAX_ITEMS + 1) * 4, device=cuda)
    ids = torch.empty(pe_ops.SORT_MAX_ITEMS * 8, dtype=torch.int64,
                      device=cuda)
    group = torch.empty_like(ids)
    for m, g, cap in ((pe_ops.SORT_MAX_ITEMS + 1, 4, 4097),
                      (8, pe_ops.SORT_MAX_GROUPS + 1, 1), (100, 4, 24),
                      (0, 4, 1)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            pe_ops.ASSIGN(cuda, s.data_ptr(), ids.data_ptr(),
                          group.data_ptr(), 1, m, g, cap, m * g, g, 1)
    with pytest.raises(ValueError, match="float32"):
        pe_ops.assign(torch.randn((30, 4), device=cuda).double(), 1)


@pytest.mark.parametrize("g,b,k,n", [(4, 128, 10, 40), (4, 128, 40, 160),
                                     (4, 128, 40, 3), (1, 7, 17, 65),
                                     (3, 130, 1, 64), (2, 64, 64, 64),
                                     # 32-row blocks' edges, 32 columns
                                     (4, 64, 40, 160), (4, 65, 40, 160),
                                     (4, 72, 40, 160), (1, 128, 40, 160),
                                     # K = 8; 720 and 2880 through the
                                     # 2-stage ring; N = 45 (4-byte
                                     # copies), 136, 720 and 2880 (64
                                     # columns past one wave)
                                     (2, 128, 8, 40), (4, 128, 720, 160),
                                     (1, 256, 2880, 720), (2, 128, 40, 45),
                                     (2, 100, 40, 136), (4, 128, 40, 720),
                                     (1, 64, 64, 2880)])
def test_grouped_bmm_matches_its_plain_version(cuda, g, b, k, n):
    gen = torch.Generator(device=cuda).manual_seed(b + k + n)
    xg = torch.randn((g, b, k), generator=gen, device=cuda)
    wc = torch.randn((g, k, n), generator=gen, device=cuda)
    if k > 64:
        # weights at the model's init scale, so that sums of K terms stay
        # O(1) against the fixed tolerance of f32 sums in another order
        wc *= k ** -0.5
    before = fm_ops.BMM.launches
    y = fm_ops.grouped_bmm(xg, wc)
    torch.cuda.synchronize()
    assert fm_ops.BMM.launches == before + 1
    torch.testing.assert_close(y, fm_ref.ref_grouped_bmm(xg, wc),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,b,k,n", [(4, 4096, 720, 2880),
                                     (4, 4096, 2880, 720),
                                     (4, 4, 720, 2880), (3, 70, 37, 45),
                                     (2, 130, 48, 136), (1, 7, 17, 65),
                                     # the routes' boundary: wmma at 64
                                     # rows, TMA at 65 and 72
                                     (4, 64, 720, 640), (4, 65, 720, 640),
                                     (4, 72, 720, 640),
                                     # K = 8; N = 45 (wmma); G = 1 with K
                                     # and N ragged against the 64-deep
                                     # k-tile and the 256-wide column tile
                                     (2, 200, 8, 136), (2, 300, 720, 45),
                                     (1, 300, 200, 328),
                                     (1, 1000, 2880, 2880)])
def test_grouped_bmm_bf16_matches_its_plain_version(cuda, g, b, k, n):
    gen = torch.Generator(device=cuda).manual_seed(b + k + n)
    xg = torch.randn((g, b, k), generator=gen, device=cuda).bfloat16()
    wc = torch.randn((g, k, n), generator=gen, device=cuda).bfloat16()
    before = (fm_ops.BMM16.launches, fm_ops.BMM.launches)
    y = fm_ops.grouped_bmm(xg, wc)
    torch.cuda.synchronize()
    assert (fm_ops.BMM16.launches, fm_ops.BMM.launches) == (before[0] + 1,
                                                           before[1])
    assert y.dtype == torch.bfloat16 and y.shape == (g, b, n)
    # f32 sums in another order, then one bf16 rounding each (2**-8)
    torch.testing.assert_close(y.float(), fm_ref.ref_grouped_bmm(xg, wc)
                               .float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_bmm_on_unaligned_views_matches_its_plain_version(cuda,
                                                                  dtype):
    """Operands that are contiguous views one element into their storage:
    bf16 then takes the wmma route, f32 the 4-byte copies."""
    g, b, k, n = 2, 300, 720, 720
    gen = torch.Generator(device=cuda).manual_seed(1)
    xg = torch.randn((g * b * k + 1,), generator=gen, device=cuda).to(
        dtype)[1:].view(g, b, k)
    wc = (torch.randn((g * k * n + 1,), generator=gen, device=cuda)
          * k ** -0.5).to(dtype)[1:].view(g, k, n)
    assert xg.data_ptr() % 16 and wc.data_ptr() % 16
    assert fm_ops.bmm_bf16_route(b, k, n, False) == fm_ops.WMMA
    y = fm_ops.grouped_bmm(xg, wc)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), fm_ref.ref_grouped_bmm(xg, wc)
                               .float(), rtol=tol, atol=tol)


def test_grouped_bmm_entries_refuse_what_the_shapes_do_not_allow(cuda):
    """The C entries never pick another route: the TMA route at 64 rows,
    at a K or N not a multiple of 8 or on an unaligned operand, an unknown
    route, and an f32 tile width other than 32 or 64 raise; the wmma route
    takes any shape, the train MLP's up included."""
    def call(entry, xg, wc, b, k, n, route):
        y = torch.empty((xg.shape[0], b, n), dtype=xg.dtype, device=cuda)
        entry(cuda, xg.data_ptr(), wc.data_ptr(), y.data_ptr(), xg.shape[0],
              b, k, n, route)
        return y

    gen = torch.Generator(device=cuda).manual_seed(2)
    for b, k, n, off in ((64, 720, 640, 0), (200, 36, 640, 0),
                         (200, 720, 45, 0), (200, 720, 640, 1)):
        xg = torch.randn((b * k + off,), generator=gen, device=cuda)
        xg = xg.bfloat16()[off:].view(1, b, k)
        wc = torch.randn((1, k, n), generator=gen, device=cuda).bfloat16()
        with pytest.raises(RuntimeError, match="invalid argument"):
            call(fm_ops.BMM16, xg, wc, b, k, n, fm_ops.TMA)
    with pytest.raises(RuntimeError, match="invalid argument"):
        call(fm_ops.BMM16, xg, wc, 200, 720, 640, 2)
    x32 = torch.randn((1, 128, 40), generator=gen, device=cuda)
    w32 = torch.randn((1, 40, 160), generator=gen, device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        call(fm_ops.BMM, x32, w32, 128, 40, 160, 48)
    xg = torch.randn((4, 4096, 720), generator=gen, device=cuda).bfloat16()
    wc = torch.randn((4, 720, 2880), generator=gen, device=cuda).bfloat16()
    y = call(fm_ops.BMM16, xg, wc, 4096, 720, 2880, fm_ops.WMMA)
    torch.testing.assert_close(y.float(), fm_ref.ref_grouped_bmm(xg, wc)
                               .float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,softcap,causal,scale", [
    (1, 8, 4, 1024, 256, 4096, 50.0, True, None),
    (1, 8, 4, 1024, 256, 0, 0.0, True, None),
    (2, 8, 4, 512, 256, 128, 50.0, True, None),
    (2, 8, 4, 200, 256, 0, 50.0, True, None),      # ragged S
    (1, 4, 4, 130, 64, 40, 0.0, True, None),
    (2, 4, 2, 96, 128, 7, 30.0, False, None),
    # the bf16 tensor-core passes' edges: dkv's 64-key tiles with 2 x 32
    # queries a step, dq's 64-query tiles with 2 x 32 keys a step, D split
    # over two warpgroups
    (1, 8, 2, 300, 256, 100, 50.0, True, None),    # qpk 4, window edge
    (2, 2, 2, 77, 128, 0, 30.0, True, None),       # qpk 1, S = 77
    (1, 4, 2, 161, 64, 33, 0.0, False, None),      # window without causal
    (1, 2, 1, 70, 32, 0, 0.0, True, None),         # D below a half
    (1, 4, 2, 90, 20, 0, 50.0, True, None),        # D % 16: FP32 FMA
    (1, 4, 2, 130, 256, 0, 50.0, True, None),      # 2 queries past 2 tiles
    (2, 8, 2, 257, 256, 90, 50.0, True, None),     # qpk 4, window in a tile
    (1, 4, 4, 192, 64, 0, 30.0, True, None),       # D 64
    (1, 4, 1, 100, 128, 50, 0.0, True, None),      # D 128, qpk 4
    (1, 8, 4, 256, 256, 0, 50.0, True, 0.1),       # a scale not D ** -0.5
    # whisper-large-v3's decoder: D 64, 20 heads, no GQA, S 448 (partial
    # 64-row tiles)
    (4, 20, 20, 448, 64, 0, 0.0, True, None)])
def test_flash_bwd_matches_its_plain_version(cuda, dtype, b, hq, hkv, s, d,
                                             window, softcap, causal, scale):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=cuda).manual_seed(s + d + 1)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((b, hq, s, d), generator=gen, device=cuda).to(dtype)
    q = q.transpose(1, 2)                        # strided, as the model's
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    out, lse = fa_ops.flash_fwd(q, k, v, **kw)
    before = (fa_ops.DQ.launches, fa_ops.DKV.launches)
    got = fa_ops.flash_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa_ops.DQ.launches, fa_ops.DKV.launches) == (before[0] + 1,
                                                         before[1] + 1)
    want = fa_ref.ref_flash_bwd(q, k, v, out, lse, do, **kw)
    # f32: sums over up to S keys / qpk * S queries in another order;
    # bf16: the same f32 math, each result rounded once to bf16 (2**-8)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol,
                                   msg=name)


def test_kernel_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn((2, 8, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fm_ops.grouped_bmm(x.double(), torch.randn((2, 4, 3), device=cuda,
                                                   dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        fm_ops.grouped_bmm(x.transpose(1, 2).contiguous().transpose(1, 2),
                           torch.randn((2, 4, 3), device=cuda))
    pref = torch.zeros((1, 2048), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile side"):
        pe_ops.rank(pref, pref.float(), 4, 2048)


def test_rollout_on_the_card_replays_on_the_cpu(cuda):
    env, ecfg = envs.make("predator_prey", n_agents=3, size=5, max_steps=10)
    cfg = dataclasses.replace(configs.smoke(), flgw_path="grouped",
                              obs_dim=env.obs_dim(ecfg))
    model = ic3net.IC3Net(cfg, seed=3, device=cuda)
    cpu_model = ic3net.IC3Net(cfg, seed=3, device="cpu")
    plans = model.encode_plans()
    r = train.rollout(model, env, ecfg, train.make_generator(5, cuda), 8,
                      plans, collect=True)
    start = env.reset(train.make_generator(5, cuda), ecfg, 8)
    start = type(start)(*(v.cpu() for v in start))
    act, gate = r.action.cpu(), r.gate.cpu()
    with torch.inference_mode():
        rep = train.run_episode(cpu_model, env, ecfg, start,
                                lambda t, lg, gl: (act[:, t], gate[:, t]),
                                cpu_model.encode_plans(), collect=True)
    for name in ("reward", "obs", "success"):
        assert torch.equal(getattr(r, name).cpu(), getattr(rep, name))
    for name in ("logp", "value", "entropy", "gate_logp"):
        torch.testing.assert_close(getattr(r, name).cpu(), getattr(rep, name),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("b,m,g,k,n", [(4, 2304, 4, 720, 2880),
                                       (130, 300, 4, 75, 70),
                                       (1, 9, 3, 3, 5), (67, 64, 2, 40, 129),
                                       (64, 500, 4, 130, 200),
                                       (136, 300, 2, 70, 136),
                                       (4, 9216, 4, 2880, 720),
                                       # wgmma: the prefill's up projection
                                       (4096, 2304, 4, 720, 2880),
                                       # the routes' boundary: streaming at
                                       # 64 rows, wmma at 65 (not a
                                       # multiple of 8), wgmma at 72
                                       (64, 2304, 4, 720, 640),
                                       (65, 2304, 4, 720, 640),
                                       (72, 2304, 4, 720, 640),
                                       # capN not a multiple of wgmma's
                                       # 128-column tile
                                       (256, 700, 3, 200, 200),
                                       # widths not multiples of 8: wmma
                                       (200, 300, 2, 50, 100),
                                       (100, 400, 2, 90, 96),
                                       # gemma2-27b's compact down
                                       # projection (K 11,520): decode's
                                       # split-K stream, prefill's wgmma
                                       (4, 36864, 4, 11520, 1448),
                                       (4096, 36864, 4, 11520, 1448)])
def test_fused_bmm_matches_its_plain_version(cuda, dtype, tol, b, m, g, k, n):
    gen = torch.Generator(device=cuda).manual_seed(b + m + k)
    x = torch.randn((m + 1, b), generator=gen, device=cuda).to(dtype)
    x[m] = 0                                     # (M+1, B): the sink row
    wc = torch.randn((g, k, n), generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, m + 1, (g, k), generator=gen, device=cuda,
                        dtype=torch.int32)
    before = fm_ops.FUSED.launches
    y = fm_ops.fused_bmm(x, wc, ids)
    torch.cuda.synchronize()
    assert fm_ops.FUSED.launches == before + 1
    assert y.dtype == dtype and y.shape == (g, b, n)
    # bf16: f32 sums in another order (split over K for few rows), then
    # one bf16 rounding (2**-8)
    torch.testing.assert_close(y.float(), fm_ref.ref_fused_bmm(x, wc, ids)
                               .float(), rtol=tol, atol=tol * k ** 0.5)


# stacked experts (E, M, N) at the MoE configs' expert projections, G = 4,
# slack 1.25: mixtral-8x22b's up/gate and down at a prefill's dropless
# rows (B=4 x S=1,024, top-2) and a decode step's; arctic-480b's at
# B=1 x S=512 and a decode step
@pytest.mark.parametrize("e,m,n,rows", [
    (8, 6144, 16384, 8192), (8, 16384, 6144, 8192), (8, 6144, 16384, 8),
    (8, 16384, 6144, 8), (128, 7168, 4864, 1024), (128, 4864, 7168, 1024),
    (128, 7168, 4864, 8), (128, 4864, 7168, 8)])
def test_batched_expert_products_match_the_masked_product(cuda, e, m, n,
                                                          rows):
    """One ``fused_bmm`` (compact weights attached) and one
    ``grouped_bmm_bf16`` (the gather path) launch for all E experts,
    each held against the masked product of every expert in f32."""
    from repro_torch.core import grouped
    gen = torch.Generator(device=cuda).manual_seed(e + m + rows)
    x = torch.randn((e, rows, m), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((e, m, n), generator=gen, device=cuda)
         / m ** 0.5).bfloat16()
    plan = grouped.make_plan(
        torch.randn((e, m, 4), generator=gen, device=cuda),
        torch.randn((e, 4, n), generator=gen, device=cuda), 1.25)
    wc = fm_ops.compact_weights(w, plan.row_ids, plan.col_ids,
                                plan.row_valid, plan.col_valid)
    before = (fm_ops.FUSED.launches, fm_ops.BMM16.launches)
    fused = fm_ops.grouped_matmul_fused(x, wc, plan.row_ids, plan.row_valid,
                                        plan.col_ids, plan.col_valid, n=n)
    gather = fm_ops.grouped_matmul(x, w, plan.row_ids, plan.col_ids,
                                   plan.row_valid, plan.col_valid)
    torch.cuda.synchronize()
    assert (fm_ops.FUSED.launches, fm_ops.BMM16.launches) == (
        before[0] + 1, before[1] + 1)
    assert fused.shape == gather.shape == (e, rows, n)
    for i in range(e):
        # the mask the plan keeps: row r and column c in one group's slots
        rows_in = torch.zeros((m + 1, 4), device=cuda)
        cols_in = torch.zeros((4, n + 1), device=cuda)
        g_of = torch.arange(4, device=cuda)[:, None]
        rows_in[torch.where(plan.row_valid[i], plan.row_ids[i], m),
                g_of.expand_as(plan.row_ids[i])] = 1
        cols_in[g_of.expand_as(plan.col_ids[i]),
                torch.where(plan.col_valid[i], plan.col_ids[i], n)] = 1
        mask = rows_in[:m] @ cols_in[:, :n]
        want = x[i].float() @ (w[i].float() * mask)
        # f32 sums in another order, then one bf16 rounding (2**-8)
        for got in (fused[i], gather[i]):
            torch.testing.assert_close(got.float(), want, rtol=2e-2,
                                       atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,window,softcap,causal", [
    (2, 8, 4, 200, 200, 256, 0, 50.0, True),
    (1, 4, 4, 130, 130, 64, 40, 0.0, True),
    (1, 2, 1, 70, 70, 16, 0, 0.0, False),
    (2, 4, 2, 96, 96, 128, 7, 30.0, False),
    # the bf16 tensor-core pass's edges: 128-query and 64-key tiles
    (1, 8, 4, 1024, 1024, 256, 0, 50.0, True),   # the prefill's shapes
    (1, 8, 2, 300, 300, 256, 100, 30.0, True),   # qpk 4, window edge
    (2, 2, 2, 77, 77, 128, 0, 0.0, True),        # qpk 1
    (1, 4, 2, 200, 333, 128, 0, 50.0, False),    # T > S, both ragged
    (1, 4, 1, 300, 100, 64, 0, 0.0, True),       # T < S under causal
    (1, 2, 2, 100, 40, 64, 8, 0.0, False),       # rows with no key
    (1, 4, 2, 90, 90, 20, 0, 50.0, True),        # D % 16 != 0: FP32 FMA
    (1, 2, 1, 150, 150, 40, 20, 0.0, True),      # D % 16 != 0: FP32 FMA
    # the dense family's prefills: gemma2-27b (qpk 2, D 128, softcap 50),
    # internlm2-20b (qpk 6, D 128, softcap 0), gemma3-12b (window 1,024
    # inside S 2,048, D 256)
    (1, 32, 16, 1024, 1024, 128, 4096, 50.0, True),
    (1, 48, 8, 1024, 1024, 128, 0, 0.0, True),
    (1, 16, 8, 2048, 2048, 256, 1024, 0.0, True),
    # whisper-large-v3's decoder: D 64, 20 heads, no GQA, S 448 (a
    # partial 128-query tile)
    (4, 20, 20, 448, 448, 64, 0, 0.0, True)])
def test_flash_fwd_matches_its_plain_version(cuda, dtype, b, hq, hkv, s, t,
                                             d, window, softcap, causal):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, t, d), generator=gen, device=cuda).to(dtype)
    q = q.transpose(1, 2)                        # strided, as the model's
    before = fa_ops.FWD.launches
    out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window,
                                softcap=softcap)
    torch.cuda.synchronize()
    assert fa_ops.FWD.launches == before + 1
    want_o, want_lse = fa_ref.ref_flash_fwd(q, k, v, causal=causal,
                                            window=window, softcap=softcap)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), want_o.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


def test_serving_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeSession, synthetic_requests
    cfg = registry.get_smoke_config(
        "gemma2_2b", flgw_groups=4, flgw_path="grouped",
        flgw_targets=("mlp", "attn"), use_flash=True)
    params = transformer.lm_init(torch.Generator(device=cuda).manual_seed(0),
                                 cfg)
    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cpu()
    cpu_params = to_cpu(params)
    tok = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    batch = {"tokens": tok, "positions": torch.arange(40, device=cuda)
             .expand(2, 40)}
    card = ServeSession(cfg, params)
    launches = (fm_ops.FUSED.launches, fm_ops.BMM.launches)
    got = card.prefill(batch)
    torch.cuda.synchronize()
    assert fm_ops.FUSED.launches > launches[0]
    assert fm_ops.BMM.launches == launches[1]
    want = ServeSession(cfg, cpu_params).prefill(
        {k: v.cpu() for k, v in batch.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=2e-2, atol=2e-2)
    reqs = synthetic_requests(0, 4, vocab=cfg.vocab)
    rep = Engine(card, 2, 32).run(reqs)
    assert rep.generated_tokens == sum(r.max_new_tokens for r in reqs)


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper-large-v3's smoke config, FLGW G=4 grouped on mlp and attn,
    bf16, on the card against the CPU: the forward with frames (encoder
    stack, cross-attention, flash prefill) and a decode step that takes
    the frames and one that reads the cache's encoder output."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer
    cfg = registry.get_smoke_config(
        "whisper_large_v3", flgw_groups=4, flgw_path="grouped",
        flgw_targets=("mlp", "attn"), use_flash=True)
    params = transformer.lm_init(torch.Generator(device=cuda).manual_seed(0),
                                 cfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=cuda)
    pos = torch.arange(40, device=cuda).expand(2, 40)
    frames = torch.randn((2, cfg.num_frames, cfg.d_model), generator=gen,
                         device=cuda).to(cfg.dtype)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        plans = transformer.encode_plans(p, cfg)
        before = (fm_ops.FUSED.launches, fa_ops.FWD.launches)
        with torch.inference_mode():
            full, _, _ = transformer.lm_apply(
                p, cfg, tok.to(dev), pos.to(dev), frames=frames.to(dev),
                plans=plans)
            cache = transformer.init_cache(cfg, 2, 2, params=p)
            steps = []
            for t in range(2):
                kw = {} if t else {"frames": frames.to(dev)}
                lg, _, cache = transformer.lm_apply(
                    p, cfg, tok[:, t:t + 1].to(dev), pos[:, t:t + 1].to(dev),
                    cache=cache, **kw)
                steps.append(lg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            # the decoder's self-attention prefill on the flash kernel; the
            # compact products on fused_bmm
            assert fa_ops.FWD.launches - before[1] == cfg.n_layers
            assert fm_ops.FUSED.launches > before[0]
        out[dev.type] = (full.float().cpu(), torch.cat(steps, 1).float().cpu(),
                         cache["encoder_out"].float().cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        # bf16 activations with f32 sums in other orders on the two devices
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


def test_training_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import adamw_init
    from repro_torch.train import state as state_lib
    from repro_torch.train import step as step_lib
    cfg = registry.get_smoke_config("gemma2_2b", flgw_groups=4,
                                    flgw_path="grouped", use_flash=True)
    params = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    batch = SyntheticTokens(cfg.vocab, 2, 40, seed=3).tensors_at(0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = _to(params, dev)
        state = state_lib.reencode_plans(state_lib.TrainState(
            params=p, opt=adamw_init(p),
            step=torch.zeros((), dtype=torch.int32, device=dev)), cfg)
        before = (fm_ops.BMM16.launches, fa_ops.DQ.launches,
                  fa_ops.DKV.launches, fm_ops.BMM.launches)
        _, m = step_lib.make_train_step(cfg)(
            state, {k: v.to(dev) for k, v in batch.items()})
        after = (fm_ops.BMM16.launches, fa_ops.DQ.launches,
                 fa_ops.DKV.launches, fm_ops.BMM.launches)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]))
        if dev.type == "cuda":
            # 3 MLP products a layer, in the forward and its remat replay
            assert after[0] - before[0] == 2 * 3 * cfg.n_layers
            assert after[1] - before[1] == cfg.n_layers
            assert after[2] - before[2] == cfg.n_layers
            assert after[3] == before[3]
    # bf16 activations with f32 sums in other orders on the two devices
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_ssm_layer_on_the_card_matches_the_cpu(cuda, dtype, tol):
    """A Mamba2 layer (FLGW G=4 grouped on its in/out projections) on the
    card against the CPU: the chunked prefill over several chunks and a
    decode step from its state, which both write in place."""
    from repro_torch.configs import registry
    from repro_torch.core import grouped
    from repro_torch.core.flgw import FLGWConfig
    from repro_torch.models import ssm
    cfg = registry.get_smoke_config("mamba2_1_3b", dtype=dtype,
                                    d_model=128, ssm_head_dim=32)
    fl = FLGWConfig(groups=4, path="grouped")
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, flgw=fl)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 48, cfg.d_model), generator=gen).to(dtype)
    state = torch.randn((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        generator=gen)
    conv = torch.randn((2, cfg.conv_width - 1,
                        cfg.d_inner + 2 * cfg.ssm_state),
                       generator=gen).to(dtype)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        pd = _to(p, dev)
        plans = {k: grouped.make_plan(pd[k]["ig"], pd[k]["og"], 1.25)
                 for k in ("in", "out")}
        cache = {"state": state.to(dev, copy=True),
                 "conv": conv.to(dev, copy=True)}
        with torch.inference_mode():
            y = ssm.ssm(pd, x.to(dev), cfg, chunk=16, flgw=fl, plans=plans)
            yd = ssm.ssm(pd, x[:, :1].to(dev), cfg, cache=cache, flgw=fl,
                         plans=plans)
        out[dev.type] = [t.float().cpu() for t in (y, yd, cache["state"],
                                                   cache["conv"])]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,m,n", [(8, 160, 384, 1024), (4, 7, 96, 200)])
def test_expert_axis_backward_matches_the_2d_one_on_the_card(cuda, dtype, e,
                                                             c, m, n):
    """The grouped backward over a leading expert axis (every expert's
    dx, dW, dIG, dOG at once, torch.bmm over the E·G tiles) against the
    2-D backward run expert by expert, on the card: cuBLAS may pick other
    algorithms for E·G tiles than for G, so within a bf16 rounding of the
    largest value (f32: 1e-5)."""
    from repro_torch.core import grouped
    gen = torch.Generator(device=cuda).manual_seed(e * c)
    x = torch.randn((e, c, m), generator=gen, device=cuda).to(dtype)
    w = torch.randn((e, m, n), generator=gen, device=cuda).to(dtype)
    ig = torch.randn((e, m, 4), generator=gen, device=cuda)
    og = torch.randn((e, 4, n), generator=gen, device=cuda)
    gy = torch.randn((e, c, n), generator=gen, device=cuda).to(dtype)
    plan = grouped.make_plan(ig, og, 1.25)
    got = grouped._grouped_bwd(x, w, ig, og, plan, 1.0, gy)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for i in range(e):
        one = grouped.GroupPlan(*(t[i] for t in plan[:6]))
        want = grouped._grouped_bwd(x[i], w[i], ig[i], og[i], one, 1.0,
                                    gy[i])
        for a, b in zip(got, want):
            scale = float(b.float().abs().max())
            assert float((a[i].float() - b.float()).abs().max()) <= \
                rel * scale


def _to(tree, dev):
    """A copy of a tensor tree on ``dev`` (the optimizers write in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


@pytest.mark.parametrize("m,n,g", [(2304, 9216, 4), (9216, 2304, 4),
                                   (128, 512, 32), (1, 64, 2), (257, 129, 4),
                                   (300, 200, 8), (5, 3, 2), (64, 17, 3),
                                   (4099, 16, 16)])
def test_osel_mask_is_bitwise_its_plain_version(cuda, m, n, g):
    from repro_torch.kernels.osel_encode import ops as os_ops
    from repro_torch.kernels.osel_encode import ref as os_ref
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    ig = torch.randint(0, g, (m,), generator=gen, device=cuda)
    # og a view one element into its storage: its data is not 16-byte
    # aligned, which the kernel's og loads must handle
    og = torch.randint(0, g, (n + 1,), generator=gen, device=cuda)[1:]
    before = os_ops.OSEL.launches
    got = os_ops.osel_mask(ig, og)
    torch.cuda.synchronize()
    assert os_ops.OSEL.launches == before + 1
    want = os_ref.ref_mask_indices(ig, og).to(torch.uint8)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(os_ops.osel_mask(ig.int(), og.contiguous().int()),
                       want)
    empty = os_ops.osel_mask(ig[:0], og)
    assert empty.shape == (0, n) and os_ops.OSEL.launches == before + 2


def test_osel_encode_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import osel
    from repro_torch.kernels.osel_encode import ops as os_ops
    gen = torch.Generator(device=cuda).manual_seed(0)
    ig = torch.randn((128, 8), generator=gen, device=cuda)
    og = torch.randn((8, 512), generator=gen, device=cuda)
    ig_idx, og_idx = ig.argmax(1), og.argmax(0)
    before = os_ops.OSEL.launches
    mem = osel.encode(ig_idx, og_idx, 8)
    tmem = osel.transpose_encode(ig_idx, og_idx, 8)
    assert os_ops.OSEL.launches == before + 2
    cpu = osel.encode(ig_idx.cpu(), og_idx.cpu(), 8)
    for a, b in zip(mem, cpu):
        assert torch.equal(a.cpu(), b)
    mask = os_ops.reference_mask(ig, og)
    assert torch.equal(osel.mask_from_memory(mem), mask)
    assert torch.equal(osel.mask_from_memory(tmem), mask.T)


def test_a2c_step_on_the_card_replays_on_the_cpu(cuda):
    """One learner iteration on the grouped path on the card, its sampled
    actions and gates recorded and replayed through the CPU model: loss
    within 1e-5, every gradient within 1e-4 relative norm, the gate
    head's gradient exactly 0 on both."""
    env, ecfg = envs.make("predator_prey", n_agents=3, size=5, max_steps=10)
    cfg = dataclasses.replace(configs.smoke(), flgw_path="grouped",
                              obs_dim=env.obs_dim(ecfg))
    tcfg = train.TrainConfig(batch=8)
    out = {}
    record = []
    for dev in (cuda, torch.device("cpu")):
        model = ic3net.IC3Net(cfg, seed=3, device=dev)
        with torch.no_grad():
            plans = model.encode_plans()
        if dev.type == "cuda":
            gen = train.make_generator(5, cuda)
            state = env.reset(gen, ecfg, tcfg.batch)
            start = type(state)(*(v.cpu() for v in state))
            draw = train.sampler(gen)

            def sample(t, lg, gl):
                a, g = draw(t, lg, gl)
                record.append((a.cpu(), g.cpu()))
                return a, g
            before = fm_ops.BMM.launches
        else:
            state = start

            def sample(t, lg, gl):
                return record[t]
        m, g = train._loss_grads(model, env, ecfg, tcfg, state, sample, 0,
                                 None, plans)
        if dev.type == "cuda":
            assert fm_ops.BMM.launches - before == 5 * ecfg.max_steps
        out[dev.type] = (float(m["loss"]), {
            k: {n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
            else v.cpu() for k, v in g.items()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    gc, gp = out["cuda"][1], out["cpu"][1]
    assert not gc["gate"]["w"].any() and not gp["gate"]["w"].any()
    for k, v in gp.items():
        for n, want in (v.items() if isinstance(v, dict) else [("", v)]):
            got = gc[k][n] if n else gc[k]
            if want.any():
                rel = float((got - want).norm() / want.norm())
                assert rel <= 1e-4, (k, n, rel)


def test_queue_push_on_one_stream_pops_the_same_bytes_on_another(cuda):
    """The async pipeline's handoff: an actor thread on its own stream
    makes each window with a long chain of kernels and pushes it; the
    learner pops on its stream. Over 100 interleaved push/pop pairs every
    popped window holds exactly the bytes that were pushed."""
    import threading

    from repro_torch.marl import async_train as at
    b, t, a, d = 16, 30, 8, 30
    spec = at.trajectory_spec(
        ic3net.IC3NetConfig(hidden=8, n_agents=a, obs_dim=d), b, t)
    drv = at.QueueDriver(3, spec, "overwrite", cuda)
    stream = torch.cuda.Stream(cuda)
    pairs, failure = 100, []

    def window(i):
        x = torch.full((b, t, a, d), float(i), device=cuda)
        for _ in range(50):               # keep the stream busy a while
            x = (x * 1.000001).sin().asin() / 1.000001
        x = torch.full_like(x, float(i)) + 0 * x
        f = torch.full((b, t, a), float(i), device=cuda)
        return at.Trajectory(obs=x, act=f.long(), gates=f, rew=f, logp=f,
                             succ=torch.full((b,), i % 2 == 1, device=cuda))

    def actor():
        try:
            with torch.cuda.stream(stream):
                for i in range(pairs):
                    while len(drv) >= 2:       # never overwrite unread
                        threading.Event().wait(0.0005)
                    drv.push(window(i), i)
        except Exception as e:  # noqa: BLE001 - re-raised below
            failure.append(e)
    th = threading.Thread(target=actor)
    th.start()
    got = []
    for i in range(pairs):
        drv.wait(lambda: bool(failure) or not th.is_alive())
        assert not failure, failure
        traj, ver = drv.pop()
        assert ver == i
        got.append(traj)
    th.join(timeout=60)
    assert not th.is_alive() and not failure
    torch.cuda.synchronize()
    for i, traj in enumerate(got):
        assert bool((traj.obs == i).all()) and bool((traj.act == i).all())
        assert bool((traj.logp == i).all()) and bool(
            (traj.succ == (i % 2 == 1)).all())


def test_threaded_async_run_never_reads_a_half_written_bundle(cuda,
                                                              monkeypatch):
    """A threaded run on the grouped path: every bundle the actor steps
    on certifies (``bundle_consistent``) and holds exactly the weights
    the learner published at its version, before and after the rollout."""
    from repro_torch.marl import async_train as at
    env, ecfg = envs.make("predator_prey", n_agents=3, size=5,
                          max_steps=10)
    cfg = dataclasses.replace(configs.smoke(), flgw_path="grouped")
    published, checked = {}, []
    real_publish, real_rollout = at.publish, at.actor_rollout

    def weights(model):
        return [p.detach().cpu() for p in model.parameters()]

    def publish(model, plans, version):
        bundle = real_publish(model, plans, version)
        published[bundle.version] = weights(bundle.params)
        return bundle

    def rollout(bundle, *a):
        at._read_on_current_stream(bundle)
        want = published[bundle.version]
        before = weights(bundle.params)
        assert bool(at.bundle_consistent(bundle)), bundle.version
        traj = real_rollout(bundle, *a)
        torch.cuda.current_stream().synchronize()
        after = weights(bundle.params)
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(want, before, after)), bundle.version
        checked.append(bundle.version)
        return traj
    monkeypatch.setattr(at, "publish", publish)
    monkeypatch.setattr(at, "actor_rollout", rollout)
    acfg = at.AsyncConfig(capacity=4, actors=1, correction="vtrace",
                          max_staleness=4, publish_every=1)
    _, hist = at.async_train(cfg, ecfg, train.TrainConfig(batch=8), acfg,
                             updates=12, seed=0, env=env, threads=True,
                             check_publication=True, device=cuda)
    assert len(hist) == 12 and max(h["staleness"] for h in hist) <= 4
    assert len(set(checked)) >= 2       # the actor adopted new versions


def _lm_mesh_run(device: str):
    """``train_lm`` at gemma2-2b's grouped bf16 smoke config, 2 steps on
    ``device``: (losses, grad norms, the final params whole as host
    arrays, bf16 as their raw 16-bit words)."""
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as launch
    from repro_torch.sharding import partition
    state, hist = launch.train_lm("gemma2_2b", steps=2, batch=4, seq=64,
                                  flgw_groups=4, flgw_path="grouped",
                                  log_every=0, device=device)

    def host(t):
        t = partition.gather(t).cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return ([float(h["loss"]) for h in hist],
            [float(h["grad_norm"]) for h in hist],
            {p: host(t) for p, t in store.tree_paths(state.params)})


def test_lm_mesh_step_on_a_world_1_nccl_group_is_bitwise_the_step_without(
        cuda, tmp_path):
    """The LM launcher's (1, 1) mesh on a one-rank NCCL group (its
    weights as DTensors, every collective on NCCL) trains bitwise as the
    launcher without a group."""
    from repro_torch.launch import mesh as mesh_lib
    plain = _lm_mesh_run(str(cuda))
    (meshed,) = mesh_lib.spawn(_lm_mesh_run, 1, str(cuda), backend="nccl",
                               init_file=str(tmp_path / "rdv"),
                               timeout_s=300)
    assert meshed[0] == plain[0] and meshed[1] == plain[1]
    assert meshed[2].keys() == plain[2].keys()
    for p, a in plain[2].items():
        np.testing.assert_array_equal(meshed[2][p], a, err_msg=p)
