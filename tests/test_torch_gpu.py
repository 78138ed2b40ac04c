"""Card-only tests of the port's CUDA kernels and of the slice on the card.

Run on a machine with a CUDA card: ``pytest -m gpu tests/test_torch_*.py``.
Without one every test here skips (decided inside the fixture).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    ids = pe_ops.balanced_assign(scores, 1, slack, block=block)
    flat = scores.reshape(-1, m, g)
    for layer, want in enumerate(flat):
        assert torch.equal(ids.reshape(-1, g, cap)[layer],
                           pe_ref.ref_balanced_assign(want, slack))


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
    (1, 8, 4, 256, 256, 0, 50.0, True, 0.1)])      # a scale not D ** -0.5
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
                                       (100, 400, 2, 90, 96)])
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
    (1, 2, 1, 150, 150, 40, 20, 0.0, True)])     # D % 16 != 0: FP32 FMA
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
