"""Card-only tests of the port's CUDA kernels and of the slice on the card.

Run on a machine with a CUDA card: ``pytest -m gpu tests/test_torch_*.py``.
Without one every test here skips (decided inside the fixture).
"""
import dataclasses

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
                                     (3, 130, 1, 64), (2, 64, 64, 64)])
def test_grouped_bmm_matches_its_plain_version(cuda, g, b, k, n):
    gen = torch.Generator(device=cuda).manual_seed(b + k + n)
    xg = torch.randn((g, b, k), generator=gen, device=cuda)
    wc = torch.randn((g, k, n), generator=gen, device=cuda)
    before = fm_ops.BMM.launches
    y = fm_ops.grouped_bmm(xg, wc)
    torch.cuda.synchronize()
    assert fm_ops.BMM.launches == before + 1
    torch.testing.assert_close(y, fm_ref.ref_grouped_bmm(xg, wc),
                               rtol=1e-5, atol=1e-5)


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
