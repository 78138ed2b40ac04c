"""The port stands alone (no jax, nothing of repro), picks the card unless
told otherwise, and takes its kernels' plain versions only for CPU
tensors."""
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import on_cpu  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.osel_encode import ops as os_ops  # noqa: E402
from repro_torch.kernels.plan_encode import ops as pe_ops  # noqa: E402
from repro_torch.launch import time_encode  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.marl import async_train, ic3net, train  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, runpy, sys, warnings
sys.modules["jax"] = None          # any import of jax, repro or
sys.modules["repro"] = None        # ml_dtypes now fails
sys.modules["ml_dtypes"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
SHIM = "repro_torch.marl.env"      # warns DeprecationWarning by design
for name in names:
    if name == SHIM:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            importlib.import_module(name)
        assert [w.category for w in seen] == [DeprecationWarning], seen
    else:
        importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_check")
assert not any(m in ("jax", "ml_dtypes")
               or m.startswith(("jax.", "repro.", "ml_dtypes."))
               for m in sys.modules if sys.modules[m] is not None)
assert {"repro_torch.marl.async_train",
        "repro_torch.launch.marl_async",
        "repro_torch.checkpoint.store", "repro_torch.runtime.fault",
        "repro_torch.train.state", SHIM, "repro_torch.launch.marl_ic3net",
        "repro_torch.launch.quickstart", "repro_torch.models.moe",
        "repro_torch.configs.mixtral_8x22b",
        "repro_torch.configs.arctic_480b", "repro_torch.models.ssm",
        "repro_torch.configs.mamba2_1_3b",
        "repro_torch.configs.jamba_1_5_large", "repro_torch.launch.mesh",
        "repro_torch.sharding", "repro_torch.sharding.partition",
        "repro_torch.sharding.collectives", "repro_torch.optim.compression",
        "repro_torch.runtime.elastic", "repro_torch.models.layers",
        "repro_torch.models.attention", "repro_torch.models.transformer",
        "repro_torch.optim.optimizers", "repro_torch.data.pipeline",
        "repro_torch.train.step", "repro_torch.launch.train",
        "repro_torch.interop"} <= set(names)
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT,
         os.path.join(ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module of the IC3Net learner and OSEL slice is among those
    # imported (osel, load_balance, the osel_encode kernel package and the
    # three environments), the async pipeline's two and the checkpoint
    # slice's four (checkpoint and runtime, each a package and a module)
    assert int(out.stdout.split()[-1]) >= 64


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = ic3net.IC3NetConfig(hidden=8, obs_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ic3net.IC3Net(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_generator(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(cfg, iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        async_train.async_train(cfg, updates=1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert ic3net.IC3Net(cfg, device="cpu").device == torch.device("cpu")
    lm = registry.get_smoke_config("gemma2_2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_cache(lm, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train_lm("gemma2_2b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        time_encode.main()
    cache = transformer.init_cache(lm, 1, 4, device="cpu")
    assert cache["pos"].device == torch.device("cpu")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels = (pe_ops.RANK, pe_ops.PLACE, pe_ops.ASSIGN, fm_ops.BMM,
               fm_ops.BMM16, fm_ops.FUSED, fa_ops.FWD, fa_ops.DQ, fa_ops.DKV,
               os_ops.OSEL)
    before = [k.launches for k in kernels]
    ig = torch.randn(40, 4)
    pe_ops.balanced_assign(ig, 1, 1.25)
    os_ops.osel_mask(ig.argmax(1), ig.argmax(1))
    fm_ops.grouped_bmm(torch.randn(2, 3, 4), torch.randn(2, 4, 5))
    fm_ops.grouped_bmm(torch.randn(2, 3, 4).bfloat16(),
                       torch.randn(2, 4, 5).bfloat16())
    fm_ops.fused_bmm(torch.randn(7, 3), torch.randn(2, 4, 5),
                     torch.zeros((2, 4), dtype=torch.int32))
    q = torch.randn(1, 2, 5, 8, requires_grad=True)
    out = fa_ops.flash_attention(q, q[:, :1], q[:, :1])
    out.sum().backward()
    assert [k.launches for k in kernels] == before


def test_kernel_wrappers_refuse_other_devices_and_mixes():
    """A mix of devices, or a device other than the CPU, a CUDA card and
    ``meta``, raises. ``meta`` alone takes the plain path, by shape only
    (the dry run's step); before the dry run it was refused too."""
    meta = torch.empty((2, 3, 4), device="meta")
    assert on_cpu(meta)
    other = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        on_cpu(other)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        on_cpu(meta, torch.empty(1))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        fm_ops.grouped_bmm(meta, torch.empty((2, 4, 5)))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        fm_ops.fused_bmm(meta[0], torch.empty((2, 4, 5)),
                         torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        fa_ops.flash_fwd(meta[None], meta[None], torch.empty((1, 2, 3, 4)))
    with pytest.raises(ValueError, match="all lie on the CPU"):
        fa_ops.flash_bwd(*[meta[None]] * 3, torch.empty((1, 2, 3, 4)),
                         meta, meta[None])
    with pytest.raises(ValueError, match="all lie on the CPU"):
        os_ops.osel_mask(meta[0, 0], torch.zeros(3, dtype=torch.int64))
    out, lse = fa_ops.flash_fwd(meta[None], meta[None], meta[None])
    assert out.device.type == lse.device.type == "meta"
    assert out.shape == (1, 2, 3, 4) and lse.shape == (1, 2, 3)
    y = fm_ops.grouped_bmm(meta, torch.empty((2, 4, 5), device="meta"))
    assert y.device.type == "meta" and y.shape == (2, 3, 5)


def test_kernel_cache_stays_inside_the_checkout(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == _build.CHECKOUT / "build" / "repro_torch"
    assert _build.CSRC.parents[1] == _build.CHECKOUT / "src"
    installed = tmp_path / "site-packages" / "repro_torch" / "csrc"
    monkeypatch.setattr(_build, "CSRC", installed)
    with pytest.raises(RuntimeError, match="not from a checkout's src/"):
        _build.library_path("flgw_matmul")
    with pytest.raises(RuntimeError, match="not from a checkout's src/"):
        _build.build()
    assert not (tmp_path / "build").exists()
