"""The port's analysis layer: the runtime contracts, the PyTorch/CUDA lint
pass and the launch audit of the CUDA kernels, on the CPU (no card, no
jax). The lint fixtures are inline source strings."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

from repro_torch.analysis import contracts, kernel_audit as ka  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis.kernel_audit import LaunchCase, Tile  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.scheduler import Engine, Request  # noqa: E402
from repro_torch.serving.session import ServeSession  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


# -- contracts ---------------------------------------------------------------

def _fake_module():
    mod = types.SimpleNamespace()
    mod.make_plan = lambda a, b=0: (a, b)
    return mod


def test_trace_counter_counts_records_and_restores():
    mod = _fake_module()
    real = mod.make_plan
    with contracts.trace_counter(mod, "make_plan", record_args=True) as c:
        assert mod.make_plan(1, 2) == (1, 2)
        mod.make_plan(3, b=4)
        assert c.count == 2 and int(c) == 2
        assert c.calls == [((1, 2), {}), ((3,), {"b": 4})]
        c.reset()
        mod.make_plan(5)
        assert c.count == 1
    assert mod.make_plan is real
    with pytest.raises(RuntimeError):
        with contracts.trace_counter(mod, "make_plan"):
            raise RuntimeError("boom")
    assert mod.make_plan is real


def test_assert_max_traces():
    mod = _fake_module()
    with contracts.assert_max_traces(mod, "make_plan", 2):
        mod.make_plan(1, 2)
    with pytest.raises(contracts.ContractViolation, match="at most 1"):
        with contracts.assert_max_traces(mod, "make_plan", 1):
            mod.make_plan(1, 2)
            mod.make_plan(3, 4)
    with pytest.raises(contracts.ContractViolation, match="exactly 2"):
        with contracts.assert_max_traces(mod, "make_plan", 2, exactly=True):
            mod.make_plan(1, 2)


def test_no_retrace_catches_unstable_passes_stable_and_allows():
    def step(x):
        contracts.record("unstable_step", {"x": x})
        return x * 2
    with pytest.raises(contracts.RetraceError, match="unstable_step"):
        with contracts.no_retrace(label="unit"):
            for n in range(1, 4):
                step(torch.zeros(n))
    with contracts.no_retrace() as mon:
        for _ in range(5):
            step(torch.zeros(3))
    assert mon.counts() == {"unstable_step": 1}
    with contracts.no_retrace(allow=("unstable_step",)) as mon:
        for n in range(1, 4):
            step(torch.zeros(n))
    assert mon.counts()["unstable_step"] == 3
    # dtype and static values are part of the signature; data is not
    with pytest.raises(contracts.RetraceError):
        with contracts.no_retrace():
            step(torch.zeros(3))
            step(torch.zeros(3, dtype=torch.float64))
    with contracts.no_retrace(max_compiles=1) as mon:
        for v in range(3):
            contracts.record("s", torch.full((2,), float(v)), v)
    assert mon.counts() == {"s": 1}


@pytest.fixture(scope="module")
def session():
    cfg = registry.get_smoke_config("gemma2_2b", dtype=torch.float32,
                                    flgw_groups=4, flgw_path="grouped")
    params = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    return cfg, params


def test_debug_contracts_on_serving_and_a_shape_unstable_decode(session):
    """``debug_contracts=True`` runs an Engine under ``no_retrace``: a
    lockstep run passes at one decode signature and gives the unguarded
    run's tokens; a decode loop fed a growing batch raises."""
    cfg, params = session
    reqs = [Request(rid=i, prompt=np.arange(1, 4 + i, dtype=np.int32),
                    max_new_tokens=3) for i in range(2)]
    runs = []
    for flag in (True, False):
        sess = ServeSession(cfg, params, debug_contracts=flag)
        eng = Engine(sess, 2, 16, admission="lockstep")
        assert eng.debug_contracts is flag
        with contracts.no_retrace() as mon:
            rep = eng.run(reqs)
        runs.append([r.tokens for r in rep.records])
        assert mon.counts() == {"decode_step": 1}
    assert runs[0] == runs[1]
    sess = ServeSession(cfg, params, debug_contracts=True)
    with pytest.raises(contracts.RetraceError, match="decode_step"):
        with contracts.no_retrace(label="unstable decode"):
            for b in (1, 2):
                cache = sess.new_cache(b, 8)
                tok = torch.ones((b, 1), dtype=torch.int64)
                sess.decode(cache, tok, torch.zeros((b, 1),
                                                    dtype=torch.int64))


# -- lint --------------------------------------------------------------------

def _lint(src, **kw):
    return lint.lint_source(textwrap.dedent(src), "mod.py", **kw)


def _codes(findings):
    return [f.code for f in findings]


@pytest.mark.parametrize("rule,bad,good", [
    ("ANL001", """
        import torch
        TABLE = torch.zeros(4, device="cuda")
        torch.cuda.set_device(0)
        """, """
        import torch
        TABLE = torch.zeros(4)
        def lazy():
            return torch.zeros(4, device="cuda")
        if __name__ == "__main__":
            torch.cuda.synchronize()
        """),
    ("ANL002", """
        import numpy as np
        def make_step(cfg):
            def step(x):
                return float(x.sum()) + x.max().item()
            return step
        def loop(sess, cache, tok):
            for _ in range(4):
                tok, cache = sess.decode(cache, tok)
                print(tok.tolist())
        """, """
        import torch
        def make_step(cfg):
            def step(x):
                return x.sum() + x.shape[0]
            return step
        def timing(sess, cache, tok):
            for _ in range(4):
                tok, cache = sess.decode(cache, tok)
                torch.cuda.synchronize()
                print(tok.tolist())
        """),
    ("ANL004", """
        import torch
        class Two(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, b):
                return a + b
            @staticmethod
            def backward(ctx, g):
                return g, g, None
        class NoBackward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a):
                return a
        """, """
        import torch
        class Two(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a, b):
                return a + b
            @staticmethod
            def backward(ctx, g):
                return g, g
        """),
])
def test_lint_rule_fires_on_bad_and_not_on_good(rule, bad, good):
    bad_f = _lint(bad, importable=True)
    assert rule in _codes(bad_f) and set(_codes(bad_f)) == {rule}
    assert _lint(good, importable=True) == []


def test_lint_anl001_only_in_importable_modules():
    src = "import torch\nX = torch.ones(2).cuda()\n"
    assert _codes(_lint(src, importable=True)) == ["ANL001"]
    assert _lint(src, importable=False) == []


CU = """
extern "C" {
// comment
int entry_a(const void* x, void* y, int n, void* stream) {
  return 0;
}
int entry_b(const void* x, int n, void* stream) { return 0; }
}  // extern "C"
namespace {
__global__ void __launch_bounds__(256) kernel_a(const float* x) {}
template <int N>
__global__ void kernel_b(float* y) {}
}
"""


def _kernel_package(tmp_path, ops_src, audit_src):
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "csrc" / "lib.cu").write_text(CU)
    fam = pkg / "kernels" / "lib"
    fam.mkdir(parents=True)
    for d in (pkg, pkg / "kernels", fam):
        (d / "__init__.py").write_text("")
    (fam / "ops.py").write_text(textwrap.dedent(ops_src))
    (fam / "audit.py").write_text(textwrap.dedent(audit_src))
    return pkg, fam / "ops.py"


GOOD_AUDIT = """
    register_launch_spec(LaunchSpec("entry_a", "lib", ("kernel_a",), f, ()))
    register_launch_spec(LaunchSpec("entry_b", "lib", ("kernel_b",), f, ()))
    """


def test_lint_anl003_and_anl006_against_the_c_source(tmp_path):
    good_ops = """
        import ctypes
        from pkg.kernels import KernelEntry
        _P, _I = ctypes.c_void_p, ctypes.c_int
        ARGS = [_P, _I]
        A = KernelEntry("lib", "entry_a", [*[_P] * 2, _I])
        B = KernelEntry("lib", "entry_b", ARGS)
        """
    pkg, ops = _kernel_package(tmp_path, good_ops, GOOD_AUDIT)
    assert lint.lint_paths([str(pkg)]) == []
    bad_ops = """
        import ctypes
        from pkg.kernels import KernelEntry
        _P, _I = ctypes.c_void_p, ctypes.c_int
        A = KernelEntry("lib", "entry_a", [_P, _I])
        C = KernelEntry("lib", "entry_c", [_P])
        """
    ops.write_text(textwrap.dedent(bad_ops))
    found = lint.lint_paths([str(pkg)])
    assert sorted(_codes(found)) == ["ANL003", "ANL003", "ANL006"]
    assert any("takes 3" in f.message for f in found)
    assert any("entry_c" in f.message and f.code == "ANL006" for f in found)
    (ops.parent / "audit.py").write_text('register_launch_spec("entry_a")\n')
    cu_found = [f for f in lint.lint_paths([str(pkg)])
                if f.path.endswith(".cu")]
    assert [f.code for f in cu_found] == ["ANL006", "ANL006"]
    assert {f.line for f in cu_found} == {10, 12}


def test_lint_noqa_baseline_round_trip_stale_and_check(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy as np\n"
                   "def make_step():\n"
                   "    def step(x):\n"
                   "        return x.item()\n"
                   "    return step\n")
    bl = tmp_path / "baseline.txt"
    args = [str(bad), "--baseline", str(bl)]
    assert lint.main(args + ["--check"]) == 1
    assert lint.main(args + ["--write-baseline"]) == 0
    assert lint.main(args + ["--check"]) == 0
    assert lint.load_baseline(str(bl))[(str(bad).replace(os.sep, "/"),
                                        "ANL002", "return x.item()")] == 1
    bad.write_text(bad.read_text().replace("x.item()",
                                           "x.item()  # noqa: ANL002"))
    assert lint.lint_file(str(bad)) == []
    capsys.readouterr()
    assert lint.main(args + ["--check"]) == 1        # the entry is stale
    assert "stale entry" in capsys.readouterr().out
    assert lint.main(args) == 0                      # stale fails --check only
    assert lint.main(args + ["--check", "--select", "ANL001"]) == 0


def test_lint_repo_is_clean_against_its_baseline(monkeypatch):
    monkeypatch.chdir(ROOT)
    assert lint.main(["src/repro_torch", "chip_smoke.py", "--check"]) == 0


# -- kernel audit ------------------------------------------------------------

def test_kernel_audit_check_passes_on_the_repo(capsys):
    assert ka.main(["--check"]) == 0
    out = capsys.readouterr().out
    assert "audit clean" in out and "grouped_bmm_tma_kernel" in out


def _case(**kw):
    n, bn, b = 100, 32, 64
    base = dict(
        label="seeded", entry="grouped_bmm_f32",
        kernel="grouped_bmm_f32_kernel<32>", grid=(-(-n // bn), 2, 1),
        block=(256, 1, 1), dynamic_smem=0,
        tiles=(Tile("y", (1, b, n), (1, 32, bn),
                    lambda x, y, z: (z, y * 32, x * bn), role="out"),))
    base.update(kw)
    return LaunchCase(**base)


def test_kernel_audit_seeded_faults_each_fire_their_finding():
    assert ka.audit_case(_case()).ok
    missed = ka.audit_case(_case(grid=(100 // 32, 2, 1)))   # ragged edge
    assert {f.check for f in missed.findings} == {"coverage"}
    big = ka.audit_case(_case(dynamic_smem=ka.SMEM_OPTIN + 1))
    assert {f.check for f in big.findings} == {"smem"}
    tall = ka.audit_case(_case(grid=(4, 65_536, 1)))
    assert "grid" in {f.check for f in tall.findings}
    # z writes every tile twice
    twice = (Tile("y", (1, 64, 100), (1, 32, 32),
                  lambda x, y, z: (0 * z, y * 32, x * 32), role="out"),)
    over = _case(grid=(4, 2, 2), tiles=twice)
    assert {f.check for f in ka.audit_case(over).findings} == {"disjoint"}
    split = dataclasses.replace(over, split_axes=(2,),
                                reduce_kernel="reduce_splits_kernel")
    reduce = _case(kernel="reduce_splits_kernel")
    assert ka.audit_call([split, reduce])[0].ok
    assert not ka.audit_call([split])[0].ok       # no reduce in the call
    past = ka.audit_case(_case(tiles=(Tile(
        "x", (1, 64, 100), (1, 32, 32), lambda x, y, z: (z, y * 32 + 64, 0)),)))
    assert {f.check for f in past.findings} == {"bounds"}


def test_every_kernel_entry_and_global_kernel_has_a_spec():
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flgw_matmul import ops as fm
    from repro_torch.kernels.osel_encode import ops as os_
    from repro_torch.kernels.plan_encode import ops as pe
    entries = {e.symbol for e in (pe.ASSIGN, pe.RANK, pe.PLACE, fm.BMM,
                                  fm.BMM16, fm.FUSED, fa.FWD, fa.DQ, fa.DKV,
                                  os_.OSEL)}
    reg = ka.load_registry()
    assert set(reg) == entries
    kernels = set()
    for name in os.listdir(os.path.join(PKG, "csrc")):
        if name.endswith(".cu"):
            with open(os.path.join(PKG, "csrc", name)) as fh:
                kernels |= {k for k, _ in lint.cuda_kernels(fh.read())}
    assert len(kernels) == 18
    assert kernels == {k for s in reg.values() for k in s.kernels}
    # every corpus launch names a kernel of its spec
    for spec in reg.values():
        for p in spec.corpus:
            for c in spec.launches(dict(p)):
                assert c.kernel.split("<")[0] in spec.kernels
    # a recorded call maps back onto the model's params
    [case] = ka.predict_recorded(
        "grouped_bmm_bf16", (16, 32, 48, 4, 4096, 720, 2880, 1))
    assert case.kernel == "grouped_bmm_tma_kernel"
    assert case.grid == (132, 1, 1) and case.cluster == (2, 1, 1)


def test_kernel_audit_registry_loads_without_torch_cuda():
    code = textwrap.dedent("""
        import torch
        def refuse(*a, **k):
            raise AssertionError("torch.cuda touched")
        torch.cuda._lazy_init = refuse
        torch.cuda.init = refuse
        torch.cuda.get_device_properties = refuse
        from repro_torch.analysis import kernel_audit
        reports = kernel_audit.audit_all()
        assert reports and all(r.ok for r in reports)
        assert not torch.cuda.is_initialized()
        """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
