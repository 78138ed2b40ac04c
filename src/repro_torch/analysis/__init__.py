"""Static analysis and runtime contracts of the port.

Port of ``repro.analysis``:

* :mod:`repro_torch.analysis.lint` -- an AST linter with the port's
  rules (ANL001-ANL004, ANL006): CUDA tensors or ``torch.cuda`` calls at
  import, host syncs inside a step or its driving loop, ``KernelEntry``
  argument lists against their C signatures, ``autograd.Function``
  gradient counts, and CUDA kernels with no launch spec. Run as
  ``python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py
  [--check]``.
* :mod:`repro_torch.analysis.contracts` -- runtime contracts:
  ``trace_counter``, ``assert_max_traces`` and ``no_retrace`` (a step
  called at a new signature mid-run), the engine of the opt-in
  ``debug_contracts=True`` on ``ServeSession`` / ``Engine`` /
  ``async_train``.
* :mod:`repro_torch.analysis.kernel_audit` -- the launch audit of every
  CUDA entry point over a shape corpus: route, grid, block, cluster and
  dynamic shared memory, bounds, output coverage, disjoint writes and
  the card's limits, without a card. Run as ``python -m
  repro_torch.analysis.kernel_audit [--check]``.

Every name resolves lazily, so the lint and audit CLIs import no torch.
"""
__all__ = [
    "ContractViolation", "RetraceError", "assert_max_traces",
    "no_retrace", "trace_counter", "Finding", "lint_file", "lint_paths",
    "AuditFinding", "CaseReport", "LaunchCase", "LaunchSpec", "Tile",
    "audit_all", "load_registry", "register_launch_spec",
    "contracts", "lint", "kernel_audit",
]

_EXPORTS = {
    "ContractViolation": "contracts", "RetraceError": "contracts",
    "assert_max_traces": "contracts", "no_retrace": "contracts",
    "trace_counter": "contracts",
    "Finding": "lint", "lint_file": "lint", "lint_paths": "lint",
    "AuditFinding": "kernel_audit", "CaseReport": "kernel_audit",
    "LaunchCase": "kernel_audit", "LaunchSpec": "kernel_audit",
    "Tile": "kernel_audit", "audit_all": "kernel_audit",
    "load_registry": "kernel_audit",
    "register_launch_spec": "kernel_audit",
}


def __getattr__(name):
    # lazily: the lint and audit CLIs must not pull in torch, and an
    # eager import would load a submodule twice under runpy
    import importlib
    if name in ("contracts", "lint", "kernel_audit"):
        return importlib.import_module(f"repro_torch.analysis.{name}")
    mod = _EXPORTS.get(name)
    if mod is not None:
        return getattr(
            importlib.import_module(f"repro_torch.analysis.{mod}"), name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
