"""Launch audit of the port's CUDA kernels, without a card.

Port of ``repro.analysis.kernel_audit`` (the reference's grid/BlockSpec
interpreter of its Pallas kernels). A Pallas kernel's tiling is its
BlockSpecs; a CUDA kernel's is its launch: which ``__global__`` kernel
the C entry picks (its route), the grid, the block, the cluster, the
dynamic shared memory, and which tile of every operand and output each
CTA touches. Each kernel family ships an ``audit.py`` beside its
``ops.py`` that registers one :class:`LaunchSpec` per C entry (the
``KernelEntry`` symbols): a model of the entry's launches for the
arguments of one call, written from the C source's launch code and
sharing the wrapper's own route functions (``ops.bmm_bf16_route``,
``ops.k_splits``, ``ops.assign_route``...), so the model and the
wrapper cannot drift. Lint rule ANL006 makes a spec mandatory for every
``__global__`` kernel and every ``KernelEntry``.

Per launch and corpus case, the checks:

bounds     every CTA's tile of every operand starts inside it (a ragged
           last tile overhangs the edge and the kernel guards it); a
           tile declared unguarded lies wholly inside.
coverage   the output tiles of all CTAs cover every output tile: no gap
           that a freshly allocated buffer would leave as garbage.
disjoint   no two CTAs write one output tile, unless the launch declares
           a split-K over those grid axes and the call launches the
           reduce kernel that sums the splits.
grid       gridDim.x <= 2^31 - 1, gridDim.y and gridDim.z <= 65,535, at
           most 1,024 threads a block, gridDim.x a multiple of the
           cluster's width and at most 8 CTAs a cluster.
smem       static shared memory <= 48 KB, static + dynamic <= the card's
           opt-in 227 KB (232,448 bytes) a block.

``python -m repro_torch.analysis.kernel_audit [--check] [--json PATH]``
prints the per-launch table of grid, block, shared memory and route
(the counterpart of the reference's ``vmem_table``;
``BENCH_kernel_vmem.json`` stays the TPU's). ``chip_smoke.py`` holds the predicted kernel, grid, block and
shared memory against what the profiler records on the card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Tile", "LaunchCase", "LaunchSpec", "AuditFinding", "CaseReport",
    "register_launch_spec", "get_registry", "load_registry", "audit_case",
    "audit_call", "audit_all", "predict_recorded", "SMEM_OPTIN",
    "SMEM_STATIC", "main",
]

SMEM_OPTIN = 232_448          # bytes a block may opt in to on an H100
SMEM_STATIC = 48 * 1024       # static shared memory a block may declare
GRID_X_MAX = 2 ** 31 - 1
GRID_YZ_MAX = 65_535
THREADS_MAX = 1024
CLUSTER_MAX = 8               # portable cluster size
SMS = 132                     # H100 SXM streaming multiprocessors

# the four kernel families; each module registers its specs at import
AUDIT_MODULES = (
    "repro_torch.kernels.flash_attention.audit",
    "repro_torch.kernels.flgw_matmul.audit",
    "repro_torch.kernels.osel_encode.audit",
    "repro_torch.kernels.plan_encode.audit",
)


@dataclass(frozen=True)
class Tile:
    """One operand's (``role="in"``) or output's (``"out"``) tile of a
    CTA. ``origin(x, y, z)`` maps the CTAs' indices (numpy arrays over
    the grid, or over a persistent kernel's work items) to the tile's
    first element in each dimension. ``ragged``: the kernel guards the
    elements past the operand's edge, so a last tile may overhang it;
    ``empty_ok``: a CTA may hold a tile wholly past the edge and write
    nothing (a persistent pair's second row tile)."""
    name: str
    shape: Tuple[int, ...]
    block: Tuple[int, ...]
    origin: Callable
    role: str = "in"
    ragged: bool = True
    empty_ok: bool = False


@dataclass(frozen=True)
class LaunchCase:
    """One kernel launch: what the C entry launches for one call."""
    label: str
    entry: str
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dynamic_smem: int
    static_smem: int = 0
    cluster: Tuple[int, int, int] = (1, 1, 1)
    tiles: Tuple[Tile, ...] = ()
    # a persistent kernel's work items (its tiles are indexed by them,
    # not by the CTAs, which walk them)
    work: Optional[Tuple[int, int, int]] = None
    # grid axes whose CTAs write partial sums of one output tile, and the
    # kernel of the same call that sums them
    split_axes: Tuple[int, ...] = ()
    reduce_kernel: Optional[str] = None
    tags: Tuple[str, ...] = ()    # the route, as the table prints it

    @property
    def smem(self) -> int:
        return self.static_smem + self.dynamic_smem


@dataclass(frozen=True)
class LaunchSpec:
    """The launch model of one C entry point (a ``KernelEntry``).
    ``launches(params)`` gives the :class:`LaunchCase` list of one call
    (a split-K call: the product, then its reduce); ``kernels`` names
    every ``__global__`` kernel the entry can launch; ``corpus`` holds
    the calls to audit; ``from_args`` maps the arguments of one recorded
    ``KernelEntry`` call (pointers as ints, then the integers) to the
    params of ``launches``."""
    entry: str
    library: str
    kernels: Tuple[str, ...]
    launches: Callable[[dict], List[LaunchCase]]
    corpus: Tuple[dict, ...]
    from_args: Callable[[tuple], dict]


@dataclass(frozen=True)
class AuditFinding:
    kernel: str
    case: str
    check: str               # bounds|coverage|disjoint|grid|smem
    message: str

    def render(self) -> str:
        return f"{self.kernel}[{self.case}] {self.check}: {self.message}"


@dataclass
class CaseReport:
    entry: str
    kernel: str
    case: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    cluster: Tuple[int, int, int]
    ctas: int
    smem: int
    findings: List[AuditFinding] = field(default_factory=list)
    tags: Tuple[str, ...] = ()

    @property
    def ok(self) -> bool:
        return not self.findings


_REGISTRY: Dict[str, LaunchSpec] = {}


def register_launch_spec(spec: LaunchSpec) -> LaunchSpec:
    """Register (or re-register, on a module reload) a LaunchSpec."""
    _REGISTRY[spec.entry] = spec
    return spec


def get_registry() -> Dict[str, LaunchSpec]:
    return dict(_REGISTRY)


def load_registry() -> Dict[str, LaunchSpec]:
    """Import the four families' audit modules (no card, no CUDA call)
    and return the populated registry."""
    for mod in AUDIT_MODULES:
        importlib.import_module(mod)
    return get_registry()


def predict_recorded(entry: str, args: tuple) -> List[LaunchCase]:
    """The launches of one recorded ``KernelEntry`` call of ``entry``."""
    spec = load_registry()[entry]
    return spec.launches(spec.from_args(tuple(args)))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _points(space: Tuple[int, int, int]):
    axes = [np.arange(n, dtype=np.int64) for n in space]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return x.ravel(), y.ravel(), z.ravel()


def _check_limits(case: LaunchCase, out: List[AuditFinding]) -> None:
    k = case.kernel
    gx, gy, gz = case.grid
    if min(case.grid) < 1 or gx > GRID_X_MAX or gy > GRID_YZ_MAX \
            or gz > GRID_YZ_MAX:
        out.append(AuditFinding(
            k, case.label, "grid",
            f"grid {case.grid} outside the launch limits (x <= "
            f"{GRID_X_MAX}, y and z <= {GRID_YZ_MAX}, each >= 1)"))
    threads = int(np.prod(case.block))
    if threads < 1 or threads > THREADS_MAX:
        out.append(AuditFinding(
            k, case.label, "grid",
            f"block {case.block} has {threads} threads (1..{THREADS_MAX})"))
    csize = int(np.prod(case.cluster))
    if csize > CLUSTER_MAX or any(g % c for g, c in zip(case.grid,
                                                          case.cluster)):
        out.append(AuditFinding(
            k, case.label, "grid",
            f"cluster {case.cluster} does not tile grid {case.grid} or "
            f"holds more than {CLUSTER_MAX} CTAs"))
    if case.static_smem > SMEM_STATIC:
        out.append(AuditFinding(
            k, case.label, "smem",
            f"static shared memory {case.static_smem} B over the "
            f"{SMEM_STATIC} B a kernel may declare"))
    if case.smem > SMEM_OPTIN:
        out.append(AuditFinding(
            k, case.label, "smem",
            f"shared memory {case.smem} B ({case.static_smem} static + "
            f"{case.dynamic_smem} dynamic) over the card's {SMEM_OPTIN} B "
            f"a block"))


def _check_tile(case: LaunchCase, t: Tile, pts, out: List[AuditFinding],
                writers: dict) -> None:
    k, lab = case.kernel, case.label
    org = [np.broadcast_to(np.asarray(o, dtype=np.int64), pts[0].shape)
           for o in t.origin(*pts)]
    if len(org) != len(t.shape) or len(t.block) != len(t.shape):
        out.append(AuditFinding(k, lab, "bounds",
                                f"{t.name}: origin of rank {len(org)}, "
                                f"block rank {len(t.block)}, operand rank "
                                f"{len(t.shape)}"))
        return
    o = np.stack(org, axis=1)
    shape = np.asarray(t.shape, dtype=np.int64)
    block = np.asarray(t.block, dtype=np.int64)
    past = (o >= shape).any(axis=1)
    bad = (o < 0).any(axis=1)
    if t.ragged:
        bad |= past & (not t.empty_ok)
    else:
        bad |= (o + block > shape).any(axis=1)
    if bad.any():
        i = int(np.argmax(bad))
        out.append(AuditFinding(
            k, lab, "bounds",
            f"{t.name}: {int(bad.sum())} CTA(s) out of bounds; CTA "
            f"{tuple(int(p[i]) for p in pts)} places block {t.block} at "
            f"{tuple(int(v) for v in o[i])} in shape {t.shape}"))
    if t.role != "out":
        return
    inside = ~past
    if (o[inside] % block).any():
        out.append(AuditFinding(k, lab, "coverage",
                                f"{t.name}: tiles not aligned to its "
                                f"{t.block} blocks"))
        return
    idx = o[inside] // block
    want = int(np.prod([cdiv(s, b) for s, b in zip(t.shape, t.block)]))
    uniq, first, counts = np.unique(idx, axis=0, return_index=True,
                                    return_counts=True)
    if len(uniq) < want:
        have = {tuple(r) for r in uniq.tolist()}
        gap = next(tuple(p) for p in np.ndindex(
            *[cdiv(s, b) for s, b in zip(t.shape, t.block)])
            if tuple(p) not in have)
        out.append(AuditFinding(
            k, lab, "coverage",
            f"{t.name}: {want - len(uniq)} of {want} output tile(s) never "
            f"written; first gap at tile {gap}"))
    dup = counts > 1
    if dup.any():
        inside_pts = [p[inside] for p in pts]
        # the CTAs that write a tile more than once differ only along the
        # declared split axes, and the call reduces the splits
        others = [a for a in range(3) if a not in case.split_axes]
        inv = np.unique(idx, axis=0, return_inverse=True)[1].ravel()
        key = np.stack([inv] + [inside_pts[a] for a in others], axis=1)
        undeclared = len(np.unique(key, axis=0)) != len(uniq)
        if undeclared or not case.split_axes:
            j = int(np.argmax(dup))
            out.append(AuditFinding(
                k, lab, "disjoint",
                f"{t.name}: {int(dup.sum())} output tile(s) written by "
                f"more than one CTA outside a declared split-K (first: "
                f"tile {tuple(int(v) for v in uniq[j])}, CTA "
                f"{tuple(int(p[first[j]]) for p in inside_pts)})"))
        else:
            writers[(case.label, t.name)] = case.reduce_kernel


def audit_case(case: LaunchCase, call: Sequence[LaunchCase] = ()
               ) -> CaseReport:
    """The checks of one launch (``call``: the launches of its call, for
    a split-K's reduce kernel)."""
    findings: List[AuditFinding] = []
    _check_limits(case, findings)
    pts = _points(case.work if case.work is not None else case.grid)
    writers: dict = {}
    for t in case.tiles:
        _check_tile(case, t, pts, findings, writers)
    kernels = {c.kernel for c in call}
    for (_, name), reduce_kernel in writers.items():
        if reduce_kernel is None or reduce_kernel not in kernels:
            findings.append(AuditFinding(
                case.kernel, case.label, "disjoint",
                f"{name}: split-K over axes {case.split_axes} without its "
                f"reduce kernel in the call"))
    return CaseReport(case.entry, case.kernel, case.label, case.grid,
                      case.block, case.cluster,
                      int(np.prod(case.grid)), case.smem, findings,
                      case.tags)


def audit_call(launches: Sequence[LaunchCase]) -> List[CaseReport]:
    return [audit_case(c, launches) for c in launches]


def audit_all(*, entry_filter: str = "") -> List[CaseReport]:
    reports: List[CaseReport] = []
    registry = load_registry()
    for name in sorted(registry):
        if entry_filter and entry_filter not in name:
            continue
        spec = registry[name]
        for params in spec.corpus:
            reports.extend(audit_call(spec.launches(dict(params))))
    return reports


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.kernel_audit",
        description="Audit every registered CUDA launch (route, grid, "
                    "block, cluster, shared memory; bounds, coverage, "
                    "disjoint writes) over the shape corpus, no card "
                    "needed.")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any finding")
    ap.add_argument("--entry", default="",
                    help="only audit C entries whose name contains this")
    ap.add_argument("--json", default=None,
                    help="also write the per-launch table as JSON")
    args = ap.parse_args(argv)
    reports = audit_all(entry_filter=args.entry)
    if not reports:
        print("no LaunchSpecs matched", file=sys.stderr)
        return 1
    kw = max(len(r.kernel) for r in reports)
    cw = max(len(r.case) for r in reports)
    print(f"{'kernel':<{kw}}  {'case':<{cw}}  {'grid':<20} "
          f"{'block':<14} {'ctas':>8}  {'smem':>8}  {'route':<22} checks")
    for r in reports:
        status = "ok" if r.ok else ",".join(
            sorted({f.check for f in r.findings}))
        print(f"{r.kernel:<{kw}}  {r.case:<{cw}}  {str(r.grid):<20} "
              f"{str(r.block):<14} {r.ctas:>8}  {r.smem:>8}  "
              f"{','.join(r.tags):<22} {status}")
    findings = [f for r in reports for f in r.findings]
    print(f"{len(reports)} launch(es) of {len({r.entry for r in reports})} "
          f"C entries and {len({r.kernel for r in reports})} kernels")
    if args.json:
        doc: Dict[str, Dict] = {}
        for r in reports:
            doc.setdefault(r.kernel, {})[r.case] = {
                "entry": r.entry, "grid": list(r.grid),
                "block": list(r.block), "cluster": list(r.cluster),
                "ctas": r.ctas, "smem_bytes": r.smem, "route": list(r.tags),
                "ok": r.ok,
                "findings": [f.render() for f in r.findings]}
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=1)
        print(f"wrote {args.json}")
    if findings:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
        return 1
    print("audit clean: bounds, coverage, disjoint writes, grid limits and "
          "shared memory hold for every registered launch across the "
          "corpus")
    return 0


if __name__ == "__main__":
    # under ``python -m`` this module is ``__main__``; the audit modules
    # register into the canonical module, so run that one's main
    from repro_torch.analysis.kernel_audit import main as _canonical_main
    sys.exit(_canonical_main())
