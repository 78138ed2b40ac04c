"""AST lint pass with the port's PyTorch and CUDA rules.

Port of ``repro.analysis.lint``: the same machinery (findings, ``# noqa``,
a baseline with stale-entry detection, ``--check``, ``--select``,
``--write-baseline``), the rules mapped from JAX and Pallas to PyTorch
and the hand-written kernels. Standard library only. Run as::

    python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py --check

=======  ====================================================================
code     what it catches
=======  ====================================================================
ANL001   A CUDA tensor built, or a ``torch.cuda.*`` call made, at import
         time in an importable module (sibling ``__init__.py``). It
         commits the process to a device (and initialises CUDA) before
         ``launch.mesh.init_distributed`` or a ``spawn`` can pick one:
         a spawned rank then inherits a context it cannot use.
ANL002   Host syncs (``.item()``, ``.tolist()``, ``.cpu()``,
         ``float()``/``int()``/``bool()`` of a tensor-valued call or
         subscript, ``np.asarray``/``np.array``,
         ``torch.cuda.synchronize``) inside a step that a ``make_*``
         factory builds, and, second form, once per iteration inside a
         loop that drives such a step (a name bound to a ``make_*``
         call or a module function named ``*_step``, or
         ``.decode``/``.prefill``/``.step``): fetch once per
         window instead. Loops that time on purpose (they call
         ``.synchronize()`` or ``.elapsed_time``) are exempt.
ANL003   A ``KernelEntry(library, symbol, argtypes)`` whose symbol is not
         in ``csrc/<library>.cu``'s ``extern "C"`` block, or whose
         argument count differs from that C signature's less the
         trailing stream: ctypes would pass the arguments shifted.
ANL004   A ``torch.autograd.Function`` with no ``backward``, or whose
         ``backward`` visibly returns (a tuple literal) a different
         number of gradients than ``forward`` takes inputs after
         ``ctx``.
ANL006   A ``__global__`` kernel of ``csrc/<library>.cu``, or a
         ``KernelEntry``, with no launch spec in its family's sibling
         ``audit.py`` (``repro_torch.analysis.kernel_audit``): it
         escapes the launch audit.
=======  ====================================================================

ANL005 (``lax.scan`` carries) has no counterpart: eager PyTorch loops in
Python and has no scan carry to mismatch.

Suppression: a trailing ``# noqa: ANL002`` on the offending line (comma
lists and bare ``# noqa`` both work). Accepted findings live in the
baseline file (``analysis_baseline_torch.txt``), one ``path|code|stripped
source line`` entry per finding, with ``#`` comments for justification;
``--write-baseline`` writes the current findings in that format. A
baseline entry that no longer matches a finding is stale and fails
``--check``.
"""
from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["RULES", "Finding", "lint_source", "lint_cuda_source",
           "lint_file", "lint_paths", "load_baseline",
           "format_baseline_entry", "stale_baseline_entries", "main"]

RULES = {
    "ANL001": "CUDA tensor or torch.cuda call at import time in an "
              "importable module (commits the device before "
              "init_distributed/spawn)",
    "ANL002": "host-device sync inside a step or a loop driving one",
    "ANL003": "KernelEntry does not match its C entry point",
    "ANL004": "autograd.Function gradient count or missing backward",
    "ANL006": "CUDA kernel or KernelEntry with no launch spec "
              "(escapes the launch audit)",
}

DEFAULT_BASELINE = "analysis_baseline_torch.txt"

_NOQA_RE = re.compile(
    r"#\s*noqa(?::\s*(?P<codes>[A-Z]+[0-9]+(?:\s*,\s*[A-Z]+[0-9]+)*))?",
    re.IGNORECASE)

# torch constructors that take a device
_TENSOR_CTORS = {
    "tensor", "as_tensor", "zeros", "ones", "full", "empty", "arange",
    "linspace", "logspace", "eye", "rand", "randn", "randint", "randperm",
    "zeros_like", "ones_like", "full_like", "empty_like", "rand_like",
    "randn_like", "from_numpy",
}
_SYNC_CALLS = {"numpy.asarray", "numpy.array", "torch.cuda.synchronize"}
_SYNC_METHODS = {"item", "tolist", "cpu"}
_STEP_ATTRS = {"decode", "prefill", "step"}
_TIMING_ATTRS = {"synchronize", "elapsed_time"}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str
    source: str = ""          # stripped source line (baseline fingerprint)

    def baseline_key(self) -> Tuple[str, str, str]:
        return (self.path.replace(os.sep, "/"), self.code, self.source)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: {self.code} "
                f"{self.message}")


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._anl_parent = node  # type: ignore[attr-defined]


def _collect_aliases(tree: ast.AST) -> Dict[str, str]:
    """Local name -> fully dotted module path, for every import."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _qual(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted path of a Name/Attribute chain with import aliases resolved
    (``np.asarray`` -> ``numpy.asarray``); None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _walk_skipping_defs(node: ast.AST) -> Iterable[ast.AST]:
    """Walk what runs at this node's own execution time: nested
    function, lambda and class bodies run later and are skipped."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def _contains_attr(node: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr in names
               for n in ast.walk(node))


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ast.dump(node)


def _is_cuda_device(node: ast.AST, aliases: Dict[str, str]) -> bool:
    """A literal CUDA device: ``"cuda"``, ``"cuda:0"`` or
    ``torch.device("cuda...")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and _qual(node.func, aliases) \
            == "torch.device" and node.args:
        return _is_cuda_device(node.args[0], aliases)
    return False


def _find_csrc(path: str) -> Optional[str]:
    """The ``csrc`` directory of the package that holds ``path``."""
    d = os.path.dirname(os.path.abspath(path))
    while True:
        if os.path.isdir(os.path.join(d, "csrc")):
            return os.path.join(d, "csrc")
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


_EXTERN_RE = re.compile(r'extern\s+"C"\s*\{')
_CDEF_RE = re.compile(
    r"^[ \t]*(?:const\s+)?[A-Za-z_][\w:]*\s*\**\s+\**\s*([A-Za-z_]\w*)\s*"
    r"\(([^)]*)\)\s*\{", re.MULTILINE)


def c_entry_points(cu_source: str) -> Dict[str, List[str]]:
    """{symbol: parameter names} of the functions defined in a CUDA
    source's ``extern "C"`` blocks."""
    out: Dict[str, List[str]] = {}
    for m in _EXTERN_RE.finditer(cu_source):
        depth, i = 1, m.end()
        while i < len(cu_source) and depth:
            depth += {"{": 1, "}": -1}.get(cu_source[i], 0)
            i += 1
        block = cu_source[m.end():i]
        # only the block's own top level: a function's body is nested
        for f in _CDEF_RE.finditer(block):
            params = [p.strip() for p in f.group(2).split(",")
                      if p.strip() and p.strip() != "void"]
            out[f.group(1)] = [re.split(r"[\s*&]+", p)[-1] for p in params]
    return out


_GLOBAL_RE = re.compile(
    r"__global__\s+(?:void\s+)?(?:__cluster_dims__\([^)]*\)\s*)?"
    r"(?:__launch_bounds__\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")


def cuda_kernels(cu_source: str) -> List[Tuple[str, int]]:
    """``(name, line)`` of every ``__global__`` kernel of a CUDA
    source."""
    return [(m.group(1), cu_source.count("\n", 0, m.start()) + 1)
            for m in _GLOBAL_RE.finditer(cu_source)]


def _audit_registers(audit_path: str, name: str) -> bool:
    """True when the family's ``audit.py`` registers a launch spec and
    names ``name`` (a C entry or a kernel) in a string literal."""
    try:
        with open(audit_path, "r", encoding="utf-8") as fh:
            src = fh.read()
    except OSError:
        return False
    return "register_launch_spec" in src and (
        f'"{name}"' in src or f"'{name}'" in src)


class _FileLinter:
    def __init__(self, path: str, src: str, tree: ast.Module,
                 importable: bool, select: Optional[Set[str]]):
        self.path = path
        self.src_lines = src.splitlines()
        self.tree = tree
        self.importable = importable
        self.select = select
        self.aliases = _collect_aliases(tree)
        self.findings: List[Finding] = []
        self.assigns: Dict[str, ast.AST] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.assigns[node.targets[0].id] = node.value

    def qual(self, node: ast.AST) -> Optional[str]:
        return _qual(node, self.aliases)

    def report(self, node: ast.AST, code: str, message: str) -> None:
        if self.select and code not in self.select:
            return
        line = getattr(node, "lineno", 1)
        text = (self.src_lines[line - 1]
                if 0 < line <= len(self.src_lines) else "")
        m = _NOQA_RE.search(text)
        if m:
            codes = m.group("codes")
            if codes is None or code in {c.strip().upper()
                                         for c in codes.split(",")}:
                return
        f = Finding(self.path, line, getattr(node, "col_offset", 0),
                    code, message, text.strip())
        if f not in self.findings:
            self.findings.append(f)

    def run(self) -> List[Finding]:
        self.anl001()
        self.anl002()
        self.anl003_anl006()
        self.anl004()
        self.findings.sort(key=lambda f: (f.line, f.col, f.code))
        return self.findings

    # -- ANL001: import-time CUDA ------------------------------------------

    def anl001(self) -> None:
        if not self.importable:
            return
        stack: List[ast.AST] = [self.tree]
        while stack:
            scope = stack.pop()
            body = getattr(scope, "body", [])
            if isinstance(scope, ast.If) and self._is_main_guard(scope):
                continue
            for stmt in body + getattr(scope, "orelse", []) + \
                    getattr(scope, "finalbody", []) + \
                    [s for h in getattr(scope, "handlers", [])
                     for s in h.body]:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, (ast.If, ast.Try, ast.With,
                                     ast.ClassDef, ast.For, ast.While)):
                    stack.append(stmt)
                    if isinstance(stmt, (ast.If, ast.While)):
                        self._check_import_time(stmt.test)
                    elif isinstance(stmt, ast.For):
                        self._check_import_time(stmt.iter)
                    elif isinstance(stmt, ast.With):
                        for item in stmt.items:
                            self._check_import_time(item.context_expr)
                    continue
                self._check_import_time(stmt)

    @staticmethod
    def _is_main_guard(node: ast.If) -> bool:
        t = node.test
        return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
                and t.left.id == "__name__")

    def _check_import_time(self, stmt: ast.AST) -> None:
        nodes = [stmt] + list(_walk_skipping_defs(stmt))
        for node in nodes:
            if isinstance(node, ast.Call):
                self._check_import_time_call(node)

    def _check_import_time_call(self, node: ast.Call) -> None:
        q = self.qual(node.func) or ""
        if q.startswith("torch.cuda."):
            self.report(node, "ANL001",
                        f"`{_unparse(node.func)}(...)` at import time "
                        f"initialises CUDA before init_distributed or a "
                        f"spawn can pick the device; call it lazily")
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "cuda" and not node.args:
            self.report(node, "ANL001",
                        f"`{_unparse(node)}` at import time puts a tensor "
                        f"on the card before the process picked one")
            return
        device_args = [kw.value for kw in node.keywords
                       if kw.arg == "device"]
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "to":
            device_args += node.args[:1]
        is_ctor = (q.startswith("torch.")
                   and q.rsplit(".", 1)[1] in _TENSOR_CTORS)
        if (is_ctor or (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "to")) \
                and any(_is_cuda_device(a, self.aliases)
                        for a in device_args):
            self.report(node, "ANL001",
                        f"`{_unparse(node.func)}(..., cuda)` at import "
                        f"time builds a CUDA tensor before the process "
                        f"picked its device; build it lazily, or keep "
                        f"module constants on the CPU")

    # -- ANL002: host syncs in steps and the loops that drive them ----------

    def _step_contexts(self) -> List[ast.AST]:
        """Functions defined inside a ``make_*`` factory."""
        out = []
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda)):
                continue
            p = getattr(node, "_anl_parent", None)
            while p is not None:
                if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and p.name.startswith("make_"):
                    out.append(node)
                    break
                p = getattr(p, "_anl_parent", None)
        return out

    def _step_names(self) -> Tuple[Set[str], Set[str]]:
        """Names and attribute names bound to a ``make_*step(...)`` call,
        and the module's own functions named ``*_step``."""
        names: Set[str] = {n.name for n in self.tree.body
                           if isinstance(n, ast.FunctionDef)
                           and n.name.endswith("_step")}
        attrs: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                q = self.qual(node.value.func) or ""
                if q.rsplit(".", 1)[-1].startswith("make_") \
                        and q.rsplit(".", 1)[-1].endswith("step"):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            names.add(tgt.id)
                        elif isinstance(tgt, ast.Attribute):
                            attrs.add(tgt.attr)
        return names, attrs

    def _sync_call_kind(self, node: ast.Call) -> Optional[str]:
        q = self.qual(node.func)
        if q in _SYNC_CALLS:
            return _unparse(node.func)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS and not node.args \
                and not node.keywords:
            return f".{node.func.attr}()"
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool") \
                and len(node.args) == 1:
            arg = node.args[0]
            # only a call or subscript argument smells like a tensor
            # pulled to the host; names and arithmetic are mostly static
            if isinstance(arg, (ast.Call, ast.Subscript)):
                if _contains_attr(arg, {"shape", "ndim", "size", "dtype",
                                        "numel", "dim"}):
                    return None
                if isinstance(arg, ast.Call) \
                        and isinstance(arg.func, ast.Name) \
                        and arg.func.id in ("len", "getattr", "max", "min",
                                            "round", "sum"):
                    return None
                return f"{node.func.id}()"
        return None

    def anl002(self) -> None:
        seen: Set[int] = set()
        for ctx in self._step_contexts():
            if id(ctx) in seen:
                continue
            seen.add(id(ctx))
            body = ctx.body if isinstance(ctx.body, list) else [ctx.body]
            for stmt in body:
                for node in [stmt] + list(ast.walk(stmt)):
                    if isinstance(node, ast.Call):
                        kind = self._sync_call_kind(node)
                        if kind:
                            name = getattr(ctx, "name", "<lambda>")
                            self.report(
                                node, "ANL002",
                                f"`{kind}` syncs the host with the card "
                                f"inside step `{name}`: the step stalls "
                                f"its stream and cannot be captured; "
                                f"keep the value on the device")
        names, attrs = self._step_names()
        step_attrs = attrs | _STEP_ATTRS
        for loop in [n for n in ast.walk(self.tree)
                     if isinstance(n, (ast.For, ast.While))]:
            body = [n for stmt in loop.body
                    for n in [stmt] + list(_walk_skipping_defs(stmt))]
            calls = [n for n in body if isinstance(n, ast.Call)]
            if any(isinstance(c.func, ast.Attribute)
                   and c.func.attr in _TIMING_ATTRS for c in calls):
                continue             # a timing loop syncs on purpose
            drives = any(
                (isinstance(c.func, ast.Attribute)
                 and c.func.attr in step_attrs)
                or (isinstance(c.func, ast.Name) and c.func.id in names)
                for c in calls)
            if not drives:
                continue
            for c in calls:
                kind = self._sync_call_kind(c)
                if kind:
                    self.report(
                        c, "ANL002",
                        f"`{kind}` syncs the host with the card on every "
                        f"iteration of a loop driving a step: fetch once "
                        f"a window (stack on the device, one fetch at the "
                        f"boundary)")

    # -- ANL003 / ANL006: KernelEntry against its C entry and audit ---------

    def _list_len(self, node: ast.AST, depth: int = 0) -> Optional[int]:
        """Length of a literal list expression: elements, ``*[x] * n``,
        ``*NAME`` of a module-level list, ``a + b``; None if unknown."""
        if depth > 8:
            return None
        if isinstance(node, ast.Name) and node.id in self.assigns:
            return self._list_len(self.assigns[node.id], depth + 1)
        if isinstance(node, (ast.List, ast.Tuple)):
            n = 0
            for e in node.elts:
                if isinstance(e, ast.Starred):
                    k = self._list_len(e.value, depth + 1)
                    if k is None:
                        return None
                    n += k
                else:
                    n += 1
            return n
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            for a, b in ((node.left, node.right), (node.right, node.left)):
                if isinstance(b, ast.Constant) and isinstance(b.value, int):
                    k = self._list_len(a, depth + 1)
                    return None if k is None else k * b.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a = self._list_len(node.left, depth + 1)
            b = self._list_len(node.right, depth + 1)
            return None if a is None or b is None else a + b
        return None

    def _kernel_entries(self) -> List[Tuple[ast.Call, str, str,
                                            Optional[ast.AST]]]:
        out = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            q = self.qual(node.func) or ""
            if q.rsplit(".", 1)[-1] != "KernelEntry":
                continue
            args = list(node.args)
            kw = {k.arg: k.value for k in node.keywords}
            lib = args[0] if args else kw.get("library")
            sym = args[1] if len(args) > 1 else kw.get("symbol")
            types = args[2] if len(args) > 2 else kw.get("argtypes")
            if not (isinstance(lib, ast.Constant)
                    and isinstance(sym, ast.Constant)):
                continue
            out.append((node, lib.value, sym.value, types))
        return out

    def anl003_anl006(self) -> None:
        entries = self._kernel_entries()
        if not entries:
            return
        csrc = _find_csrc(self.path)
        audit = os.path.join(os.path.dirname(os.path.abspath(self.path)),
                             "audit.py")
        for node, lib, sym, types in entries:
            if not _audit_registers(audit, sym):
                self.report(node, "ANL006",
                            f"KernelEntry `{sym}` has no launch spec in "
                            f"its sibling audit.py (register_launch_spec "
                            f"naming it): its launches escape the launch "
                            f"audit")
            cu = os.path.join(csrc, f"{lib}.cu") if csrc else None
            if cu is None or not os.path.exists(cu):
                self.report(node, "ANL003",
                            f"KernelEntry library `{lib}` has no source "
                            f"csrc/{lib}.cu")
                continue
            with open(cu, "r", encoding="utf-8") as fh:
                c_entries = c_entry_points(fh.read())
            if sym not in c_entries:
                self.report(node, "ANL003",
                            f"`{sym}` is not an extern \"C\" entry of "
                            f"csrc/{lib}.cu (entries: "
                            f"{', '.join(sorted(c_entries))})")
                continue
            params = c_entries[sym]
            want = len(params) - (1 if params and params[-1] == "stream"
                                  else 0)
            got = self._list_len(types) if types is not None else None
            if got is not None and got != want:
                self.report(node, "ANL003",
                            f"KernelEntry `{sym}` declares {got} argument "
                            f"types but csrc/{lib}.cu's `{sym}` takes "
                            f"{want} before the stream: ctypes would pass "
                            f"them shifted")

    # -- ANL004: autograd.Function ------------------------------------------

    def anl004(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not any((self.qual(b) or "").endswith("autograd.Function")
                       or (self.qual(b) or "") == "Function"
                       for b in node.bases):
                continue
            methods = {m.name: m for m in node.body
                       if isinstance(m, ast.FunctionDef)}
            if "backward" not in methods:
                self.report(node, "ANL004",
                            f"autograd.Function `{node.name}` has no "
                            f"backward: its gradient raises at run time")
                continue
            fwd = methods.get("forward")
            if fwd is None or fwd.args.vararg is not None:
                continue
            n_in = len(fwd.args.posonlyargs) + len(fwd.args.args)
            if "setup_context" not in methods:
                n_in -= 1                   # ctx
            for ret in ast.walk(methods["backward"]):
                if isinstance(ret, ast.Return) \
                        and isinstance(ret.value, ast.Tuple) \
                        and not any(isinstance(e, ast.Starred)
                                    for e in ret.value.elts) \
                        and len(ret.value.elts) != n_in:
                    self.report(
                        ret, "ANL004",
                        f"backward of `{node.name}` returns "
                        f"{len(ret.value.elts)} gradients but forward "
                        f"takes {n_in} inputs: autograd raises (one "
                        f"gradient, or None, an input)")


# ---------------------------------------------------------------------------
# CUDA sources: ANL006 for __global__ kernels
# ---------------------------------------------------------------------------

def lint_cuda_source(src: str, path: str, *,
                     select: Optional[Iterable[str]] = None
                     ) -> List[Finding]:
    """ANL006 for each ``__global__`` kernel of a CUDA source: its
    family's ``kernels/<library>/audit.py`` (beside the package's
    ``csrc``) must name it."""
    sel = {s.upper() for s in select} if select else None
    if sel is not None and "ANL006" not in sel:
        return []
    lib = os.path.splitext(os.path.basename(path))[0]
    root = os.path.dirname(os.path.dirname(os.path.abspath(path)))
    audit = os.path.join(root, "kernels", lib, "audit.py")
    lines = src.splitlines()
    out = []
    for name, line in cuda_kernels(src):
        text = lines[line - 1] if line <= len(lines) else ""
        m = _NOQA_RE.search(text)
        if m and (m.group("codes") is None or "ANL006" in m.group("codes")):
            continue
        if not _audit_registers(audit, name):
            out.append(Finding(path, line, 0, "ANL006",
                               f"__global__ `{name}` has no launch spec "
                               f"in kernels/{lib}/audit.py: its launches "
                               f"escape the launch audit", text.strip()))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>", *,
                importable: bool = False,
                select: Optional[Iterable[str]] = None) -> List[Finding]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, (e.offset or 1) - 1,
                        "ANL000", f"syntax error: {e.msg}")]
    _attach_parents(tree)
    sel = {s.upper() for s in select} if select else None
    return _FileLinter(path, src, tree, importable, sel).run()


def _is_importable(path: str) -> bool:
    return os.path.exists(os.path.join(os.path.dirname(os.path.abspath(
        path)), "__init__.py"))


def lint_file(path: str, *, select: Optional[Iterable[str]] = None,
              importable: Optional[bool] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    if path.endswith(".cu"):
        return lint_cuda_source(src, path, select=select)
    if importable is None:
        importable = _is_importable(path)
    return lint_source(src, path, importable=importable, select=select)


def _iter_files(roots: Sequence[str]) -> Iterable[str]:
    def wanted(p: str) -> bool:
        return p.endswith((".py", ".cu"))
    for root in roots:
        if os.path.isfile(root):
            if wanted(root):
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                p = os.path.join(dirpath, fn)
                if wanted(p):
                    yield p


def lint_paths(roots: Sequence[str], *,
               select: Optional[Iterable[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in _iter_files(roots):
        findings.extend(lint_file(path, select=select))
    return findings


# -- baseline ----------------------------------------------------------------

def format_baseline_entry(f: Finding) -> str:
    path, code, src = f.baseline_key()
    return f"{path}|{code}|{src}"


def load_baseline(path: str) -> Counter:
    entries: Counter = Counter()
    if not os.path.exists(path):
        return entries
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("|", 2)
            if len(parts) == 3:
                entries[(parts[0], parts[1], parts[2])] += 1
    return entries


def apply_baseline(findings: List[Finding],
                   baseline: Counter) -> Tuple[List[Finding], List[Finding]]:
    """-> (new findings, baselined findings). Each baseline entry absorbs
    as many findings as it has copies."""
    budget = Counter(baseline)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        k = f.baseline_key()
        if budget[k] > 0:
            budget[k] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def stale_baseline_entries(findings: List[Finding], baseline: Counter,
                           select: Optional[Iterable[str]] = None
                           ) -> List[Tuple[str, str, str]]:
    """Baseline entries (with multiplicity) that absorbed no finding.
    Under a narrowed ``select``, entries of codes not run are not
    stale."""
    budget = Counter(baseline)
    for f in findings:
        k = f.baseline_key()
        if budget[k] > 0:
            budget[k] -= 1
    sel = {s.upper() for s in select} if select else None
    stale: List[Tuple[str, str, str]] = []
    for key, count in sorted(budget.items()):
        if sel is not None and key[1] not in sel:
            continue
        stale.extend([key] * count)
    return stale


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="The port's PyTorch/CUDA lint pass (rules ANL001-"
                    "ANL004, ANL006; see the module docstring).")
    ap.add_argument("paths", nargs="+",
                    help="files or directory roots to lint (.py, .cu)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: exit 1 on any finding not in the "
                         "baseline, or a stale baseline entry")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run "
                         "(default: all)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline of accepted findings "
                         f"(default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write all current findings to the baseline "
                         "file and exit 0")
    args = ap.parse_args(argv)
    select = (args.select.split(",") if args.select else None)
    findings = lint_paths(args.paths, select=select)
    if args.write_baseline:
        with open(args.baseline, "w", encoding="utf-8") as fh:
            fh.write("# repro_torch.analysis.lint baseline: accepted "
                     "findings\n# format: path|rule|stripped source line\n"
                     "# justify each entry in a '#' comment line above it\n")
            for f in findings:
                fh.write(format_baseline_entry(f) + "\n")
        print(f"wrote {len(findings)} baseline entrie(s) to "
              f"{args.baseline}")
        return 0
    baseline = (Counter() if args.no_baseline
                else load_baseline(args.baseline))
    new, old = apply_baseline(findings, baseline)
    stale = stale_baseline_entries(findings, baseline, select)
    if not args.check:
        for f in new:
            print(f.render())
        for f in old:
            print(f"{f.render()}  [baselined]")
    elif new:
        for f in new:
            print(f.render())
    for path, code, src in stale:
        print(f"{args.baseline}: stale entry matches no finding; "
              f"delete it: {path}|{code}|{src}")
    counts = Counter(f.code for f in new)
    summary = ", ".join(f"{c}: {n}" for c, n in sorted(counts.items()))
    if new or (stale and args.check):
        if new:
            print(f"{len(new)} finding(s) not in baseline"
                  + (f" ({summary})" if summary else "")
                  + (f"; {len(old)} baselined" if old else ""))
        if stale:
            print(f"{len(stale)} stale baseline entrie(s)")
        return 1
    print("clean: 0 new finding(s)"
          + (f", {len(old)} baselined" if old else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
