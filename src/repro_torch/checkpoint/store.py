"""Atomic checkpoints with a hash per leaf.

Port of ``repro.checkpoint.store``, with the same layout, so that a
checkpoint written by either package restores in the other:

    <dir>/step_00000123.tmp-<pid>-<ns>/   # written first
        manifest.json                     # paths, shapes, dtypes, hashes
        arr_000000.npy ...                # one file per leaf
    <dir>/step_00000123/                  # renamed when complete

* **Atomicity**: a crash mid-write leaves only a ``.tmp-*`` directory,
  which restore ignores and the next save removes. The rename is the
  commit point.
* **Integrity**: the manifest holds a sha256 of each leaf's bytes;
  restore checks every leaf before it writes any. The leaves are hashed
  (and, on restore, read) on a pool of threads: ``hashlib`` and the file
  reads release the interpreter lock, so a state's leaves hash on as
  many cores (one core took 8.95 s for gemma2-2b's 2-layer 7.5 GB state
  on the H100 host).
* **Leaf paths** are ``jax.tree_util.keystr`` of each leaf, in JAX's
  flatten order (NamedTuple fields ``.name`` in declaration order, dict
  keys ``['key']`` in sorted order, sequence items ``[i]``; ``None`` and
  empty containers hold no leaf), built here by :func:`tree_paths`.
* **bfloat16** leaves are written as their raw 2-byte words (numpy dtype
  ``V2``) with the manifest dtype ``"bfloat16"``, and read back through
  an ``int16`` view, so neither package needs the other's bf16 type.

* **Meshes**: a state of DTensors (``repro_torch.sharding.partition``)
  is saved whole: each leaf is gathered from its shards onto the mesh's
  first rank, which writes, while the other ranks wait at a barrier, so
  the manifest is leaf for leaf the one-process layout and restores in
  either package. A restore
  into DTensors reads and verifies each whole leaf and keeps each rank's
  shards, whatever mesh the checkpoint was saved on.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding import partition


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and len(x) > 0 and all(
        hasattr(p, "is_shard") for p in x)


def tree_paths(tree, prefix: str = "", *, placements: bool = False
               ) -> list[tuple[str, Any]]:
    """``(keystr path, leaf)`` of every leaf of ``tree`` (nested dicts,
    lists, tuples and NamedTuples), in JAX's flatten order.
    ``placements``: a placements tree, each tuple of placements a leaf."""
    if tree is None:
        return []
    if placements and _is_placements(tree):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for name in tree._fields
                for pl in tree_paths(getattr(tree, name), f"{prefix}.{name}",
                                     placements=placements)]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, f"{prefix}[{i}]",
                                     placements=placements)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}[{k!r}]",
                                     placements=placements)]
    return [(prefix, tree)]


def leaf_to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records:
    bf16 tensors as their raw 2-byte words (``V2``, ``"bfloat16"``).
    ``.cpu()`` waits for the work that writes the tensor on its stream."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


# threads that hash and read leaves (module docstring)
IO_THREADS = min(8, os.cpu_count() or 1)


def hash_array(a: np.ndarray) -> str:
    """First 16 hex digits of the sha256 of the array's bytes in C order
    (the JAX package's ``_hash``)."""
    return hashlib.sha256(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8)).hexdigest()[:16]


def save_checkpoint(ckpt_dir, step: int, tree, *, keep: int = 3) -> str:
    """Write one checkpoint; atomic commit via rename. Returns final path.
    A tree of DTensors is saved whole by every rank of its mesh together
    (module docstring)."""
    flat = tree_paths(tree)
    if any(isinstance(leaf, DTensor) for _, leaf in flat):
        return _save_sharded(ckpt_dir, step, flat, keep)
    return _write(ckpt_dir, step, flat, keep)


def _save_sharded(ckpt_dir, step: int, flat, keep: int) -> str:
    """A state of DTensors saved whole: each leaf in turn is gathered onto
    the mesh's first rank (every rank takes part in the collectives),
    that rank writes, and every rank waits at a barrier until the
    checkpoint is committed."""
    mesh = partition.mesh_of([leaf for _, leaf in flat])
    first = not any(partition.mesh_coords(mesh))

    def whole():
        for path, leaf in flat:
            full = partition.gather_to_first(leaf) \
                if isinstance(leaf, DTensor) else leaf
            yield path, (leaf_to_numpy(full) if first else None)

    if first:
        final = _write(ckpt_dir, step, whole(), keep)
    else:
        for _ in whole():
            pass
        final = str(pathlib.Path(ckpt_dir) / f"step_{step:08d}")
    if dist.is_initialized():
        dist.barrier()
    return final


def _write(ckpt_dir, step: int, flat, keep: int) -> str:
    """Write ``(path, leaf)`` pairs (a leaf a tensor or a ``(host array,
    dtype name)`` pair) as one checkpoint; commit by rename."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir()

    manifest = {"step": step, "leaves": []}
    with ThreadPoolExecutor(IO_THREADS) as pool:
        hashes = []
        for i, (path, leaf) in enumerate(flat):
            arr, dtype = leaf if isinstance(leaf, tuple) \
                else leaf_to_numpy(leaf)
            fname = f"arr_{i:06d}.npy"
            hashes.append(pool.submit(hash_array, arr))
            np.save(tmp / fname, arr)
            manifest["leaves"].append({
                "path": path, "file": fname, "shape": list(arr.shape),
                "dtype": dtype})
        for e, h in zip(manifest["leaves"], hashes):
            e["hash"] = h.result()
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if final.exists():                      # crash-retry of the same step
        shutil.rmtree(final)
    tmp.rename(final)                       # commit point

    # GC: stale tmp dirs + old steps beyond ``keep``.
    for d in ckpt_dir.glob("step_*.tmp-*"):
        shutil.rmtree(d, ignore_errors=True)
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
    return str(final)


def list_steps(ckpt_dir) -> list[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    for d in ckpt_dir.glob("step_*"):
        if d.name.endswith(".json") or ".tmp-" in d.name:
            continue
        if (d / "manifest.json").exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _step_dir(ckpt_dir, step: Optional[int]) -> tuple[pathlib.Path, int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return ckpt_dir / f"step_{step:08d}", step


def read_manifest(ckpt_dir, *, step: Optional[int] = None) -> dict:
    """One checkpoint's manifest (the latest when ``step`` is None)."""
    d, _ = _step_dir(ckpt_dir, step)
    return json.loads((d / "manifest.json").read_text())


def manifest_paths(ckpt_dir, *, step: Optional[int] = None) -> set:
    """Leaf keystr paths recorded in one checkpoint's manifest."""
    return {e["path"] for e in read_manifest(ckpt_dir, step=step)["leaves"]}


def _load_leaf(d: pathlib.Path, e: dict, like: torch.Tensor, path: str,
               verify: bool) -> torch.Tensor:
    """One recorded leaf as a CPU tensor of ``like``'s dtype, its hash
    checked against the manifest."""
    arr = np.load(d / e["file"])
    if verify and hash_array(arr) != e["hash"]:
        raise IOError(f"checkpoint corruption at {e['path']}")
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{d} holds {path} as {tuple(arr.shape)}, the "
                         f"restore target as {tuple(like.shape)}")
    if arr.dtype.kind == "V":   # np.load loses bf16's name: raw words
        if e["dtype"] != "bfloat16":
            raise TypeError(f"{d}: {path} has dtype {e['dtype']}, which "
                            "the port cannot read")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(like.dtype)
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    want = torch.empty((), dtype=like.dtype).numpy().dtype
    return torch.from_numpy(arr.astype(want, copy=False))


def restore_checkpoint(ckpt_dir, target_tree, *, shardings=None,
                       step: Optional[int] = None, verify: bool = True,
                       strict: bool = True):
    """Restore into ``target_tree``, whose tensors are overwritten in
    place (each keeps its device, dtype and shape). Returns
    ``(target_tree, step)``.

    A DTensor leaf (a state on a mesh) takes this rank's shard of the
    whole recorded leaf, whatever mesh the checkpoint was saved on (the
    elastic reshard). ``shardings``, the reference's argument, is a
    placements tree of the target's structure
    (``partition.constrained_shardings``); it must be the target's own,
    which the in-place restore keeps.

    In place, as the port's optimizers update their state: at gemma2-2b's
    size a second copy of the state on the card would cost up to 26 GB.
    A restore that raises leaves the target untouched: the manifest's
    paths are checked, and every leaf is read and its hash verified on
    the host, before the first tensor is written.

    ``strict=False`` tolerates target leaves the manifest does not record
    (they keep their values) instead of raising. The main client is
    checkpoint *schema growth*: grouped ``TrainState``s carry derived
    ``plans`` leaves that pre-plans manifests lack, which
    ``repro_torch.train.state.restore_state`` re-encodes from the
    restored params. There is no ``shardings`` argument: the port has no
    mesh yet.
    """
    d, step = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())

    by_path = {e["path"]: e for e in manifest["leaves"]}
    flat = tree_paths(target_tree)
    for path, leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"restore target leaf {path} is a "
                            f"{type(leaf).__name__}, not a tensor")
    missing = [p for p, _ in flat if p not in by_path]
    if missing and strict:
        raise KeyError(
            f"{d} records {len(by_path)} leaves but the restore target has "
            f"{len(missing)} the manifest does not (e.g. {missing[0]}). "
            "If the target schema grew since the save (pre-plans grouped "
            "checkpoints lack TrainState.plans leaves), restore with "
            "strict=False and recompute the missing leaves, or use "
            "repro_torch.train.state.restore_state which migrates and "
            "re-encodes plans automatically.")
    if shardings is not None:
        want = dict(tree_paths(shardings, placements=True))
        for p, leaf in flat:
            have = tuple(leaf.placements) if isinstance(leaf, DTensor) \
                else None
            if want.get(p) is not None and tuple(want[p]) != have:
                raise ValueError(f"restore target leaf {p} lies as {have}, "
                                 f"shardings= asks for {tuple(want[p])}")
    present = [(p, leaf) for p, leaf in flat if p in by_path]
    with ThreadPoolExecutor(IO_THREADS) as pool:
        values = list(pool.map(
            lambda pl: _load_leaf(d, by_path[pl[0]], pl[1], pl[0], verify),
            present))
    loaded = [(leaf, v) for (_, leaf), v in zip(present, values)]
    with torch.no_grad():
        for leaf, value in loaded:
            if isinstance(leaf, DTensor):
                leaf.to_local().copy_(partition.shard_of(
                    value, leaf.placements, leaf.device_mesh))
            else:
                leaf.copy_(value)
    return target_tree, step
