"""Sharded, atomic, *verified* checkpointing (the port's copy of
``repro/ckpt/checkpoint.py``: the same layout, files and rules).

Layout:
    <dir>/step_<N>.tmp/            (written)
        manifest.json              tree structure + leaf metadata
                                   (paths, dtypes, global shapes)
        shard_<host>.npz           this host's leaf shards
        shard_<host>.sums.json     per-tensor sha256 + npz file sha256
        commit.json                commit marker: env key + sha256 of
                                   every file above (written LAST)
    <dir>/step_<N>/                (atomic rename on completion)

Fault-tolerance properties (as the reference's):
  * atomic commit — a crash mid-write leaves only a .tmp dir, never a
    half-valid checkpoint; ``latest_step`` ignores .tmp;
  * verified commit — ``commit.json`` is written after every shard and
    the manifest and records their checksums: ``verify_step`` proves a
    checkpoint complete without trusting the rename alone, and
    ``restore`` re-checks per-tensor checksums, so a bit-flipped shard
    reads as ``CheckpointCorrupt``, not as silently wrong weights;
  * walk-back restore — ``newest_restorable`` / ``restore_or_init``
    (``repro_torch.ckpt.manager``) skip truncated, corrupt or torn steps
    and fall back to the newest complete and verified one;
  * per-host shard files, concatenated along the leading axis on
    restore (the manifest records global shapes);
  * bounded retention (``keep``): old checkpoints are removed only
    after a new commit that verifies, and the newest VERIFIED checkpoint
    is never deleted.

Leaves are torch tensors, keyed by their paths in the reference's form
(``.params/embed/table``, ``.opt/.step``, ...) over the port's own tree,
whose layers are a list (``layers/<i>``) where the reference stacks them
under ``decoder``: the two packages share the files, and a state moves
between them through ``convert.py``.  A tied tensor is one leaf, named by
the model's tree (``Ties.keys``: zamba2's block under ``shared_attn``,
with the reference's leaf names below it).  numpy has no bfloat16, so a
bf16 leaf is stored as its ``uint16`` view and the manifest names
``bfloat16``.  ``restore`` writes into the example tree's tensors, on
their device, and returns that tree.

Host memory: the reference builds the whole ``.npz`` in memory.  Here the
same npz format (a zip of ``.npy`` members, as ``np.savez`` writes) is
streamed into the ``.tmp`` file one leaf at a time, hashed as it streams
(the per-tensor sums on worker threads), so a save holds about one leaf
on the host; a restore reads one member at a time.

Every durable write goes through ``repro_torch.core.artifacts`` (tmp +
fsync + atomic rename, the shared disk-fault injector).
"""
from __future__ import annotations

import collections
import concurrent.futures as futures
import hashlib
import json
import os
import pathlib
import shutil
import zipfile
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.core.artifacts import (
    _disk_fault,
    atomic_write_bytes,
    env_key,
    file_sha256,
    fsync_dir,
    read_bytes,
)
from repro_torch.models.transformer import Ties

#: torch dtypes stored as another numpy dtype of the same bytes
_STORED_AS = {torch.bfloat16: (np.uint16, np.int16, torch.int16)}
_HASH_THREADS = 4


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification (missing files, checksum
    mismatch, unparsable metadata).  Restore walk-back catches this and
    falls back to an older verified step."""


def _flatten_with_paths(tree: Any) -> tuple[list[tuple[str, Any]], Any]:
    """(key, leaf) pairs, each tensor once (``Ties``): a tensor that
    several places hold (zamba2's tied shared-attention block, its
    moments) is written and restored once, under the name the model's
    tree gives it (``Ties.keys``: the reference's ``.../shared_attn/...``),
    and a restore into it fills every place."""
    ties = Ties(tree)
    return list(zip(ties.keys(tree), ties.unique(tree))), ties.spec


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes as a C-contiguous numpy array on the host."""
    t = t.detach()
    if t.dtype in _STORED_AS:
        stored, _, view = _STORED_AS[t.dtype]
        return t.contiguous().view(view).cpu().numpy().view(stored)
    return t.contiguous().cpu().numpy()


def _tensor_sha(arr: np.ndarray) -> str:
    return hashlib.sha256(memoryview(np.require(arr, requirements="C"))
                          .cast("B")).hexdigest()


class _HashingWriter:
    """A write-only, unseekable file wrapper that hashes what passes on
    ``pool``'s one worker (sha256 releases the interpreter lock), beside
    the zip's CRC and the write: a ``zipfile`` given it writes its
    members in one forward pass."""

    def __init__(self, f, pool: futures.Executor):
        self._f, self._h, self._n = f, hashlib.sha256(), 0
        self._pool, self._queued = pool, collections.deque()

    def write(self, b) -> int:
        self._f.write(b)
        data = bytes(b)
        # one worker: the updates run in order; a few chunks queued at most
        while len(self._queued) >= _HASH_THREADS:
            self._queued.popleft().result()
        self._queued.append(self._pool.submit(self._h.update, data))
        self._n += len(data)
        return len(data)

    def tell(self) -> int:
        return self._n

    def seek(self, *a):
        raise OSError("unseekable")

    def flush(self) -> None:
        self._f.flush()

    def hexdigest(self) -> str:
        while self._queued:
            self._queued.popleft().result()
        return self._h.hexdigest()


def _write_shard(path: pathlib.Path, arrays) -> tuple[str, dict]:
    """Stream ``arrays`` ((key, np array) pairs) into the npz ``path``
    (tmp + fsync + atomic rename).  Returns (file sha256, per-tensor
    sha256).  The disk-fault injector's write faults fire as in
    ``atomic_write_bytes``: raise before the write, or a torn transfer
    (the file cut short after its checksum was taken)."""
    act = _disk_fault("write")
    if act == "raise":
        raise OSError(f"injected disk write fault: {path.name}")
    tmp = path.with_name(path.name + ".tmp")
    sums: dict[str, futures.Future] = {}
    with futures.ThreadPoolExecutor(_HASH_THREADS) as pool, \
            futures.ThreadPoolExecutor(1) as stream, open(tmp, "wb") as f:
        w = _HashingWriter(f, stream)
        with zipfile.ZipFile(w, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, arr in arrays:
                # a few leaves in flight at most: the host holds about one
                busy = [f for f in sums.values() if not f.done()]
                if len(busy) >= _HASH_THREADS:
                    busy[0].result()
                sums[key] = pool.submit(_tensor_sha, arr)
                with zf.open(key + ".npy", "w", force_zip64=True) as m:
                    np.lib.format.write_array(m, arr, allow_pickle=False)
        f.flush()
        if act == "truncate":
            f.truncate(max(w.tell() // 2 - 1, 0))
        os.fsync(f.fileno())
        digest = w.hexdigest()
        tensors = {k: s.result() for k, s in sums.items()}
    os.replace(tmp, path)
    return digest, tensors


def save(directory: str | pathlib.Path, step: int, tree: Any, *,
         host_id: int = 0, num_hosts: int = 1, keep: int = 3) -> pathlib.Path:
    """Write one checkpoint atomically.  Single-host writes everything;
    multi-host writes host-local rows of the leading axis."""
    directory = pathlib.Path(directory)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    tmp.mkdir(parents=True, exist_ok=True)

    keyed, spec = _flatten_with_paths(tree)
    manifest = {
        "step": step,
        "num_hosts": num_hosts,
        "leaves": [{"key": k, "shape": list(v.shape),
                    "dtype": _dtype_name(v)} for k, v in keyed],
        "treedef": str(spec),
    }

    def host_arrays():
        for k, v in keyed:
            arr = _host_array(v)
            if num_hosts > 1 and arr.ndim > 0 and \
                    arr.shape[0] % num_hosts == 0:
                rows = arr.shape[0] // num_hosts
                arr = arr[host_id * rows:(host_id + 1) * rows]
            yield k, arr

    shard_name = f"shard_{host_id}.npz"
    file_sha, sums = _write_shard(tmp / shard_name, host_arrays())
    atomic_write_bytes(
        tmp / f"shard_{host_id}.sums.json",
        json.dumps({"file_sha256": file_sha, "tensors": sums}).encode())
    if host_id == 0:
        atomic_write_bytes(tmp / "manifest.json",
                           json.dumps(manifest).encode())
    # two-phase commit: rename only once every host's shard (and the
    # manifest) is present — whichever host finishes last commits.  The
    # commit marker goes in LAST, carrying checksums of every file.
    shards_present = len(list(tmp.glob("shard_*.npz")))
    if shards_present >= num_hosts and (tmp / "manifest.json").exists():
        # this host's shard hashed as it streamed; the rest read back
        files = {p.name: (file_sha if p.name == shard_name
                          else file_sha256(p))
                 for p in sorted(tmp.iterdir()) if p.name != "commit.json"}
        atomic_write_bytes(tmp / "commit.json",
                           json.dumps({"env": env_key(), "step": step,
                                       "files": files}).encode())
        fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        fsync_dir(directory)
        # retention: only after a commit that VERIFIES (a torn commit
        # must not orphan the last-known-good); nothing to delete, no
        # read-back
        steps = sorted(all_steps(directory))
        if len(steps) > keep and verify_step(directory, step) == "verified":
            for old in steps[:-keep]:
                shutil.rmtree(directory / f"step_{old}", ignore_errors=True)
    return final


def all_steps(directory: str | pathlib.Path) -> list[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp"):
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str | pathlib.Path) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def verify_step(directory: str | pathlib.Path, step: int) -> str:
    """Integrity status of one checkpoint, without loading tensors:

    * ``"verified"`` — commit marker present and every recorded file
      exists with a matching sha256;
    * ``"legacy"``   — no commit marker, but a manifest and at least
      one shard parse (the pre-checksum format);
    * ``"corrupt"``  — marker/manifest unparsable, files missing, or
      checksums disagree;
    * ``"missing"``  — no such step directory.
    """
    d = pathlib.Path(directory) / f"step_{step}"
    if not d.is_dir():
        return "missing"
    marker = d / "commit.json"
    if not marker.exists():
        try:
            json.loads(read_bytes(d / "manifest.json"))
            if not list(d.glob("shard_*.npz")):
                return "corrupt"
            return "legacy"
        except (OSError, ValueError):
            return "corrupt"
    try:
        rec = json.loads(read_bytes(marker))
        for name, sha in rec["files"].items():
            p = d / name
            if not p.exists() or file_sha256(p) != sha:
                return "corrupt"
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return "corrupt"
    return "verified"


def newest_restorable(directory: str | pathlib.Path) -> int | None:
    """The newest step that verifies as complete (``verified`` or
    ``legacy``) — the step restore walk-back would land on."""
    for step in reversed(all_steps(directory)):
        if verify_step(directory, step) in ("verified", "legacy"):
            return step
    return None


def _open_shard(step: int, s: pathlib.Path, pool) -> tuple[Any, Any]:
    """One shard opened for member reads, its whole-file checksum
    checked (on a worker thread, beside the reads) where a sums sidecar
    exists.  Returns (NpzFile, (per-tensor sums or None, future))."""
    act = _disk_fault("read")
    if act == "raise":
        raise OSError(f"injected disk read fault: {s.name}")
    if act == "truncate":
        raise CheckpointCorrupt(f"step {step}: {s.name} torn read")
    sums_p = s.with_name(s.stem + ".sums.json")
    sums = None
    check = None
    if sums_p.exists():
        sums = json.loads(read_bytes(sums_p))
        check = pool.submit(file_sha256, s)
    return np.load(s, allow_pickle=False), (sums, check)


def restore(directory: str | pathlib.Path, step: int, example_tree: Any,
            *, num_hosts_now: int = 1) -> Any:
    """Restore into ``example_tree``: every leaf is checked against the
    manifest's shape and copied into the example's tensor on its device,
    one leaf at a time, its checksum checked on a worker thread beside
    the next reads; returns ``example_tree``.

    Handles host-count changes: all shard files are concatenated along
    the leading axis to reassemble global leaves.  Raises
    ``CheckpointCorrupt`` on truncated / unparsable / bit-flipped data;
    a shape mismatch against ``example_tree`` stays ``AssertionError``
    (a config error, not data rot).  After a raise the example's leaves
    may hold part of the checkpoint: the caller starts again from a
    fresh tree (``CheckpointManager.restore_or_init`` does)."""
    directory = pathlib.Path(directory) / f"step_{step}"
    try:
        manifest = json.loads(read_bytes(directory / "manifest.json"))
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"step {step}: bad manifest: {e}") from e
    shards = sorted(directory.glob("shard_*.npz"),
                    key=lambda p: int(p.stem.split("_")[1]))
    if not shards:
        raise CheckpointCorrupt(f"step {step}: no shard files")
    keyed, _ = _flatten_with_paths(example_tree)
    metas = {m["key"]: m for m in manifest.get("leaves", [])}
    with futures.ThreadPoolExecutor(_HASH_THREADS) as pool:
        opened = []
        try:
            for s in shards:
                try:
                    opened.append((s, *_open_shard(step, s, pool)))
                except CheckpointCorrupt:
                    raise
                except Exception as e:
                    raise CheckpointCorrupt(
                        f"step {step}: unreadable shard {s.name}: {e}"
                    ) from e
            checks: collections.deque = collections.deque()

            def check(k, want, got):
                if got.result() != want:
                    raise CheckpointCorrupt(
                        f"step {step}: tensor {k} checksum mismatch")

            for k, example in keyed:
                if k not in metas:
                    raise CheckpointCorrupt(f"step {step}: leaf {k} absent")
                arr, sums = _read_leaf(step, k, metas[k], opened)
                # the sums on the pool, beside the next reads and copies
                for part, want in sums:
                    while len(checks) >= _HASH_THREADS:
                        check(*checks.popleft())
                    checks.append((k, want, pool.submit(_tensor_sha, part)))
                assert tuple(arr.shape) == tuple(example.shape), \
                    f"{k}: ckpt {arr.shape} != model {tuple(example.shape)}"
                with torch.no_grad():
                    example.copy_(_as_tensor(arr, metas[k]["dtype"]))
            while checks:
                check(*checks.popleft())
            for s, _, (sums, whole) in opened:
                if whole is not None and \
                        sums.get("file_sha256") != whole.result():
                    raise CheckpointCorrupt(
                        f"step {step}: {s.name} file checksum mismatch")
        finally:
            for _, npz, _ in opened:
                npz.close()
    return example_tree


def _read_leaf(step: int, k: str, meta: dict, opened: list
               ) -> tuple[np.ndarray, list]:
    """Leaf ``k`` from every shard that holds it, reassembled along the
    leading axis, and the (part, recorded sha256) pairs to check."""
    shape = tuple(meta["shape"])
    parts, sums_of = [], []
    try:
        for s, npz, (sums, _) in opened:
            if k not in npz.files:
                continue
            arr = npz[k]
            tensors = None if sums is None else sums.get("tensors", {})
            if tensors is not None and k in tensors:
                sums_of.append((arr, tensors[k]))
            parts.append(arr)
    except CheckpointCorrupt:
        raise
    except Exception as e:  # truncated npz members, zip errors, ...
        raise CheckpointCorrupt(
            f"step {step}: shard data unreadable: {e}") from e
    if not parts:
        raise CheckpointCorrupt(
            f"step {step}: leaf {k} missing from all shards")
    if tuple(parts[0].shape) == shape:
        return parts[0], sums_of   # unsharded leaf: hosts hold replicas
    arr = np.concatenate(parts, axis=0)
    if arr.shape != shape:
        raise CheckpointCorrupt(
            f"step {step}: {k} reassembled {arr.shape} != saved {shape}")
    return arr, sums_of


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The stored array as a torch tensor of the manifest's dtype (a bf16
    leaf's uint16 bytes viewed back)."""
    arr = np.require(arr, requirements="C")     # keeps a 0-d leaf 0-d
    want = getattr(torch, dtype, None)
    if want in _STORED_AS:
        _, signed, _ = _STORED_AS[want]
        return torch.from_numpy(arr.view(signed)).view(want)
    return torch.from_numpy(arr)
