"""Durable, corruption-safe on-disk artifacts (the port's copy of
``repro/core/artifacts.py``: the same API, protocol and on-disk format,
stamped with torch's versions in place of jax's).

The paper's end-to-end flow (§V) compiles a program for MPU *once* and
deploys it; everything durable in this repo (offload plans, checkpoint
manifests) goes through this module so that durability has ONE failure
contract: **a bad artifact is a counted miss, never an exception and
never a wrong answer**.

Write protocol (per entry):

    1. payload  -> ``<key>.bin.tmp``   write + flush + fsync
    2. atomic   -> ``os.replace`` to ``<key>.bin``
    3. marker   -> ``<key>.ok.tmp``    commit record (sha256, size,
                                       env key, meta) + fsync
    4. atomic   -> ``os.replace`` to ``<key>.ok``  <- the commit point
    5. fsync the directory

A reader that finds ``.bin`` without ``.ok`` saw a torn write: that is
a *miss*, not corruption.  A reader that finds both but the checksum,
size, or version/environment key disagrees saw *corruption*: the entry
is quarantined (renamed ``<key>.corrupt``) so it is never served again,
and the caller falls back to recomputing.

Every entry is keyed under a **version/environment key** — the
package's version, torch's version, the CUDA version torch was built
with, and the store schema version — so an upgraded process never
deserializes a stale-format artifact: version skew reads as corruption
(counted + quarantined), not as a crash.

Cross-process coordination uses an advisory ``fcntl`` lock on
``<dir>/.lock`` around writes and evictions; reads are lock-free (the
commit marker is the linearization point).  The store is LRU-bounded
(``max_entries`` / ``max_bytes``, recency = marker mtime, touched on
every hit) so a long-lived fleet cache cannot grow without bound.

``set_disk_injector`` installs a fault injector (see
``repro_torch/serve/faults.py``'s ``disk_io`` class) that makes reads/writes raise
or truncate — CI's chaos path drives every failure mode above without
real disk faults.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
from typing import Any

try:  # advisory locking: POSIX only; the store degrades to lockless
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

SCHEMA_VERSION = 1

# -- fault injection hook (duck-typed: needs .disk_io(op) -> action) --------
_DISK_INJECTOR: Any = None


def set_disk_injector(injector: Any):
    """Install a disk fault injector process-wide; returns the previous
    one.  ``injector.disk_io(op)`` is consulted on every artifact read/
    write and may return ``None`` (no fault), ``"raise"`` (simulate an
    IO error) or ``"truncate"`` (simulate a torn transfer)."""
    global _DISK_INJECTOR
    prev = _DISK_INJECTOR
    _DISK_INJECTOR = injector
    return prev


def _disk_fault(op: str) -> str | None:
    inj = _DISK_INJECTOR
    if inj is None:
        return None
    hook = getattr(inj, "disk_io", None)
    return hook(op) if hook is not None else None


# -- primitives shared with the checkpoint store ----------------------------

def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_sha256(path: str | pathlib.Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def fsync_dir(path: str | pathlib.Path) -> None:
    """Durably record a directory's entries (renames/creates).  Best
    effort: some filesystems refuse directory fds."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str | pathlib.Path, data: bytes) -> None:
    """tmp + fsync + atomic rename.  The injector's write faults fire
    here (raise before the write, truncate the written payload) so every
    durable file in the stack shares one chaos surface."""
    path = pathlib.Path(path)
    act = _disk_fault("write")
    if act == "raise":
        raise OSError(f"injected disk write fault: {path.name}")
    if act == "truncate":
        data = data[:max(len(data) // 2 - 1, 0)]
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_bytes(path: str | pathlib.Path) -> bytes:
    """Plain read through the disk-fault hook (raise / torn read)."""
    act = _disk_fault("read")
    if act == "raise":
        raise OSError(f"injected disk read fault: {pathlib.Path(path).name}")
    data = pathlib.Path(path).read_bytes()
    if act == "truncate":
        data = data[:max(len(data) // 2 - 1, 0)]
    return data


def env_key() -> dict:
    """The version/environment key every artifact is stamped with."""
    import torch

    try:
        from importlib.metadata import version
        pkg = version("mpu-repro")
    except Exception:
        pkg = "0.1.0"
    return {"repro_torch": pkg, "torch": torch.__version__,
            "cuda": torch.version.cuda, "schema": SCHEMA_VERSION}


@contextlib.contextmanager
def file_lock(path: str | pathlib.Path):
    """Advisory exclusive lock (cross-process).  No-op where fcntl is
    unavailable."""
    if fcntl is None:  # pragma: no cover - non-POSIX
        yield
        return
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a+b") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


# -- the store --------------------------------------------------------------

class ArtifactStore:
    """Bounded, checksummed, atomically-written key/value artifact dir.

    API is *total*: ``fetch`` and ``put`` never raise on IO or
    corruption — failures become counters (``self.counters``) and
    misses.  Keys are hex digests (see ``key_for``); payloads are
    opaque bytes.
    """

    def __init__(self, directory: str | pathlib.Path, *,
                 max_entries: int = 512, max_bytes: int | None = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.counters = {"hits": 0, "misses": 0, "corrupt": 0,
                         "writes": 0, "write_failures": 0, "evictions": 0}
        self._env = env_key()

    # -- keys ---------------------------------------------------------------
    def key_for(self, *parts: str) -> str:
        """Deterministic entry key: sha256 over the canonicalized parts
        plus the version/environment key, so one directory can be shared
        by different schemas/versions without collisions."""
        h = hashlib.sha256()
        h.update(json.dumps(self._env, sort_keys=True).encode())
        for p in parts:
            b = p if isinstance(p, bytes) else str(p).encode()
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
        return h.hexdigest()

    # -- paths --------------------------------------------------------------
    def _bin(self, key: str) -> pathlib.Path:
        return self.dir / f"{key}.bin"

    def _marker(self, key: str) -> pathlib.Path:
        return self.dir / f"{key}.ok"

    # -- read ---------------------------------------------------------------
    def fetch(self, key: str) -> tuple[bytes | None, str]:
        """Returns ``(payload, status)`` with status one of ``"hit"`` /
        ``"miss"`` / ``"corrupt"``.  Corrupt entries (bad marker, bad
        checksum, truncated payload, version skew, torn read) are
        quarantined on disk before returning."""
        marker_p, bin_p = self._marker(key), self._bin(key)
        if not marker_p.exists():
            # torn write (bin without marker) or plain absence: a miss
            self.counters["misses"] += 1
            return None, "miss"
        try:
            marker = json.loads(read_bytes(marker_p))
            if marker.get("env") != self._env:
                raise _Corrupt("version/environment skew")
            data = read_bytes(bin_p)
            if len(data) != marker["size"] or \
                    sha256_bytes(data) != marker["sha256"]:
                raise _Corrupt("checksum mismatch")
        except _Corrupt as e:
            self.counters["corrupt"] += 1
            self._quarantine(key, str(e))
            return None, "corrupt"
        except (OSError, ValueError, KeyError, TypeError) as e:
            # unreadable marker/payload: injected IO fault or real rot.
            # An IO *error* may be transient, so only quarantine when the
            # bytes themselves were readable-but-wrong (handled above);
            # here we just miss and keep the entry for the next reader.
            if isinstance(e, (ValueError, KeyError, TypeError)):
                self.counters["corrupt"] += 1
                self._quarantine(key, f"unparsable marker: {e}")
                return None, "corrupt"
            self.counters["misses"] += 1
            return None, "miss"
        self.counters["hits"] += 1
        with contextlib.suppress(OSError):
            os.utime(marker_p)  # LRU recency
        return data, "hit"

    def get(self, key: str) -> bytes | None:
        return self.fetch(key)[0]

    # -- write --------------------------------------------------------------
    def put(self, key: str, payload: bytes, meta: dict | None = None) -> int:
        """Atomically commit one entry; returns the number of entries
        evicted to stay within bounds (-1 on a failed write)."""
        try:
            with file_lock(self.dir / ".lock"):
                atomic_write_bytes(self._bin(key), payload)
                marker = {"sha256": sha256_bytes(payload),
                          "size": len(payload), "env": self._env,
                          "meta": meta or {}}
                atomic_write_bytes(self._marker(key),
                                   json.dumps(marker).encode())
                fsync_dir(self.dir)
                self.counters["writes"] += 1
                return self._evict(protect=key)
        except OSError:
            self.counters["write_failures"] += 1
            return -1

    def _evict(self, protect: str | None = None) -> int:
        """Drop least-recently-used committed entries beyond the bounds
        (never the entry just written).  Called under the lock."""
        entries = []
        for marker_p in self.dir.glob("*.ok"):
            key = marker_p.name[:-3]
            if key == protect:
                continue
            try:
                size = self._bin(key).stat().st_size
                entries.append((marker_p.stat().st_mtime, key, size))
            except OSError:
                continue
        entries.sort()
        n_over = len(entries) + 1 - self.max_entries
        evicted = 0
        total = sum(s for _, _, s in entries)
        if protect is not None:
            with contextlib.suppress(OSError):
                total += self._bin(protect).stat().st_size
        for mtime, key, size in entries:
            over_bytes = self.max_bytes is not None and \
                total > self.max_bytes
            if evicted < n_over or over_bytes:
                self._remove(key)
                evicted += 1
                total -= size
            else:
                break
        self.counters["evictions"] += evicted
        return evicted

    # -- hygiene ------------------------------------------------------------
    def _remove(self, key: str) -> None:
        with contextlib.suppress(OSError):
            self._marker(key).unlink(missing_ok=True)
        with contextlib.suppress(OSError):
            self._bin(key).unlink(missing_ok=True)

    def _quarantine(self, key: str, reason: str) -> None:
        """Rename a bad entry out of the namespace so it can never be
        served again; keep the bytes around for post-mortems."""
        with contextlib.suppress(OSError):
            self._marker(key).unlink(missing_ok=True)
        with contextlib.suppress(OSError):
            bad = self.dir / f"{key}.corrupt"
            if self._bin(key).exists():
                os.replace(self._bin(key), bad)
            (self.dir / f"{key}.why").write_text(reason)

    def quarantine(self, key: str, reason: str) -> None:
        """Caller-detected corruption (e.g. a payload that checksummed
        clean but failed domain validation): count + quarantine."""
        self.counters["corrupt"] += 1
        self._quarantine(key, reason)

    # -- introspection ------------------------------------------------------
    def keys(self) -> list[str]:
        return sorted(p.name[:-3] for p in self.dir.glob("*.ok"))

    def __len__(self) -> int:
        return len(list(self.dir.glob("*.ok")))


class _Corrupt(Exception):
    pass
