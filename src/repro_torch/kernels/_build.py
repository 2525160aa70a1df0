"""Build the CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds) and is compiled for ``sm_90a`` into
``<build dir>/lib<name>-<source hash>.so``, then loaded with ``ctypes``.
Generated sources (the anchored segments of an offload plan, one
translation unit per plan, including ``csrc/fused_matmul.cuh``) are
written to ``<build dir>/gen/`` and built the same way
(``start_generated`` / ``finish_generated``).  The build happens at first use, never at
import: a machine without ``nvcc`` can import every module of the
package.

The build directory is ``build/`` at the root of the checkout (the
directory that holds ``src/``); it also holds the generated Triton
sources (``triton_src/``) and Triton's cache (``triton_cache/``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: ``-fno-gnu-unique``: a function-local static of a template in a header
#: (the launchers' ``static const cudaError_t attr =
#: cudaFuncSetAttribute(...)``) is otherwise an ``STB_GNU_UNIQUE`` symbol,
#: which the dynamic linker binds once for the whole process whatever
#: ``RTLD_LOCAL`` says.  Two generated libraries that instantiate the same
#: segment would share one guard, and the second library's kernel would
#: launch without its shared-memory attribute ever set (refused:
#: ``invalid argument``).  With the flag every library keeps its own.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xcompiler",
              "-fno-gnu-unique")

_LIBS: dict[str, ctypes.CDLL] = {}
#: seconds each library took to build in this process (0.0 = found built)
BUILD_SECONDS: dict[str, float] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA "
        "kernels of repro_torch are built from source at first use")


def sources() -> list[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1()
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(dep.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str, extra_flags: tuple[str, ...] = (), force: bool = False):
    """Start one ``nvcc`` for ``name`` unless its library exists (or
    ``force``)."""
    src, out = _target(name)
    return _spawn(src, out, extra_flags, force)


def _spawn(src: Path, out: Path, extra_flags: tuple[str, ...],
           force: bool = False):
    if out.exists() and not force:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), *extra_flags, "-o",
           str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> str:
    """Wait for a started build; returns the compiler's output."""
    if started is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return ""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return log


def build_all(*, verbose: bool = False) -> dict[str, str]:
    """Build every source in ``csrc/``, one ``nvcc`` each, all started
    together.  Returns the compiler output per source; with ``verbose``
    each source is compiled anew, built or not, for its ``-Xptxas -v``
    resource usage."""
    extra = ("-Xptxas", "-v") if verbose else ()
    started = {n: _start(n, extra, force=verbose) for n in sources()}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
    return lib


def _generated_target(source: str) -> tuple[str, Path, Path]:
    digest = hashlib.sha1(source.encode())
    for dep in sorted(CSRC.glob("*.cuh")):
        digest.update(dep.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    name = f"gen-{digest.hexdigest()[:12]}"
    return name, build_dir() / "gen" / f"{name}.cu", \
        build_dir() / f"lib{name}.so"


def start_generated(source: str, *, verbose: bool = False):
    """Write a generated translation unit under ``build/gen`` and start
    its ``nvcc`` (None when its library exists).  Returns
    ``(name, started)`` for ``finish_generated``."""
    name, src, out = _generated_target(source)
    src.parent.mkdir(parents=True, exist_ok=True)
    if not src.exists():
        tmp = src.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, src)
    return name, _spawn(src, out, ("-Xptxas", "-v") if verbose else ())


def finish_generated(name: str, started) -> tuple[ctypes.CDLL, str]:
    log = _finish(name, started)
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(
            str(build_dir() / f"lib{name}.so"))
    return lib, log
