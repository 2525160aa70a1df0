"""The fused AdamW update: the CUDA kernel's wrapper and its plain
version (B8).

``adamw_update`` replaces the TPU kernel of the same name in
``repro/kernels/adamw_update.py`` (``pl.pallas_call`` at :55): one pass
over a parameter leaf that reads ``p``, ``g``, ``m`` and ``v`` once and
writes ``p'``, ``m'`` and ``v'`` once,

  m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
  p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)

with ``hyper`` = [lr, b1, b2, eps, wd, bc1, bc2] (f32, on the device),
``m`` / ``v`` f32 and ``p`` / ``g`` f32, bf16 or f16 (math in f32,
``p'`` rounded to ``p``'s dtype).

On Hopper it is bound by bytes (~15 operations per element against
16-28 bytes moved).  The kernel is ``csrc/adamw_update.cu``: one flat
pass over the contiguous leaf in packs of 8 elements moved as 16-byte
vectors, a grid that covers the leaf in one pass (``launch_grid``), a
scalar head and tail inside the kernel (``vector_plan``), streaming
cache hints, and
every operation rounded on its own in the plain version's order, so the
two are bit-equal (see the note there).  Functional, as the reference:
new output tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "adamw_update"
#: elements of a pack (one 16-byte vector of a 16-bit operand) and
#: threads of a block
PACK, THREADS = 8, 256
#: packs a thread loads before it computes (the kernel's U)
UNROLL = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def vector_plan(ptrs, sizes, n: int) -> tuple[int, int, int]:
    """``(head, packs, tail)`` of a leaf of ``n`` elements whose operands
    start at the byte addresses ``ptrs`` with element sizes ``sizes``:
    ``head`` scalar elements until every operand is 16-byte aligned, then
    ``packs`` packs of ``PACK`` elements, then ``tail`` scalar elements.
    Where no head below ``PACK`` aligns every operand, all ``n`` elements
    are the head."""
    for head in range(min(PACK, n + 1)):
        if all((a + head * s) % 16 == 0 for a, s in zip(ptrs, sizes)):
            packs = (n - head) // PACK
            return head, packs, n - head - packs * PACK
    return n, 0, 0


def launch_grid(head: int, packs: int, tail: int) -> int:
    """Blocks of ``THREADS`` threads that cover the leaf in one pass: a
    thread takes ``UNROLL`` packs and one head and one tail element (on
    the H100 one pass ran faster than a grid of a few blocks an SM
    walking the leaf)."""
    work = max(-(-packs // UNROLL), head, tail, 1)
    return -(-work // THREADS)


def adamw_update_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                       v: torch.Tensor, hyper: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain version: the same f32 ops in the same order."""
    lr, b1, b2, eps, wd, bc1, bc2 = hyper.float().unbind()
    pf, gf = p.float(), g.float()
    m_new = b1 * m + (1 - b1) * gf
    v_new = b2 * v + (1 - b2) * gf * gf
    upd = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) + wd * pf
    return (pf - lr * upd).to(p.dtype), m_new, v_new


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.adamw_update_launch.argtypes is None:
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.adamw_update_launch.argtypes = [vp] * 8 + [i64] * 3 + \
            [ci] * 3 + [vp]
        lib.adamw_update_launch.restype = ci
        lib.adamw_update_error.argtypes = [ci]
        lib.adamw_update_error.restype = ctypes.c_char_p
    return lib


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, hyper: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B8 on CUDA tensors; returns ``(p', m', v')`` as new
    tensors.  Runs on PyTorch's current stream, never synchronises;
    raises on anything the kernel does not take or on a refused launch,
    never falls back to the plain version."""
    if not (p.shape == g.shape == m.shape == v.shape) or \
            hyper.numel() != 7:
        raise ValueError("p, g, m and v must have one shape, hyper 7 "
                         "elements")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or \
            hyper.dtype != torch.float32:
        raise TypeError("m, v and hyper must be float32")
    if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
        raise TypeError(f"p and g must be float32, bfloat16 or float16; got "
                        f"{p.dtype}, {g.dtype}")
    if not all(t.is_cuda for t in (p, g, m, v, hyper)):
        raise RuntimeError(
            "adamw_update launches a CUDA kernel: every operand must be "
            "a CUDA tensor (CPU tensors take the plain version)")
    p, g, m, v, hyper = (t.contiguous() for t in (p, g, m, v, hyper))
    po = torch.empty_like(p)
    mo = torch.empty_like(m)
    vo = torch.empty_like(v)
    n = p.numel()
    if n == 0:
        return po, mo, vo
    ts = (p, g, m, v, po, mo, vo)
    head, packs, tail = vector_plan([t.data_ptr() for t in ts],
                                    [t.element_size() for t in ts], n)
    lib = _lib()
    with torch.cuda.device(p.device):
        code = lib.adamw_update_launch(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            hyper.data_ptr(), po.data_ptr(), mo.data_ptr(), vo.data_ptr(),
            n, head, packs, _DTYPES[p.dtype], _DTYPES[g.dtype],
            launch_grid(head, packs, tail),
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.adamw_update_error(code).decode()
        raise RuntimeError(f"adamw_update launch failed at "
                           f"{tuple(p.shape)}: {msg}")
    kernel_guard().count_launch(KERNEL)
    return po, mo, vo
