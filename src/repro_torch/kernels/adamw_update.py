"""The fused AdamW update: the Triton kernel, its wrapper and its plain
version (B8).

``adamw_update`` replaces the TPU kernel of the same name in
``repro/kernels/adamw_update.py`` (``pl.pallas_call`` at :55): one pass
over a parameter leaf that reads ``p``, ``g``, ``m`` and ``v`` once and
writes ``p'``, ``m'`` and ``v'`` once,

  m' = b1 m + (1 - b1) g          v' = b2 v + (1 - b2) g g
  p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)

with ``hyper`` = [lr, b1, b2, eps, wd, bc1, bc2] (f32, on the device),
``m`` / ``v`` f32 and ``p`` / ``g`` any float dtype (math in f32, ``p'``
rounded to ``p``'s dtype).

On Hopper it is bound by bytes: ~15 operations per element against
16-28 bytes moved (4 reads, 3 writes), far below the card's balance, and
no value is reused, so the kernel is one elementwise Triton pass.  Each
leaf is viewed as ``[rows, c]`` (c = its last dim), as the TPU kernel
views it; a program covers a ``[RB, BC]`` tile of that view with masks
on both edges, so no row is padded.  It is compiled without multiply-add
contraction and divides and takes the square root with the correctly
rounded ``div_rn`` / ``sqrt_rn``, so it rounds every operation as the
plain version's eager PyTorch ops do.  ``triton`` is imported only when
the kernel is launched.
"""
from __future__ import annotations

import os

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.guard import kernel_guard

KERNEL = "adamw_update"
#: tile of one program: rows x lanes of the [rows, c] view
_RB, _BC = 4, 1024
_NUM_WARPS = 4


def _view(t: torch.Tensor) -> tuple[int, int]:
    """(rows, c) of a leaf's 2-D view (a rank-1 leaf is one row)."""
    n = t.numel()
    c = t.shape[-1] if t.dim() > 1 else n
    return n // max(c, 1), c


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


_KERNEL = None


def _kernel():
    """The ``@triton.jit`` kernel, defined at first launch."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(_build.build_dir() / "triton_cache"))
    import triton
    import triton.language as tl

    @triton.jit
    def adamw_kernel(p_ptr, g_ptr, m_ptr, v_ptr, hp_ptr, po_ptr, mo_ptr,
                     vo_ptr, rows, cols, RB: tl.constexpr,
                     BC: tl.constexpr):
        r = tl.program_id(0) * RB + tl.arange(0, RB)[:, None]
        c = tl.program_id(1) * BC + tl.arange(0, BC)[None, :]
        mask = (r < rows) & (c < cols)
        off = r.to(tl.int64) * cols + c
        lr = tl.load(hp_ptr + 0)
        b1 = tl.load(hp_ptr + 1)
        b2 = tl.load(hp_ptr + 2)
        eps = tl.load(hp_ptr + 3)
        wd = tl.load(hp_ptr + 4)
        bc1 = tl.load(hp_ptr + 5)
        bc2 = tl.load(hp_ptr + 6)
        p = tl.load(p_ptr + off, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
        m = tl.load(m_ptr + off, mask=mask, other=0.0)
        v = tl.load(v_ptr + off, mask=mask, other=0.0)
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g * g
        denom = tl.math.sqrt_rn(tl.math.div_rn(v_new, bc2)) + eps
        upd = tl.math.div_rn(tl.math.div_rn(m_new, bc1), denom) + wd * p
        p_new = p - lr * upd
        tl.store(po_ptr + off, p_new.to(po_ptr.dtype.element_ty), mask=mask)
        tl.store(mo_ptr + off, m_new, mask=mask)
        tl.store(vo_ptr + off, v_new, mask=mask)

    _KERNEL = adamw_kernel
    return _KERNEL


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, hyper: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch B8 on CUDA tensors; returns ``(p', m', v')`` as new
    tensors.  Raises on anything the kernel does not take; never falls
    back to the plain version."""
    if not all(t.is_cuda for t in (p, g, m, v, hyper)):
        raise RuntimeError(
            "adamw_update launches a Triton kernel: every operand must be "
            "a CUDA tensor (CPU tensors take the plain version)")
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError("p, g, m and v must have one shape")
    if m.dtype != torch.float32 or v.dtype != torch.float32 or \
            hyper.dtype != torch.float32 or hyper.numel() != 7:
        raise TypeError("m, v and hyper[7] must be float32")
    if not (p.is_floating_point() and g.is_floating_point()):
        raise TypeError("p and g must be floating point")
    p, g, m, v = (t.contiguous() for t in (p, g, m, v))
    rows, cols = _view(p)
    po = torch.empty_like(p)
    mo = torch.empty_like(m)
    vo = torch.empty_like(v)
    grid = (-(-rows // _RB), -(-cols // _BC))
    with torch.cuda.device(p.device):
        _kernel()[grid](p, g, m, v, hyper.contiguous(), po, mo, vo, rows,
                        cols, RB=_RB, BC=_BC, num_warps=_NUM_WARPS,
                        enable_fp_fusion=False)
    kernel_guard().count_launch(KERNEL)
    return po, mo, vo
