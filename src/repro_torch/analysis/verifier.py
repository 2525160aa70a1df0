"""Static plan verifier: proves an offload plan safe without running it.

The counterpart of ``repro/analysis/verifier.py`` for the port's plans
(an ``OffloadPlan`` over a captured fx graph) and the port's kernels on
the H100.  The planner relies on inline guards (the epilogue row that
must fit shared memory, the far ops kept out of segments, the tiles its
kernels pick); this module checks the emitted plan against them
independently, as MPU's compilation flow (§V) runs a verifying backend
before it offloads instructions near-bank:

  1. **alias safety** — every ``Segment.donations`` pair (operand,
     output) names a bulk operand of the output's shape and dtype that
     is dead once the segment has run; donating a contraction stream is
     checked against the schedule of the kernel that runs it: its CTAs
     run in no order, so an output tile written in the tile while
     another CTA still reads the donated stream (the rows every column
     tile re-reads, the weight every row tile re-reads) is a race.  An
     epilogue that runs after a K split, in a kernel of its own, writes
     after the whole product has been read.
  2. **index bounds / coverage** — the row every operand is read at,
     evaluated from the expression the kernel itself is generated with
     (B2's ``role_rows``, the anchored epilogue's row map), is in bounds
     at every sampled output row, and an interior-broadcast row agrees
     with numpy broadcasting; the anchored grid (the sm90 tiles and K
     split, the weight stream's, the FMA template's row blocks) and B5's
     q tiles cover the output and the contraction once.
  3. **shared memory and registers on the H100** — the dynamic shared
     memory every kernel of a segment launches with, from the helper the
     launcher reads (``sm90_smem_bytes``, ``stream_smem_bytes``,
     ``epilogue_smem_bytes``, ``flash_attention.fwd_smem_bytes``), within
     the card's per-block limit (232,448 bytes) and the policy's budget;
     the accumulator tile held in registers, or within shared memory.
  4. **well-formedness** — no far op fused into a segment, spans inside
     the graph, the ``decisions`` table in agreement with the segments,
     and (given the graph) the plan's fingerprint that of the graph.

Findings are data (``Finding``), never exceptions; ``PlanVerificationError``
is for callers that fail hard.  Rule ids are the reference's
(``docs/torch_analysis.md`` has the catalog).  The reference also
verifies the plans of ``lax.scan`` / ``pjit`` bodies; the port captures
loops unrolled and has no inner plans.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.fx as fx

from repro_torch.core import prims
from repro_torch.core.machine import H100_SXM
from repro_torch.core.offload import (
    GRID_ROWS_BLOCK,
    OffloadPlan,
    OperandSpec,
    Segment,
    _matmul_gen,
    donation_layout,
    donation_refusal,
    graph_fingerprint,
    segment_call,
    storage_roots,
)
from repro_torch.kernels import fused_matmul as fm
from repro_torch.kernels import fused_matmul_bwd as fmb
from repro_torch.kernels.blockprog import dtype_name
from repro_torch.kernels.flash_attention import (
    fwd_smem_bytes,
    refusal,
    sm90_width,
)
from repro_torch.kernels.fused_elementwise import (
    operand_layout,
    role_rows,
    segment_row_block,
)

SEVERITIES = ("info", "warning", "error")

#: dynamic shared memory one block may opt into on the H100
SMEM_CAPACITY_BYTES = H100_SXM.smem_bytes
#: registers one thread may hold
REGISTERS_A_THREAD = 255

#: output rows evaluated in full up to this many; edges and a stride
#: sample above
_ENUM_CAP = 1 << 12
#: kernels whose launch writes an output into a donated operand's buffer:
#: B2's grid and the anchored B3 / B4 / B6 (B5's flash segment writes
#: fresh outputs)
_ALIASING_KINDS = frozenset({"grid", "matmul"})


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verification finding: ``rule`` a stable id (the catalog in
    ``docs/torch_analysis.md``), ``severity`` one of ``SEVERITIES``,
    ``segment`` the index into ``plan.segments`` (-1 for the plan),
    ``detail`` the explanation."""

    rule: str
    severity: str
    segment: int
    detail: str

    def __str__(self) -> str:
        where = f"seg {self.segment}" if self.segment >= 0 else "plan"
        return f"[{self.severity}] {self.rule} ({where}): {self.detail}"


class PlanVerificationError(RuntimeError):
    """Raised by enforcing callers (``mpu_offload(verify_plans=True)``)
    when a plan carries error-severity findings."""

    def __init__(self, findings: Sequence[Finding]):
        self.findings = list(findings)
        super().__init__(
            "offload plan failed verification:\n  "
            + "\n  ".join(str(f) for f in self.findings))


def max_severity(findings: Iterable[Finding]) -> str | None:
    worst = None
    for f in findings:
        if worst is None or SEVERITIES.index(f.severity) > \
                SEVERITIES.index(worst):
            worst = f.severity
    return worst


def has_errors(findings: Iterable[Finding]) -> bool:
    return any(f.severity == "error" for f in findings)


# ---------------------------------------------------------------------------
# small helpers over the graph
# ---------------------------------------------------------------------------

def _val(v):
    return v.meta.get("val") if isinstance(v, fx.Node) else v


def _size(v) -> int:
    t = _val(v)
    return int(t.numel()) if isinstance(t, torch.Tensor) else 1


def _dtype(v):
    t = _val(v)
    return t.dtype if isinstance(t, torch.Tensor) else None


def _grid_range(n: int, cap: int) -> list[int]:
    """Indices to evaluate at: all of them when few, else the edges and
    an interior stride sample."""
    if n <= cap:
        return list(range(n))
    e = min(64, max(cap // 4, 1))
    edge = list(range(e)) + list(range(n - e, n))
    step = max(n // cap, 1)
    return sorted(set(edge + list(range(0, n, step))))


@dataclasses.dataclass
class _Sets:
    """What the rules read of a plan's graph: the call nodes, each value's
    consumers (node indices), inputs, outputs, constants, the inputs
    the caller donates, and the storage each value shares
    (``core.offload.storage_roots``; ``storage`` lists the values of a
    root)."""

    eqns: list
    consumers: dict
    invars: set
    outvars: set
    constvars: set
    donated: set
    roots: dict
    storage: dict


def _graph_sets(plan: OffloadPlan) -> _Sets:
    eqns = plan.eqns
    consumers: dict[Any, list[int]] = {}
    for i, node in enumerate(eqns):
        for v in node.all_input_nodes:
            consumers.setdefault(v, []).append(i)
    graph = plan.annotation.graph
    nodes = list(graph.nodes)
    phs = [n for n in nodes if n.op == "placeholder"]
    outvars: set = set()
    for n in nodes:
        if n.op == "output":
            outvars.update(n.all_input_nodes)
    roots = storage_roots(graph)
    storage: dict[Any, list] = {}
    for n, r in roots.items():
        storage.setdefault(r, []).append(n)
    return _Sets(eqns, consumers, set(phs), outvars,
                 {n for n in nodes if n.op == "get_attr"},
                 {phs[k] for k in plan.donated_inputs if k < len(phs)},
                 roots, storage)


def _mm_stream_vars(seg: Segment) -> set:
    """Values the contraction of an anchored segment streams."""
    mm = seg.matmul
    return {mm.rhs, *(sp.var for sp in mm.lhs_specs),
            *(sp.var for sp in mm.rhs_specs)}


def _gen(eqns, seg: Segment) -> dict | None:
    """The generated code of an anchored (not flash) segment, through
    the function its wrapper launches with; None where the segment is
    too broken to generate (the bounds rules say why)."""
    try:
        return _matmul_gen(segment_call(eqns, seg))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# alias safety
# ---------------------------------------------------------------------------

def _anchored_ctas(seg: Segment, gen: dict) -> list[tuple]:
    """The CTAs of an anchored segment's GEMM kernel as
    ``(cta, out_rows, out_cols, k_range)``, over a sample of its grid
    (row tiles, column tiles, K splits), from the generated geometry."""
    mm = seg.matmul
    per = seg.rows // mm.batch
    if gen["path"] == "sm90":
        tm, tn, ks = fmb.SM90_TM, gen["tn"], max(gen["ks"], 1)
        kstep = gen["kch"] * fmb.SM90_BK
    elif gen["path"] == "stream":
        tm, tn, ks = fmb.STREAM_ROWS, gen["tn"], max(gen["ks"], 1)
        kstep = gen["kch"] * fmb.STREAM_BK
    else:
        tm, tn, ks = gen["rb"], fm.BN, max(gen["ks"], 1)
        kstep = gen["kch"]
    if mm.form == "drhs":
        ks, kstep = 1, mm.k
    out = []
    for b in _grid_range(mm.batch, 4):
        for i in _grid_range(-(-per // tm), 16):
            r0 = b * per + i * tm
            rows = (r0, min(r0 + tm, (b + 1) * per))
            for j in _grid_range(-(-mm.n // tn), 16):
                cols = (j * tn, min((j + 1) * tn, mm.n))
                for s in _grid_range(ks, 4):
                    k = (s * kstep, min((s + 1) * kstep, mm.k))
                    out.append(((b, i, j, s), b, rows, cols, k))
    return out


def _stream_reads(seg: Segment, var, b: int, rows, cols, k) -> tuple | None:
    """The flat elements of ``var`` one CTA reads as its contraction
    stream, as a bounding interval (over-approximated to whole rows:
    safe for a hazard, never misses one); None when it is not read."""
    mm = seg.matmul
    per = seg.rows // mm.batch
    lhs = any(var is s.var and s.role != "param_k" for s in mm.lhs_specs)
    rhs = var is mm.rhs or any(var is s.var and s.role == "bulk_w"
                               for s in mm.rhs_specs)
    if mm.form == "drhs":
        if lhs:     # x [batch*m, per]: every m row, this CTA's columns
            return (b * mm.k * per, (b + 1) * mm.k * per)
        if rhs:     # g [batch*m, n]
            return (b * mm.k * mm.n, (b + 1) * mm.k * mm.n)
        return None
    if lhs:         # x [rows, K]: this tile's rows over the split
        return (rows[0] * mm.k, rows[1] * mm.k)
    if rhs and mm.form == "fwd":    # w [batch*K, N]: the split's K rows
        return ((b * mm.k + k[0]) * mm.n, (b * mm.k + k[1]) * mm.n)
    if rhs:         # dlhs: w [batch*N, K], this tile's N rows
        return ((b * mm.n + cols[0]) * mm.k, (b * mm.n + cols[1]) * mm.k)
    return None


def _stream_race(seg: Segment, gen: dict, sp: OperandSpec, oi: int
                 ) -> str | None:
    """A write-then-read hazard for donating a contraction stream: where
    the epilogue runs in the tile, each CTA writes its output tile while
    the other CTAs of the grid, in no order, may still read the donated
    stream.  Where it runs after a K split (a kernel of its own, reading
    the workspace) every read of the stream precedes every write."""
    if gen["ks"]:
        return None
    out_cols = seg.out_cols[oi]
    ctas = _anchored_ctas(seg, gen)
    reads = []
    for cta, b, rows, cols, k in ctas:
        r = _stream_reads(seg, sp.var, b, rows, cols, k)
        if r is not None:
            reads.append((cta, r))
    for cta, b, rows, cols, k in ctas:
        wlo, whi = rows[0] * out_cols, rows[1] * out_cols
        for other, (rlo, rhi) in reads:
            if other != cta and rlo < whi and wlo < rhi:
                return (f"CTA {cta} writes output {oi} rows [{rows[0]}, "
                        f"{rows[1]}) in the tile while CTA {other} reads "
                        f"the donated stream at flat [{rlo}, {rhi}) "
                        f"(the {gen['path']} grid's CTAs run in no order)")
    return None


def _copied(seg: Segment, sp: OperandSpec) -> bool:
    """Whether the segment's kernel reads operand ``sp`` through a copy:
    B2 one no layout addresses in place (``operand_layout``), the
    anchored epilogue one that is not row-major."""
    val = _val(sp.var)
    if seg.matmul is not None:
        return not val.is_contiguous()
    return operand_layout(val, sp.rows, sp.cols) is False


def _kernel_race(sets: _Sets, seg: Segment, bi: int, oi: int,
                 memo: dict) -> str | None:
    """Where the segment's kernel reads the donated operand after it
    writes the output — in program order, or from a thread or program
    that another writes before (``core.offload.donation_refusal``, which
    asks ``fused_elementwise`` / ``fused_matmul``'s ``donation_refusal``
    on the code the launch runs; ``memo`` keeps it between pairs)."""
    try:
        return donation_refusal(sets.eqns, seg, bi, oi, memo)
    except Exception:
        return None       # the bounds rules say why it cannot generate


def _check_aliases(seg: Segment, si: int, sets: _Sets,
                   findings: list[Finding]) -> None:
    taken: set[int] = set()
    gen = None
    memo: dict = {}
    kind = "grid" if seg.matmul is None else \
        "flash" if seg.matmul.flash is not None else "matmul"
    padded = kind == "grid" and seg.donations and not segment_row_block(
        seg.rows, [s.meta for s in seg.operand_specs], GRID_ROWS_BLOCK,
        donate=True)[2]
    for bi, oi in seg.donations:
        if not (0 <= bi < len(seg.operand_specs)) or \
                not (0 <= oi < len(seg.outputs)):
            findings.append(Finding(
                "alias-index", "error", si,
                f"donation ({bi}, {oi}) out of range "
                f"({len(seg.operand_specs)} operands, "
                f"{len(seg.outputs)} outputs)"))
            continue
        if oi in taken:
            findings.append(Finding(
                "alias-index", "error", si,
                f"output {oi} aliased by more than one operand"))
        taken.add(oi)
        sp = seg.operand_specs[bi]
        if sp.role != "bulk":
            findings.append(Finding(
                "alias-role", "error", si,
                f"donated operand {bi} has role {sp.role!r}; only bulk "
                "operands own a full [rows, cols] buffer to reuse"))
            continue
        ov = seg.outputs[oi]
        if sp.cols != seg.out_cols[oi] or _dtype(sp.var) != _dtype(ov) or \
                _size(sp.var) != _size(ov):
            findings.append(Finding(
                "alias-shape", "error", si,
                f"donated operand {bi} [{sp.rows}x{sp.cols} "
                f"{_dtype(sp.var)}] does not match output {oi} "
                f"[{seg.rows}x{seg.out_cols[oi]} {_dtype(ov)}]"))
            continue
        if kind != "flash" and _copied(seg, sp):
            findings.append(Finding(
                "donation-dropped", "warning", si,
                f"donated operand {bi} is read through a copy: the kernel "
                f"cannot write output {oi} into its buffer"))
            continue
        why = donation_layout(sp.var, ov, permuted=kind == "grid")
        if why is not None:
            findings.append(Finding(
                "alias-shape", "error", si,
                f"donated operand {bi} cannot hold output {oi} as the "
                f"kernel writes it: {why}"))
            continue
        root = sets.roots.get(sp.var, sp.var)
        shared = sets.storage.get(root, [sp.var])
        if any(v in sets.outvars for v in shared):
            findings.append(Finding(
                "alias-live", "error", si,
                f"donated operand {bi} is a program output, or shares its "
                "storage with one: its buffer outlives the segment"))
        if root in sets.constvars:
            findings.append(Finding(
                "alias-live", "error", si,
                f"donated operand {bi} is a captured constant"))
        late = sorted({ci for v in shared for ci in sets.consumers.get(v, ())
                       if ci > seg.span_end})
        if late:
            findings.append(Finding(
                "alias-live", "error", si,
                f"donated operand {bi} (or a view of its storage) is still "
                f"read by node(s) {late} after the segment span ends at "
                f"{seg.span_end}"))
        if root in sets.invars:
            if root in sets.donated:
                findings.append(Finding(
                    "alias-invar", "info", si,
                    f"donated operand {bi} is a program input the caller "
                    "donates"))
            else:
                findings.append(Finding(
                    "alias-live", "error", si,
                    f"donated operand {bi} is (a view of) a program input "
                    "the caller does not donate"))
        mm = seg.matmul
        if mm is not None and mm.flash is None and \
                sp.var in _mm_stream_vars(seg):
            gen = gen or _gen(sets.eqns, seg)
            race = _stream_race(seg, gen, sp, oi) if gen else None
            if race:
                findings.append(Finding("alias-kaxis-race", "error", si,
                                        race))
            continue
        if kind != "flash" and not padded:
            race = _kernel_race(sets, seg, bi, oi, memo)
            if race is not None:
                findings.append(Finding("alias-order", "error", si,
                                        f"donation ({bi}, {oi}): {race}"))
    if seg.donations and kind not in _ALIASING_KINDS:
        findings.append(Finding(
            "donation-dropped", "warning", si,
            f"the {kind} kernel writes fresh outputs: the plan's "
            "aliases are dropped at launch and its donated-byte "
            "accounting is optimistic"))
    if padded:
        findings.append(Finding(
            "donation-dropped", "warning", si,
            "row padding of the row-block grid drops this segment's "
            "aliases (the launch refuses them)"))


def dropped_findings(plan: OffloadPlan) -> list[Finding]:
    """The donations the planner dropped because a kernel cannot honour
    them (``Segment.dropped``), as ``donation-dropped`` info findings.
    Not part of ``verify_plan``: the plan holds no such alias, so there
    is nothing in it to verify."""
    return [Finding("donation-dropped", "info", si,
                    f"the planner dropped donation ({bi}, {oi}): {why}")
            for si, seg in enumerate(plan.segments)
            for bi, oi, why in seg.dropped]


# ---------------------------------------------------------------------------
# index bounds / coverage
# ---------------------------------------------------------------------------

def _bcast_reference_row(out_row, lead: tuple, out_lead: tuple):
    """The operand row a broadcast output row (an int, or an int64 array
    of them) reads, by numpy broadcasting: the independent reference the
    kernels' row maps must agree with."""
    idx = 0
    rem = out_row
    coords = []
    for od in reversed(out_lead):
        coords.append(rem % od)
        rem //= od
    coords.reverse()
    for c, od, pd in zip(coords, out_lead, lead):
        idx = idx * pd + (c if pd != 1 else 0)
    return idx


def _check_spec(sp: OperandSpec, si: int, rows: int,
                findings: list[Finding]) -> bool:
    """The view of one grid / epilogue operand against its value and the
    segment's rows; False where its rows cannot be evaluated."""
    size = _size(sp.var)
    if sp.cols <= 0 or sp.rows <= 0:
        findings.append(Finding(
            "index-bounds", "error", si,
            f"operand {sp.role} view [{sp.rows}x{sp.cols}] is empty"))
        return False
    if size != sp.rows * sp.cols:
        findings.append(Finding(
            "index-bounds", "error", si,
            f"operand {sp.role} view [{sp.rows}x{sp.cols}] does not "
            f"tile its value ({size} elements)"))
        return False
    if sp.role == "param" and sp.rows != 1:
        findings.append(Finding(
            "index-bounds", "error", si,
            f"param operand must be a [1, cols] view, got "
            f"[{sp.rows}x{sp.cols}]"))
        return False
    if sp.role == "bulk" and sp.rows != rows:
        findings.append(Finding(
            "index-bounds", "error", si,
            f"bulk operand spans {sp.rows} rows but the segment covers "
            f"{rows}"))
        return False
    if sp.role in ("rep", "tile") and rows % sp.rows:
        findings.append(Finding(
            "index-coverage", "error", si,
            f"{sp.role} operand rows {sp.rows} do not divide segment rows "
            f"{rows}"))
        return False
    if sp.role == "bcast":
        lead, out_lead = tuple(sp.lead), tuple(sp.out_lead)
        if len(lead) != len(out_lead) or not out_lead:
            findings.append(Finding(
                "index-bounds", "error", si,
                f"bcast lead ranks differ: {lead} vs {out_lead}"))
            return False
        if int(np.prod(out_lead)) != rows or int(np.prod(lead)) != sp.rows:
            findings.append(Finding(
                "index-bounds", "error", si,
                f"bcast leads {lead}->{out_lead} do not multiply out to "
                f"[{sp.rows} -> {rows}] rows"))
            return False
    if sp.role not in ("param", "bulk", "rep", "tile", "bcast"):
        findings.append(Finding(
            "index-bounds", "error", si, f"unknown operand role {sp.role!r}"))
        return False
    return True


def _row_fn(expr: str | None, c_division: bool):
    """A kernel's row expression as a function of the output rows (an
    int64 array; in an anchored epilogue, with their row block's ``pid``
    / ``lr``): integer arithmetic, evaluated on the whole array at once."""
    if expr is None:
        return lambda row, rb: np.zeros_like(row)
    if c_division:
        expr = expr.replace("/", "//")
    code = compile(expr, "<row>", "eval")
    return lambda row, rb: np.broadcast_to(
        eval(code, {"grow": row, "row": row,   # noqa: S307
                    "pid": row // rb, "lr": row % rb}), row.shape)


def _check_rows(specs: Sequence[OperandSpec], exprs: Sequence, si: int,
                rows: int, rb: int, c_division: bool,
                findings: list[Finding]) -> None:
    """Every operand's row, evaluated from the kernel's own expression at
    the sampled output rows: in bounds, and an interior-broadcast row
    equal to numpy broadcasting's.  The first sampled row at fault is
    reported, one finding an operand."""
    sample = np.asarray(_grid_range(rows, _ENUM_CAP), np.int64)
    for sp, expr in zip(specs, exprs):
        got = _row_fn(expr, c_division)(sample, rb)
        outside = (got < 0) | (got >= sp.rows)
        want = None
        bad = outside
        if sp.role == "bcast":
            want = _bcast_reference_row(sample, tuple(sp.lead),
                                        tuple(sp.out_lead))
            bad = outside | (got != want)
        hit = np.flatnonzero(bad)
        if not hit.size:
            continue
        i = hit[0]
        r, g = int(sample[i]), int(got[i])
        if outside[i]:
            findings.append(Finding(
                "index-bounds", "error", si,
                f"{sp.role} operand read at row {g} for output row "
                f"{r}, outside [0, {sp.rows})"))
        else:
            findings.append(Finding(
                "index-coverage", "error", si,
                f"bcast operand read at row {g} for output row "
                f"{r}; broadcasting semantics require row {int(want[i])}"))


def _check_outputs(seg: Segment, si: int, findings: list[Finding],
                   expect_cols: int | None = None) -> None:
    for oi, (v, c) in enumerate(zip(seg.outputs, seg.out_cols)):
        if _size(v) != seg.rows * c:
            findings.append(Finding(
                "index-coverage", "error", si,
                f"output {oi} has {_size(v)} elements; the grid writes "
                f"exactly {seg.rows} x {c}"))
        if expect_cols is not None and c != expect_cols:
            findings.append(Finding(
                "index-coverage", "error", si,
                f"output {oi} is {c} lanes wide but the kernel's output "
                f"tiles span {expect_cols}"))


def _check_matmul_streams(seg: Segment, si: int,
                          findings: list[Finding]) -> bool:
    mm = seg.matmul
    rows, batch = seg.rows, mm.batch
    if batch < 1 or rows % batch:
        findings.append(Finding(
            "index-coverage", "error", si,
            f"batch {batch} does not divide segment rows {rows}"))
        return False
    ok = True

    def bad(detail):
        nonlocal ok
        ok = False
        findings.append(Finding("index-bounds", "error", si, detail))

    if mm.flash is not None:
        kv = [s for s in mm.rhs_specs if s.role != "param_w"]
        t_dim = mm.flash.get("t_dim", 0)
        if len(kv) < 2:
            bad("flash segment needs streamed K and V operands")
        elif t_dim <= 0:
            bad(f"flash t_dim {t_dim} must be positive")
        else:
            if _size(kv[0].var) != batch * t_dim * mm.k:
                bad(f"flash K stream has {_size(kv[0].var)} elements, "
                    f"expected batch*t*head = {batch * t_dim * mm.k}")
            if _size(kv[1].var) != batch * t_dim * mm.n:
                bad(f"flash V stream has {_size(kv[1].var)} elements, "
                    f"expected batch*t*n = {batch * t_dim * mm.n}")
        for s in mm.lhs_specs:
            if s.role != "param_k" and _size(s.var) != rows * mm.k:
                bad(f"flash Q stream has {_size(s.var)} elements, expected "
                    f"rows*head = {rows * mm.k}")
        return ok
    if mm.form in ("fwd", "dlhs"):
        for s in mm.lhs_specs:
            if s.role == "param_k":
                if _size(s.var) != s.cols:
                    bad(f"param_k operand has {_size(s.var)} elements, "
                        f"spec says {s.cols}")
            elif _size(s.var) != rows * mm.k:
                bad(f"bulk_k operand has {_size(s.var)} elements; the "
                    f"[rows, k] view needs {rows} x {mm.k}")
        if mm.form == "fwd":
            for s in mm.rhs_specs:
                if s.role != "param_w" and \
                        _size(s.var) != batch * mm.k * mm.n:
                    bad(f"bulk_w operand has {_size(s.var)} elements; the "
                        f"[batch*k, n] view needs {batch * mm.k} x {mm.n}")
        elif _size(mm.rhs) != batch * mm.n * mm.k:
            bad(f"dlhs weight has {_size(mm.rhs)} elements; the "
                f"[batch*n, k] view needs {batch * mm.n} x {mm.k}")
        return ok
    if mm.form == "drhs":
        if _size(mm.lhs_var) != mm.k * rows:
            bad(f"drhs activation has {_size(mm.lhs_var)} elements; the "
                f"[batch*m, rows/batch] view needs {mm.k} x {rows}")
        if _size(mm.rhs) != batch * mm.k * mm.n:
            bad(f"drhs cotangent has {_size(mm.rhs)} elements; the "
                f"[batch*m, n] view needs {batch * mm.k} x {mm.n}")
        return ok
    bad(f"unknown anchor form {mm.form!r}")
    return False


def _check_gemm_grid(seg: Segment, gen: dict, si: int,
                     findings: list[Finding]) -> None:
    """The anchored grid covers the output and the contraction once:
    the row block tiles the rows (FMA template), the K splits cover K
    with none empty."""
    mm = seg.matmul
    if gen["path"] == "fma" and seg.rows % gen["rb"]:
        findings.append(Finding(
            "index-coverage", "error", si,
            f"row block {gen['rb']} does not tile {seg.rows} rows"))
    if mm.form == "drhs":
        return
    ks = max(gen["ks"], 1)
    step = gen["kch"] if gen["path"] == "fma" else gen["kch"] * (
        fmb.SM90_BK if gen["path"] == "sm90" else fmb.STREAM_BK)
    if ks * step < mm.k or (ks - 1) * step >= mm.k:
        findings.append(Finding(
            "index-coverage", "error", si,
            f"{ks} K splits of {step} do not cover K = {mm.k} once with "
            "none empty"))


# ---------------------------------------------------------------------------
# shared memory and registers on the H100
# ---------------------------------------------------------------------------

def _smem_findings(what: str, smem: int, budget: int, si: int,
                   findings: list[Finding]) -> None:
    if smem > SMEM_CAPACITY_BYTES:
        findings.append(Finding(
            "vmem-footprint", "error", si,
            f"{what} takes {smem} bytes of dynamic shared memory, beyond "
            f"the {SMEM_CAPACITY_BYTES} a block may opt into on the "
            "H100: it cannot launch"))
    elif smem > budget:
        findings.append(Finding(
            "vmem-footprint", "warning", si,
            f"{what} takes {smem} bytes of dynamic shared memory, over "
            f"the policy's {budget}-byte budget"))


def _acc_findings(what: str, acc: int, threads: int | None, budget: int,
                  si: int, findings: list[Finding]) -> None:
    """``acc`` f32 bytes: held in registers over ``threads`` threads, or
    (``threads`` None) the block's tile on chip."""
    if threads is not None:
        regs = acc // (4 * threads)
        if regs > REGISTERS_A_THREAD:
            findings.append(Finding(
                "vmem-accumulator", "error", si,
                f"{what}'s f32 accumulator takes {regs} registers a "
                f"thread, beyond the {REGISTERS_A_THREAD} a thread holds"))
        return
    if acc > SMEM_CAPACITY_BYTES:
        findings.append(Finding(
            "vmem-accumulator", "error", si,
            f"{what}'s f32 accumulator tile is {acc} bytes, beyond the "
            f"{SMEM_CAPACITY_BYTES} a block holds on the H100 (policy "
            f"budget {budget}): the kernel cannot hold it"))
    elif acc > budget:
        findings.append(Finding(
            "vmem-accumulator", "warning", si,
            f"{what}'s f32 accumulator tile is {acc} bytes, over the "
            f"{budget}-byte policy budget"))


def segment_smem(eqns, seg: Segment) -> dict[str, int]:
    """The dynamic shared memory each kernel of a segment launches with,
    by kernel: the GEMM (sm90 / weight stream) and the workspace
    epilogue of an anchored segment, B5 of a flash segment; empty for a
    grid segment (Triton sizes its own) or a segment that cannot be
    generated.  The values the launchers set."""
    mm = seg.matmul
    if mm is None:
        return {}
    if mm.flash is not None:
        return {"flash_attention": fwd_smem_bytes(mm.k,
                                                     _dtype(mm.lhs_var))}
    gen = _gen(eqns, seg)
    if gen is None:
        return {}
    out = {}
    if gen["smem"]:
        out[gen["path"]] = gen["smem"]
    if gen["epi_smem"]:
        out["epilogue"] = gen["epi_smem"]
    return out


def _check_smem(seg: Segment, si: int, gen: dict | None,
                findings: list[Finding]) -> None:
    budget = seg.smem_budget
    mm = seg.matmul
    if mm is None:      # B2: Triton sizes its registers and shared memory
        return
    if mm.flash is not None:
        dt = _dtype(mm.lhs_var)
        _smem_findings("B5's CTA", fwd_smem_bytes(mm.k, dt), budget, si,
                       findings)
        width = mm.n if dt == torch.float32 else sm90_width(mm.n)
        _acc_findings("B5's [128 x v] output tile", 128 * width * 4, 256,
                      budget, si, findings)
        return
    if gen is None:
        return
    if gen["path"] == "sm90":
        _smem_findings("the sm90 CTA", gen["smem"], budget, si, findings)
        _acc_findings("the sm90 [128 x tn] tile", fmb.SM90_TM * gen["tn"] * 4,
                      256, budget, si, findings)
    elif gen["path"] == "stream":
        _smem_findings("the weight-stream CTA", gen["smem"], budget, si,
                       findings)
        _acc_findings("the weight stream's [8 x 8] lane tile",
                      fmb.STREAM_ROWS * 8 * 4, 1, budget, si, findings)
    elif mm.form == "drhs":
        pb, nb = fmb.drhs_blocks(seg.rows, mm.n, vmem_bytes=budget,
                                 batch=mm.batch)
        _acc_findings(f"the drhs [{pb} x {nb}] block", 4 * pb * nb, None,
                      budget, si, findings)
    else:
        acc = 4 * gen["rb"] * min(mm.n, fm.BN)
        _acc_findings(f"the [{gen['rb']} x {min(mm.n, fm.BN)}] row block",
                      acc, None, budget, si, findings)
    if gen["epi_smem"]:
        _smem_findings("the lane-reduce epilogue's f32 row",
                       gen["epi_smem"], budget, si, findings)


# ---------------------------------------------------------------------------
# well-formedness and decision drift
# ---------------------------------------------------------------------------

def _check_wellformed(seg: Segment, si: int, eqns,
                      findings: list[Finding]) -> bool:
    n = len(eqns)
    for i in seg.all_eqn_idx + list(seg.pre_eqns):
        if not 0 <= i < n:
            findings.append(Finding(
                "segment-span", "error", si,
                f"node index {i} outside the graph (0..{n - 1})"))
            return False
    lo, hi = seg.span_start, seg.span_end
    if not 0 <= lo <= hi < n:
        findings.append(Finding(
            "segment-span", "error", si,
            f"span [{lo}, {hi}] is not a valid node range"))
        return False
    anchors, absorbed = set(), set()
    if seg.matmul is not None:
        anchors.add(seg.matmul.eqn_idx)
        # the chain a flash segment absorbs (its second product, its
        # softmax's reductions) is tier-exempt, as the reference's
        # extra_eqns
        absorbed.update(seg.matmul.extra_eqns)
    for i in seg.all_eqn_idx:
        if not lo <= i <= hi:
            findings.append(Finding(
                "segment-span", "error", si,
                f"fused node {i} lies outside the segment span "
                f"[{lo}, {hi}]"))
        name = prims.node_name(eqns[i]) or str(eqns[i].target)
        tier = prims.eqn_tier(prims.node_name(eqns[i]) or "")
        if i in anchors:
            if tier != "anchor":
                findings.append(Finding(
                    "far-prim-in-segment", "error", si,
                    f"anchor node {i} is {name!r} (tier {tier}), not a "
                    "contraction"))
        elif tier not in ("near", "layout", "reduce") and i not in absorbed:
            findings.append(Finding(
                "far-prim-in-segment", "error", si,
                f"node {i} ({name!r}) is tier {tier!r}; only "
                "near/layout/reduce ops may fuse into a segment"))
    return True


def decision_statuses(plan: OffloadPlan) -> list[str]:
    """One status a decision row: "ok" where the fused row matches its
    segment, "-" for a decline, "MISMATCH(...)" / "MISSING-SEGMENT" on
    drift.  ``explain()`` renders them as the ``verified`` column."""
    statuses: list[str] = []
    si = 0
    for d in plan.decisions:
        if not d.fused:
            statuses.append("-")
            continue
        if si >= len(plan.segments):
            statuses.append("MISSING-SEGMENT")
            si += 1
            continue
        seg = plan.segments[si]
        si += 1
        probs = []
        form = None
        if seg.matmul is not None:
            form = "flash" if seg.matmul.flash is not None \
                else seg.matmul.form
        if (d.form or None) != form:
            probs.append(f"form {d.form or '-'} != {form or '-'}")
        if d.rows != seg.rows:
            probs.append(f"rows {d.rows} != {seg.rows}")
        tier = "anchor" if seg.matmul is not None else "elementwise"
        if d.tier != tier:
            probs.append(f"tier {d.tier} != {tier}")
        statuses.append("ok" if not probs
                        else "MISMATCH(" + ", ".join(probs) + ")")
    return statuses


def _check_decisions(plan: OffloadPlan, findings: list[Finding]) -> None:
    statuses = decision_statuses(plan)
    fused = sum(1 for d in plan.decisions if d.fused)
    if fused != len(plan.segments):
        findings.append(Finding(
            "decision-drift", "error", -1,
            f"{fused} fused decision row(s) vs {len(plan.segments)} "
            "emitted segment(s)"))
    seg_i = -1
    for di, (d, st) in enumerate(zip(plan.decisions, statuses)):
        if d.fused:
            seg_i += 1
        if st not in ("ok", "-"):
            findings.append(Finding(
                "decision-drift", "error",
                seg_i if seg_i < len(plan.segments) else -1,
                f"decision row {di}: {st}"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _verify_segment(seg: Segment, si: int, sets, findings: list[Finding]
                    ) -> None:
    eqns = sets.eqns
    if not _check_wellformed(seg, si, eqns, findings):
        return
    _check_aliases(seg, si, sets, findings)
    mm = seg.matmul
    gen = None
    if mm is None:
        ok = [_check_spec(sp, si, seg.rows, findings)
              for sp in seg.operand_specs]
        if all(ok):
            metas = [sp.meta for sp in seg.operand_specs]
            _check_rows(seg.operand_specs, role_rows(metas, seg.rows), si,
                        seg.rows, 1, False, findings)
        _check_outputs(seg, si, findings)
    else:
        streams_ok = _check_matmul_streams(seg, si, findings)
        specs_ok = all([_check_spec(sp, si, seg.rows, findings)
                        for sp in seg.operand_specs])
        if mm.flash is None and streams_ok and specs_ok:
            gen = _gen(eqns, seg)
            if gen is None:
                findings.append(Finding(
                    "index-bounds", "error", si,
                    "the anchored kernel cannot be generated for this "
                    "segment's views"))
            else:
                _check_gemm_grid(seg, gen, si, findings)
                metas = [("acc", seg.rows, mm.n)] + \
                    [sp.meta for sp in seg.operand_specs]
                exprs = fm._rows_of(metas, seg.rows, gen["rb"])[1:]
                _check_rows(seg.operand_specs, exprs, si, seg.rows,
                            gen["rb"], True, findings)
        elif mm.flash is not None and streams_ok:
            dt = _dtype(mm.lhs_var)
            if refusal(mm.k, dt) is not None:
                findings.append(Finding(
                    "index-bounds", "error", si,
                    f"B5 refuses head dim {mm.k} in {dtype_name(dt)}: "
                    f"{refusal(mm.k, dt)}"))
        _check_outputs(seg, si, findings,
                       expect_cols=mm.n if mm.form == "drhs" else None)
    _check_smem(seg, si, gen, findings)


def _owning_module(graph) -> fx.GraphModule | None:
    if isinstance(graph, fx.GraphModule):
        return graph
    return getattr(graph, "owning_module", None)


def verify_plan(plan: OffloadPlan, graph=None) -> list[Finding]:
    """Statically verify one offload plan; returns its findings (empty
    when it proves out).  ``graph`` (a captured ``GraphModule`` or its
    ``Graph``), when given, is what the caller is about to run the plan
    on: its canonical fingerprint (``core.offload.graph_fingerprint``,
    the plan store's key) must be that of the plan's own graph."""
    findings: list[Finding] = []
    if graph is not None:
        try:
            mine = _owning_module(plan.annotation.graph)
            other = _owning_module(graph)
            if graph_fingerprint(other) != graph_fingerprint(mine):
                findings.append(Finding(
                    "plan-fingerprint", "error", -1,
                    "plan was built for a different graph than the one "
                    "it is being applied to"))
        except Exception as e:   # fingerprinting never crashes verify
            findings.append(Finding(
                "plan-fingerprint", "warning", -1,
                f"could not fingerprint the graph: {e}"))
    sets = _graph_sets(plan)
    for si, seg in enumerate(plan.segments):
        _verify_segment(seg, si, sets, findings)
    _check_decisions(plan, findings)
    return findings


def verify_paged_decode(block_tables, lengths, *, num_pages: int,
                        page_size: int) -> list[Finding]:
    """Bounds proof of the paged decode's block tables, the reference's
    rules on the same tables: every entry (padding included) names a
    page of the pool, and no sequence claims more positions than its
    row addresses.  The port's B1 (``csrc/paged_decode_attention.cu``)
    reads ``lengths[b]`` clamped to the row's capacity and the entries
    that cover it, so the padding rule is stricter than its reads."""
    findings: list[Finding] = []
    t = np.asarray(block_tables)
    lens = np.asarray(lengths)
    if t.ndim != 2:
        findings.append(Finding(
            "page-table-bounds", "error", -1,
            f"block table must be [batch, n_pages], got shape {t.shape}"))
        return findings
    bad = np.argwhere((t < 0) | (t >= num_pages))
    for b, p in bad[:8]:
        findings.append(Finding(
            "page-table-bounds", "error", -1,
            f"table[{b}, {p}] = {int(t[b, p])} outside the "
            f"[0, {num_pages}) page pool"))
    if len(bad) > 8:
        findings.append(Finding(
            "page-table-bounds", "error", -1,
            f"... and {len(bad) - 8} more out-of-range table entries"))
    cap = t.shape[1] * page_size
    for b, ln in enumerate(lens.reshape(-1)[: t.shape[0]]):
        if ln < 0 or ln > cap:
            findings.append(Finding(
                "page-length-bounds", "error", -1,
                f"sequence {b} claims {int(ln)} KV positions; its table "
                f"addresses at most {cap}"))
    return findings
