"""Tile planner of the trapezoid/diamond temporal tiling (K4) on the card.

The port's copy of ``yask_tpu/ops/tile_planner.py`` (``TilePlan``
:42-333, ``plan_blocks`` :334-508), for the two tilings the port runs: the
uniform shrink (K1's function, every level over the block expanded by the
later levels' reach) and the two-phase trapezoid/diamond split of K4.
The reference's skewed wavefront (``skew_dims``, ``write_shift``: K3's
carry of K levels along ``lead[-1]``) has no counterpart here.  The port's
answer to K2 and K3 on the card is the stream arm of K1, planned by
:func:`stream_plan` at the end of this module (the counterpart of
``skew_plan_hints`` / ``skew_engaged_dims``, pallas_stencil.py:366-441):
one level per launch, streamed along slot 0 (ROADMAP.md A4a, C11); and
K6's stream arm (several sub-stages, each at its lag along slot 0), by
:func:`stages_stream_plan`, which also plans K4's stream arm (the K
levels of a group as the sub-stages of one launch, ``by_cells``).

What changes for the card:

* the TPU's sublane rounding unit (8 for fp32) is the constructor argument
  ``unit``; the card needs no alignment of the trapezoid dims (x and y are
  not the contiguous minor dim), so the port plans with ``unit=1``: write
  windows and diamond bands are exact.  ``unit=8`` reproduces every
  geometry answer of the reference's plan;
* ``PARALLEL_CORES`` is 1: the TPU credits a parallel grid with its two
  megacore TensorCores, while every CUDA grid is parallel, the uniform
  one included, so neither variant gets a credit the other lacks;
* :func:`plan_blocks` budgets the shared memory of one CUDA block
  (``cuda_emit.SMEM_LIMIT``) instead of VMEM, and counts the live level
  tiles of a K-step tile (the ring of each written var plus the staged
  read-only vars) over a minor-dim tile of ``minor_block`` points.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m if m > 1 else x


class TilePlan:
    """Dataflow plan of one fused K-group's tiling, per lead dim
    ``"uniform"`` or ``"trapezoid"``; the single source of the K4 margin
    math (the emitter, the gate and the planner hints read it):

    * :meth:`margins` — per-dim (left, right) fetch margins of a phase-1
      tile;
    * :meth:`min_block` / :meth:`margin_override` — the :func:`plan_blocks`
      hints (trapezoid band floors and fetch margins);
    * :meth:`write_shrink` — how far level ``lvl``'s output window shrinks
      per side;
    * :meth:`diamond` — the fill-pass geometry of a trapezoid dim;
    * :meth:`halo` — the uniform fused halo radius×K;
    * :meth:`dataflow` — per-level read/write intervals of one tile;
    * :meth:`stage_widths` / :meth:`stage_flow` — per-stage widths and
      per-level, per-stage write/read windows of a multi-stage solution;
    * :meth:`volumes` — (useful, computed, fetched) cells per K-group for
      the profit gate.
    """

    #: Grid parallelism credited to the trapezoid's compute by the gate.
    #: The TPU credits 2 (its parallel grid dims split over two megacore
    #: TensorCores, while the uniform/skew grid is sequential); on the
    #: card every grid, the uniform one too, is parallel, so 1.
    PARALLEL_CORES = 1

    def __init__(self, program, fuse_steps: int, trap_dims=(),
                 unit: int = 1):
        self.program = program
        ana = program.ana
        self.dims = ana.domain_dims
        self.lead = self.dims[:-1]
        self.minor = self.dims[-1]
        self.K = fuse_steps
        rad = ana.fused_step_radius()
        self.rad = {d: rad.get(d, 0) for d in self.lead}
        self.unit = unit
        self.trap_dims = list(trap_dims)
        self.mode = {d: ("trapezoid" if d in self.trap_dims else "uniform")
                     for d in self.lead}

    def _unit(self, d: str) -> int:
        """The rounding unit of dim ``d``: ``unit`` on the written vars'
        second-minor axis (the TPU's sublane axis, ``lead[-1]``), 1
        elsewhere."""
        return self.unit if (self.lead and d == self.lead[-1]) else 1

    # -- geometry primitives ------------------------------------------

    def cl(self, d: str, lvl: int) -> int:
        """Trapezoid half-band at time level ``lvl``: (lvl−1)·r, rounded
        UP to the unit."""
        return _ceil_to((lvl - 1) * self.rad[d], self._unit(d))

    def halo(self, d: str) -> int:
        """Uniform fused halo radius×K."""
        return self.rad[d] * self.K

    def margins(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Phase-1 per-dim (mL, mR) fetch margins: one step radius per
        side in a trapezoid dim (the per-level shrink happens in the write
        windows), radius×K in a uniform one."""
        mL, mR = {}, {}
        for d in self.lead:
            if self.mode[d] == "trapezoid":
                mL[d] = mR[d] = self.rad[d]
            else:
                mL[d] = mR[d] = self.halo(d)
        return mL, mR

    def write_shrink(self, d: str, lvl: int) -> int:
        """Trapezoid: level ``lvl``'s write window shrinks per side by
        (lvl−1)·r, rounded DOWN to the unit (the rest lies inside the
        diamond band, which the fill pass writes)."""
        if self.mode[d] != "trapezoid":
            return 0
        fl = (lvl - 1) * self.rad[d]
        u = self._unit(d)
        return (fl // u) * u

    def diamond(self, d: str) -> Dict[str, int]:
        """Fill-pass geometry of trapezoid dim ``d``: ``half`` = cl(K),
        ``band`` = 2·half (the band written around each tile boundary),
        ``margin`` = K·r per side (uniform telescoping from level 0)."""
        half = self.cl(d, self.K)
        return {"half": half, "band": 2 * half, "margin": self.halo(d)}

    # -- planner hints -------------------------------------------------

    def min_block(self) -> Optional[Dict[str, int]]:
        """Per-dim block floors: a trapezoid tile covers at least its own
        diamond band plus one unit."""
        out = {d: 2 * self.cl(d, self.K) + self._unit(d)
               for d in self.trap_dims}
        return out or None

    def margin_override(self) -> Optional[Dict[str, int]]:
        """Per-dim TOTAL tile margin for :func:`plan_blocks` where the
        tiling fetches less than the uniform 2·K·r."""
        out = {d: 2 * self.rad[d] for d in self.trap_dims}
        return out or None

    # -- dataflow ------------------------------------------------------

    def dataflow(self, block: Dict[str, int]) -> List[Dict]:
        """Per-level interval sets of one interior tile in
        tile-origin-relative coordinates (the tile spans
        ``[0, mL + block + mR)`` per dim): ``{"level", "read": {d: (lo,
        hi)}, "write": {d: (lo, hi)}}``.  ``write`` is the level's output
        window in a trapezoid dim and its computed region in a uniform one;
        ``read`` is the region the level consumes."""
        mL, mR = self.margins()
        steps = []
        for k in range(self.K):
            lvl = k + 1
            entry = {"level": lvl, "read": {}, "write": {}}
            for d in self.lead:
                B, r = block[d], self.rad[d]
                if self.mode[d] == "trapezoid":
                    lo = mL[d] + (lvl - 1) * r - r
                    hi = mL[d] + B - (lvl - 1) * r + r
                    entry["write"][d] = (mL[d] + self.write_shrink(d, lvl),
                                         mL[d] + B
                                         - self.write_shrink(d, lvl))
                else:
                    lo = max(mL[d] - (self.K - lvl) * r - r, 0)
                    hi = min(mL[d] + B + (self.K - lvl) * r + r,
                             mL[d] + B + mR[d])
                    entry["write"][d] = (mL[d] - (self.K - lvl) * r,
                                         mL[d] + B + (self.K - lvl) * r)
                entry["read"][d] = (lo, hi)
            steps.append(entry)
        return steps

    # -- multi-stage dataflow ------------------------------------------

    def stage_widths(self) -> List[Dict[str, int]]:
        """Per analysis stage, per lead dim: the widest one-side ghost
        width the stage's reads consume (``program.stage_reads``, a
        scratch part's write halo included).  Per dim they sum to
        ``self.rad`` (``fused_step_radius``)."""
        out = []
        for reads in self.program.stage_reads:
            w = {d: 0 for d in self.lead}
            for vv in reads.values():
                for d, (lo, hi) in vv.items():
                    if d in w:
                        w[d] = max(w[d], lo, hi)
            out.append(w)
        return out

    def stage_flow(self, block: Dict[str, int]) -> List[Dict]:
        """Per level, per analysis stage: the stage's write and read
        intervals of one tile (tile-origin-relative, lead dims).  The
        final stage writes the level's window (:meth:`dataflow`'s
        ``write``); each earlier stage's window is grown per side by the
        widths of the stages after it, so stage ``s``'s read interval is
        stage ``s−1``'s write interval.  K4 computes each stage (and
        scratch sub-stage) of a level inside these windows
        (``cuda_emit.emit_trapezoid`` checks it)."""
        sw = self.stage_widths()
        tails: List[Dict[str, int]] = []
        acc = {d: 0 for d in self.lead}
        for w in reversed(sw):
            tails.append(dict(acc))
            acc = {d: acc[d] + w[d] for d in self.lead}
        tails.reverse()
        flow = []
        for entry in self.dataflow(block):
            stages = []
            for si, w in enumerate(sw):
                wr, rd = {}, {}
                for d in self.lead:
                    lo, hi = entry["write"][d]
                    t = tails[si][d]
                    wr[d] = (lo - t, hi + t)
                    rd[d] = (lo - t - w[d], hi + t + w[d])
                stages.append({"stage": si, "write": wr, "read": rd})
            flow.append({"level": entry["level"], "stages": stages})
        return flow

    # -- cost model ----------------------------------------------------

    def volumes(self, block: Dict[str, int]) -> Tuple[int, int, int]:
        """(useful, computed, fetched) cells per tile per K-group over the
        lead dims, the diamond pass's recompute included."""
        mL, mR = self.margins()
        useful = computed = 0
        fetched = 1
        for d in self.lead:
            fetched *= block[d] + mL[d] + mR[d]
        for k in range(self.K):
            lvl = k + 1
            u = c = 1
            for d in self.lead:
                B, r = block[d], self.rad[d]
                u *= B
                if self.mode[d] == "trapezoid":
                    c *= B - 2 * (lvl - 1) * r + 2 * r
                else:
                    c *= B + 2 * (self.K - lvl) * r
            useful += u
            computed += c
        # diamond fill pass: per trapezoid dim, one inverted trapezoid per
        # tile boundary recomputes ~(2·cl(K) + 2·K·r) width across the
        # other dims' blocks, K levels deep
        for d in self.trap_dims:
            dia = self.diamond(d)
            w = dia["band"] + 2 * dia["margin"]
            other = 1
            for d2 in self.lead:
                if d2 != d:
                    other *= block[d2]
            computed += self.K * w * other
            fetched += w * other
        return useful, computed, fetched


def live_tiles(program) -> int:
    """Shared-memory tiles a K-step tile keeps live: one per ring slot of
    each written var (its staged levels and the levels computed over
    them) and one per staged read-only full-dim var."""
    n = 0
    for g in program.geoms.values():
        if g.is_scratch:
            continue
        if g.is_written:
            n += g.num_slots
        elif g.domain_dims == list(program.ana.domain_dims):
            n += 1
    return max(n, 1)


def plan_blocks(program, fuse_steps: int = 1,
                smem_budget: Optional[int] = None,
                min_block: Optional[Dict[str, int]] = None,
                margin_override: Optional[Dict[str, int]] = None,
                minor_block: int = 32) -> Dict[str, int]:
    """Lead-dim block sizes of a K-step tile (the reference's algorithm:
    fold hints or 8 to start, snapped to divisors of the domain, floored
    at ``min_block``, then doubled in the dim whose halo overhead falls
    most while the tile fits).

    The tile model is the shared memory of one CUDA block: per lead dim
    ``block + margin`` (margin ``2·K·r`` unless ``margin_override`` gives
    the tiling's own), times ``minor_block + 2·K·r`` minor-dim cells,
    times the element size and :func:`live_tiles`.  Floors may pass the
    budget; the emitter's exact accounting then decides.  The budget
    defaults to ``cuda_emit.SMEM_LIMIT``."""
    import numpy as np
    if smem_budget is None:
        from yask_tpu_torch.ops.cuda_emit import SMEM_LIMIT as smem_budget
    ana = program.ana
    dims = ana.domain_dims
    lead = dims[:-1]
    minor = dims[-1]
    sizes = {d: program.sizes[d] for d in dims}
    rad = ana.fused_step_radius()
    marg = {d: 2 * rad.get(d, 0) * fuse_steps for d in lead}
    for d, m in (margin_override or {}).items():
        if d in marg:
            marg[d] = m
    fold = program.soln.get_settings().fold

    block: Dict[str, int] = {}
    for d in lead:
        if fold.has_dim(d) and fold[d] > 0:
            block[d] = min(fold[d], sizes[d])
        else:
            block[d] = min(8, sizes[d])
    for d in lead:
        b = block[d]
        while sizes[d] % b != 0:
            b -= 1
        block[d] = max(b, 1)

    esize = np.dtype(program.dtype).itemsize
    minor_ext = min(minor_block, sizes[minor]) \
        + 2 * rad.get(minor, 0) * fuse_steps
    nlive = live_tiles(program)

    def tile_bytes(blk):
        per = 1
        for d in lead:
            per *= blk[d] + marg[d]
        return per * minor_ext * esize * nlive

    for d, mn in (min_block or {}).items():
        if d in block and block[d] < mn:
            b = min(mn, sizes[d])
            while sizes[d] % b != 0 and b < sizes[d]:
                b += 1
            block[d] = b

    def overhead(blk):
        interior = padded = 1
        for d in lead:
            interior *= blk[d]
            padded *= blk[d] + marg[d]
        return (padded - interior) / max(interior, 1)

    improved = True
    while improved:
        improved = False
        best = None
        for d in lead:
            nb = block[d] * 2
            while nb <= sizes[d] and sizes[d] % nb != 0:
                nb *= 2
            if nb > sizes[d]:
                continue
            cand = dict(block)
            cand[d] = nb
            if tile_bytes(cand) > smem_budget:
                continue
            ov = overhead(cand)
            if best is None or ov < best[0]:
                best = (ov, cand)
        if best is not None:
            block = best[1]
            improved = True
    return block


# ==== the stream arm: K1 walking slot 0 through a ring of planes =========
# A block owns a T1 x T2 column of the (slot 1, slot 2) plane and walks a
# segment of slot 0 in order.  Each input staged in shared memory (a
# full-dim var read at a spatial offset) has a ring of planes with their
# in-plane halo: the h0_lo + h0_hi + 1 planes one output plane reads,
# carried from plane to plane, P planes fetched ahead with cp.async, and
# one more so that one barrier per plane suffices (ring_depth).

#: Plane tiles (slot 1, slot 2) tried in order until the rings fit shared
#: memory; slot 2 is the contiguous minor dim, one thread per point.
STREAM_TILES = ((16, 64), (32, 32), (8, 64), (16, 32), (8, 32), (4, 32),
                (2, 32), (1, 32))
#: Prefetch depths tried at each plane tile, deepest first.
STREAM_PREFETCH = (2, 1)
#: Streaming multiprocessors of an H100 SXM, and the shared memory,
#: resident threads and 32-bit registers one of them holds: the segment
#: count fills them.
SMS = 132
SM_SMEM = 233472
SM_THREADS = 2048
SM_REGS = 65536


def ring_depth(h0_lo: int, h0_hi: int, prefetch: int) -> int:
    """Planes in one input's ring: the planes one output plane reads, the
    ``prefetch`` planes in flight, and the oldest plane of the output
    plane before, so that one barrier per plane keeps a copy from landing
    in a plane still being read."""
    return h0_lo + h0_hi + 2 + prefetch


def stream_row(e2: int, esize: int) -> int:
    """Elements of one ring row in shared memory for a plane row of
    ``e2`` cells: ``e2`` at 4 and 8 bytes; at 2 bytes (K6's stream arm,
    csrc ``ring_row``) one more, rounded up to even, so that the row can
    start at the 4-byte-aligned pair holding its first cell (K6 fills a
    bfloat16 ring pair by pair).  K1's stream arm takes :func:`pair_row`
    at 2 bytes."""
    return (e2 + 2) & ~1 if esize == 2 else e2


def pair_row(e2: int) -> int:
    """Elements of one ring row of K1's stream arm at element size 2 for a
    plane row of ``e2`` cells: a whole number of 16-byte units (8
    elements) that holds the row from the unit holding its first cell, at
    any of that unit's 8 cells: ``e2 + 7`` rounded up to 8 (csrc
    ``pair_row``).  The rows are
    filled with 16-byte ``cp.async`` copies, and the walk computes two
    minor-dim points a thread in packed bfloat16x2 arithmetic."""
    return (e2 + 14) & ~7


#: Elements past K1's last ring at element size 2: a pair read at a row's
#: last cells also loads the 32-bit word after them (the pair's position
#: parity is known at run time only), at most two cells past the row.
PAIR_TAIL = 8


def ring_elems(halo: Tuple[Tuple[int, int], ...], depth: int, t1: int,
               t2: int, esize: int) -> int:
    """Elements of one ring of K1's stream arm at plane tile ``t1 x t2``
    for an input of per-slot ``halo``: ``depth`` planes of rows of
    :func:`stream_row` elements (at element size 2 :func:`pair_row`)."""
    e2 = t2 + halo[2][0] + halo[2][1]
    return depth * (t1 + halo[1][0] + halo[1][1]) * (
        pair_row(e2) if esize == 2 else stream_row(e2, esize))


def ring_cells(halos: Dict[int, Tuple[Tuple[int, int], ...]],
               depths: Dict[int, int], t1: int, t2: int, esize: int) -> int:
    """Elements of all of K1's stream rings (:func:`ring_elems`), at
    element size 2 with :data:`PAIR_TAIL` more."""
    return (sum(ring_elems(h, depths[a], t1, t2, esize)
                for a, h in halos.items())
            + (PAIR_TAIL if esize == 2 else 0))


def stream_threads(t1: int, t2: int, esize: int) -> int:
    """Threads of a block of K1's stream arm at plane tile ``t1 x t2``:
    one a point, at element size 2 one a pair of minor-dim points."""
    return t1 * t2 // 2 if esize == 2 else t1 * t2


def thread_registers(threads: int, per_sm: int) -> int:
    """The 32-bit registers a thread may hold where the launch bounds ask
    for ``per_sm`` blocks of ``threads`` an SM: ptxas allocates them 8 at
    a time, at most 255."""
    return min((SM_REGS // (threads * per_sm)) & ~7, 255)


def register_queue(threads: int, per_sm: int) -> int:
    """Depth of the register queue of same-point reads: values of the
    planes z .. z + depth - 1, loaded depth - 1 planes ahead.  3 where a
    thread may hold 64 registers (one 1024-thread block per SM), else 2
    (a deeper queue spills at 32)."""
    return 3 if thread_registers(threads, per_sm) >= 64 else 2


@dataclass
class StreamPlan:
    """The stream arm's plan for one solution: its plane tile, prefetch
    depth, the rings (input -> planes) and their shared memory, and the
    segments of slot 0 the grid's z walks."""
    tile: Tuple[int, int]
    prefetch: int
    depths: Dict[int, int]
    smem_bytes: int
    seg: int                 # planes of slot 0 per segment
    segments: int
    blocks: int              # the grid's blocks (columns x segments)
    per_sm: int              # blocks one SM holds (threads, shared memory)
    queue: int               # register queue of same-point reads
    #: per ring, cells staged per interior point: the in-plane halo and
    #: the h0 planes each segment stages again
    staged_per_point: Dict[int, float]
    #: planes each segment stages again (the widest ring's h0_lo + h0_hi)
    h0: int = 0
    #: past three domain dims: the outer cells, each a coordinate of the
    #: work items beside the columns and segments (0 in 3-D)
    outer_cells: int = 0
    #: the element size (2: two minor-dim points a thread in packed
    #: bfloat16x2 arithmetic, rings of 16-byte rows)
    esize: int = 4

    def segments_of(self, n0: int, cols: int) -> Tuple[int, int]:
        """The segment length and segments of a walk of ``n0`` planes over
        ``cols`` columns (times the outer cells and the members of a
        batch): the plan's rule,
        :func:`stream_segments` on the card's resident blocks of this
        plane tile.  The plan takes it at the domain's extents, K7's
        wrapper with the batch's columns, K5's at each box's."""
        return stream_segments(n0, cols, SMS * self.per_sm, self.h0)

    def record(self) -> Dict[str, object]:
        return {"plane_tile": list(self.tile), "prefetch": self.prefetch,
                "ring_depths": dict(self.depths),
                "smem_bytes": self.smem_bytes, "segment_planes": self.seg,
                "segments": self.segments, "blocks": self.blocks,
                "blocks_per_sm": self.per_sm, "register_queue": self.queue,
                "staged_per_point": {a: round(v, 4) for a, v in
                                     self.staged_per_point.items()},
                **({"outer_cells": self.outer_cells}
                   if self.outer_cells else {}),
                **({"pairs": self.pairs()} if self.esize == 2 else {})}

    def pairs(self) -> Dict[str, object]:
        """At element size 2, the pair flavour: two minor-dim points a
        thread in packed bfloat16x2 arithmetic, its threads a block and
        the registers a thread may hold at the plan's blocks per SM
        (:func:`thread_registers`), and the rings' rows of whole 16-byte
        units."""
        nt = stream_threads(*self.tile, 2)
        return {"flavour": "bfloat16x2", "points_per_thread": 2,
                "threads": nt,
                "registers": thread_registers(nt, self.per_sm),
                "row_unit_bytes": 16}


#: Past three domain dims, the least 32-bit registers a thread of K1's
#: stream arm keeps (the blocks per SM stop there), and the resident
#: threads an SM should hold: at 32 registers (two 1024-thread blocks an
#: SM) test_4d's builds spill 68 B and more a thread and its launch at
#: 128⁴ ran 1.2x slower than at 64 (chip_smoke phase 24 (b)'s sweep,
#: PERF.md); one such block an SM leaves the barriers unhidden.
STREAM_OUTER_MIN_REGS = 40
STREAM_OUTER_THREADS = 1536
#: At element size 2 (two points a thread, more values live at once) the
#: least registers a thread keeps, in 3-D and past three domain dims: at
#: 40, iso3dfd r=2's K5 build spilled 8 B a thread, iso3dfd r=8 built for
#: 40 ran 1.753 ms a launch at 512³ against 1.674 at 64, and test_4d's
#: builds spilled 60 B (solo) and 244 B (K7) a thread (chip_smoke phases
#: 1, 24 (b) and 25 (b), PERF.md).  Past three dims the register queue
#: stays 2 (:data:`STREAM_PAIR_OUTER_QUEUE`): a deeper one holds one more
#: value a same-point input, and K7's 4-D build has none to spare; and a
#: block holds at most :data:`STREAM_PAIR_OUTER_BLOCK` threads: test_4d
#: bf16 at 128⁴ ran 3.015 ms a launch by 4 blocks of 256 (16x32) against
#: 3.305 by 2 of 512 (32x32), each at 64 registers without spills (a
#: plane's barrier stalls a quarter of an SM's threads, not half).
STREAM_PAIR_MIN_REGS = 64
STREAM_PAIR_OUTER_QUEUE = 2
STREAM_PAIR_OUTER_BLOCK = 256


def stream_plan(halos: Dict[int, Tuple[Tuple[int, int], ...]], n, esize: int,
                smem_limit: Optional[int] = None,
                outer: int = 0) -> Optional[StreamPlan]:
    """Plan the stream arm for the staged inputs' ``halos`` (input ->
    per-slot (lo, hi)) over interior extents ``n`` (slots 0, 1, 2): the
    first (plane tile, prefetch) of the ladder whose rings fit
    ``smem_limit`` (``cuda_emit.SMEM_LIMIT``), or None.  The segment
    length minimises the planes the busiest SM walks, waves of resident
    blocks times the segment's planes with its re-staged h0 planes.
    Past three domain dims ``outer`` is the outer cells, each a work-item
    coordinate: the columns the waves count are the plane's times them;
    a thread keeps :data:`STREAM_OUTER_MIN_REGS` registers (at element
    size 2 :data:`STREAM_PAIR_MIN_REGS`), and of the
    plane tiles (each at its deepest prefetch that fits) that keep
    :data:`STREAM_OUTER_THREADS` threads resident the plan takes the one
    staging the fewest in-plane cells per point (the first on a tie), or
    the one with the most resident threads where none does: the choice
    does not depend on ``n``, so neither does the source.  At element
    size 2 a thread computes two minor-dim points (:func:`stream_threads`)
    and keeps :data:`STREAM_PAIR_MIN_REGS` registers (past three dims
    with a register queue of :data:`STREAM_PAIR_OUTER_QUEUE`, in blocks
    of at most :data:`STREAM_PAIR_OUTER_BLOCK` threads), and the rings'
    rows are whole 16-byte units (:func:`pair_row`)."""
    if smem_limit is None:
        from yask_tpu_torch.ops.cuda_emit import SMEM_LIMIT as smem_limit
    n0, n1, n2 = (int(x) for x in n)
    floor = STREAM_PAIR_MIN_REGS if esize == 2 else STREAM_OUTER_MIN_REGS
    cands = []
    for t1, t2 in STREAM_TILES:
        for pf in STREAM_PREFETCH:
            depths = {a: ring_depth(h[0][0], h[0][1], pf)
                      for a, h in halos.items()}
            cells = ring_cells(halos, depths, t1, t2, esize)
            if cells * esize > smem_limit:
                continue
            nt = stream_threads(t1, t2, esize)
            if outer and esize == 2 and nt > STREAM_PAIR_OUTER_BLOCK:
                break
            per_sm = max(1, min(SM_THREADS // nt,
                                SM_SMEM // (cells * esize + 1024)))
            if outer or esize == 2:
                per_sm = max(1, min(per_sm, SM_REGS // (nt * floor)))
            cols = -(-n1 // t1) * -(-n2 // t2) * max(outer, 1)
            h0 = max((h[0][0] + h[0][1] for h in halos.values()), default=0)
            seg, segs = stream_segments(n0, cols, SMS * per_sm, h0)
            staged = {a: (t1 + h[1][0] + h[1][1]) * (t2 + h[2][0] + h[2][1])
                      * (n0 + segs * (h[0][0] + h[0][1])) / (t1 * t2 * n0)
                      for a, h in halos.items()}
            queue = (STREAM_PAIR_OUTER_QUEUE if outer and esize == 2
                     else register_queue(nt, per_sm))
            plan = StreamPlan((t1, t2), pf, depths, cells * esize, seg, segs,
                              cols * segs, per_sm, queue, staged, h0, outer,
                              esize)
            if not outer:
                return plan
            inplane = sum((t1 + h[1][0] + h[1][1]) * (t2 + h[2][0] + h[2][1])
                          for h in halos.values()) / (t1 * t2)
            cands.append((nt * per_sm, inplane, plan))
            break
    full = [c for c in cands
            if c[0] >= min(STREAM_OUTER_THREADS, SM_REGS // floor)]
    if full:
        return min(full, key=lambda c: c[1])[2]
    return max(cands, key=lambda c: c[0])[2] if cands else None


# ==== K6's stream arm: every sub-stage walking slot 0 ====================
# A block owns a T1 x T2 plane tile of (slot 1, slot 2) and walks a
# segment of slot 0 in order, computing sub-stage K at plane z + lag(K),
# lag(K) being how far above its own plane the later sub-stages read it
# (the emitter's sub_hi0).  Each staged input has a ring of planes with
# its in-plane halo, sized from the planes its readers need at their lags
# (not from the slot-0 halo of the union, which the earlier sub-stages'
# expansion inflates), the prefetch and one plane more (ring_depth); each
# computed tile a ring of the planes its readers need at their lags.

#: (T1, T2, threads) plane tiles of K6's stream arm, tried in order until
#: the rings fit shared memory; a thread computes T1·T2 / threads points
#: of a sub-stage that is not grown in-plane.  Slot 2 (T2) is the
#: contiguous minor dim.  The rungs are those a registered solution takes
#: (every one at element size 4 the first; at element size 8 fsg, fsg2,
#: fsg_merged and awp_elastic 8x32, the other awp, fsg and ssg solutions
#: 4x32) and those chip_smoke phase 17 (b) times on awp at 512³
#: (PERF.md): 16x32 by 512 threads ran 1.59x faster than 8x32 by 256 (one
#: block an SM either way), its spills at 128 registers a thread
#: notwithstanding.  Where no rung fits, K6's body runs (skew_fallback).
STAGES_STREAM_TILES = ((16, 32, 512), (8, 64, 512), (8, 32, 256),
                       (4, 64, 256), (4, 32, 128))
#: The least registers a thread of K6's stream arm may hold: the blocks
#: per SM it asks the compiler for stop there (awp's stress sub-stage
#: holds many values at once).
STAGES_STREAM_MIN_REGS = 128
#: Past three domain dims, the window widths tried in each outer dim (a
#: rung is the outer windows with a plane tile of
#: :data:`STAGES_STREAM_TILES`), capped at the dim's extent: a wider
#: window recomputes less of what the later sub-stages (K4: levels) read
#: at outer offsets, a narrower one keeps the rings in shared memory.
STAGES_STREAM_OUTER = (1, 2, 4, 8, 16)


#: The card's L2 cache (H100 SXM, 50 MB): where computed rings live past
#: shared memory, the resident blocks of a launch stay at most as many as
#: keep every block's workspace slice within it.
L2_BYTES = 50 << 20


@dataclass
class StagesStreamPlan:
    """K6's stream arm for one solution: its plane tile, threads and
    prefetch, each sub-stage's lag, each ring's reach and depth (staged
    inputs: planes ``z - lo .. z + hi`` around the walk's plane ``z``;
    computed tiles: planes ``z - lo .. z + lag`` of their writer), its
    shared memory, and the segments of slot 0 the resident blocks walk
    (one work item per column, segment and member).

    Where no rung's rings fit shared memory, they are placed past it
    (:func:`_place_rings`): ``in_place`` gives each staged input "smem"
    (a ring) or "global" (read from its own allocation), ``cmp_place``
    each computed ring "smem" or "workspace" (a slice of ``ws_elems``
    elements per resident block, at most ``ws_blocks`` blocks); a ring's
    offset (``in_offsets``, ``cmp_offsets``) at or past ``smem_elems``
    lies in the slice at the offset less ``smem_elems``."""
    tile: Tuple[int, int]
    threads: int
    prefetch: int
    lags: List[int]
    warm: int                        # planes a segment walks before its first
    in_reach: Dict[int, Tuple[int, int]]
    in_depths: Dict[int, int]
    in_elems: Dict[int, int]         # per ring, elements (16-byte units)
    cmp_lo: List[int]
    cmp_depths: List[int]
    cmp_elems: List[int]
    smem_bytes: int
    seg: int
    segments: int
    columns: int
    per_sm: int
    staged_per_point: float          # staged cells per interior point
    computed_per_point: List[float]  # per sub-stage, computed cells per
                                     # interior point
    in_place: Dict[int, str] = field(default_factory=dict)
    cmp_place: List[str] = field(default_factory=list)
    in_offsets: Dict[int, int] = field(default_factory=dict)
    cmp_offsets: List[int] = field(default_factory=list)
    smem_elems: int = 0
    ws_elems: int = 0
    ws_blocks: int = 0               # the L2 cap on resident blocks (0: none)
    #: estimated bytes per interior point read or written outside shared
    #: memory (ring-less inputs' reads, workspace rings' writes and reads)
    outside_per_point: float = 0.0
    esize: int = 4
    #: past three domain dims: the window width in each outer dim (a work
    #: item's box), and each staged ring's outer halo ((lo, hi) per outer
    #: dim); empty in 3-D
    outer_tile: Tuple[int, ...] = ()
    in_ohalos: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def placed(self) -> bool:
        """Some ring lies outside shared memory."""
        return ("global" in self.in_place.values()
                or "workspace" in self.cmp_place)

    def record(self) -> Dict[str, object]:
        esize = self.esize
        return {"plane_tile": list(self.tile), "threads": self.threads,
                "prefetch": self.prefetch, "lags": list(self.lags),
                "warm_planes": self.warm,
                "ring_depths": dict(self.in_depths),
                "ring_reach": {a: list(r) for a, r in self.in_reach.items()},
                "computed_ring_depths": list(self.cmp_depths),
                "smem_bytes": self.smem_bytes, "segment_planes": self.seg,
                "segments": self.segments, "columns": self.columns,
                "blocks_per_sm": self.per_sm,
                "staged_per_point": round(self.staged_per_point, 4),
                "computed_per_point": [round(c, 4)
                                       for c in self.computed_per_point],
                "ring_places": dict(self.in_place),
                "computed_ring_places": list(self.cmp_place),
                "ws_block_bytes": self.ws_elems * esize,
                "ws_blocks": self.ws_blocks,
                "ws_total_bytes": self.ws_elems * esize * self.ws_blocks,
                "outside_bytes_per_point": round(self.outside_per_point, 4),
                **({"outer_window": list(self.outer_tile)}
                   if self.outer_tile else {})}


def _span(reads: Dict[int, Tuple[int, int]], lags: List[int]):
    """(lo, hi) planes around the walk's plane z that the readers reach:
    reader J reads offsets [-lo, hi] of its plane z + lags[J]."""
    return (max(lo - lags[j] for j, (lo, hi) in reads.items()),
            max(lags[j] + hi for j, (lo, hi) in reads.items()))


def _place_rings(in_elems: Dict[int, int], cmp_elems: List[int],
                 in_weight: Dict[int, float], limit: int):
    """Rings past shared memory: the computed rings first (they have no
    other home), then the staged inputs' by ``in_weight`` (their readers'
    reads per element, most first), each taking shared memory by first
    fit while it fits.  Returns (input -> offset or None for a ring-less
    input, computed ring offsets, shared elements, workspace elements);
    a computed ring that does not fit lies at the shared elements plus
    its offset in the workspace slice."""
    sm, wsn, cmp_at = 0, 0, []
    for c in cmp_elems:
        if sm + c <= limit:
            cmp_at.append((True, sm))
            sm += c
        else:
            cmp_at.append((False, wsn))
            wsn += c
    in_off: Dict[int, Optional[int]] = {}
    for a in sorted(in_elems, key=lambda a: (-in_weight[a], a)):
        if sm + in_elems[a] <= limit:
            in_off[a] = sm
            sm += in_elems[a]
        else:
            in_off[a] = None
    return ({a: in_off[a] for a in sorted(in_off)},
            [o if inside else sm + o for inside, o in cmp_at], sm, wsn)


def stream_segments(n0: int, cols: int, blocks: int, warm: int
                    ) -> Tuple[int, int]:
    """The segment length of slot 0 (``n0`` planes) for a stream arm
    (K1's and K6's) and the segments it makes: of ``cols`` columns (times
    the members of a batch) on ``blocks`` resident blocks, the split whose
    waves of work items times each item's walk (its planes and the
    ``warm`` planes before them: K6's warm-up, K1's re-staged h0) are the
    fewest, the fewest segments on a tie.  The plans apply it at the
    domain's extents, the wrappers at a batch's members and each box's
    extents."""
    best = None
    for s in range(1, min(n0, 65535) + 1):
        seg = -(-n0 // s)
        segs = -(-n0 // seg)
        cost = -(-cols * segs // blocks) * (seg + warm)
        if best is None or cost < best[0]:
            best = (cost, seg, segs)
    return best[1], best[2]


def stages_stream_plan(in_halos: Dict[int, Tuple[Tuple[int, int], ...]],
                       in_reads: Dict[int, Dict[int, Tuple[int, int]]],
                       sub_regions, cmp_subs: List[int],
                       cmp_reads: List[Dict[int, Tuple[int, int]]], n,
                       esize: int, smem_limit: Optional[int] = None,
                       tiles=STAGES_STREAM_TILES,
                       prefetch=STREAM_PREFETCH, *,
                       in_nreads: Dict[int, Dict[int, int]],
                       cmp_nreads: List[Dict[int, int]], ws_limit: int,
                       by_cells: bool = False, outer_n=(),
                       in_ohalos: Dict[int, List[Tuple[int, int]]] = None
                       ) -> Optional[StagesStreamPlan]:
    """Plan K6's stream arm: the first (plane tile, prefetch) of the
    ladders whose rings fit ``smem_limit``; where none does, the rung
    whose rings placed past shared memory (:func:`_place_rings`) read and
    write the fewest estimated bytes per point outside it, among those
    whose workspace slice (the computed rings past shared memory) fits
    ``ws_limit`` bytes; None where none does.

    ``by_cells`` (K4's stream arm, whose levels grow each plane tile by
    what the later levels read): every rung, its rings in shared memory
    at the first prefetch that fits, else placed as above, and the one
    with the fewest computed cells per useful point taken (then the
    fewest bytes outside shared memory, then the ladder's order).  On the
    card (an H100 at 700 W) the four rungs' times on tti r=2 K=2 and three on
    iso3dfd r=2 K=4 at 512³ fell in the order of their computed cells,
    while the fewest bytes outside shared memory took tti's 4×32 rung of
    128 threads, 3.7× slower than its 16×32.

    ``in_halos``: staged input → per-slot (lo, hi) halo (slots 1 and 2
    give its rings' in-plane halo); ``in_reads``: staged input →
    {sub-stage: (lo, hi)} of its slot-0 read offsets ([-lo, hi]);
    ``sub_regions``: per sub-stage ((lo0, lo1, lo2), (hi0, hi1, hi2)), its
    region around the block; ``cmp_subs``: per computed tile its writing
    sub-stage, ``cmp_reads`` its readers' slot-0 offsets; ``n``: the
    interior extents of slots 0, 1, 2; ``in_nreads`` and ``cmp_nreads``:
    per staged input and computed tile, {sub-stage: distinct offsets it
    reads} (the placement's weights).  A ring is a whole number of
    16-byte units, so every ring starts aligned, and so is a workspace
    slice.  At element size 2 a staged ring's row holds
    :func:`stream_row` elements: it starts at the 4-byte pair that holds
    its first cell (the kernel fills it pair by pair).

    Past three domain dims (``outer_n``: the outer dims' extents; the
    sub-stage regions then reach into them past the three slots, and
    ``in_ohalos`` gives each staged input's outer halo), a rung is a
    window width per outer dim from :data:`STAGES_STREAM_OUTER` (capped
    at its extent) with a plane tile (a rung ``(T1, T2, threads, windows)`` of
    ``tiles`` names its windows): a ring plane and a sub-stage's rows span
    the window grown by their outer reach, the columns the windows too,
    and the rung is taken as ``by_cells`` takes it."""
    if smem_limit is None:
        from yask_tpu_torch.ops.cuda_emit import SMEM_LIMIT as smem_limit
    n0, n1, n2 = (int(x) for x in n)
    no = len(outer_n)
    lags = [hi[0] for _lo, hi in sub_regions]
    warm = max(lo[0] + hi[0] for lo, hi in sub_regions)
    in_reach = {a: _span(r, lags) for a, r in in_reads.items()}
    cmp_lo = [_span(r, lags)[0] for r in cmp_reads]
    cmp_depths = [lo + lags[k] + 1 for lo, k in zip(cmp_lo, cmp_subs)]
    unit = 16 // esize

    def ofac(wo, lo_hi):
        """Cells of a box over the outer windows ``wo`` grown by
        ``lo_hi`` ((lo, hi) per outer dim)."""
        c = 1
        for w, (lo, hi) in zip(wo, lo_hi):
            c *= w + lo + hi
        return c

    def sub_o(wo, k):
        lo, hi = sub_regions[k]
        return ofac(wo, list(zip(lo[3:], hi[3:])))

    def rings(t1, t2, pf, wo=()):
        depths = {a: ring_depth(lo, hi, pf)
                  for a, (lo, hi) in in_reach.items()}
        # a staged ring's rows: at 2 bytes from the pair holding the
        # row's first cell (stream_row)
        elems = {a: _ceil_to(depths[a]
                             * (t1 + in_halos[a][1][0] + in_halos[a][1][1])
                             * stream_row(t2 + in_halos[a][2][0]
                                          + in_halos[a][2][1], esize)
                             * (ofac(wo, in_ohalos[a]) if no else 1),
                             unit)
                 for a in in_reach}
        cells = []
        for k, d in zip(cmp_subs, cmp_depths):
            lo, hi = sub_regions[k]
            cells.append(_ceil_to(d * (t1 + lo[1] + hi[1])
                                  * (t2 + lo[2] + hi[2])
                                  * (sub_o(wo, k) if no else 1), unit))
        return depths, elems, cells

    def plan(t1, t2, nt, pf, depths, elems, cells, placed=None, wo=()):
        if placed is None:
            o, in_off, cmp_off = 0, {}, []
            for a in in_reach:
                in_off[a] = o
                o += elems[a]
            for c in cells:
                cmp_off.append(o)
                o += c
            sm, wsn, outside = o, 0, 0.0
        else:
            in_off, cmp_off, sm, wsn, outside = placed
        wsn = _ceil_to(wsn, unit)
        smem = sm * esize
        per_sm = max(1, min(SM_THREADS // nt, SM_SMEM // (smem + 1024),
                            SM_REGS // (nt * STAGES_STREAM_MIN_REGS)))
        cap = max(1, L2_BYTES // (wsn * esize)) if wsn else 0
        blocks = min(SMS * per_sm, cap) if cap else SMS * per_sm
        cols = -(-n1 // t1) * -(-n2 // t2)
        wpts = 1        # a window's points in the outer dims
        for w, ne in zip(wo, outer_n):
            cols *= -(-int(ne) // w)
            wpts *= w
        seg, segs = stream_segments(n0, cols, blocks, warm)
        pts = t1 * t2 * n0 * wpts
        staged = sum((t1 + h[1][0] + h[1][1]) * (t2 + h[2][0] + h[2][1])
                     * (ofac(wo, in_ohalos[a]) if no else 1)
                     * (n0 + segs * (warm + sum(in_reach[a])))
                     for a, h in in_halos.items()
                     if a in in_reach and in_off.get(a) is not None) / pts
        computed = [(t1 + lo[1] + hi[1]) * (t2 + lo[2] + hi[2])
                    * (ofac(wo, list(zip(lo[3:], hi[3:]))) if no else 1)
                    * (n0 + segs * (lo[0] + hi[0])) / pts
                    for lo, hi in sub_regions]
        return StagesStreamPlan(
            (t1, t2), nt, pf, lags, warm, in_reach, depths, elems,
            cmp_lo, cmp_depths, cells, smem, seg, segs, cols, per_sm,
            staged, computed,
            {a: "smem" if in_off[a] is not None else "global"
             for a in in_reach},
            ["smem" if o < sm else "workspace" for o in cmp_off],
            {a: o for a, o in in_off.items() if o is not None}, cmp_off,
            sm, wsn, cap, outside, esize, tuple(wo),
            {a: [tuple(x) for x in in_ohalos[a]] for a in in_reach}
            if no else {})

    # the rungs: past three dims every combination of outer windows with
    # each plane tile, or the windows a rung names as its fourth entry
    wos = list(itertools.product(*[
        list(dict.fromkeys(min(w, int(ne)) for w in STAGES_STREAM_OUTER))
        for ne in outer_n]))
    tiles = [(*rung[:3], wo) for rung in tiles
             for wo in ([tuple(rung[3])] if len(rung) > 3 else wos)]
    fits = {}
    for t1, t2, nt, wo in tiles:
        for pf in prefetch:
            depths, elems, cells = rings(t1, t2, pf, wo)
            if (sum(elems.values()) + sum(cells)) * esize <= smem_limit:
                if not by_cells:
                    return plan(t1, t2, nt, pf, depths, elems, cells)
                fits[(t1, t2, nt, wo)] = plan(t1, t2, nt, pf, depths, elems,
                                              cells, wo=wo)
                break
    # rungs whose rings do not fit: past shared memory
    best = None
    for t1, t2, nt, wo in tiles:
        if by_cells and (t1, t2, nt, wo) in fits:
            continue
        for pf in prefetch:
            depths, elems, cells = rings(t1, t2, pf, wo)
            # computed cells per plane-tile point of each sub-stage
            per = [(t1 + lo[1] + hi[1]) * (t2 + lo[2] + hi[2]) / (t1 * t2)
                   * ((sub_o(wo, k) / math.prod(wo)) if no else 1)
                   for k, (lo, hi) in enumerate(sub_regions)]
            reads = {a: sum(c * per[j] for j, c in in_nreads[a].items())
                     for a in in_reach}
            in_off, cmp_off, sm, wsn = _place_rings(
                elems, cells,
                {a: reads[a] / elems[a] for a in in_reach},
                smem_limit // esize)
            if _ceil_to(wsn, unit) * esize > ws_limit:
                continue
            outside = sum(reads[a] for a, o in in_off.items() if o is None)
            outside += sum(per[k] + sum(c * per[j] for j, c in r.items())
                           for k, r, o in zip(cmp_subs, cmp_nreads, cmp_off)
                           if o >= sm)
            outside *= esize
            if best is None or outside < best[0]:
                best = (outside, (t1, t2, nt, pf, depths, elems, cells,
                                  (in_off, cmp_off, sm, wsn, outside), wo))
        if by_cells and best is not None \
                and (*best[1][:3], best[1][-1]) == (t1, t2, nt, wo):
            fits[(t1, t2, nt, wo)] = plan(*best[1])
            best = None
    if by_cells:
        order = {rung: i for i, rung in enumerate(tiles)}

        def inplane(p):
            """Computed cells per useful point in the plane tile (and the
            outer windows; the segments' slot-0 warm-up left out: the rung
            does not depend on the domain's size)."""
            t1, t2 = p.tile
            wo = p.outer_tile
            return sum((t1 + lo[1] + hi[1]) * (t2 + lo[2] + hi[2])
                       * (ofac(wo, list(zip(lo[3:], hi[3:]))) if no else 1)
                       for lo, hi in sub_regions) / (
                           t1 * t2 * math.prod(wo) * len(sub_regions))
        return min(fits.values(), default=None, key=lambda p: (
            inplane(p), p.outside_per_point,
            order[(*p.tile, p.threads, p.outer_tile)]))
    return None if best is None else plan(*best[1])
