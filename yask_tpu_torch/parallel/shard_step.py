"""Explicit sharded stepping: per-shard programs and ghost exchange.

The port's counterpart of ``yask_tpu/parallel/shard_step.py``, the
structural twin of the reference's MPI halo machinery
(``src/kernel/lib/halo.cpp``).  ``yask_tpu`` is single-controller SPMD:
one process traces every shard of a ``jax.sharding.Mesh`` inside
``shard_map`` and moves ghost slabs with ``lax.ppermute``.  The port keeps
that shape without a compiler: one process holds every shard's padded
tensors (a list in mesh order, :class:`~yask_tpu_torch.parallel.mesh.Mesh`)
and runs each stage or sub-step for all shards in lockstep, and a ghost
exchange is a set of slab copies (``narrow(...).copy_(...)``) between
neighbour shards' tensors — inside one card's memory where two shards
share a device, peer to peer between cards otherwise.

* :func:`exchange_ghosts` / :func:`_exchange_coalesced` /
  :func:`exchange_many`: the exchange, in place, axes in CommPlan order so
  corner ghosts compose; a face with no neighbour receives zeros (the
  reference's ``ppermute`` members that receive nothing).
* :func:`run_shard_map` (modes ``shard_map`` and ``sharded``): the
  per-shard torch ``StepProgram`` (its rank offset a plain int), ghosts
  refreshed before each stage that reads at an offset
  (``StepProgram.stage_reads``), optionally split into core and shells
  (:func:`_make_overlap_step`).
* :func:`run_shard_pallas`: ghost pads of ``hK = radius × K`` (``radius``
  the whole step's reach, ``fused_step_radius``: every stage's read
  widths summed), one exchange per group of K steps, then K sub-steps of
  K5 (``fused_stencil.shard_step``: K1's body for one stage, K6's for
  several stages or scratch vars, every A3 arm alike) per shard,
  sub-step ``s`` over the interior grown by ``r·(K−1−s)`` in the sharded
  dims (outer dims included); with the overlap engaged
  (:func:`overlap_decision`) every sub-step's core runs on the
  pre-exchange state while the exchange copies on a second CUDA stream,
  then the shell slabs (:func:`split_boxes`) run.  The exchange carries
  every var the shard holds: misc axes ride along whole, a var lacking a
  sharded dim has nothing to exchange in it (every shard of that row
  computes the same values), and bfloat16 slabs are copied as they are.
* the state: the global padded state of the context is scattered to the
  shards at a run's start and stays there between runs
  (``RunState.resident``); any host-visible access gathers it back one var
  and ring slot at a time (:func:`gather_state`, the reference's
  ``_repad_global``).

Not carried: the halo-time calibration (``timed_median``,
``_calibrate_halo_frac``, ``_build_exchange_only``; ``-measure_halo``
raises, ROADMAP.md A11).  The skewed wavefront inside shards is K5 over
the stream arms (K1's for a single-stage solution, K6's otherwise), one
level per launch, each box walked along slot 0 (``-skew``, the default;
ROADMAP.md C11).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

from yask_tpu_torch.utils.exceptions import YaskException


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def _slab(a, ax: int, lo: int, width: int):
    return a.narrow(ax, lo, width)


def exchange_ghosts(arrs, geom, dim_widths: Dict[str, Tuple[int, int]],
                    mesh, local_sizes):
    """Fill the ghost pads of one buffer on every shard from its
    neighbours, in place, for the given dims in the given order.

    ``arrs`` holds the buffer's padded tensor per shard (mesh order); for
    each dim with width (l, r): each shard's right interior edge slab goes
    to its right neighbour's left ghost and its left edge slab to the left
    neighbour's right ghost (the pack/send/unpack cycle of
    ``exchange_halos``, ``halo.cpp:146``); an outer face gets zeros."""
    for d, (l, r) in dim_widths.items():
        n = mesh.shape.get(d, 1)
        if n <= 1 or d not in geom.domain_dims:
            continue
        ax = geom.axis_of(d)
        o = geom.origin[d]
        sz = local_sizes[d]
        pairs = mesh.neighbour_pairs(d)
        if l > 0:
            for left, right in pairs:
                _slab(arrs[right], ax, o - l, l).copy_(
                    _slab(arrs[left], ax, o + sz - l, l))
            for i in mesh.edges(d, left=True):
                _slab(arrs[i], ax, o - l, l).zero_()
        if r > 0:
            for left, right in pairs:
                _slab(arrs[left], ax, o + sz, r).copy_(
                    _slab(arrs[right], ax, o, r))
            for i in mesh.edges(d, left=False):
                _slab(arrs[i], ax, o + sz, r).zero_()
    return arrs


def _exchange_coalesced(items, mesh, local_sizes, order):
    """Coalesced exchange: per (axis, direction) and neighbour pair ONE
    copy carrying every buffer's slab, flattened and concatenated (grouped
    by dtype), then split back into each buffer's ghost band.  The copy
    moves bytes only, so the result is bit-identical to the per-buffer
    schedule; axes still go in plan order, so corner ghosts compose."""
    import torch
    for d in order:
        n = mesh.shape.get(d, 1)
        if n <= 1:
            continue
        sz = local_sizes[d]
        pairs = mesh.neighbour_pairs(d)
        for left in (True, False):
            # what each item sends and where it lands, per dtype
            groups: Dict[str, list] = {}
            for arrs, g, w in items:
                if d not in w or d not in g.domain_dims:
                    continue
                width = w[d][0] if left else w[d][1]
                if width <= 0:
                    continue
                ax = g.axis_of(d)
                o = g.origin[d]
                src_lo = (o + sz - width) if left else o
                dst_lo = (o - width) if left else (o + sz)
                groups.setdefault(str(arrs[0].dtype), []).append(
                    (arrs, ax, src_lo, dst_lo, width))
            for group in groups.values():
                for a, b in pairs:
                    src, dst = (a, b) if left else (b, a)
                    if len(group) == 1:
                        arrs, ax, s_lo, d_lo, width = group[0]
                        _slab(arrs[dst], ax, d_lo, width).copy_(
                            _slab(arrs[src], ax, s_lo, width))
                        continue
                    payload = torch.cat(
                        [_slab(arrs[src], ax, s_lo, width).reshape(-1)
                         for arrs, ax, s_lo, _d, width in group])
                    recv = payload.to(group[0][0][dst].device)
                    off = 0
                    for arrs, ax, _s, d_lo, width in group:
                        view = _slab(arrs[dst], ax, d_lo, width)
                        nel = view.numel()
                        view.copy_(recv[off:off + nel].view(view.shape))
                        off += nel
                edges = mesh.edges(d, left=left)
                for arrs, ax, _s, d_lo, width in group:
                    for i in edges:
                        _slab(arrs[i], ax, d_lo, width).zero_()
    return [arrs for arrs, _g, _w in items]


def exchange_many(items, mesh, local_sizes, plan=None):
    """The one multi-buffer exchange entry of both shard paths.

    ``items`` is a list of ``(per-shard tensors, geom, dim_widths)``; the
    tensors are updated in place (and returned in the same order).  The
    CommPlan decides the schedule: without one, or with coalescing off,
    each buffer runs :func:`exchange_ghosts` with its dims in plan order;
    with coalescing on, :func:`_exchange_coalesced`.  Either way axes go
    in plan order and the two schedules are bit-identical."""
    if not items:
        return []
    order = list(plan.order) if plan is not None else []
    seen = set(order)
    for _a, _g, w in items:
        for d in w:
            if d not in seen:
                order.append(d)
                seen.add(d)
    if plan is None or not plan.coalesce:
        return [exchange_ghosts(a, g, {d: w[d] for d in order if d in w},
                                mesh, local_sizes) for a, g, w in items]
    return _exchange_coalesced(items, mesh, local_sizes, order)


def _widen(applied: Dict, key, widths: Dict[str, Tuple[int, int]]):
    """Track the union of exchanged ghost widths per buffer: returns
    (union, grew) where ``grew`` means this refresh must actually run — a
    later stage reading the same buffer with WIDER ghosts re-exchanges the
    union, not the narrow refresh."""
    out = dict(applied.get(key, {}))
    grew = key not in applied
    for d, (l, r) in widths.items():
        al, ar = out.get(d, (0, 0))
        if l > al or r > ar:
            grew = True
        out[d] = (max(al, l), max(ar, r))
    return out, grew


# ---------------------------------------------------------------------------
# the overlap decision of shard_pallas
# ---------------------------------------------------------------------------


def overlap_decision(ctx, K: int, local_prog=None, unit: int = 1):
    """Engage/reject decision for the overlapped shard_pallas schedule
    (the core/shell split of each K-group), the reference's
    ``overlap_decision`` (shard_step.py:213-318).

    Returns ``(engage, core, shells, reasons)``: ``core`` is the region
    ``{dim: (lo, hi)}`` of the core chunk, ``shells`` a list of
    ``(dim, lo, hi)`` face slabs.  Pure geometry, never raises.  ``unit``
    is the alignment of a split boundary in a dim that is some var's
    second-minor axis: the reference's sublane tile (8 for fp32) rides
    Mosaic's DMA rules; the card needs none, so the port runs with 1, and
    ``unit=8`` reproduces the reference's answers.  Eligibility: setting
    not ``off``, K ≥ 2, the minor dim unsharded, at least one sharded
    leading dim with a nonzero ``hK = radius × K``, and per sharded dim an
    aligned core span ``[align_up(hK), align_down(n − hK))`` of at least
    one unit.  ``auto`` then engages only where the mesh spans more than
    one card: with every shard on one card the split measured slower than
    the serial schedule (PERF.md, PR 5), and ``on`` forces it."""
    opts = ctx._opts
    ana = ctx._ana
    dims = ana.domain_dims
    minor = dims[-1]
    nr = {d: opts.num_ranks[d] for d in dims}
    lsizes = opts.rank_domain_sizes
    rad = ana.fused_step_radius()
    hK = {d: rad.get(d, 0) * K for d in dims}
    setting = getattr(opts, "overlap_exchange", "auto")
    reasons: List[dict] = []

    if setting == "off":
        reasons.append({"code": "overlap_disabled",
                        "cause": "overlap_exchange=off"})
        return False, None, None, reasons
    if K < 2:
        reasons.append({
            "code": ("overlap_infeasible" if setting == "on"
                     else "overlap_ineligible"),
            "cause": "wf_steps=1: a single-step group leaves no core "
                     "compute to overlap the exchange with"})
        return False, None, None, reasons
    if nr.get(minor, 1) > 1:
        reasons.append({"code": "overlap_ineligible",
                        "cause": f"minor dim '{minor}' is sharded "
                                 "(lane-axis windows cannot restrict)"})
        return False, None, None, reasons
    sharded = [d for d in dims[:-1] if nr.get(d, 1) > 1 and hK[d] > 0]
    if not sharded:
        reasons.append({"code": "overlap_ineligible",
                        "cause": "no sharded leading dim with a "
                                 "nonzero fused ghost width"})
        return False, None, None, reasons

    if local_prog is None:
        local_prog = ctx._csol.plan(
            lsizes, global_sizes=opts.global_domain_sizes,
            extra_pad={d: (hK[d], hK[d]) for d in dims})
    # dims that are some var's second-minor axis take the unit
    sub_dims = set()
    for g in local_prog.geoms.values():
        if g.is_scratch or len(g.axes) < 2:
            continue
        dn, kind = g.axes[-2]
        if kind == "domain" and dn != minor:
            sub_dims.add(dn)

    core: Dict[str, Tuple[int, int]] = {}
    shells: List[Tuple[str, int, int]] = []
    for d in sharded:
        q = unit if d in sub_dims else 1
        lo = -(-hK[d] // q) * q
        hi = ((lsizes[d] - hK[d]) // q) * q
        if hi - lo < q:
            reasons.append({
                "code": ("overlap_infeasible" if setting == "on"
                         else "overlap_ineligible"),
                "cause": f"dim '{d}': aligned core span [{lo},{hi}) is "
                         f"empty — rank domain {lsizes[d]} cannot "
                         f"cover 2×hK={2 * hK[d]} plus alignment "
                         f"(unit {q})", "dim": d})
            return False, None, None, reasons
        core[d] = (lo, hi)
        shells.append((d, 0, lo))
        shells.append((d, hi, lsizes[d]))
    mesh = getattr(ctx, "_mesh", None)
    if setting == "auto" and mesh is not None and mesh.num_cards() == 1:
        reasons.append({
            "code": "overlap_one_card",
            "cause": "auto: every shard sits on one card, where the "
                     "exchange is a few copies inside its memory and the "
                     "split adds a launch per shell to every shard's "
                     "sub-step; -overlap_x on forces it",
            "core": {d: list(core[d]) for d in sorted(core)}})
        return False, None, None, reasons
    reasons.append({"code": "overlap_engaged",
                    "core": {d: list(core[d]) for d in sorted(core)},
                    "hK": {d: hK[d] for d in sorted(core)}})
    return True, core, shells, reasons


# ---------------------------------------------------------------------------
# shard state: scatter, gather, per-shard programs
# ---------------------------------------------------------------------------


class ShardLayout:
    """The per-shard geometry of one shard mode of a prepared context:
    the mesh, each shard's global origin and device, the local sizes and
    one program per shard (``rank_offset`` = its origin, ``global_sizes``
    set, ops on its device).  ``key`` names the pad geometry, so a
    resident state is reused only by a run of the same layout;
    ``pad_multiple`` rounds each shard's padded extent per dim, as the
    context's plan does."""

    def __init__(self, ctx, extra_pad, key, pad_multiple=None):
        from yask_tpu_torch.compiler.lowering import TorchOps
        opts = ctx._opts
        dims = ctx._ana.domain_dims
        self.key = key
        self.mesh = ctx._mesh
        self.lsizes = opts.rank_domain_sizes.copy()
        self.gsizes = opts.global_domain_sizes.copy()
        self.nr = {d: opts.num_ranks[d] for d in dims}
        self.offsets = []
        self.devices = []
        self.progs = []
        for i in range(self.mesh.size):
            c = self.mesh.coords(i)
            off = {d: c.get(d, 0) * self.lsizes[d] for d in dims}
            dev = self.mesh.device(i)
            self.offsets.append(off)
            self.devices.append(dev)
            self.progs.append(ctx._csol.plan(
                self.lsizes, ops=TorchOps(dev), extra_pad=extra_pad,
                rank_offset=off, global_sizes=self.gsizes,
                pad_multiple=pad_multiple))
        self.names = [k for k, g in ctx._program.geoms.items()
                      if not g.is_scratch]

    def _local_idx(self, g):
        return tuple(slice(g.origin[dn], g.origin[dn] + self.lsizes[dn])
                     if kind == "domain" else slice(None)
                     for dn, kind in g.axes)

    def _global_idx(self, gg, off):
        return tuple(slice(gg.origin[dn] + off[dn],
                           gg.origin[dn] + off[dn] + self.lsizes[dn])
                     if kind == "domain" else slice(None)
                     for dn, kind in gg.axes)

    def scatter(self, ctx):
        """The context's global padded state as per-shard padded states
        (pads zero), one var and ring slot at a time; each global slot is
        dropped once scattered."""
        import torch
        from yask_tpu_torch.compiler.lowering import torch_dtype
        rs = ctx._run
        gstate = rs.state
        gprog = ctx._program
        dtype = torch_dtype(gprog.dtype)
        shards = [{} for _ in range(self.mesh.size)]
        for k in self.names:
            ring = gstate[k]
            gg = gprog.geoms[k]
            for si in range(len(ring)):
                src = ring[si]
                if not isinstance(src, torch.Tensor):
                    src = torch.as_tensor(src)
                for i, p in enumerate(self.progs):
                    g = p.geoms[k]
                    a = torch.zeros(tuple(g.shape), dtype=dtype,
                                    device=self.devices[i])
                    a[self._local_idx(g)] = src[
                        self._global_idx(gg, self.offsets[i])].to(
                            self.devices[i])
                    shards[i].setdefault(k, []).append(a)
                ring[si] = None
        rs.state = None
        return shards

    def gather(self, ctx, shards):
        """Per-shard states back into the context's global padded state on
        its device, one var and ring slot at a time (each shard slot is
        dropped once copied: the state is held twice for one slot only)."""
        import torch
        from yask_tpu_torch.compiler.lowering import torch_dtype
        gprog = ctx._program
        dtype = torch_dtype(gprog.dtype)
        state = {}
        for k in self.names:
            gg = gprog.geoms[k]
            ring = []
            for si in range(len(shards[0][k])):
                a = torch.zeros(tuple(gg.shape), dtype=dtype,
                                device=ctx._device)
                for i, p in enumerate(self.progs):
                    g = p.geoms[k]
                    a[self._global_idx(gg, self.offsets[i])] = \
                        shards[i][k][si][self._local_idx(g)].to(ctx._device)
                    shards[i][k][si] = None
                ring.append(a)
            state[k] = ring
        return state


def gather_state(ctx) -> None:
    """The lazy host sync point (the reference's ``_materialize_state`` +
    ``_repad_global``): a resident per-shard state becomes the context's
    global padded state again."""
    rs = ctx._run
    layout, shards = rs.resident
    rs.resident = None
    rs.state = layout.gather(ctx, shards)
    rs.state_on_device = True


def _resident_shards(ctx, layout):
    """The per-shard states a run of ``layout`` starts from: the resident
    ones when they have this layout, else scattered from the global
    state."""
    rs = ctx._run
    if rs.resident is not None and rs.resident[0].key == layout.key:
        shards = rs.resident[1]
        rs.resident = None
        return shards
    ctx._materialize_state()
    ctx._state_to_device()
    return layout.scatter(ctx)


def _sync(layout) -> None:
    import torch
    for d in set(layout.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# shard_map / sharded: per-shard torch steps
# ---------------------------------------------------------------------------


def _stage_writes(ana) -> List[List[str]]:
    out = []
    for stage in ana.stages:
        ws = []
        for part in stage.parts:
            if not part.is_scratch:
                for eq in part.eqs:
                    if eq.lhs.var_name() not in ws:
                        ws.append(eq.lhs.var_name())
        out.append(ws)
    return out


def _make_plain_step(layout, plan):
    """One step of every shard in lockstep, ghosts refreshed before each
    stage (the reference's ``one_step_plain`` with its ``halo_hook``):
    BOTH buffers a stage's reads can hit — an earlier stage's computed
    array and the newest ring slot — batched through exchange_many."""
    progs = layout.progs
    prog0 = progs[0]
    mesh, lsizes = layout.mesh, layout.lsizes
    S = len(progs)

    def one_step(shards, t):
        applied: Dict = {}
        computed = [{} for _ in range(S)]
        scratch = [{} for _ in range(S)]
        for si in range(len(prog0.ana.stages)):
            split = prog0.stage_reads_split[si]
            items = []
            for vname, widths in split["computed"].items():
                if vname not in computed[0]:
                    continue
                u, grew = _widen(applied, (vname, "c"), widths)
                if grew:
                    items.append(([c[vname] for c in computed],
                                  prog0.geoms[vname], u))
                    applied[(vname, "c")] = u
            for vname, widths in split["ring"].items():
                g2 = prog0.geoms[vname]
                if not (g2.is_written and g2.has_step):
                    continue
                u, grew = _widen(applied, (vname, "s"), widths)
                if grew:
                    items.append(([st[vname][-1] for st in shards], g2, u))
                    applied[(vname, "s")] = u
            exchange_many(items, mesh, lsizes, plan)
            for i in range(S):
                progs[i].eval_stage(si, t, shards[i], computed[i],
                                    scratch[i])
        return [progs[i].rotate(shards[i], computed[i]) for i in range(S)]

    return one_step


def _make_overlap_step(layout, plan):
    """Interior/exterior-split step: the reference's ``_make_overlap_step``
    (the ``run_solution`` exterior-then-interior structure,
    ``context.cpp:377-478``).  Per stage: the *core* region (interior
    shrunk by the stage's ghost widths in sharded dims) reads no ghost, so
    it is evaluated before the exchange; the boundary *shell* slabs are
    evaluated after it, on the core's output.  The exchange runs in place:
    it writes ghosts only, which the core never reads, so its pre- and
    post-exchange state are the same tensors.  Overlapping shell corners
    recompute identical values."""
    progs = layout.progs
    prog0 = progs[0]
    ana = prog0.ana
    dims = ana.domain_dims
    mesh, lsizes, nr = layout.mesh, layout.lsizes, layout.nr
    S = len(progs)
    stage_writes = _stage_writes(ana)

    def one_step(shards, t):
        computed = [{} for _ in range(S)]
        posted = set()      # computed buffers whose ghosts are fresh
        ring_w: Dict = {}
        post_w: Dict = {}
        for si in range(len(ana.stages)):
            reads = prog0.stage_reads[si]
            split = prog0.stage_reads_split[si]
            items, tags = [], []
            for vname, widths in split["computed"].items():
                if not any(nr.get(d, 1) > 1 for d in widths):
                    continue
                if vname in computed[0]:
                    union, grew = _widen(post_w, vname, widths)
                    if vname not in posted or grew:
                        items.append(([c[vname] for c in computed],
                                      prog0.geoms[vname], union))
                        tags.append(("c", vname, union))
            for vname, widths in split["ring"].items():
                g = prog0.geoms[vname]
                if not any(nr.get(d, 1) > 1 for d in widths):
                    continue
                if g.is_written and g.has_step:
                    union, grew = _widen(ring_w, vname, widths)
                    if grew:
                        items.append(([st[vname][-1] for st in shards], g,
                                      union))
                        tags.append(("s", vname, union))

            act: Dict[str, Tuple[int, int]] = {}
            for vname, widths in reads.items():
                for d, (l, r) in widths.items():
                    if nr.get(d, 1) > 1:
                        cl, cr = act.get(d, (0, 0))
                        act[d] = (max(cl, l), max(cr, r))
            splittable = act and all(
                lsizes[d] - l - r > 0 for d, (l, r) in act.items())

            def exchange():
                exchange_many(items, mesh, lsizes, plan)
                for kind, vname, union in tags:
                    if kind == "c":
                        posted.add(vname)
                        post_w[vname] = union
                    else:
                        ring_w[vname] = union

            if not splittable:
                exchange()
                for i in range(S):
                    tmp = dict(computed[i])
                    progs[i].eval_stage(si, t, shards[i], tmp, {})
                    for name in stage_writes[si]:
                        computed[i][name] = tmp[name]
                for name in stage_writes[si]:
                    posted.discard(name)
                    post_w.pop(name, None)
                continue

            core = {d: (act.get(d, (0, 0))[0],
                        lsizes[d] - act.get(d, (0, 0))[1]) for d in dims}
            tmps = []
            for i in range(S):
                tmp = dict(computed[i])
                progs[i].eval_stage(si, t, shards[i], tmp, {}, over=core)
                tmps.append(tmp)
            exchange()
            interior = {d: (0, lsizes[d]) for d in dims}
            for i in range(S):
                tmp = dict(computed[i])
                for name in stage_writes[si]:
                    tmp[name] = tmps[i][name]
                for d, (l, r) in act.items():
                    for a, b in ((0, l), (lsizes[d] - r, lsizes[d])):
                        if b <= a:
                            continue
                        over = dict(interior)
                        over[d] = (a, b)
                        progs[i].eval_stage(si, t, shards[i], tmp, {},
                                            over=over)
                for name in stage_writes[si]:
                    computed[i][name] = tmp[name]
            for name in stage_writes[si]:
                posted.discard(name)
                post_w.pop(name, None)
        return [progs[i].rotate(shards[i], computed[i]) for i in range(S)]

    return one_step


def shard_map_layout(ctx) -> ShardLayout:
    """The per-shard geometry of shard_map/sharded: pads = halos (the
    reference's per-shard plan without Mosaic alignment)."""
    if not isinstance(ctx._shard, ShardLayout):
        ctx._shard = ShardLayout(ctx, None, ("shard_map",))
    return ctx._shard


def run_shard_map(ctx, start: int, n: int) -> None:
    """Advance ``n`` steps in modes ``shard_map`` and ``sharded``; the
    shards stay resident afterwards."""
    opts = ctx._opts
    dirn = ctx._ana.step_dir
    plan = ctx.comm_plan()
    if plan.errors:
        raise YaskException("communication plan invalid: "
                            + "; ".join(plan.errors))
    layout = shard_map_layout(ctx)
    ctx._last_cache_hit = "eager"
    with ctx._run_timer:
        shards = _resident_shards(ctx, layout)
        # every slot once, so older ring slots carry valid ghosts (only
        # the newest slot is stale afterwards)
        items = []
        prog0 = layout.progs[0]
        for k in layout.names:
            g = prog0.geoms[k]
            widths = {d: g.var.halo.get(d, (0, 0)) for d in g.domain_dims}
            widths = {d: w for d, w in widths.items() if w != (0, 0)}
            if widths:
                for si in range(len(shards[0][k])):
                    items.append(([sh[k][si] for sh in shards], g, widths))
        exchange_many(items, layout.mesh, layout.lsizes, plan)
        one_step = (_make_overlap_step if opts.overlap_comms
                    else _make_plain_step)(layout, plan)
        t = start
        for _ in range(n):
            shards = one_step(shards, t)
            t += dirn
        _sync(layout)
    ctx._run.resident = (layout, shards)


# ---------------------------------------------------------------------------
# shard_pallas: K5 sub-steps per shard
# ---------------------------------------------------------------------------


class ShardPallasPlan:
    """One shard_pallas configuration of a prepared context: the layout
    (pads grown by ``hK = radius × wf_steps``), K5's kernel over the local
    program (push off, as the reference builds its distributed chunk
    without ``push=``; the session's ``-skew`` and ``-skew_dims`` select
    a stream arm over each box where it engages: K1's for a single-stage
    solution, K6's otherwise), and the tiling
    record of the last run."""

    def __init__(self, ctx):
        from yask_tpu_torch.compiler.lowering import is_bfloat16
        from yask_tpu_torch.ops.fused_stencil import FusedKernel
        opts = ctx._opts
        dims = ctx._ana.domain_dims
        self.K = max(opts.wf_steps, 1)
        rad = ctx._ana.fused_step_radius()
        self.rad = {d: rad.get(d, 0) for d in dims}
        hK = {d: self.rad[d] * self.K for d in dims}
        extra = {d: (hK[d], hK[d]) for d in dims}
        # at element size 2 the padded minor extent per shard the
        # context plans: the stream arms over a box fill their rings with
        # aligned bfloat16 pairs, K1's with 16-byte units
        # (fused_stencil.check_pair_strides)
        from yask_tpu_torch.ops.cuda_emit import bf16_minor_multiple
        mult = ({dims[-1]: bf16_minor_multiple(ctx._ana)}
                if is_bfloat16(ctx._csol.dtype) else None)
        self.layout = ShardLayout(ctx, extra, ("shard_pallas", self.K),
                                  mult)
        self.kernel = FusedKernel(ctx._csol.plan(
            opts.rank_domain_sizes, ops=self.layout.progs[0].ops,
            extra_pad=extra, global_sizes=opts.global_domain_sizes,
            pad_multiple=mult),
            push=False, skew=ctx._skew_arg(),
            max_skew_dims=opts.skew_dims_max, region=True)
        self.tiling = None


def check_shard_pallas(ctx, K: int) -> None:
    """The reference's rejections (shard_step.py:1040-1056), with its
    messages."""
    opts = ctx._opts
    dims = ctx._ana.domain_dims
    minor = dims[-1]
    nr = {d: opts.num_ranks[d] for d in dims}
    lsizes = opts.rank_domain_sizes
    if K > 1 and nr.get(minor, 1) > 1:
        raise YaskException(
            f"shard_pallas with wf_steps={K} > 1 cannot shard the minor "
            f"dim '{minor}' (its in-tile region never shrinks); use "
            "wf_steps 1 or keep the minor dim whole")
    rad = ctx._ana.fused_step_radius()
    for d in dims:
        hk = rad.get(d, 0) * K
        if nr.get(d, 1) > 1 and lsizes[d] < hk:
            raise YaskException(
                f"rank domain {lsizes[d]} in dim '{d}' smaller than the "
                f"fused ghost width {hk} (radius × wf_steps)")


def shard_pallas_plan(ctx) -> ShardPallasPlan:
    """The context's shard_pallas plan, made at the first run (again if
    ``wf_steps`` grew past the pads it planned)."""
    if not isinstance(ctx._shard, ShardPallasPlan) \
            or ctx._shard.K < max(ctx._opts.wf_steps, 1):
        ctx._shard = ShardPallasPlan(ctx)
    return ctx._shard


def _full_box(sp, gk, s):
    """Sub-step ``s`` of a ``gk``-step group: the interior grown by
    ``r·(gk−1−s)`` in the sharded dims (what the later sub-steps read)."""
    layout = sp.layout
    box = {}
    for d in layout.lsizes.get_dim_names():
        e = sp.rad[d] * (gk - 1 - s) if layout.nr.get(d, 1) > 1 else 0
        box[d] = (-e, layout.lsizes[d] + e)
    return box


def _chunk(sp, shards, t, gk, dirn):
    """``gk`` sub-steps of K5 on every shard, each over its full box;
    returns the shards' new states."""
    from yask_tpu_torch.ops.fused_stencil import shard_step
    out = []
    for i, st in enumerate(shards):
        for s in range(gk):
            st = shard_step(sp.kernel, st, t + s * dirn, _full_box(sp, gk, s),
                            sp.layout.offsets[i])
        out.append(st)
    return out


def split_boxes(sp, core, gk, s):
    """Sub-step ``s`` of an overlapped ``gk``-step group: the core box
    (``core`` grown by ``r·(gk−1−s)`` in the sharded dims) and the shell
    boxes that tile the rest of the sub-step's full box, disjoint from the
    core and from each other (per split dim in order: its two faces over
    what the earlier dims' faces left)."""
    full = _full_box(sp, gk, s)
    cbox = {d: ((core[d][0] + lo, core[d][1] - lo) if d in core else (lo, hi))
            for d, (lo, hi) in full.items()}
    shells = []
    rest = dict(full)
    for d in core:
        for a, b in ((full[d][0], cbox[d][0]), (cbox[d][1], full[d][1])):
            if b > a:
                piece = dict(rest)
                piece[d] = (a, b)
                shells.append(piece)
        rest[d] = cbox[d]
    return cbox, shells


def _widths_hK(sp, K, g):
    return {d: (sp.rad[d] * K, sp.rad[d] * K) for d in g.domain_dims
            if sp.layout.nr.get(d, 1) > 1 and sp.rad[d] * K > 0}


def _exchange_all(sp, shards, K, plan):
    """Full refresh: every slot of every var (once per run: read-only
    vars and surviving slots keep valid ghosts after it)."""
    items = []
    g0 = sp.kernel.program.geoms
    for k in sp.layout.names:
        w = _widths_hK(sp, K, g0[k])
        if w:
            for si in range(len(shards[0][k])):
                items.append(([sh[k][si] for sh in shards], g0[k], w))
    exchange_many(items, sp.layout.mesh, sp.layout.lsizes, plan)


def exchange_newest(sp, shards, K, plan):
    """Per-group refresh: only the min(K, slots) newest slots of written
    vars, which the group just produced."""
    items = []
    g0 = sp.kernel.program.geoms
    for k in sp.layout.names:
        g = g0[k]
        if not g.is_written:
            continue
        w = _widths_hK(sp, K, g)
        if not w:
            continue
        L = len(shards[0][k])
        for si in range(L - min(K, L), L):
            items.append(([sh[k][si] for sh in shards], g, w))
    exchange_many(items, sp.layout.mesh, sp.layout.lsizes, plan)


@contextlib.contextmanager
def _side_streams(layout, side):
    """Run the enclosed work on each card's side stream, ordered after
    what its main stream has queued."""
    import torch
    if not side:
        yield
        return
    with contextlib.ExitStack() as stack:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
            stack.enter_context(torch.cuda.stream(s))
        yield


def _join_streams(side) -> None:
    import torch
    for dev, s in side.items():
        torch.cuda.current_stream(dev).wait_stream(s)


def run_shard_pallas(ctx, start: int, n: int) -> None:
    """Distributed fused stepping: each shard carries ghost pads of
    ``radius × K``, one exchange refreshes them per group of K steps, and
    K5 advances the group on every shard (its domain mask works in global
    coordinates through the shard's origin, so exchanged ghosts update
    through the sub-steps while the global boundary stays zero)."""
    opts = ctx._opts
    dirn = ctx._ana.step_dir
    K = min(max(opts.wf_steps, 1), n)
    check_shard_pallas(ctx, K)
    plan = ctx.comm_plan(K)
    if plan.errors:
        raise YaskException("communication plan invalid: "
                            + "; ".join(plan.errors))
    sp = shard_pallas_plan(ctx)
    layout = sp.layout
    if layout.devices[0].type == "cuda":
        ctx._compile_secs += sp.kernel.build()
        ctx._last_cache_hit = sp.kernel.cache_hit
    else:
        ctx._last_cache_hit = "plain"
    groups, rem = divmod(n, K)
    ngroups = groups + (1 if rem else 0)

    ov, core, shells, reasons = overlap_decision(
        ctx, K, local_prog=sp.kernel.program)
    setting = getattr(opts, "overlap_exchange", "auto")
    if setting == "on" and not ov:
        raise YaskException(
            "overlap_exchange=on but the core/shell split is "
            "infeasible: " + "; ".join(
                r.get("cause", r["code"]) for r in reasons))
    if ov and ngroups < 2:
        ov = False
        reasons.append({"code": "overlap_inactive",
                        "cause": f"single K-group (n={n} ≤ K={K}): "
                                 "no exchange to overlap"})
    if ov and rem == 1:
        reasons.append({
            "code": "overlap_rem_unsplit",
            "cause": "remainder group fuses a single step: run whole on "
                     "post-exchange state (no compute to hide its "
                     "exchange under)"})
    spec = sp.kernel.spec
    # a var whose unwritten misc slices start from a copy of its evicted
    # slot cannot take the copy before the group's shells wrote that slot
    base = spec.base_outputs if spec is not None else []
    short = [n for n in base if sp.kernel.program.geoms[n].num_slots < K]
    if ov and short:
        reasons.append({
            "code": "overlap_base_ring_short",
            "cause": f"{', '.join(short)} start from a copy of the evicted "
                     f"slot, which a {K}-step group writes before its "
                     "shells ran: such a group runs whole on post-exchange "
                     "state"})
    tiling = sp.kernel.tiling(K)
    tiling.update(kernel="shard_step",
                  launches_per_step=layout.mesh.size, distributed=True,
                  mesh=dict(layout.mesh.shape),
                  overlap_exchange=bool(ov), overlap_reasons=list(reasons),
                  comm=plan.record())
    if not tiling.get("skew"):
        tiling["name"] = spec.name + "_region" if spec is not None else None
    if ov:
        tiling["overlap_core"] = {d: list(v) for d, v in core.items()}
    sp.tiling = tiling

    import torch
    side = {}
    if ov:
        # high priority: the exchange's copies take an SM as soon as one
        # frees up, instead of queueing behind the core's blocks
        side = {d: torch.cuda.Stream(d, priority=-1)
                for d in set(layout.devices) if d.type == "cuda"}

    def ov_group(st, t, gk):
        """Exchange on the side streams while every sub-step's core runs
        on the pre-exchange state, then every sub-step's shells on the
        post-exchange state.  The exchange writes ghosts only, which the
        core never reads, so both states are the same tensors; the core
        and the shells of a sub-step write disjoint boxes of its
        outputs."""
        from yask_tpu_torch.ops.fused_stencil import (_rotated, copy_base,
                                                      shard_step)
        with _side_streams(layout, side):
            exchange_newest(sp, st, K, plan)
        kern = sp.kernel
        if gk < 2 or any(len(st[0][n]) < gk for n in base):
            # a single-step group has no core compute to hide the
            # exchange under, and a short ring of a base output (above):
            # run it whole after the exchange
            _join_streams(side)
            return _chunk(sp, st, t, gk, dirn)
        chains = []
        for i, shard in enumerate(st):
            states, outs = [shard], []
            for _s in range(gk):
                outs.append(copy_base(kern, states[-1], layout.devices[i]))
                states.append(_rotated(kern.program, kern.spec, states[-1],
                                       outs[-1]))
            chains.append((states, outs))
        split = [split_boxes(sp, core, gk, s_) for s_ in range(gk)]
        for s_ in range(gk):
            for i, (states, outs) in enumerate(chains):
                shard_step(kern, states[s_], t + s_ * dirn, split[s_][0],
                           layout.offsets[i], outs=outs[s_])
        _join_streams(side)
        for s_ in range(gk):
            for i, (states, outs) in enumerate(chains):
                for box in split[s_][1]:
                    shard_step(kern, states[s_], t + s_ * dirn, box,
                               layout.offsets[i], outs=outs[s_])
        return [states[gk] for states, _o in chains]

    with ctx._run_timer:
        shards = _resident_shards(ctx, layout)
        _exchange_all(sp, shards, K, plan)
        t = start
        for gi in range(ngroups):
            gk = K if gi < groups else rem
            if gi == 0:
                shards = _chunk(sp, shards, t, gk, dirn)
            elif ov:
                shards = ov_group(shards, t, gk)
            else:
                exchange_newest(sp, shards, K, plan)
                shards = _chunk(sp, shards, t, gk, dirn)
            t += gk * dirn
        _sync(layout)
    ctx._run.resident = (layout, shards)
    if tiling.get("skew"):
        # K5's stream arm: the segment length of each box a group walks,
        # on the card's resident blocks once a launch has asked them
        boxes = []
        for gk in sorted({K, rem} - {0}):
            for s_ in range(gk):
                boxes.append(_full_box(sp, gk, s_))
                if ov and gk > 1:
                    cbox, shells = split_boxes(sp, core, gk, s_)
                    boxes += [cbox] + shells
        (tiling.get("stages_stream") or tiling["stream"])[
            "box_segments"] = [sp.kernel.region_segment(b) for b in boxes]
