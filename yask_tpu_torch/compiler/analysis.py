"""Equation analysis: validity, dependencies, parts, stages, halos.

TPU-native counterpart of the reference's analysis pipeline
(``src/compiler/lib/Eqs.cpp``):

* ``analyze_eqs`` (:364): LHS form validation (step ``t±1`` on non-scratch
  vars, plain domain indices, constant misc indices), step-direction
  consistency, and eq↔eq dependency discovery with cycle detection;
* ``make_parts`` (:1170): grouping equations into *parts* — same
  domain/step conditions, no unresolved intra-part deps;
* ``make_stages`` (:1523): grouping parts into sequential *stages* (halo
  exchange happens between stages in the runtime);
* ``calc_halos`` (:1614): per-var halo growth from read offsets, including
  write-halo propagation through scratch-var chains
  (``find_scratch_write_halos``, ``setup.cpp:1044``);
* ``calc_lifespans`` (:1912): #step slots each var needs.

The result object is consumed by ``yask_tpu_torch.compiler.lowering`` and by the
kernel runtime for allocation geometry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.compiler.expr import (
    CounterVisitor,
    EqualsExpr,
    IndexType,
    PointVisitor,
    VarPoint,
)
from yask_tpu_torch.compiler.var import Var


class Part:
    """A group of equations with identical conditions and no internal
    dependencies (reference 'part'/'bundle')."""

    def __init__(self, name: str, cond, step_cond, is_scratch: bool):
        self.name = name
        self.eqs: List[EqualsExpr] = []
        self.cond = cond                # BoolExpr | None (domain condition)
        self.step_cond = step_cond      # BoolExpr | None
        self.is_scratch = is_scratch    # all eqs write scratch vars
        self.deps: Set["Part"] = set()  # parts that must run before this one
        self.stage_index: int = -1

    def lhs_vars(self) -> List[Var]:
        out = []
        for eq in self.eqs:
            v = eq.lhs.get_var()
            if v not in out:
                out.append(v)
        return out

    def __repr__(self):
        return f"<Part {self.name}: {len(self.eqs)} eq(s)>"


class Stage:
    """A sequence point: all parts in a stage can be evaluated with halos
    exchanged once before it (reference 'stage', ``Eqs.cpp:1523``)."""

    def __init__(self, index: int):
        self.index = index
        self.parts: List[Part] = []

    def __repr__(self):
        return f"<Stage {self.index}: {[p.name for p in self.parts]}>"


def _cond_key(cond) -> tuple:
    return cond.skey() if cond is not None else ()


def missing_dim_race(eq: EqualsExpr, domain_dims: Sequence[str]) -> Set[str]:
    """The dims along which ``eq``'s RHS/conditions VARY while its LHS
    var lacks them — each such dim is an intra-step race: every point of
    the missing extent would demand a different value for the single
    stored slab.  Returns the racy dim set (empty = fine).

    THE single definition of the missing-dim race rule:
    ``_validate_and_scan`` raises on it during analysis, and the static
    checker of ``yask_tpu`` (``yask_tpu/checker/races.py``) reports it as
    a non-raising diagnostic over un-analyzed solutions."""
    var = eq.lhs.get_var()
    lhs_dd = set(var.domain_dim_names())
    missing = [d for d in domain_dims if d not in lhs_dd]
    if not missing:
        return set()
    from yask_tpu_torch.compiler.expr import used_domain_dims
    return used_domain_dims(eq.rhs, eq.cond, eq.step_cond) & set(missing)


class SolutionAnalysis:
    """Full analysis result for one solution (the pipeline of
    ``Solution::analyze_solution``, ``Solution.cpp:127-160``)."""

    def __init__(self, soln):
        self.soln = soln
        eqs: List[EqualsExpr] = soln.get_equations()
        # Zero equations is legal (reference test_empty/test_empty_2d,
        # ``TestStencils.cpp:999-1035``): the solution prepares and steps
        # as a no-op, so every pass below just sees empty collections.
        self.eqs = eqs
        self.step_dim: Optional[str] = soln.step_dim_name()
        self.domain_dims: List[str] = soln.domain_dim_names()
        self.step_dir: int = 0

        self._validate_and_scan()
        self._find_deps()
        self._make_parts()
        self._make_stages()
        self._calc_scratch_halos()
        self._count()

    # ------------------------------------------------------------------
    # validation & var stats (analyze_eqs LHS rules, Eqs.cpp:364-470)
    # ------------------------------------------------------------------

    def _validate_and_scan(self) -> None:
        soln = self.soln
        for eq in self.eqs:
            lhs = eq.lhs
            var = lhs.get_var()
            var.is_written = True
            # LHS domain indices must be plain (offset 0).
            for d, ofs in lhs.domain_offsets().items():
                if ofs != 0:
                    raise YaskException(
                        f"LHS of '{eq.format_simple()}' uses domain offset "
                        f"{d}{ofs:+d}; LHS domain indices must be plain "
                        "(reference rule, Eqs.cpp:364)")
            # LHS step index must be ±1 and consistent across equations.
            if not var.is_scratch():
                so = lhs.step_offset()
                if so is None:
                    raise YaskException(
                        f"non-scratch var '{var.get_name()}' written without "
                        "a step index")
                if so not in (1, -1):
                    raise YaskException(
                        f"LHS step offset must be +1 or -1, got {so} in "
                        f"'{eq.format_simple()}'")
                if self.step_dir == 0:
                    self.step_dir = so
                elif self.step_dir != so:
                    raise YaskException(
                        "all equations must step in the same direction "
                        f"(got both {self.step_dir:+d} and {so:+d})")
                var.step_offsets_used.append(so)
            # LHS misc indices: record.
            for d, val in lhs.misc_vals().items():
                var.update_misc_range(d, val)

            # A write to a var lacking some solution domain dims must
            # not read anything that varies along those dims — an
            # intra-step race.  (The reference cannot even express
            # this: its loop nest is the LHS var's dims,
            # Eqs.cpp:364-470.)  All lowering backends then agree on
            # collapsing the constant extent.  missing_dim_race is the
            # single definition, shared with the static checker.
            varying = missing_dim_race(eq, self.domain_dims)
            if varying:
                raise YaskException(
                    f"'{eq.format_simple()}' writes var "
                    f"'{var.get_name()}' (no dim "
                    f"{sorted(varying)}) but its RHS/condition "
                    f"varies along {sorted(varying)} — an "
                    "intra-step race")

            # Scan RHS (and conditions) reads: halos, misc ranges, steps.
            pv = PointVisitor()
            eq.rhs.accept(pv)
            if eq.cond is not None:
                eq.cond.accept(pv)
            if eq.step_cond is not None:
                eq.step_cond.accept(pv)
            for p in pv.points:
                rvar = p.get_var()
                rvar.is_read = True
                spatial = 0
                for d, ofs in p.domain_offsets().items():
                    rvar.update_halo(d, ofs)
                    spatial = max(spatial, abs(ofs))
                for d, val in p.misc_vals().items():
                    rvar.update_misc_range(d, val)
                so = p.step_offset()
                if so is not None:
                    rvar.step_offsets_used.append(so)
                    # Max spatial reach per step offset — drives the
                    # write-back ring-slot optimization (the reference
                    # reduces step allocation when the extreme step offset
                    # carries no halo, Var.cpp write-back analysis).
                    rvar.step_read_halo[so] = max(
                        rvar.step_read_halo.get(so, 0), spatial)
        if self.step_dir == 0:
            self.step_dir = 1

    # ------------------------------------------------------------------
    # dependency graph (find_all_deps, Eqs.hpp:252)
    # ------------------------------------------------------------------

    def _reads_of(self, eq: EqualsExpr) -> List[VarPoint]:
        pv = PointVisitor()
        eq.rhs.accept(pv)
        if eq.cond is not None:
            eq.cond.accept(pv)
        if eq.step_cond is not None:
            eq.step_cond.accept(pv)
        return pv.points

    def _find_deps(self) -> None:
        """eq j depends on eq i when j reads a value i writes *within the
        same step evaluation*: a non-scratch var at the written step offset,
        or any scratch var (scratch values live only within a step)."""
        eqs = self.eqs
        # writers: var name -> list of eq indices writing it this step
        writers: Dict[str, List[int]] = {}
        for i, eq in enumerate(eqs):
            writers.setdefault(eq.lhs.var_name(), []).append(i)

        n = len(eqs)
        self.eq_deps: List[Set[int]] = [set() for _ in range(n)]
        for j, eq in enumerate(eqs):
            for p in self._reads_of(eq):
                vname = p.var_name()
                if vname not in writers:
                    continue
                rvar = p.get_var()
                if rvar.is_scratch():
                    for i in writers[vname]:
                        if i != j:
                            self.eq_deps[j].add(i)
                else:
                    so = p.step_offset()
                    if so is not None and so == self.step_dir:
                        # Reading the value being computed this step.
                        for i in writers[vname]:
                            if i != j:
                                self.eq_deps[j].add(i)
                        if j in writers[vname] and len(writers[vname]) == 1 \
                                and self.soln.is_dependency_checker_enabled():
                            raise YaskException(
                                f"equation '{eq.format_simple()}' reads the "
                                "point it is writing in the same step "
                                "(intra-step race; reference rejects this, "
                                "Eqs.cpp:364-470)")

        # Write-after-write: multiple eqs writing the same var this step
        # (e.g. a bulk update plus IF_DOMAIN boundary overrides) execute in
        # registration order — later writers depend on earlier ones, giving
        # deterministic last-write-wins semantics.
        for vname, ws in writers.items():
            for a, b in zip(ws, ws[1:]):
                self.eq_deps[b].add(a)

        # User-declared edges (yc_solution::add_flow_dependency,
        # yask_compiler_api.hpp:657): 'from' DEPENDS ON 'to' — i.e.
        # 'to' evaluates first; the primary channel when the automatic
        # checker is disabled.
        for f_eq, t_eq in getattr(self.soln, "_manual_deps", ()):
            fi = ti = None
            for i, eq in enumerate(eqs):
                if eq.same(f_eq):
                    fi = i
                if eq.same(t_eq):
                    ti = i
            if fi is None or ti is None:
                raise YaskException(
                    "add_flow_dependency references an equation not in "
                    "this solution")
            self.eq_deps[fi].add(ti)

        # Cycle detection via DFS (reference DFS path visitors, Eqs.hpp).
        color = [0] * n  # 0=white 1=grey 2=black
        order: List[int] = []

        def dfs(u: int, stack: List[int]):
            color[u] = 1
            stack.append(u)
            for v in self.eq_deps[u]:
                if color[v] == 1:
                    cyc = " -> ".join(
                        eqs[k].lhs.format_simple()
                        for k in stack[stack.index(v):] + [v])
                    raise YaskException(
                        f"circular dependency among equations: {cyc}")
                if color[v] == 0:
                    dfs(v, stack)
            stack.pop()
            color[u] = 2
            order.append(u)

        for u in range(n):
            if color[u] == 0:
                dfs(u, [])
        self.eq_topo_order = order  # deps before dependents

    # ------------------------------------------------------------------
    # parts (make_parts, Eqs.cpp:1170)
    # ------------------------------------------------------------------

    def _make_parts(self) -> None:
        eqs = self.eqs
        parts: List[Part] = []
        eq_part: Dict[int, Part] = {}

        for idx in self.eq_topo_order:
            eq = eqs[idx]
            var = eq.lhs.get_var()
            ckey = (_cond_key(eq.cond), _cond_key(eq.step_cond),
                    var.is_scratch())
            # Earliest part this eq may join: after every part containing a
            # dependency.
            min_pos = -1
            for dep in self.eq_deps[idx]:
                dp = eq_part[dep]
                min_pos = max(min_pos, parts.index(dp))
            placed = None
            for pos in range(min_pos + 1, len(parts)):
                p = parts[pos]
                if (_cond_key(p.cond), _cond_key(p.step_cond),
                        p.is_scratch) == ckey:
                    placed = p
                    break
            if placed is None:
                placed = Part(f"part_{len(parts)}", eq.cond, eq.step_cond,
                              var.is_scratch())
                parts.append(placed)
            placed.eqs.append(eq)
            eq_part[idx] = placed

        # Part-level deps.
        for idx in range(len(eqs)):
            p = eq_part[idx]
            for dep in self.eq_deps[idx]:
                dp = eq_part[dep]
                if dp is not p:
                    p.deps.add(dp)

        self.parts = parts
        self._eq_part = eq_part

    # ------------------------------------------------------------------
    # stages (make_stages, Eqs.cpp:1523)
    # ------------------------------------------------------------------

    def _make_stages(self) -> None:
        """Assign each part a stage level = 1 + max(level of deps); scratch
        parts are pulled into the stage of their first consumer so each
        stage is self-contained (scratch chains run inside the consumer's
        stage, as in the reference's micro-block scratch evaluation,
        ``stencil_calc.cpp:40-289``)."""
        level: Dict[Part, int] = {}

        def get_level(p: Part, seen: Tuple[Part, ...] = ()) -> int:
            if p in level:
                return level[p]
            if p in seen:
                raise YaskException("circular dependency among parts")
            lv = 0
            for d in p.deps:
                lv = max(lv, get_level(d, seen + (p,)) + 1)
            level[p] = lv
            return lv

        for p in self.parts:
            get_level(p)

        # Pull scratch parts up to the min level of their consumers.
        consumers: Dict[Part, List[Part]] = {p: [] for p in self.parts}
        for p in self.parts:
            for d in p.deps:
                consumers[d].append(p)
        changed = True
        while changed:
            changed = False
            for p in self.parts:
                if p.is_scratch and consumers[p]:
                    tgt = min(level[c] for c in consumers[p])
                    if level[p] != tgt and level[p] < tgt:
                        level[p] = tgt
                        changed = True

        # Scratch levels may now exceed their consumers'; clamp: scratch part
        # runs in the stage of its earliest consumer.
        for p in self.parts:
            if p.is_scratch and consumers[p]:
                level[p] = min(level[c] for c in consumers[p])

        nlevels = max(level.values()) + 1 if level else 1
        stages = [Stage(i) for i in range(nlevels)]
        # Keep topological part order within a stage: scratch producers
        # first, then in part-creation order.
        for p in self.parts:
            p.stage_index = level[p]
        for p in sorted(self.parts,
                        key=lambda q: (level[q], not q.is_scratch,
                                       self.parts.index(q))):
            stages[level[p]].parts.append(p)
        self.stages = [s for s in stages if s.parts]
        for i, s in enumerate(self.stages):
            s.index = i
            for p in s.parts:
                p.stage_index = i

    # ------------------------------------------------------------------
    # scratch write-halo propagation (find_scratch_write_halos,
    # setup.cpp:1044; calc_halos, Eqs.cpp:1614)
    # ------------------------------------------------------------------

    def _calc_scratch_halos(self) -> None:
        """Scratch vars are evaluated over the consumer's domain *expanded*
        by the consumer's read offsets into them (write-halo); the vars the
        scratch eq reads then need their halos grown by that expansion.
        Iterate to fixpoint to handle scratch→scratch chains."""
        # write_halo[var_name][dim] = (left, right) area beyond the domain
        # over which the scratch var must be computed.
        self.scratch_write_halo: Dict[str, Dict[str, Tuple[int, int]]] = {}
        scratch_vars = [v for v in self.soln.get_vars() if v.is_scratch()]
        for v in scratch_vars:
            self.scratch_write_halo[v.get_name()] = {
                d: (0, 0) for d in v.domain_dim_names()}

        for _ in range(len(scratch_vars) + 2):
            changed = False
            # 1) write-halo of scratch var s = union over all reads of s of
            #    (reader offset extent + write-halo of reader's LHS if the
            #    reader itself writes a scratch var).
            for eq in self.eqs:
                lhs_var = eq.lhs.get_var()
                lhs_wh = self.scratch_write_halo.get(lhs_var.get_name())
                for p in self._reads_of(eq):
                    rv = p.get_var()
                    if not rv.is_scratch():
                        continue
                    wh = self.scratch_write_halo[rv.get_name()]
                    for d, ofs in p.domain_offsets().items():
                        if d not in wh:
                            continue
                        l, r = wh[d]
                        base_l = base_r = 0
                        if lhs_wh is not None and d in lhs_wh:
                            base_l, base_r = lhs_wh[d]
                        nl = max(l, base_l + max(0, -ofs))
                        nr = max(r, base_r + max(0, ofs))
                        if (nl, nr) != (l, r):
                            wh[d] = (nl, nr)
                            changed = True
            if not changed:
                break

        # 2) grow halos of vars read by scratch-writing eqs: the scratch is
        #    computed over domain+write_halo, so its inputs are read at
        #    write_halo + read offset.
        for eq in self.eqs:
            lhs_var = eq.lhs.get_var()
            if not lhs_var.is_scratch():
                continue
            wh = self.scratch_write_halo[lhs_var.get_name()]
            for p in self._reads_of(eq):
                rv = p.get_var()
                for d, ofs in p.domain_offsets().items():
                    if d not in wh:
                        continue
                    wl, wr = wh[d]
                    if d in rv.halo:
                        rv.update_halo(d, -(wl + max(0, -ofs)))
                        rv.update_halo(d, wr + max(0, ofs))

    # ------------------------------------------------------------------
    # counters (CounterVisitor, ExprUtils.hpp)
    # ------------------------------------------------------------------

    def _count(self) -> None:
        # sin/cos pairing (reference PairingVisitor, ExprUtils.hpp:137):
        # sin(x) and cos(x) on structurally identical arguments are one
        # paired evaluation — both lowering backends materialize the
        # partner under its own CSE key in the same visit, and the op
        # model charges the pair one transcendental (TTI's ti0–ti3 trig
        # chains are the motivating case).
        from yask_tpu_torch.compiler.expr import ExprVisitor, FuncExpr

        sin_args, cos_args = set(), set()

        class _Trig(ExprVisitor):
            def visit_func(self, node: FuncExpr):
                if node.name == "sin":
                    sin_args.add(node.args[0].skey())
                elif node.name == "cos":
                    cos_args.add(node.args[0].skey())
                for a in node.args:
                    a.accept(self)

        tv = _Trig()
        for eq in self.eqs:
            eq.accept(tv)
        self.sincos_args = sin_args & cos_args

        c = CounterVisitor(sincos_args=self.sincos_args)
        for eq in self.eqs:
            eq.accept(c)
        self.counters = c

    # ------------------------------------------------------------------

    def stage_read_widths_split(self) -> List[Dict[str, Dict]]:
        """Per stage, ghost widths split by which BUFFER the read hits:
        ``"computed"`` — reads at the written step offset (this step's
        output, an earlier stage's `computed` array); ``"ring"`` — every
        other read (previous-step ring slots, read-only vars). The
        distributed refresh must exchange BOTH when a stage does both —
        a later stage can read an already-computed var's previous-step
        ring values with ghost offsets, and refreshing only the computed
        array leaves the ring slot (which the rotation carries into the
        next step) with stale shard ghosts."""
        out: List[Dict[str, Dict]] = []
        for stage in self.stages:
            kinds = {"ring": {}, "computed": {}}
            for part in stage.parts:
                for eq in part.eqs:
                    lhs_wh = self.scratch_write_halo.get(
                        eq.lhs.var_name(), {})
                    for p in self._reads_of(eq):
                        v = p.get_var()
                        if v.is_scratch():
                            continue
                        so = p.step_offset()
                        kind = "computed" if (so is not None
                                              and so == self.step_dir
                                              and v.is_written) else "ring"
                        entry = kinds[kind].setdefault(v.get_name(), {})
                        for d, ofs in p.domain_offsets().items():
                            wl, wr = lhs_wh.get(d, (0, 0))
                            l, r = entry.get(d, (0, 0))
                            entry[d] = (max(l, wl - min(ofs, 0)),
                                        max(r, wr + max(ofs, 0)))
            for kind in kinds:
                kinds[kind] = {
                    k: {d: lr for d, lr in vv.items() if lr != (0, 0)}
                    for k, vv in kinds[kind].items()}
                kinds[kind] = {k: vv for k, vv in kinds[kind].items()
                               if vv}
            out.append(kinds)
        return out

    def stage_read_widths(self) -> List[Dict[str, Dict[str, Tuple[int, int]]]]:
        """Per stage: vars (non-scratch) read with nonzero domain offsets
        and the (left, right) ghost widths needed — the UNION over both
        read kinds of :meth:`stage_read_widths_split`. Drives the Pallas
        per-stage margin accounting and the overlap split's core shrink;
        the exchange planner uses the split form."""
        out: List[Dict[str, Dict[str, Tuple[int, int]]]] = []
        for kinds in self.stage_read_widths_split():
            reads: Dict[str, Dict[str, Tuple[int, int]]] = {}
            for kind in ("ring", "computed"):
                for vname, widths in kinds[kind].items():
                    entry = reads.setdefault(vname, {})
                    for d, (l, r) in widths.items():
                        cl, cr = entry.get(d, (0, 0))
                        entry[d] = (max(cl, l), max(cr, r))
            out.append(reads)
        return out

    def read_var_names(self) -> Set[str]:
        """Names of every non-scratch var READ by any equation, at ANY
        offset — including pure same-point (zero-domain-offset) reads,
        which :meth:`stage_read_widths` deliberately omits (they need no
        ghost margin).  The Pallas skew carry must consult THIS set: a
        written var consumed only at the same point (awp's anelastic
        memory vars — ``r(t+1) = q·(r(t)+el)`` read back by the stress
        stage) still crosses sub-steps, so its slid-region left strips
        ride the inter-tile carry exactly like offset reads do."""
        out: Set[str] = set()
        for eq in self.eqs:
            for p in self._reads_of(eq):
                v = p.get_var()
                if not v.is_scratch():
                    out.add(v.get_name())
        return out

    def fused_step_radius(self) -> Dict[str, int]:
        """Per domain dim, the (symmetric) margin ONE full step consumes
        when fused in-tile: the sum over stages of each stage's max ghost
        width (same-step chains eat margin stage by stage). Both the
        Pallas kernel's shrink accounting and the runtime's pad planning
        use exactly this number."""
        out = {d: 0 for d in self.domain_dims}
        for reads in self.stage_read_widths():
            sm = {d: 0 for d in self.domain_dims}
            for vv in reads.values():
                for d, (l, r) in vv.items():
                    sm[d] = max(sm[d], l, r)
            out = {d: out[d] + sm[d] for d in self.domain_dims}
        return out

    def max_halos(self) -> Dict[str, Tuple[int, int]]:
        """Per-domain-dim max (left, right) halo over all non-scratch vars —
        what the runtime uses for pad geometry and ghost-exchange width."""
        out: Dict[str, Tuple[int, int]] = {d: (0, 0) for d in self.domain_dims}
        for v in self.soln.get_vars():
            extra: Dict[str, Tuple[int, int]] = {}
            if v.is_scratch():
                extra = self.scratch_write_halo.get(v.get_name(), {})
            for d, (l, r) in v.halo.items():
                el, er = extra.get(d, (0, 0))
                L, R = out.get(d, (0, 0))
                out[d] = (max(L, l + el), max(R, r + er))
        return out

    def summary(self) -> str:
        return (f"{len(self.eqs)} eq(s) in {len(self.parts)} part(s) over "
                f"{len(self.stages)} stage(s); step dir {self.step_dir:+d}")
