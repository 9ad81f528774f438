"""Cross-solution pipeline fusion: producer→consumer solution DAGs.

The port's counterpart of ``yask_tpu/ops/pipeline.py``: the same
bindings, structural checks and decline codes, the same node-for-node
merge, the same host-chained oracle.  Where it differs: the fused arm's
plan is the CUDA emitter's own (``plan["fused_kernel"]``: the emitted
spec's tile, shared-memory bytes and pushed vars) instead of the TPU
checker's VMEM plan, and a merged chain whose tiles do not fit a block's
shared memory declines as ``pipeline-smem-overflow``.  With ``-mode
fused`` the merged program runs K6 (``ops/fused_stencil.py``), one launch
per step for every stage.

Real applications chain several solutions per time step (RTM: forward
wavefield → imaging condition → smoothing filter).  Run naively, every
stage round-trips its full state through device memory or the host and
the next stage re-fetches it — N× the interior traffic of the fused
equivalent.  The fused kernel already fuses *intra*-solution
multi-stage chains in-tile: a read at step offset ``step_dir`` on a
written var is a "computed read", the analysis places the consumer
equation into a later stage, and K6 computes producer tiles over the
block expanded by the consumer's read widths.  This module generalizes
that to *whole solutions*:

* :class:`SolutionPipeline` — an ordered DAG of solutions plus
  declared producer→consumer var **bindings** (consumer's step-free
  read-only input var ← producer's freshly written field);
* **fusion by source-level merge** — eligible chains are rewritten
  into ONE merged ``yc_solution`` (vars renamed ``stage__var``, bound
  input vars eliminated, every read of one becoming a computed read of
  the producer at ``+step_dir``), so the existing machinery — analysis
  staging, the emitter's multi-stage tiles — applies unchanged;
* :func:`pipeline_plan` — the plan-only decision record (structured
  ``reasons`` for every fuse/decline);
* **auto-fallback** — ineligible or infeasible chains run the unfused
  host-chained schedule (per step, per stage: push bindings, run one
  step), which is also the bit-equality oracle for the fused arm.

Device-facing work routes through ``guarded_call`` at the
``pipeline.run`` fault site.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.compiler import expr as E
from yask_tpu_torch.compiler.expr import IndexType, VarPoint
from yask_tpu_torch.compiler.solution import yc_factory, yc_solution
from yask_tpu_torch.resilience.guard import guarded_call

__all__ = ["PipelineBinding", "SolutionPipeline", "pipeline_plan",
           "merge_solutions", "pipeline_hbm_model", "rtm_chain",
           "SEP", "PIPELINE_SCHEMA"]

#: stage/var separator in merged-var names; stage names must not
#: contain it (``fwd__pressure`` ← stage ``fwd``, var ``pressure``).
SEP = "__"

PIPELINE_SCHEMA = "yask_tpu_torch.pipeline/1"


class PipelineBinding:
    """One producer→consumer edge: the consumer stage's step-free
    read-only var ``consumer_var`` is fed each step by the producer
    stage's freshly written ``producer_var`` (its ``+step_dir``
    value)."""

    __slots__ = ("consumer_stage", "consumer_var",
                 "producer_stage", "producer_var")

    def __init__(self, consumer_stage: str, consumer_var: str,
                 producer_stage: str, producer_var: str):
        self.consumer_stage = consumer_stage
        self.consumer_var = consumer_var
        self.producer_stage = producer_stage
        self.producer_var = producer_var

    def as_tuple(self) -> Tuple[str, str, str, str]:
        return (self.consumer_stage, self.consumer_var,
                self.producer_stage, self.producer_var)

    def __repr__(self):
        return (f"{self.producer_stage}.{self.producer_var} -> "
                f"{self.consumer_stage}.{self.consumer_var}")


def _norm_bindings(bindings) -> List[PipelineBinding]:
    out = []
    for b in bindings or ():
        if isinstance(b, PipelineBinding):
            out.append(b)
        elif isinstance(b, dict):
            out.append(PipelineBinding(
                b["consumer_stage"], b["consumer_var"],
                b["producer_stage"], b["producer_var"]))
        else:
            out.append(PipelineBinding(*b))
    return out


def _soln_of(source) -> yc_solution:
    """Accept a yc_solution or a yc_solution_base (define() run)."""
    if isinstance(source, yc_solution):
        return source
    if hasattr(source, "run_define") and hasattr(source, "get_soln"):
        source.run_define()
        return source.get_soln()
    raise YaskException(
        f"pipeline stage needs a yc_solution or yc_solution_base, "
        f"got {type(source).__name__}")


def _written_names(soln: yc_solution) -> set:
    return {eq.lhs.var.get_name() for eq in soln.get_equations()}


def _read_points(soln: yc_solution) -> List[VarPoint]:
    pv = E.PointVisitor()
    for eq in soln.get_equations():
        eq.rhs.accept(pv)
        if eq.cond is not None:
            eq.cond.accept(pv)
        if eq.step_cond is not None:
            eq.step_cond.accept(pv)
    return pv.points


# ---------------------------------------------------------------------------
# structural eligibility
# ---------------------------------------------------------------------------


def _check_structure(stage_names, solns, bindings) -> List[Dict]:
    """All failed structural checks as reason dicts (``ok: False``);
    empty list = structurally fusable.  Collects EVERYTHING rather than
    short-circuiting — a decline must name every blocker at once."""
    bad: List[Dict] = []

    def no(code, msg, **kw):
        d = {"code": code, "ok": False, "msg": msg}
        d.update(kw)
        bad.append(d)

    if len(stage_names) < 2:
        no("stage-count", f"need >=2 stages, got {len(stage_names)}")
    seen = set()
    for s in stage_names:
        if not s.isidentifier() or SEP in s:
            no("stage-name", f"stage name {s!r} must be an identifier "
               f"without {SEP!r}", stage=s)
        if s in seen:
            no("stage-name", f"duplicate stage name {s!r}", stage=s)
        seen.add(s)

    anas = {}
    for s in stage_names:
        try:
            anas[s] = solns[s].analyze()
        except YaskException as e:
            no("stage-analyze", f"stage {s!r} fails analysis: {e}",
               stage=s)
    if bad:
        return bad

    # shared dims, step dim, direction
    s0 = stage_names[0]
    dd0 = list(anas[s0].domain_dims)
    sd0 = anas[s0].step_dim
    dir0 = anas[s0].step_dir
    for s in stage_names[1:]:
        a = anas[s]
        if list(a.domain_dims) != dd0:
            no("dims-mismatch",
               f"stage {s!r} domain dims {list(a.domain_dims)} != "
               f"stage {s0!r} dims {dd0}", stage=s)
        if a.step_dim != sd0:
            no("dims-mismatch",
               f"stage {s!r} step dim {a.step_dim!r} != {sd0!r}",
               stage=s)
        if a.step_dir != dir0:
            no("step-dir-mismatch",
               f"stage {s!r} steps {a.step_dir:+d}, stage {s0!r} "
               f"steps {dir0:+d}", stage=s)

    # index-name/type conflicts across stages (x as domain in one
    # stage, misc in another, cannot share one merged index)
    itypes: Dict[str, IndexType] = {}
    for s in stage_names:
        for v in solns[s].get_vars():
            for d in v.get_dims():
                t = itypes.setdefault(d.name, d.type)
                if t != d.type:
                    no("index-type-conflict",
                       f"index {d.name!r} is {t.value} in one stage, "
                       f"{d.type.value} in stage {s!r}", stage=s,
                       dim=d.name)

    # bindings
    order = {s: i for i, s in enumerate(stage_names)}
    targets = set()
    for b in bindings:
        loc = repr(b)
        if b.consumer_stage not in order or b.producer_stage not in order:
            no("binding-unknown-stage", f"binding {loc}: unknown stage")
            continue
        csol, psol = solns[b.consumer_stage], solns[b.producer_stage]
        try:
            cv = csol.get_var(b.consumer_var)
        except YaskException:
            no("binding-unknown-var",
               f"binding {loc}: consumer stage has no var "
               f"{b.consumer_var!r}")
            continue
        try:
            pv = psol.get_var(b.producer_var)
        except YaskException:
            no("binding-unknown-var",
               f"binding {loc}: producer stage has no var "
               f"{b.producer_var!r}")
            continue
        if order[b.producer_stage] >= order[b.consumer_stage]:
            no("binding-order",
               f"binding {loc}: producer stage must come before the "
               f"consumer in the stage list (DAG is acyclic by "
               f"construction)")
        key = (b.consumer_stage, b.consumer_var)
        if key in targets:
            no("binding-duplicate",
               f"binding {loc}: {b.consumer_var!r} already bound")
        targets.add(key)
        if pv.get_name() not in _written_names(psol) or pv.is_scratch():
            no("binding-producer",
               f"binding {loc}: producer var must be a written "
               f"non-scratch var")
        if pv.step_dim() is None:
            no("binding-producer",
               f"binding {loc}: producer var needs a step dim (its "
               f"fresh +step value is what the consumer reads)")
        if pv.misc_dim_names():
            no("binding-producer",
               f"binding {loc}: producer var must have no misc dims")
        if cv.get_name() in _written_names(csol):
            no("binding-consumer",
               f"binding {loc}: consumer input var must be read-only")
        if cv.step_dim() is not None or cv.misc_dim_names():
            no("binding-consumer",
               f"binding {loc}: consumer input var must be step-free "
               f"with no misc dims (a pure per-step input slot)")
        if cv.domain_dim_names() != pv.domain_dim_names() \
                or cv.domain_dim_names() != dd0:
            no("binding-consumer",
               f"binding {loc}: consumer/producer domain dims must "
               f"both equal the solution dims {dd0}")
    return bad


def _binding_pushable(solns, stage_order, b) -> bool:
    """Whether the host-chained arm can physically push this binding
    (stages and vars exist, the producer is a written step var that
    runs EARLIER in the step — its fresh value must exist when
    pushed).  A superset of full structural eligibility: a chain that
    declines for other reasons still pushes its well-formed
    bindings."""
    if b.consumer_stage not in stage_order \
            or b.producer_stage not in stage_order:
        return False
    if stage_order[b.producer_stage] >= stage_order[b.consumer_stage]:
        return False
    try:
        cv = solns[b.consumer_stage].get_var(b.consumer_var)
        pv = solns[b.producer_stage].get_var(b.producer_var)
    except YaskException:
        return False
    return (pv.get_name() in _written_names(solns[b.producer_stage])
            and pv.step_dim() is not None
            and cv.step_dim() is None)


# ---------------------------------------------------------------------------
# source-level merge
# ---------------------------------------------------------------------------


def merge_solutions(name: str, stages: Sequence[Tuple[str, yc_solution]],
                    bindings: Sequence[PipelineBinding],
                    step_dir: int) -> yc_solution:
    """Build ONE merged ``yc_solution`` from structurally eligible
    stages: vars renamed ``stage__var``, bound consumer inputs
    eliminated — every read of one is rewritten onto the producer's
    merged var at step offset ``+step_dir`` (the computed-read form the
    analysis already stages and K6 fuses in-tile over expanded
    regions)."""
    merged = yc_factory().new_solution(name)
    solns = dict(stages)
    order = [s for s, _ in stages]

    # shared indices (by name; types verified by _check_structure)
    idx: Dict[str, E.IndexExpr] = {}

    def index_for(d) -> E.IndexExpr:
        if d.name not in idx:
            if d.type == IndexType.STEP:
                idx[d.name] = merged.new_step_index(d.name)
            elif d.type == IndexType.DOMAIN:
                idx[d.name] = merged.new_domain_index(d.name)
            else:
                idx[d.name] = merged.new_misc_index(d.name)
        return idx[d.name]

    ana0 = solns[order[0]].analyze()
    step_idx = None
    if ana0.step_dim:
        step_idx = index_for(
            E.IndexExpr(ana0.step_dim, IndexType.STEP))
    dom_idx = [index_for(E.IndexExpr(d, IndexType.DOMAIN))
               for d in ana0.domain_dims]
    merged.set_domain_dims(dom_idx)

    bound = {(b.consumer_stage, b.consumer_var): b for b in bindings}

    # vars (declared dim order preserved; bound inputs eliminated)
    vmap: Dict[Tuple[str, str], object] = {}
    for s in order:
        for v in solns[s].get_vars():
            if (s, v.get_name()) in bound:
                continue
            dims = [index_for(d) for d in v.get_dims()]
            mk = (merged.new_scratch_var if v.is_scratch()
                  else merged.new_var)
            vmap[(s, v.get_name())] = mk(f"{s}{SEP}{v.get_name()}", dims)

    def rw_point(s: str, vp: VarPoint):
        key = (s, vp.var.get_name())
        if key in bound:
            b = bound[key]
            mvar = vmap[(b.producer_stage, b.producer_var)]
            shift = step_dir
        else:
            mvar = vmap[key]
            shift = None
        args = []
        for d in mvar.get_dims():
            if d.type == IndexType.STEP:
                off = (shift if shift is not None
                       else vp.offsets[d.name])
                args.append(idx[d.name] if off == 0
                            else idx[d.name] + off)
            elif d.type == IndexType.DOMAIN:
                off = vp.offsets[d.name]
                args.append(idx[d.name] if off == 0
                            else idx[d.name] + off)
            else:
                args.append(vp.offsets[d.name])
        return mvar(*args)

    def rw(s: str, node):
        """Rebuild the expression tree onto merged vars/indices,
        preserving structure exactly (same node types, same arg
        order), so the lowered op sequence — and therefore the
        floating-point result — is bit-identical to the unfused
        stage's."""
        if node is None or isinstance(node, E.ConstExpr):
            return node
        if isinstance(node, VarPoint):
            return rw_point(s, node)
        if isinstance(node, E.IndexExpr):
            return idx[node.name]
        if isinstance(node, E.FirstIndexExpr):
            return E.FirstIndexExpr(idx[node.dim.name])
        if isinstance(node, E.LastIndexExpr):
            return E.LastIndexExpr(idx[node.dim.name])
        if isinstance(node, E.NegExpr):
            return E.NegExpr(rw(s, node.arg))
        if isinstance(node, (E.AddExpr, E.MultExpr)):
            return type(node)([rw(s, a) for a in node.args])
        if isinstance(node, (E.SubExpr, E.DivExpr, E.ModExpr)):
            return type(node)(rw(s, node.lhs), rw(s, node.rhs))
        if isinstance(node, E.FuncExpr):
            return E.FuncExpr(node.name, [rw(s, a) for a in node.args])
        if isinstance(node, E.CompExpr):
            return E.CompExpr(node.op, rw(s, node.lhs), rw(s, node.rhs))
        if isinstance(node, E.AndExpr):
            return E.AndExpr(rw(s, node.lhs), rw(s, node.rhs))
        if isinstance(node, E.OrExpr):
            return E.OrExpr(rw(s, node.lhs), rw(s, node.rhs))
        if isinstance(node, E.NotExpr):
            return E.NotExpr(rw(s, node.arg))
        raise YaskException(
            f"pipeline merge: unhandled expression node "
            f"{type(node).__name__}")

    for s in order:
        for eq in solns[s].get_equations():
            merged.add_eq(rw(s, eq.lhs), rw(s, eq.rhs),
                          cond=rw(s, eq.cond),
                          step_cond=rw(s, eq.step_cond))
    return merged


# ---------------------------------------------------------------------------
# plan (the single fuse/decline decision record)
# ---------------------------------------------------------------------------


def pipeline_plan(pipe: "SolutionPipeline") -> Dict:
    """Plan-only fuse/decline decision for a pipeline: structural
    eligibility, then (for ``-mode fused``) the CUDA emitter over the
    merged program — the same :func:`~yask_tpu_torch.ops.cuda_emit.emit`
    the executor builds from, so the plan's tile, shared-memory bytes and
    pushed vars are the kernel's.  ``prepare`` stores the result on
    ``fused_ctx._pipeline_plan``; ``plan["fused"]`` IS the executor
    decision; every contributing check lands in ``plan["reasons"]``."""
    plan: Dict = {
        "schema": PIPELINE_SCHEMA,
        "sig": pipe.signature(),
        "stages": list(pipe.stage_names),
        "bindings": [b.as_tuple() for b in pipe.bindings],
        "eligible": pipe.structurally_eligible,
        "fused": False,
        "mode": None,
        "reasons": [dict(r) for r in pipe._struct_reasons],
    }
    reasons = plan["reasons"]
    if not pipe.structurally_eligible:
        return plan
    reasons.append({"code": "structure-ok", "ok": True,
                    "msg": f"{len(plan['stages'])} stages, "
                           f"{len(plan['bindings'])} binding(s) merge "
                           f"cleanly"})

    fctx = pipe._ensure_fused_ctx()
    try:
        program = fctx._program if fctx._program is not None \
            else fctx._plan_geometry()
    except YaskException as e:
        reasons.append({"code": "plan-failed", "ok": False,
                        "msg": f"merged geometry planning failed: {e}"})
        return plan
    mode = fctx._mode or fctx._opts.mode
    plan["mode"] = mode

    if mode == "fused":
        from yask_tpu_torch.ops.cuda_emit import SMEM_LIMIT, emit
        try:
            spec = emit(program, fctx._push_arg())
        except YaskException as e:
            reasons.append({"code": "fused-plan-failed", "ok": False,
                            "msg": f"merged chain has no fused "
                                   f"kernel: {e}"})
            return plan
        if spec.workspace:
            # K6 would keep tiles in its device-memory workspace: the
            # chain's intermediates would not stay on chip
            reasons.append(
                {"code": "pipeline-smem-overflow", "ok": False,
                 "msg": f"merged chain's shared-memory tiles do not fit: "
                        f"{spec.workspace['detail']}",
                 "smem_limit": SMEM_LIMIT})
            return plan
        push_vars = list(spec.push_vars)
        plan["fused_kernel"] = {
            "kernel": ("stages_step" if spec.stages > 1
                       else "fused_step"),
            "name": spec.name, "stages": spec.stages,
            "tile": list(spec.tile), "smem_bytes": spec.smem_bytes,
            "smem_limit": SMEM_LIMIT, "push": bool(push_vars),
            "push_vars": push_vars,
            "push_smem_bytes": spec.push_smem_bytes}
        if push_vars:
            reasons.append(
                {"code": "pipeline-push-engaged", "ok": True,
                 "msg": f"push-memory fusion: {push_vars} consumed "
                        f"in shared memory (no device-memory round-trip)",
                 "push_vars": push_vars})
        else:
            why = [r for r in spec.push_reasons
                   if r.get("code") in ("push_ineligible",
                                        "push_disabled")]
            reasons.append(
                {"code": "pipeline-push-ineligible", "ok": True,
                 "msg": "no stage tile pushes: "
                        + ("; ".join(
                            f"{r.get('var', '*')}: {r['detail']}"
                            for r in why) or "planner declined"),
                 "detail": why})

    plan["hbm_model"] = pipeline_hbm_model(
        pipe, push_vars=(plan.get("fused_kernel") or {}).get("push_vars"))
    plan["fused"] = True
    reasons.append({"code": "pipeline-engaged", "ok": True,
                    "msg": f"{len(plan['stages'])}-stage chain fuses "
                           f"into one {mode} program"})
    return plan


def pipeline_hbm_model(pipe: "SolutionPipeline", push_vars=None) -> Dict:
    """Per-point per-step device-memory traffic model, chained vs fused:
    the chained arm streams every stage's read/write var set AND pays the
    binding push (one read + one write per bound var); fusion eliminates
    the bound vars entirely and streams the union once.  Interior traffic
    only (the halo re-reads of the expanded stage regions are not
    counted), the same model as ``yask_tpu``'s.

    ``push_vars`` (merged ``stage__var`` names the emitter pushed, from
    ``plan["fused_kernel"]["push_vars"]``) extends the model with
    ``fused_push_bytes_pp``: a pushed var is consumed in shared memory,
    so its write-back leaves the fused traffic too (its consumer reads
    were already dropped with the bound vars).  Always present — equal
    to ``fused_bytes_pp`` when nothing pushes."""
    eb = 4
    for _s, soln in pipe.stages:
        eb = soln._settings.elem_bytes or eb
        break
    bound = {(b.consumer_stage, b.consumer_var) for b in pipe.bindings}
    chained = 0
    fused = 0
    for s, soln in pipe.stages:
        writes = _written_names(soln)
        reads = {p.var.get_name() for p in _read_points(soln)}
        chained += (len(reads) + len(writes)) * eb
        f_reads = {v for v in reads if (s, v) not in bound}
        fused += (len(f_reads) + len(writes)) * eb
    chained += 2 * eb * len(pipe.bindings)
    n_push = len(push_vars or ())
    fused_push = max(fused - n_push * eb, eb)
    return {"elem_bytes": eb, "chained_bytes_pp": chained,
            "fused_bytes_pp": fused,
            "ratio": (chained / fused) if fused else 0.0,
            "push_vars": sorted(push_vars or ()),
            "fused_push_bytes_pp": fused_push,
            "push_ratio": (chained / fused_push) if fused_push else 0.0}


# ---------------------------------------------------------------------------
# the pipeline object
# ---------------------------------------------------------------------------


class SolutionPipeline:
    """An ordered producer→consumer DAG of solutions with declared var
    bindings, runnable fused (one merged program) or host-chained (the
    unfused oracle), with auto-fallback and a shared plan record.

    >>> stages, bindings = rtm_chain(radius=2)
    >>> pipe = SolutionPipeline(env, stages, bindings)
    >>> pipe.apply_command_line_options("-g 32 -mode fused")
    >>> pipe.prepare()
    >>> pipe.run(0, 3)
    """

    def __init__(self, env, stages, bindings=(), dtype=None,
                 name: Optional[str] = None):
        self._env = env
        self._dtype = dtype
        self.stages: List[Tuple[str, yc_solution]] = [
            (s, _soln_of(src)) for s, src in stages]
        self.stage_names = [s for s, _ in self.stages]
        self._solns = dict(self.stages)
        self.bindings = _norm_bindings(bindings)
        self.name = name or f"pipe_{'_'.join(self.stage_names)}"

        self._struct_reasons = _check_structure(
            self.stage_names, self._solns, self.bindings)
        self.structurally_eligible = not self._struct_reasons
        # the host-chained fallback honors only well-formed bindings
        # (both vars exist, producer is a written step var) — malformed
        # ones are already named in the decline reasons and cannot be
        # pushed at all
        order = {s: i for i, s in enumerate(self.stage_names)}
        self._pushable = [b for b in self.bindings
                          if _binding_pushable(self._solns, order, b)]
        self._merged: Optional[yc_solution] = None
        if self.structurally_eligible:
            dir0 = self._solns[self.stage_names[0]].analyze().step_dir
            self._merged = merge_solutions(
                self.name, self.stages, self.bindings, dir0)

        self._cli: List[str] = []
        self._fused_ctx = None
        self._stage_ctxs: Optional[Dict[str, object]] = None
        self._fused: Optional[bool] = None   # None until prepare()
        self._plan: Optional[Dict] = None
        self._prepared = False

    # -- configuration -------------------------------------------------

    def apply_command_line_options(self, args: str) -> None:
        """Stash shared kernel options (applied to every context this
        pipeline builds — both arms must run the same geometry)."""
        if self._prepared:
            raise YaskException(
                "apply_command_line_options before prepare()")
        self._cli.append(args)

    def signature(self) -> str:
        """Stable short hash over stage names, solution names, and
        bindings — the extra AOT-cache variant dimension
        (``ctx._pipeline_sig``): a fused chain must never collide with
        an unfused solution of identical equations."""
        h = hashlib.sha256()
        for s, soln in self.stages:
            h.update(f"{s}={soln.get_name()};".encode())
        for b in self.bindings:
            h.update(f"{b!r};".encode())
        return h.hexdigest()[:16]

    # -- context construction ------------------------------------------

    def _new_ctx(self, source, pipeline_sig=None):
        from yask_tpu_torch.runtime.context import StencilContext
        ctx = StencilContext(self._env, source, dtype=self._dtype)
        if pipeline_sig is not None:
            ctx._pipeline_sig = pipeline_sig
        for args in self._cli:
            ctx.apply_command_line_options(args)
        return ctx

    def _ensure_fused_ctx(self):
        if self._fused_ctx is None:
            if self._merged is None:
                raise YaskException(
                    f"pipeline {self.name!r} is not structurally "
                    f"fusable: {self.decline_summary()}")
            self._fused_ctx = self._new_ctx(
                self._merged, pipeline_sig=self.signature())
            self._fused_ctx._pipeline = self
        return self._fused_ctx

    def _ensure_stage_ctxs(self) -> Dict[str, object]:
        if self._stage_ctxs is None:
            self._stage_ctxs = {}
            for s, soln in self.stages:
                ctx = self._new_ctx(soln)
                ctx.prepare_solution()
                self._stage_ctxs[s] = ctx
        return self._stage_ctxs

    # -- prepare: the fuse/decline decision ----------------------------

    def prepare(self, fuse: Optional[bool] = None) -> Dict:
        """Decide the executor (fused vs host-chained), prepare the
        winning arm, and return the plan dict.  ``fuse=None`` follows
        the plan (auto-fallback on any decline), ``True`` forces fused
        (raises when impossible), ``False`` forces the host-chained
        oracle."""
        plan = pipeline_plan(self) if self._merged is not None else {
            "schema": PIPELINE_SCHEMA, "sig": self.signature(),
            "stages": list(self.stage_names),
            "bindings": [b.as_tuple() for b in self.bindings],
            "eligible": False, "fused": False, "mode": None,
            "reasons": [dict(r) for r in self._struct_reasons],
        }
        want = plan["fused"] if fuse is None else fuse
        if fuse is True and not plan["fused"]:
            raise YaskException(
                f"pipeline {self.name!r} cannot fuse: "
                f"{self.decline_summary(plan)}")
        if fuse is False and plan["fused"]:
            plan["reasons"].append(
                {"code": "forced-unfused", "ok": True,
                 "msg": "host-chained arm forced by caller"})
            plan["fused"] = False
            want = False

        if want:
            fctx = self._ensure_fused_ctx()
            try:
                fctx.prepare_solution()
            except YaskException as e:
                if fuse is True:
                    raise
                plan["reasons"].append(
                    {"code": "prepare-failed", "ok": False,
                     "msg": f"fused prepare failed, falling back to "
                            f"host-chained: {e}"})
                plan["fused"] = False
                want = False
        if not want:
            self._ensure_stage_ctxs()

        self._fused = bool(want)
        plan["fused"] = self._fused
        self._plan = plan
        if self._fused_ctx is not None:
            self._fused_ctx._pipeline_plan = plan
        self._prepared = True
        return plan

    @property
    def fused(self) -> bool:
        self._check_prepared()
        return bool(self._fused)

    def plan(self) -> Dict:
        self._check_prepared()
        return self._plan

    def decline_summary(self, plan: Optional[Dict] = None) -> str:
        reasons = (plan or self._plan or
                   {"reasons": self._struct_reasons})["reasons"]
        bad = [r for r in reasons if not r.get("ok")]
        return "; ".join(f"[{r['code']}] {r['msg']}" for r in bad) \
            or "no decline recorded"

    def _check_prepared(self) -> None:
        if not self._prepared:
            raise YaskException("call pipeline.prepare() first")

    # -- state access --------------------------------------------------

    def pushed_vars(self) -> set:
        """Merged ``stage__var`` names the emitter pushed for the prepared
        fused arm (empty host-chained, or on any mode without a fused
        kernel plan).  Pushed vars are consumed in shared memory — their
        device rings go STALE after ``run()`` (on the card) and must not
        be read or compared."""
        if not self._prepared or not self._fused or not self._plan:
            return set()
        return set((self._plan.get("fused_kernel") or {})
                   .get("push_vars") or ())

    def get_var(self, stage: str, var: str):
        """The authoritative ``yk_var`` for ``stage.var`` in whichever
        arm is prepared.  Bound consumer inputs do not exist fused
        (they were eliminated); init the producer instead.  Push-fused
        intermediates raise: their rings are stale by design."""
        self._check_prepared()
        if self._fused:
            for b in self.bindings:
                if (b.consumer_stage, b.consumer_var) == (stage, var):
                    raise YaskException(
                        f"{stage}.{var} is a bound input eliminated by "
                        f"fusion; it is fed by "
                        f"{b.producer_stage}.{b.producer_var}")
            mname = f"{stage}{SEP}{var}"
            if mname in self.pushed_vars():
                raise YaskException(
                    f"{stage}.{var} is push-fused: its tiles are "
                    f"consumed in shared memory and never written back, "
                    f"so the ring is stale after run(); read the final "
                    f"stage's outputs, or prepare with push off "
                    f"(-push off)")
            return self._fused_ctx.get_var(mname)
        return self._stage_ctxs[stage].get_var(var)

    @property
    def fused_ctx(self):
        return self._fused_ctx

    def stage_ctx(self, stage: str):
        return self._ensure_stage_ctxs()[stage]

    # -- execution -----------------------------------------------------

    def run(self, first_step_index: int, last_step_index: int) -> None:
        """Run the prepared arm over [first, last].  Fused: one program
        step does all stages (consumers read producers in-tile/at the
        same scan step).  Host-chained: per step, per stage in order —
        push inbound bindings (producer's fresh value, interior only;
        pads stay zero by the ghost-zero invariant), then one step —
        the exact semantics the merged rewrite encodes, making this
        arm the bit-equality oracle."""
        self._check_prepared()
        if self._fused:
            guarded_call(self._fused_ctx.run_solution,
                         first_step_index, last_step_index,
                         site="pipeline.run")
            return
        self._run_chained(first_step_index, last_step_index)

    def _run_chained(self, first_step_index: int,
                     last_step_index: int) -> None:
        """The host-chained schedule, callable regardless of which arm
        is pinned."""
        ctxs = self._ensure_stage_ctxs()
        c0 = ctxs[self.stage_names[0]]
        start, n = c0._step_seq(first_step_index, last_step_index)
        sdir = c0._ana.step_dir
        for i in range(n):
            t = start + i * sdir
            for s in self.stage_names:
                for b in self._pushable:
                    if b.consumer_stage == s:
                        self._push_binding(b, t + sdir)
                guarded_call(ctxs[s].run_solution, t, t,
                             site="pipeline.run")

    def _push_binding(self, b: PipelineBinding, t_new: int) -> None:
        ctxs = self._stage_ctxs
        pctx = ctxs[b.producer_stage]
        pv = pctx.get_var(b.producer_var)
        cv = ctxs[b.consumer_stage].get_var(b.consumer_var)
        lo, hi = [], []
        for d in pv.get_dim_names():
            if d == pctx.get_step_dim_name():
                lo.append(t_new)
                hi.append(t_new)
            else:
                lo.append(0)
                hi.append(pctx.get_overall_domain_size(d) - 1)
        buf = pv.get_elements_in_slice(lo, hi)
        dom = [d for d in pv.get_dim_names()
               if d != pctx.get_step_dim_name()]
        buf = buf.reshape([pctx.get_overall_domain_size(d) for d in dom])
        clo = [0] * len(dom)
        chi = [pctx.get_overall_domain_size(d) - 1 for d in dom]
        cv.set_elements_in_slice(buf, clo, chi)

    # -- comparison (the bit-equality gate) ----------------------------

    def written_vars(self, stage: str) -> List[str]:
        soln = self._solns[stage]
        scratch = {v.get_name() for v in soln.get_vars()
                   if v.is_scratch()}
        return sorted(_written_names(soln) - scratch)

    def _interior(self, stage: str, var: str, t: Optional[int]):
        v = self.get_var(stage, var)
        ctx = self._fused_ctx if self._fused else self._stage_ctxs[stage]
        lo, hi = [], []
        for d in v.get_dim_names():
            if v.get_step_dim_name() and d == v.get_step_dim_name():
                lo.append(t)
                hi.append(t)
            elif d in ctx.get_domain_dim_names():
                lo.append(0)
                hi.append(ctx.get_overall_domain_size(d) - 1)
            else:
                lo.append(v.get_first_misc_index(d))
                hi.append(v.get_last_misc_index(d))
        return np.asarray(v.get_elements_in_slice(lo, hi))

    def compare(self, other: "SolutionPipeline", epsilon: float = 0.0,
                abs_epsilon: float = 0.0) -> int:
        """Count mismatching interior elements of every written var of
        every stage against another pipeline that ran the same steps
        (over the step indices valid in BOTH rings).  ``epsilon=0``
        is exact bit-equality — the fused-vs-chained gate."""
        self._check_prepared()
        other._check_prepared()
        bad = 0
        # push-fused intermediates have stale rings in whichever arm
        # pushed them — only vars observable in BOTH arms participate
        skip = self.pushed_vars() | other.pushed_vars()
        for s in self.stage_names:
            for vn in self.written_vars(s):
                if f"{s}{SEP}{vn}" in skip:
                    continue
                va, vb = self.get_var(s, vn), other.get_var(s, vn)
                if va.get_step_dim_name():
                    ts = range(max(va.get_first_valid_step_index(),
                                   vb.get_first_valid_step_index()),
                               min(va.get_last_valid_step_index(),
                                   vb.get_last_valid_step_index()) + 1)
                else:
                    ts = [None]
                for t in ts:
                    a = self._interior(s, vn, t)
                    b = other._interior(s, vn, t)
                    tol = epsilon * np.maximum(np.abs(a), np.abs(b)) \
                        + abs_epsilon
                    bad += int(np.sum(~(np.abs(a - b) <= tol)))
        return bad

    # -- teardown ------------------------------------------------------

    def end(self) -> None:
        if self._fused_ctx is not None and self._fused_ctx.is_prepared():
            self._fused_ctx.end_solution()
        for ctx in (self._stage_ctxs or {}).values():
            if ctx.is_prepared():
                ctx.end_solution()


# ---------------------------------------------------------------------------
# the headline chain
# ---------------------------------------------------------------------------


def rtm_chain(radius: int = 2, accumulate: bool = True):
    """The 3-stage RTM-like chain (forward acoustic step → imaging
    condition → 27-point box smoothing): ``(stages, bindings)`` ready for
    :class:`SolutionPipeline` — shared by ``chip_smoke.py`` and the
    tests.

    ``accumulate=False`` swaps the imaging stage for the
    non-accumulating ``rtm_img_pure`` (per-shot correlation, no
    ``img(t)`` self-read): the merged image var's only reader is then
    the smoother at ``+step_dir``, making it the push-memory fusion
    flagship — its tile never round-trips device memory."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    img = "rtm_img" if accumulate else "rtm_img_pure"
    stages = [("fwd", create_solution("rtm_fwd", radius=radius)),
              ("img", create_solution(img)),
              ("smooth", create_solution("rtm_smooth"))]
    bindings = [("img", "fwd_in", "fwd", "pressure"),
                ("smooth", "img_in", "img", "img")]
    return stages, bindings
