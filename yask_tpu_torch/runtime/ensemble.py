"""Ensemble batching: N independent instances of one prepared solution
run as a batch.

Counterpart of ``yask_tpu/runtime/ensemble.py``.  Small domains (the
parameter-sweep and ensemble-seismic-shot regime) leave most of a card
idle, and N separate runs pay N launches per step.  Here every ring slot
of the members is stacked once per run into one contiguous (N, *shape)
tensor, and ``-mode fused`` advances all members with one launch of K7
per step (the member-batched fused kernel:
:func:`yask_tpu_torch.ops.fused_stencil.batched_step` over K1's body,
``batched_stages_step`` over K6's; under ``-skew``, the default, over
their stream arms where the solo run takes one), then unstacks the
members as
contiguous views.  K7 takes every arm of the reference's vmapped chunk:
several stages, scratch sub-stages, rewrites, misc dims, partial-dim
writes, element size 2 and more than three domain dims.  It never
pushes: the reference builds its member batch with ``push=False``, so
the context hands it a push-off kernel (``StencilContext._batched_kernel``)
and a var a solo run pushes is materialised in a batch (ROADMAP.md §C16).
Under ``-trapezoid`` each K-step group of a batch runs on K4's member
batch (:func:`yask_tpu_torch.ops.fused_stencil.batched_trapezoid_chunk`,
as the reference vmaps its trapezoid chunk) where the context's gate
resolves K4, and the remainder steps on K7.  One prepared
context serves every member: :class:`RunState` is what a member is.

Feasibility is a mode property with one definition
(:func:`ensemble_feasible`): the single-device modes (``torch``,
``fused``) batch; ``ref`` is the sequential oracle by contract.

``torch`` mode runs the members one after another under the shared
step program, and :attr:`EnsembleRun.batched_reason` says so.
``torch.func.vmap`` over ``StepProgram.step`` runs iso3dfd bit-identically
on the CPU, but it is not taken: eager element-wise ops on a stacked
tensor move the same bytes as on each member, and the loop is
bit-identical to solo runs for every solution by construction.

Per-member initial conditions and results ride the var APIs unchanged:
:meth:`EnsembleRun.member` swaps the context's active run state.

Bit-identity contract: per member, a batched run gives the bits of that
member run alone (``tests/test_torch_ensemble.py``): K7 stages and
computes exactly what K1 or K6 does for one member, offset by the
member (a var a solo run pushes aside).

Masked sub-domain members (``sub_domains=``, serve-side shape
bucketing): a member may occupy only the low-corner ``{dim: size}``
sub-box of the shared geometry; everything outside it is zeroed on entry
and after every step, which reproduces the solo run's ghost-zero
boundary exactly.  ``torch`` mode only, as ``yask_tpu`` keeps it
jit-only: the fused kernel advances a whole chunk with no hook between
steps for the mask (``yask_tpu_torch.serve.buckets`` is the gate).

Unlike ``yask_tpu``, a failure to build or launch the batched kernel is
never answered by running the members sequentially: it raises out of
:meth:`EnsembleRun.run` (ROADMAP.md §C records the difference).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from yask_tpu_torch.utils.exceptions import YaskException

#: modes whose whole state lives on one device — the ones that batch.
BATCHED_MODES = ("torch", "fused")

#: why torch-mode members run one after another (EnsembleRun.batched_reason)
TORCH_SEQUENTIAL = ("torch mode runs the members one after another under "
                    "the shared step program (eager PyTorch moves the "
                    "same bytes batched or not)")


def sub_domain_masks(ctx, sub_sizes: Dict[str, int]) -> Dict:
    """Per-var boolean masks (tensors on the context's device, host numpy
    for ``ref``) selecting a tenant's sub-domain inside a larger bucket
    geometry: True on ``[origin, origin+sub)`` along every domain dim
    (low-corner anchoring), True across misc axes.  The masked members
    are zeroed outside the mask on entry and after every step."""
    import numpy as np
    ctx._check_prepared()
    masks = {}
    for name, g in ctx._program.geoms.items():
        if g.is_scratch:
            continue
        m = np.zeros(tuple(g.shape), dtype=bool)
        idx = []
        for dn, kind in g.axes:
            if kind == "domain":
                size = int(sub_sizes.get(
                    dn, ctx._opts.global_domain_sizes[dn]))
                idx.append(slice(g.origin[dn], g.origin[dn] + size))
            else:
                idx.append(slice(None))
        m[tuple(idx)] = True
        if ctx._mode != "ref":
            import torch
            m = torch.as_tensor(m, device=ctx._device)
        masks[name] = m
    return masks


def ensemble_feasible(ctx) -> Tuple[bool, str]:
    """Can this configured context batch an ensemble?  ``(ok, reason)``
    — the one definition the run path and the server consult."""
    mode = ctx._mode or ctx._opts.mode
    if mode == "auto":
        mode = "torch"
    if mode in BATCHED_MODES:
        return True, ""
    if mode == "ref":
        return False, ("mode 'ref' is the sequential numpy oracle; "
                       "ensemble batching only applies to the device "
                       "paths (torch/fused)")
    return False, (f"mode '{mode}' does not batch; use -mode torch or "
                   "-mode fused")


class EnsembleRun:
    """N members of one prepared solution, run as a batch.

    Member 0 *is* the context's current :class:`RunState`; members
    1..N-1 get fresh zero-filled states from ``ctx.new_run_state()``.
    With ``members=`` the run batches existing run states instead (the
    serving scheduler's shape: each tenant session owns its state).
    """

    def __init__(self, ctx, n: Optional[int] = None,
                 members: Optional[List] = None,
                 sub_domains: Optional[List[Optional[Dict[str, int]]]]
                 = None):
        ctx._check_prepared()
        if members is not None:
            if n is not None and n != len(members):
                raise YaskException(
                    f"ensemble n={n} disagrees with {len(members)} "
                    "explicit members")
            n = len(members)
        if n is None or n < 1:
            raise YaskException(f"ensemble size must be >= 1, got {n}")
        ok, why = ensemble_feasible(ctx)
        if not ok:
            raise YaskException(f"ensemble={n} infeasible: {why}")
        self._ctx = ctx
        if members is not None:
            self._members = list(members)
        else:
            self._members = [ctx.get_run_state()]
            self._members += [ctx.new_run_state() for _ in range(n - 1)]
        self._sub_domains = list(sub_domains) if sub_domains else None
        if self._sub_domains is not None:
            if len(self._sub_domains) != len(self._members):
                raise YaskException(
                    f"sub_domains has {len(self._sub_domains)} entries "
                    f"for {len(self._members)} members")
            if not any(self._sub_domains):
                self._sub_domains = None
        if self._sub_domains is not None \
                and (ctx._mode or ctx._opts.mode) != "torch":
            raise YaskException(
                "masked sub-domain members need a mask between steps, "
                "which only torch mode has; mode "
                f"'{ctx._mode or ctx._opts.mode}' fuses steps")
        #: "" after a batched run; otherwise why the members ran one
        #: after another.
        self.batched_reason = ""
        #: K7's tiling record after a batched run (no stream arm, and
        #: why), else None
        self.tiling = None

    @property
    def masked(self) -> bool:
        return self._sub_domains is not None

    @property
    def n(self) -> int:
        return len(self._members)

    @contextmanager
    def member(self, i: int):
        """Make member ``i`` the context's active run state for the
        block: every var API call inside targets that member."""
        prev = self._ctx.set_run_state(self._members[i])
        try:
            yield self._ctx
        finally:
            self._ctx.set_run_state(prev)

    # ------------------------------------------------------------------

    def _stack_states(self):
        """var → ring of contiguous (N, *shape) tensors.  Stacking
        copies, so the members' own rings stay as they were until the
        run succeeds."""
        import torch
        ctx = self._ctx
        for i in range(self.n):
            with self.member(i):
                ctx._materialize_state()
                ctx._state_to_device()
        names = list(self._members[0].state)
        return {name: [torch.stack([m.state[name][s]
                                    for m in self._members])
                       for s in range(len(self._members[0].state[name]))]
                for name in names}

    def _unstack_states(self, batched) -> None:
        """Each member's rings become views of the stacks (contiguous,
        so K1 takes them as they are)."""
        for i, m in enumerate(self._members):
            m.state = {name: [b[i] for b in ring]
                       for name, ring in batched.items()}
            m.state_on_device = True

    def run(self, first_step_index: int,
            last_step_index: Optional[int] = None) -> None:
        """Advance every member over the step range (inclusive), the
        ensemble analog of ``run_solution``.  Wall-clock lands in member
        0's run timer (the aggregate batched time); every member's
        ``cur_step``/``steps_done`` advance as if run alone.  A failed
        kernel build or launch raises."""
        from yask_tpu_torch.obs.tracer import span
        ctx = self._ctx
        ctx._check_prepared()
        if last_step_index is None:
            last_step_index = first_step_index
        start, n = ctx._step_seq(first_step_index, last_step_index)
        mode = ctx._mode
        if mode == "fused":
            with span("ensemble.run", phase="compute", members=self.n,
                      steps=n, masked=self.masked):
                self._run_batched(start, n)
            self.batched_reason = ""
            dirn = ctx._ana.step_dir
            for m in self._members:
                m.cur_step = start + n * dirn
                m.steps_done += n
            return
        self.batched_reason = TORCH_SEQUENTIAL
        with span("ensemble.sequential", phase="compute", members=self.n,
                  steps=n, masked=self.masked):
            self._run_sequential(first_step_index, last_step_index)

    def _run_batched(self, start: int, n: int) -> None:
        """K7 chunks over the stacked members: ⌊n/K⌋ chunks of K steps
        (K = wf_steps) plus a remainder, one launch per step; where
        ``-trapezoid`` resolved K4, each K-step group is one K4 member
        batch (a launch per pass) and the remainder runs on K7."""
        ctx = self._ctx
        batched = self._stack_states()
        K = max(ctx._opts.wf_steps, 1)
        trap = ctx._built_trapezoid_kernel()
        chunks = ctx._chunks(n, K)
        # K7 is emitted and built only where it runs
        kern = (ctx._batched_kernel()
                if trap is None or any(k != K for k in chunks) else None)
        dirn = ctx._ana.step_dir
        with self._members[0].run_timer:
            st, t = batched, start
            for k in chunks:
                st = (trap if trap is not None and k == K
                      else kern).batched_chunk(st, t, k, self.n)
                t += k * dirn
            ctx._sync()
        self._unstack_states(st)
        self.tiling = (trap or kern).tiling(K, members=self.n)

    def _mask_member_state(self, i: int, masks) -> None:
        """Zero member ``i``'s state outside its sub-domain (``masks``
        from :func:`sub_domain_masks`; +0.0 exactly, as solo pads)."""
        import torch
        m = self._members[i]
        m.state = {name: [torch.where(masks[name], s, torch.zeros(
                              (), dtype=s.dtype, device=s.device))
                          if name in masks else s for s in ring]
                   for name, ring in m.state.items()}

    def _run_sequential(self, first_step_index: int,
                        last_step_index: int) -> None:
        ctx = self._ctx
        if not self.masked:
            for i in range(self.n):
                with self.member(i):
                    ctx.run_solution(first_step_index, last_step_index)
            return
        start, n = ctx._step_seq(first_step_index, last_step_index)
        dirn = ctx._ana.step_dir
        for i in range(self.n):
            with self.member(i):
                if not self._sub_domains[i]:
                    ctx.run_solution(first_step_index, last_step_index)
                    continue
                masks = sub_domain_masks(ctx, self._sub_domains[i])
                ctx._state_to_device()
                self._mask_member_state(i, masks)
                t = start
                for _ in range(n):
                    ctx.run_solution(t, t)
                    self._mask_member_state(i, masks)
                    t += dirn
