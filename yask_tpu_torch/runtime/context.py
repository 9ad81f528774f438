"""The stencil context: ``yk_solution`` driving step programs on devices.

Counterpart of ``yask_tpu/runtime/context.py`` (the reference's
``StencilContext``, ``src/kernel/lib/context.hpp:231-786``), main path
only: ``prepare_solution`` plans geometry and allocates the step rings on
the context's ``torch.device``; ``run_solution`` advances steps on the
selected mode; ``run_ref``/``compare_data`` implement the validation
oracle; ``get_stats`` reports throughput.

Execution modes (``-mode``):

* ``torch`` — ``StepProgram.step`` on tensors, ``wf_steps`` steps per
  chunk (the counterpart of ``jit``; ``auto`` resolves to it);
* ``fused`` — the hand-written CUDA kernel of
  :mod:`yask_tpu_torch.ops.fused_stencil`, one launch per step (the
  counterpart of ``pallas``); on CPU tensors its plain version runs.
  With ``-skew`` (on by default) a 3-D single-stage solution runs K1's
  stream arm instead (``stream_step``, and in member batches and on
  shards' boxes ``<name>_stream_batched`` and ``_stream_region``;
  ``-no-skew`` keeps K1), and a 3-D
  multi-stage one without scratch vars K6's stream arm, solo and in
  member batches (``stages_step`` launches ``<name>_stages_stream``;
  ``-no-skew`` keeps K6's body).  With
  ``-trapezoid`` each group of K = ``wf_steps`` steps may run on K4
  instead (under ``-skew``, on a 3-D solution K6's stream arm takes, one
  launch of K4's stream arm, the K levels lagged along slot 0; else, and
  under ``-no-skew``, phase 1 and the diamond launches, every stage of K6
  inside each level), the remainder on K1, its stream arm or K6; a member
  batch likewise on K4's member batch;
* ``ref`` — the eager numpy oracle (the reference's ``run_ref``);
* ``shard_map``, ``sharded``, ``shard_pallas`` — the domain decomposed
  over the env's device list by ``-nr`` (:mod:`yask_tpu_torch.parallel`):
  per-shard torch steps with a ghost exchange before each stage (``auto``
  with more than one rank resolves to ``sharded``, which runs as
  ``shard_map`` does, ROADMAP.md C9), or per-shard K5 sub-steps with one
  exchange per group of ``wf_steps`` steps.  The shards stay resident
  between runs; any host-visible access gathers them back
  (:meth:`StencilContext._materialize_state`).

Modes and settings of the reference package that this slice does not
carry raise a :class:`YaskException` naming the ROADMAP.md item that
brings them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.cli import CommandLineParser
from yask_tpu_torch.runtime.env import yk_env
from yask_tpu_torch.runtime.run_state import RunState
from yask_tpu_torch.runtime.settings import SHARD_MODES, KernelSettings
from yask_tpu_torch.runtime.stats import yk_stats
from yask_tpu_torch.runtime.var import yk_var, _to_numpy


class _TorchXP:
    """The two numpy calls the fill paths make, on a torch device."""

    def __init__(self, device):
        import torch
        self._torch = torch
        self._device = device
        self.float64 = torch.float64

    def arange(self, n, dtype):
        return self._torch.arange(n, dtype=dtype, device=self._device)


class StencilContext:
    """One runnable instance of a compiled stencil solution."""

    def __init__(self, env: yk_env, source, dtype=None):
        self._env = env
        from yask_tpu_torch.compiler.solution import yc_solution
        from yask_tpu_torch.compiler.solution_base import yc_solution_base
        from yask_tpu_torch.compiler.lowering import CompiledSolution
        if isinstance(source, yc_solution_base):
            source.run_define()
            self._csol = source.get_soln().compile(dtype=dtype)
        elif isinstance(source, yc_solution):
            self._csol = source.compile(dtype=dtype)
        elif isinstance(source, CompiledSolution):
            self._csol = source
        else:
            raise YaskException(
                f"cannot build a kernel solution from {type(source).__name__}")
        self._soln = self._csol.soln
        self._ana = self._csol.ana

        self._opts = KernelSettings(self._ana.domain_dims)
        self._program = None          # StepProgram (compute geometry)
        self._run = RunState()
        self._vars: Dict[str, yk_var] = {}
        self._mode = None
        self._device = None
        self._fused = None            # FusedKernel, built at first use
        self._fused_batched = None    # K7's push-off FusedKernel, if any
        # the shard modes: the device mesh, the per-(mode, K, knobs)
        # CommPlans, and the per-shard layout (ShardLayout for shard_map/
        # sharded, ShardPallasPlan for shard_pallas), made at first run
        self._mesh = None
        self._comm_plans: Dict[tuple, object] = {}
        self._shard = None
        # the -trapezoid resolution: (TrapezoidKernel or None, reasons)
        self._trap = None
        # set by SolutionPipeline on the context of a merged chain: the
        # pipeline, its signature (part of the variant key) and its plan
        self._pipeline = None
        self._pipeline_sig = None
        self._pipeline_plan = None
        self._compile_secs = 0.0
        self._last_cache_hit = None   # where the latest kernel build came from
        self._hooks: Dict[str, List[Callable]] = {
            "before_prepare": [], "after_prepare": [],
            "before_run": [], "after_run": []}

        # yc_solution::call_after_new_solution hooks run now
        for code in getattr(self._soln, "_after_new_solution", ()):
            if callable(code):
                code(self)
            else:
                exec(compile(str(code), "<call_after_new_solution>",
                             "exec"), {"kernel_soln": self})

    # ------------------------------------------------------------------
    # per-run state delegation (RunState)
    # ------------------------------------------------------------------

    @property
    def _state(self):
        """The global padded state; a shard-resident state is gathered
        back first (the lazy sync of every host-visible access)."""
        if self._run.resident is not None:
            self._materialize_state()
        return self._run.state

    @_state.setter
    def _state(self, v):
        self._run.resident = None
        self._run.state = v

    @property
    def _state_on_device(self):
        return self._run.state_on_device

    @_state_on_device.setter
    def _state_on_device(self, v):
        self._run.state_on_device = v

    @property
    def _cur_step(self):
        return self._run.cur_step

    @_cur_step.setter
    def _cur_step(self, v):
        self._run.cur_step = v

    @property
    def _steps_done(self):
        return self._run.steps_done

    @_steps_done.setter
    def _steps_done(self, v):
        self._run.steps_done = v

    @property
    def _run_timer(self):
        return self._run.run_timer

    @property
    def _halo_timer(self):
        return self._run.halo_timer

    def get_run_state(self) -> RunState:
        return self._run

    def set_run_state(self, rs: RunState) -> RunState:
        """Swap in another run's state bundle; returns the previous one.
        The solution side (program, fused kernel) is untouched: one
        prepare, many runs."""
        prev, self._run = self._run, rs
        return prev

    def new_run_state(self) -> RunState:
        """A fresh zero-state run over the prepared geometry (the
        ensemble-member and serving-session allocator), allocated as
        ``prepare_solution`` allocates: zero-filled rings on the
        context's device (host numpy for ``ref``)."""
        self._check_prepared()
        rs = RunState()
        rs.state = self._program.alloc_state()
        rs.state_on_device = self._mode != "ref"
        return rs

    def new_ensemble(self, n: Optional[int] = None):
        """N members of this prepared solution run as a batch
        (:mod:`yask_tpu_torch.runtime.ensemble`); ``n`` defaults to the
        ``-ensemble`` setting.  Member 0 adopts the context's current
        run state (initial conditions already set stay member 0's)."""
        from yask_tpu_torch.runtime.ensemble import EnsembleRun
        return EnsembleRun(self, n if n is not None
                           else max(self._opts.ensemble, 1))

    # ------------------------------------------------------------------
    # identity / settings / vars
    # ------------------------------------------------------------------

    def get_name(self) -> str:
        return self._soln.get_name()

    def get_description(self) -> str:
        return self._soln.get_description()

    def get_env(self) -> yk_env:
        return self._env

    def get_settings(self) -> KernelSettings:
        return self._opts

    def get_device(self):
        """The ``torch.device`` the state lives on (after prepare)."""
        return self._device

    def get_step_dim_name(self) -> str:
        return self._ana.step_dim or ""

    def get_domain_dim_names(self) -> List[str]:
        return list(self._ana.domain_dims)

    def set_overall_domain_size(self, dim: str, size: int) -> None:
        self._opts.global_domain_sizes[dim] = size

    def set_overall_domain_size_vec(self, sizes) -> None:
        for d, v in (sizes.items() if hasattr(sizes, "items") else sizes):
            self._opts.global_domain_sizes[d] = v

    def get_overall_domain_size(self, dim: str) -> int:
        return self._opts.global_domain_sizes[dim]

    def set_rank_domain_size(self, dim: str, size: int) -> None:
        self._opts.rank_domain_sizes[dim] = size

    def get_rank_domain_size(self, dim: str) -> int:
        return self._opts.rank_domain_sizes[dim]

    def set_block_size(self, dim: str, size: int) -> None:
        self._opts.block_sizes[dim] = size

    def get_block_size(self, dim: str) -> int:
        return self._opts.block_sizes[dim]

    def get_element_bytes(self) -> int:
        return int(np.dtype(self._csol.dtype).itemsize)

    def set_num_ranks(self, dim: str, n: int) -> None:
        self._opts.num_ranks[dim] = n

    def get_num_ranks(self, dim: str) -> int:
        return self._opts.num_ranks[dim]

    def get_num_vars(self) -> int:
        return len([v for v in self._soln.get_vars() if not v.is_scratch()])

    def get_var_names(self) -> List[str]:
        return [v.get_name() for v in self._soln.get_vars()
                if not v.is_scratch()]

    def get_var(self, name: str) -> yk_var:
        if name not in self._vars:
            raise YaskException(
                f"no var '{name}' (or prepare_solution not called)")
        return self._vars[name]

    def get_vars(self) -> List[yk_var]:
        return list(self._vars.values())

    def first_domain_index(self, dim: str) -> int:
        return 0

    def last_domain_index(self, dim: str) -> int:
        return self._opts.global_domain_sizes[dim] - 1

    def get_first_rank_domain_index(self, dim: str) -> int:
        return 0

    def get_last_rank_domain_index(self, dim: str) -> int:
        return self.get_overall_domain_size(dim) - 1

    def get_num_domain_dims(self) -> int:
        return len(self.get_domain_dim_names())

    def get_overall_domain_size_vec(self):
        return [self.get_overall_domain_size(d)
                for d in self.get_domain_dim_names()]

    def get_min_pad_size(self, dim: str) -> int:
        return self._opts.min_pad_sizes[dim]

    def set_min_pad_size(self, dim: str, size: int) -> None:
        self._opts.min_pad_sizes[dim] = max(
            self._opts.min_pad_sizes[dim], int(size))

    def get_step_wrap(self) -> bool:
        return getattr(self, "_step_wrap", False)

    def set_step_wrap(self, wrap: bool) -> None:
        """``yk_solution::set_step_wrap``: with wrapping on, var element
        APIs accept any step index and map it onto the ring."""
        self._step_wrap = bool(wrap)

    def is_offloaded(self) -> bool:
        return self._device is not None and self._device.type == "cuda"

    def get_elapsed_run_secs(self) -> float:
        return self._run_timer.get_elapsed_secs()

    # ------------------------------------------------------------------
    # hooks (yk_solution hook registration, soln_apis.cpp)
    # ------------------------------------------------------------------

    def call_before_prepare_solution(self, fn: Callable) -> None:
        self._hooks["before_prepare"].append(fn)

    def call_after_prepare_solution(self, fn: Callable) -> None:
        self._hooks["after_prepare"].append(fn)

    def call_before_run_solution(self, fn: Callable) -> None:
        self._hooks["before_run"].append(fn)

    def call_after_run_solution(self, fn: Callable) -> None:
        self._hooks["after_run"].append(fn)

    # ------------------------------------------------------------------
    # prepare
    # ------------------------------------------------------------------

    def _check_carried(self) -> None:
        """Raise for settings of the reference package whose paths this
        slice does not carry, naming the ROADMAP.md item that brings
        each."""
        o = self._opts
        pending = []
        if o.do_auto_tune:
            pending.append("-auto_tune: ROADMAP.md A6 (auto-tuner)")
        if o.measure_halo_time:
            pending.append("-measure_halo: ROADMAP.md A11 (halo "
                           "calibration)")
        if o.ckpt_every > 0 or o.watchdog_every > 0 \
                or o.run_deadline_secs > 0:
            pending.append("ckpt_every/watchdog_every/run_deadline: "
                           "ROADMAP.md A10 (checkpoint and supervised "
                           "runs)")
        self._push_arg()   # a bad -push value raises
        if pending:
            raise YaskException(
                "not ported yet: " + "; ".join(pending))

    def _resolve_device(self):
        if not self._opts.device:
            return self._env.get_device()
        import torch
        dev = torch.device(self._opts.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise YaskException(
                f"-device {dev}: no CUDA device on this host; use "
                "-device cpu")
        return dev

    def _ops(self, mode: str):
        from yask_tpu_torch.compiler.lowering import NumpyOps, TorchOps
        return NumpyOps() if mode == "ref" else TorchOps(self._device)

    def _plan_geometry(self):
        """Settings adjustment → mode resolution → var-geometry planning,
        without allocating state.  Sets ``self._mode``/``self._device``."""
        self._opts.adjust_settings(self._env.get_num_ranks())
        self._check_carried()
        mode = self._opts.mode
        if mode == "auto":
            mode = ("torch" if self._opts.num_ranks.product() == 1
                    else "sharded")
        if self._opts.force_scalar:
            mode = "ref"
        self._mode = mode
        self._device = self._resolve_device()
        if mode in SHARD_MODES:
            # the port's sharded mode runs the shard_map exchange, so it
            # takes shard_map's geometry checks (ROADMAP.md C9)
            from yask_tpu_torch.parallel.decomp import \
                validate_shard_geometry
            validate_shard_geometry(self._csol, self._opts)
        extra = {d: (self._opts.min_pad_sizes[d], self._opts.min_pad_sizes[d])
                 for d in self._ana.domain_dims}
        if mode == "fused" and self._trapezoid_arg() is not False:
            # the diamond windows reach trapezoid_pad_need past the domain
            # in each dim the trapezoid may take (lead[-2:], the
            # reference's context.py:941-965)
            from yask_tpu_torch.ops.cuda_emit import trapezoid_pad_need
            K = max(self._opts.wf_steps, 1)
            rad = self._ana.fused_step_radius()
            for d in self._ana.domain_dims[:-1][-2:]:
                need = trapezoid_pad_need(rad.get(d, 0), K)
                extra[d] = tuple(max(e, need) for e in extra[d])
        self._plan_kwargs = dict(extra_pad=extra)
        from yask_tpu_torch.compiler.lowering import is_bfloat16
        if is_bfloat16(self._csol.dtype) and mode not in SHARD_MODES:
            # the stream arms fill their rings with aligned bfloat16 pairs,
            # K1's with 16-byte units (fused_stencil.check_pair_strides)
            from yask_tpu_torch.ops.cuda_emit import bf16_minor_multiple
            self._plan_kwargs["pad_multiple"] = {
                self._ana.domain_dims[-1]: bf16_minor_multiple(self._ana)}
        prog = self._csol.plan(self._opts.global_domain_sizes,
                               ops=self._ops(mode), **self._plan_kwargs)
        if mode in ("fused", "shard_pallas"):
            # K5 runs on the body K1 or K6 would (every arm of theirs);
            # shard_pallas's own rejections are the reference's
            # (check_shard_pallas at the first run, decomp's at prepare)
            from yask_tpu_torch.ops.cuda_emit import fused_applicable
            ok, why = fused_applicable(prog)
            if not ok:
                path, alt = (("fused kernel", "torch") if mode == "fused"
                             else ("shard_pallas path", "shard_map"))
                raise YaskException(
                    f"solution '{self.get_name()}' cannot use the {path}: "
                    f"{why}; use -mode {alt}")
        return prog

    def prepare_solution(self) -> None:
        """Setup pipeline (reference ``prepare_solution``,
        ``soln_apis.cpp:137-250``): settings → geometry → allocation."""
        for h in self._hooks["before_prepare"]:
            h(self)
        self._ended = False
        self._program = self._plan_geometry()
        self._fused = None
        self._fused_batched = None
        self._trap = None
        self._shard = None
        self._comm_plans.clear()
        self._mesh = None
        if self._mode in SHARD_MODES:
            from yask_tpu_torch.parallel.mesh import build_mesh
            self._mesh = build_mesh(self._env, self._opts)
        self._state = self._program.alloc_state()
        self._state_on_device = self._mode != "ref"
        self._vars = {v.get_name(): yk_var(self, v.get_name())
                      for v in self._soln.get_vars() if not v.is_scratch()}
        self._cur_step = 0
        for h in self._hooks["after_prepare"]:
            h(self)

    def is_prepared(self) -> bool:
        return self._program is not None

    # ------------------------------------------------------------------
    # state plumbing
    # ------------------------------------------------------------------

    def _check_prepared(self):
        if self._program is None:
            if getattr(self, "_ended", False):
                raise YaskException(
                    "end_solution was called; call prepare_solution "
                    "again to run")
            raise YaskException("prepare_solution has not been called")

    def _materialize_state(self) -> None:
        """The lazy sync point before host-visible state access: a state
        left resident on the shards by a shard-mode run is gathered back
        into the global padded state, one var and ring slot at a time
        (the reference's context.py:487-503)."""
        rs = self._run
        if rs.resident is not None:
            from yask_tpu_torch.parallel.shard_step import gather_state
            gather_state(self)
        if rs.state is None:
            if getattr(self, "_ended", False):
                raise YaskException(
                    "end_solution was called; call prepare_solution "
                    "again to access var data")
            raise YaskException("the active run state holds no arrays")

    def _interior_idx(self, name: str):
        g = self._program.geoms[name]
        return tuple(
            slice(g.origin[dn], g.origin[dn]
                  + self._opts.global_domain_sizes[dn])
            if kind == "domain" else slice(None)
            for dn, kind in g.axes)

    def _interior_shape(self, name: str):
        a = self._state[name][0]
        return tuple(a.shape[ax] if s.stop is None else s.stop - s.start
                     for ax, s in enumerate(self._interior_idx(name)))

    def _put(self, arr: np.ndarray):
        """A host array as a state array of this context's kind (on the
        host, bfloat16 values in float32)."""
        from yask_tpu_torch.compiler.lowering import (NumpyOps, is_bfloat16,
                                                      torch_dtype)
        if not self._state_on_device:
            if is_bfloat16(self._program.dtype):
                return NumpyOps().asdtype(arr, self._program.dtype)
            return arr
        import torch
        return torch.as_tensor(arr).to(
            device=self._device, dtype=torch_dtype(self._program.dtype))

    def _update_state_array(self, name: str, slot: int, fn) -> None:
        """Replace one ring slot by ``fn(host copy)``, pads re-zeroed
        (physical-boundary ghost cells are zero in every mode)."""
        self._check_prepared()
        old = _to_numpy(self._state[name][slot])
        new = np.asarray(fn(np.array(old)), dtype=old.dtype)
        out = np.zeros_like(old)
        idx = self._interior_idx(name)
        out[idx] = new[idx]
        self._state[name][slot] = self._put(out)

    def _fill_interior(self, name: str, slot: int, values) -> None:
        """Zero one ring slot and fill its interior, on the state's own
        device: ``values`` is a float, a numpy array of the interior's
        shape, or ``fn(xp, n)`` giving ``n`` float64 values laid out over
        the interior shape (``xp`` is numpy or its torch counterpart)."""
        self._check_prepared()
        a = self._state[name][slot]
        idx = self._interior_idx(name)
        ishape = self._interior_shape(name)
        if isinstance(a, np.ndarray):
            xp, out = np, np.zeros_like(a)
        else:
            import torch
            xp, out = _TorchXP(a.device), torch.zeros_like(a)
        if callable(values):
            n = int(np.prod(ishape)) if ishape else 1
            values = values(xp, n).reshape(ishape)
        if isinstance(values, np.ndarray) and xp is not np:
            import torch
            values = torch.as_tensor(values).to(a.device)
        out[idx] = values
        self._state[name][slot] = self._put(out) if xp is np else out

    def _state_to_host(self) -> None:
        if self._state_on_device:
            self._state = {k: [np.array(_to_numpy(a)) for a in ring]
                           for k, ring in self._state.items()}
            self._state_on_device = False

    def _state_to_device(self) -> None:
        if not self._state_on_device:
            self._state_on_device = True
            self._state = {k: [self._put(a) for a in ring]
                           for k, ring in self._state.items()}

    def _sync(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            import torch
            torch.cuda.synchronize(self._device)

    # ------------------------------------------------------------------
    # run
    # ------------------------------------------------------------------

    def _step_seq(self, first_t: int, last_t: int):
        """Evaluation order for the step range (ascending for forward
        stencils, descending for reverse-time)."""
        if first_t > last_t:
            first_t, last_t = last_t, first_t
        n = last_t - first_t + 1
        start = first_t if self._ana.step_dir > 0 else last_t
        return start, n

    def _chunks(self, n: int, k: int) -> List[int]:
        k = max(1, min(k, n))
        return [k] * (n // k) + ([n % k] if n % k else [])

    def run_solution(self, first_step_index: int,
                     last_step_index: Optional[int] = None) -> None:
        """Apply the stencil for the given step indices (inclusive), the
        reference's ``run_solution(first_t, last_t)`` hot path."""
        self._check_prepared()
        self._check_carried()
        if last_step_index is None:
            last_step_index = first_step_index
        for h in self._hooks["before_run"]:
            h(self)
        start, n = self._step_seq(first_step_index, last_step_index)
        if self._mode == "ref":
            self._run_ref_steps(start, n)
        elif self._mode == "fused":
            self._run_fused_steps(start, n)
        elif self._mode == "shard_pallas":
            from yask_tpu_torch.parallel.shard_step import run_shard_pallas
            run_shard_pallas(self, start, n)
        elif self._mode in ("shard_map", "sharded"):
            from yask_tpu_torch.parallel.shard_step import run_shard_map
            run_shard_map(self, start, n)
        else:
            self._run_torch_steps(start, n)
        self._cur_step = start + n * self._ana.step_dir
        self._steps_done += n
        for h in self._hooks["after_run"]:
            h(self)

    def _run_ref_steps(self, start: int, n: int) -> None:
        self._state_to_host()
        prog = self._csol.plan(self._opts.global_domain_sizes,
                               ops=self._ops("ref"), **self._plan_kwargs)
        with self._run_timer:
            t = start
            for _ in range(n):
                self._state = prog.step(self._state, t)
                t += self._ana.step_dir

    def _run_torch_steps(self, start: int, n: int) -> None:
        """``wf_steps`` steps per chunk of ``StepProgram.step`` on tensors
        (the counterpart of the reference's jit chunks)."""
        self._state_to_device()
        self._last_cache_hit = "eager"
        wf = self._opts.wf_steps if self._opts.wf_steps > 0 else n
        dirn = self._ana.step_dir
        prog = self._program
        with self._run_timer:
            st, t = self._state, start
            for k in self._chunks(n, wf):
                for _ in range(k):
                    st = prog.step(st, t)
                    t += dirn
            self._sync()
        self._state = st

    def _push_arg(self):
        """The push-memory request (``FusedKernel(push=)``) the ``-push``
        setting resolves to: ``auto`` engages only for the context of a
        fused pipeline (a plain solution's user expects every written var
        observable after ``run()``; a pipeline hides its pushed
        intermediates behind ``SolutionPipeline.get_var``), ``on`` for any
        fused context, ``force`` raises when nothing is eligible, ``off``
        never engages."""
        pm = self._opts.push_memory
        if pm == "off":
            return False
        if pm == "on":
            return None
        if pm == "force":
            return True
        if pm != "auto":
            raise YaskException(
                f"bad -push value '{pm}': expected auto|on|force|off")
        return None if self._pipeline is not None else False

    def _trapezoid_arg(self):
        """The trapezoid request (``resolve_trapezoid(trapezoid=)``):
        ``-trapezoid`` = None (auto), else False.  A caller forces K4 the
        way the reference's tests force ``build_pallas_chunk(trapezoid=
        True)``: by making this return True."""
        return None if self._opts.trapezoid_tiling else False

    def _trapezoid_kernel(self):
        """K4 for this prepared solution's groups of K = ``wf_steps``
        steps (solo and member batches alike: it never pushes), or None
        when they run on K1 or K6; resolved once per prepare, with its
        reason records.  Under ``-skew`` (the default) a group the stream
        arm takes is one launch of K4's stream arm, under ``-no-skew`` the
        two-phase passes."""
        if self._trap is None:
            from yask_tpu_torch.ops.cuda_emit import resolve_trapezoid
            from yask_tpu_torch.ops.fused_stencil import TrapezoidKernel
            reasons: List[Dict] = []
            spec = None
            arg = self._trapezoid_arg()
            if arg is not False:
                bs = self._opts.block_sizes
                lead = self._ana.domain_dims[:-1]
                block = ({d: bs[d] if bs[d] > 0 else 8 for d in lead}
                         if any(bs[d] > 0 for d in lead) else None)
                spec = resolve_trapezoid(self._program,
                                         max(self._opts.wf_steps, 1), arg,
                                         block=block, reasons=reasons,
                                         skew=self._skew_arg())
            self._trap = (TrapezoidKernel(self._program, spec)
                          if spec is not None else None, reasons)
        return self._trap[0]

    def _built_trapezoid_kernel(self):
        """:meth:`_trapezoid_kernel`, built on a CUDA device (nvcc at first
        use, counted as compile time)."""
        trap = self._trapezoid_kernel()
        if trap is not None and self._device.type == "cuda":
            self._compile_secs += trap.build()
        return trap

    def _skew_arg(self):
        """The stream-arm request (``FusedKernel(skew=)``): ``-skew`` =
        None (auto), ``-no-skew`` = False.  A caller forces the arm
        (raising where it cannot run) by making this return True."""
        return None if self._opts.skew_wavefront else False

    def _fused_spec_kernel(self):
        """The fused kernel of this prepared solution, emitted but not
        built; its arm (K1 or the stream arm) is selected here."""
        if self._fused is None:
            from yask_tpu_torch.ops.fused_stencil import FusedKernel
            self._fused = FusedKernel(self._program, self._push_arg(),
                                      self._skew_arg(),
                                      self._opts.skew_dims_max)
        return self._fused

    def _fused_kernel(self):
        """The fused kernel of this prepared solution; its build (nvcc at
        first use on a CUDA device) counts as compile time, and where it
        came from lands in ``_last_cache_hit``."""
        kern = self._fused_spec_kernel()
        if self._device.type == "cuda":
            self._compile_secs += kern.build()
            self._last_cache_hit = kern.cache_hit
        else:
            self._last_cache_hit = "plain"
        return kern

    def _batched_kernel(self):
        """K7's kernel for this prepared solution's member batches: the
        solo fused kernel where ``-push`` resolves to off, else a push-off
        one (the reference's vmapped chunk is built with ``push=False``,
        so a batch materialises the vars a solo run pushes, and a forced
        push with nothing to push does not raise; ROADMAP.md §C16), with
        the session's ``-skew`` request (K6's stream arm over the batch).
        Built on a CUDA device, as :meth:`_fused_kernel`.  Under
        ``-trapezoid`` a batch's K-step groups run on K4's member batch
        (:meth:`_trapezoid_kernel`, which never pushes) and only its
        remainder steps on this one."""
        if self._push_arg() is False:
            kern = self._fused_spec_kernel()
        else:
            if self._fused_batched is None:
                from yask_tpu_torch.ops.fused_stencil import FusedKernel
                self._fused_batched = FusedKernel(self._program, False,
                                                  self._skew_arg(),
                                                  self._opts.skew_dims_max)
            kern = self._fused_batched
        if self._device.type == "cuda":
            self._compile_secs += kern.build()
            self._last_cache_hit = kern.cache_hit
        else:
            self._last_cache_hit = "plain"
        return kern

    def comm_plan(self, K: Optional[int] = None):
        """The communication schedule (CommPlan) of the configured shard
        mode, derived once per (mode, K, knobs) and cached; the exchange
        paths and the tiling report consume this one instance."""
        from yask_tpu_torch.parallel.comm_plan import build_comm_plan
        mode = self._mode or self._opts.mode
        if K is None:
            K = max(self._opts.wf_steps, 1) if mode == "shard_pallas" \
                else 1
        key = (mode, int(K), self._opts.comm_order, self._opts.coalesce)
        if key not in self._comm_plans:
            self._comm_plans[key] = build_comm_plan(self, K=K)
        return self._comm_plans[key]

    def _fused_variant_key(self) -> tuple:
        """The settings beyond (profile, mode) that change what a fused
        chunk runs, so that requests are batched only onto one kernel:
        the counterpart of ``yask_tpu``'s ``_pallas_variant_key``.  For
        ``fused`` it is the chunk length, the emitted kernel's name (a
        hash of its source), the stream arm's dims, the trapezoid
        request, the push request and the pipeline signature (a push and
        a no-push build, a K4 and a K1 group, K1 and its stream arm, or a
        merged chain and a solution of the same equations, never share a
        kernel).  The shard modes add the mesh, the comm plan's key and
        the overlap setting; ``torch`` and ``ref`` run no kernel."""
        if self._mode in SHARD_MODES:
            mesh = (tuple(self._mesh.shape.items()),
                    tuple(str(d) for d in self._mesh.devices.flat))
            if self._mode != "shard_pallas":
                return (self._mode, mesh, self.comm_plan().key(),
                        self._opts.overlap_comms)
            from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
            K = max(self._opts.wf_steps, 1)
            return ("shard_pallas", K,
                    shard_pallas_plan(self).kernel.spec.name, mesh,
                    self.comm_plan(K).key(), self._opts.overlap_exchange)
        if self._mode != "fused":
            return (self._mode,)
        trap = self._trapezoid_kernel()
        kern = self._fused_spec_kernel() if trap is None else None
        name = (trap.spec.name if trap is not None else
                kern.spec.name if kern.spec is not None else "")
        return ("fused", max(self._opts.wf_steps, 1), name,
                tuple(kern.skew_dims) if kern is not None else (),
                self._trapezoid_arg(), self._push_arg(),
                self._pipeline_sig or "")

    def _run_fused_steps(self, start: int, n: int) -> None:
        """⌊n/K⌋ chunks of K steps (K = wf_steps) plus a remainder chunk,
        all through the fused kernel (K1, or its stream arm where ``-skew``
        engaged it): one launch per step; or, where ``-trapezoid``
        resolved to K4, each K-step group through K4 and the remainder
        through the fused kernel."""
        self._state_to_device()
        K = max(self._opts.wf_steps, 1)
        trap = self._built_trapezoid_kernel()
        chunks = self._chunks(n, K)
        # K1/K6 is emitted and built only where it runs: where K4 takes
        # every group, no nvcc run for a kernel that never launches
        kern = (self._fused_kernel()
                if trap is None or any(k != K for k in chunks) else None)
        dirn = self._ana.step_dir
        with self._run_timer:
            st, t = self._state, start
            for k in chunks:
                st = (trap if trap is not None and k == K
                      else kern).chunk(st, t, k)
                t += k * dirn
            self._sync()
        self._state = st

    def run_ref(self, first_step_index: int,
                last_step_index: Optional[int] = None) -> None:
        """Run the independent eager-numpy oracle over the same state
        (reference ``run_ref``, ``context.cpp:46``)."""
        self._check_prepared()
        if last_step_index is None:
            last_step_index = first_step_index
        start, n = self._step_seq(first_step_index, last_step_index)
        self._run_ref_steps(start, n)
        self._cur_step = start + n * self._ana.step_dir
        self._steps_done += n

    def run_auto_tuner_now(self, candidates=None, min_trial_secs=None) -> int:
        raise YaskException(
            "the auto-tuner is not ported yet: ROADMAP.md A6 (auto-tuner)")

    def reset_auto_tuner(self, enable: bool = True) -> None:
        self._opts.do_auto_tune = enable

    def is_auto_tuner_enabled(self) -> bool:
        return self._opts.do_auto_tune

    def set_trace_dir(self, path: Optional[str]) -> None:
        if path:
            raise YaskException(
                "per-step trace dumps are not ported yet: ROADMAP.md A14 "
                "(observability, perflab and checker)")

    # ------------------------------------------------------------------
    # validation (yask_main.cpp:564-616 -validate flow)
    # ------------------------------------------------------------------

    def compare_data(self, other: "StencilContext", epsilon: float = 1e-4,
                     abs_epsilon: float = 1e-7,
                     field_epsilon: float = 0.0) -> int:
        """Element-wise compare of all common vars against another context;
        returns #mismatches.  A point mismatches only if
        |x−y| > abs_eps + eps·max(|x|,|y|) (+ field_eps·max(‖x‖∞, ‖y‖∞)
        when ``field_epsilon`` is set — the tolerance for paths with
        different FP association, such as a kernel whose compiler
        contracts multiply-adds into FMAs).  Interiors only: pad geometry
        differs per mode and per package."""
        self._check_prepared()
        other._check_prepared()

        def interior(ctx, name, arr):
            return _to_numpy(arr[ctx._interior_idx(name)]).astype(np.float64)

        bad = 0
        for name, ring in self._state.items():
            if name not in other._state:
                continue
            oring = other._state[name]
            for a, b in zip(ring[::-1], oring[::-1]):
                x = interior(self, name, a)
                y = interior(other, name, b)
                if x.shape != y.shape:
                    bad += x.size
                    continue
                tol = abs_epsilon + epsilon * np.maximum(np.abs(x), np.abs(y))
                if field_epsilon > 0.0 and x.size:
                    scale = max(np.abs(x).max(), np.abs(y).max())
                    tol = tol + field_epsilon * scale
                bad += int((np.abs(x - y) > tol).sum())
        return bad

    # ------------------------------------------------------------------
    # stats (yk_stats)
    # ------------------------------------------------------------------

    def hbm_model_bytes_pp(self):
        """(read, write) device-memory bytes per point per step of the
        configured path: each live ring slot moves once per step (K1 is
        one launch per step), or once per group of K steps where K4
        runs the groups."""
        if self._program is None:
            return (0.0, 0.0)
        if self._mode == "fused" and self._trap and self._trap[0]:
            return self._program.hbm_bytes_per_point(
                fuse_steps=self._trap[0].K)
        return self._program.hbm_bytes_per_point()

    def get_stats(self) -> yk_stats:
        c = self._ana.counters
        rb_pp, wb_pp = self.hbm_model_bytes_pp()
        tiling = None
        hbm_peak = (self._env.get_hbm_peak_bytes_per_sec()
                    if self.is_offloaded() else 0.0)
        if self._mode in SHARD_MODES:
            # throughput is over the global domain, so the roofline
            # denominator counts every card of the mesh (repeats of one
            # card count once)
            hbm_peak *= self._mesh.num_cards()
            if self._mode == "shard_pallas" and self._shard is not None:
                tiling = self._shard.tiling
        if self._mode == "fused" and (self._fused is not None
                                      or (self._trap and self._trap[0])):
            K = max(self._opts.wf_steps, 1)
            trap, reasons = self._trap or (None, [])
            tiling = (trap or self._fused).tiling(K)
            if trap is None:
                tiling.update(trapezoid=False, trap_dims=[])
            tiling["trapezoid_request"] = {
                True: "forced", None: "auto", False: "off"}[
                    self._trapezoid_arg()]
            tiling["reasons"] = list(reasons)
        return yk_stats(
            npts=self._opts.global_domain_sizes.product(),
            nsteps=self._steps_done,
            nreads_pp=c.num_reads, nwrites_pp=c.num_writes,
            nfpops_pp=c.num_ops,
            elapsed=self._run_timer.get_elapsed_secs(),
            halo_secs=self._halo_timer.get_elapsed_secs(),
            compile_secs=self._compile_secs,
            read_bytes_pp=rb_pp, write_bytes_pp=wb_pp,
            hbm_peak=hbm_peak, tiling=tiling)

    def clear_stats(self) -> None:
        self._run_timer.clear()
        self._halo_timer.clear()
        self._steps_done = 0

    # ------------------------------------------------------------------
    # CLI parity
    # ------------------------------------------------------------------

    def get_command_line_values(self) -> str:
        o = self._opts
        dd = self.get_domain_dim_names()
        parts = [f"-g_{d} {o.global_domain_sizes[d]}" for d in dd]
        parts += [f"-b_{d} {o.block_sizes[d]}" for d in dd]
        parts += [f"-wf_steps {o.wf_steps}", f"-mode {o.mode}"]
        if o.device:
            parts.append(f"-device {o.device}")
        return " ".join(parts)

    def end_solution(self) -> None:
        """Release run resources (reference ``end_solution``); re-prepare
        to run again."""
        self._state = None
        self._program = None
        self._fused = None
        self._fused_batched = None
        self._trap = None
        self._shard = None
        self._ended = True

    def apply_command_line_options(self, args) -> List[str]:
        if isinstance(args, str):
            args = args.split()
        p = CommandLineParser()
        self._opts.add_options(p)
        return p.parse_args(list(args))

    def get_command_line_help(self) -> str:
        p = CommandLineParser()
        self._opts.add_options(p)
        return p.print_help()

    def __repr__(self):
        return (f"<StencilContext '{self.get_name()}' mode={self._mode} "
                f"prepared={self.is_prepared()}>")
