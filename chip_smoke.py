#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a host with a CUDA device and
``nvcc`` (the kernels are built from ``yask_tpu_torch/csrc`` and the
emitted sources at first use).  Every phase raises on failure, so the
script exits 0 only when all of them passed.  Phases:

1. identify the card (``nvidia-smi`` name and power limit) and build every
   kernel of the path, one ``nvcc`` per source, all started together;
2. hold each arm of K1 (``-mode fused``: the stream arm ``stream_step``
   under ``-skew``, K1's 3-D tiles ``fused_step`` under ``-no-skew``)
   against its plain version (``-mode torch``) on a numpy-seeded random
   state: iso3dfd r=8 and 3axis r=1 at 64³, K ∈ {1, 2}, 5 steps (so a
   remainder chunk runs), 0 mismatches at
   ``compare_data(field_epsilon=1e-4)``, the repo's tolerance for a fused
   kernel against its unfused path (the build turns FMA contraction off,
   so the two should in fact agree to the bit), 5 launches of the arm and
   of nothing else; and the two arms against each other to the bit
   (``compare_data(epsilon=0)``);
3. validate both arms against the numpy oracle (``-mode ref``) at 32³ for
   2 steps with ``compare_data``'s defaults;
4. the main path at full width: iso3dfd r=8 at 512³, fp32, ``-mode fused
   -wf_steps 2`` through ``yk_factory → new_solution →
   apply_command_line_options → prepare_solution → init vars →
   run_solution``, with ``-skew``'s default (the stream arm), then the same
   with ``-no-skew`` (K1) from the same seeded state: each a warm-up, then
   3 trials of 20 steps, with every launch counter zeroed just before and
   read just after (only the selected arm may launch); the two arms
   bit-equal after the same steps (compared on the card); then, outside
   those windows, each arm's time per launch (CUDA events) against the
   16 B/pt bound, the plain version's time, and one chunk of each against
   it from the same state; the same two arms at iso3dfd r=2 512³;
5. the serving path: a ``StencilServer`` with 8 ``-mode fused`` sessions
   of iso3dfd r=8 at 256³ (the same points as phase 4's 512³), each
   seeded through ``set_var_slice``; one warm-up request per session,
   then 8 requests of 20 steps submitted before waiting, which the
   scheduler batches into one ``EnsembleRun``: one launch of K7 (the
   member-batched kernel) per step.  Every response must be ``ok`` at
   occupancy 8, batched, not degraded; K7 must launch exactly 20 times
   in that window; two members must be bit-identical to solo ``-mode
   fused`` contexts from the same seeds; one batched chunk must agree
   with its plain version; ``run_resident`` over 8 items must be
   bit-identical to per-request dispatch.  It prints the latency split,
   the aggregate rate, K7's time against its bound, and the share of a
   request spent in the per-chunk ``extract_snapshot`` host copies (from
   the span trace, ``YT_TRACE``);
6. the pipeline path: the RTM chain (``rtm_chain``: forward step →
   imaging condition → smoothing) merged by ``SolutionPipeline`` and run
   ``-mode fused -wf_steps 1`` with ``prepare(fuse=True)``, one launch of
   K6 (the multi-stage kernel, the image pushed: it never leaves shared
   memory) per step.  (a) K6 against its plain version (``-mode torch``
   on the same merged program) from one numpy-seeded state: the pure
   (push) and accumulating chains at a ragged 67×45×131 and the pure r=8
   chain at 64³ (the shared-memory ladder steps down), 4 steps, one
   launch each; (b) the push and ``-push off`` fused arms against the
   host-chained arm (one K1 per stage under ``-no-skew``, bindings copied
   through the host) at 96³, ``compare == 0``; (c) the path at full size:
   r=2, 512³ fp32, ``fwd.pressure`` seeded in every ring slot from
   ``RandomState(7)`` (and ``fwd.vel``), 2 warm-up steps, then 3 trials
   of 20 steps with the counters zeroed just before (60 K6 launches and
   no other), for
   the push arm and the ``-push off`` arm, each against its bound (20
   and 24 B per point), then ``end()``;
7. the trapezoid path: ``-mode fused -wf_steps K -trapezoid``, where each
   group of K steps is one launch of K4's phase 1 (K levels per tile in
   one launch) plus one diamond launch per trapezoid dim, the remainder
   steps on K1 (every context of the phase runs ``-no-skew``).  (a)
   Forced (``trap_ctx(force=True)``) on small ragged grids, each with at
   least three tile boundaries in every trapezoid dim and a
   remainder group: iso3dfd r=2 K=4 and K=3, cube r=1 K=4,
   iso3dfd_sponge r=2 K=2 and the 2-D wave2d r=8 K=2.  Each is held
   against its plain version on CUDA tensors (``-mode torch``; max |Δ|
   printed, 0 mismatches at ``field_epsilon``), bit-equal
   (``compare_data(epsilon=0)``) against the K1 path (``-no-trapezoid``
   at the same K), and its launch counts checked.  (b) The path at full
   width: iso3dfd r=2, 512³ fp32, ``-mode fused -wf_steps 4 -trapezoid``
   (forced where the gate rejects it; the line says which), 2 warm-up
   groups, then 3 trials of 20 steps with the counters zeroed just before
   (15 phase-1 and 30 diamond launches, no K1); ms/step, points/s and the
   share of the 5 B/pt/step bound; each pass's time per launch with CUDA
   events; one group against its plain version; the same run with
   ``-no-trapezoid`` (K1, 4 launches per group) beside it;
8. the distributed path: ``-mode shard_pallas`` over an env of four (or
   eight) shards on ``cuda:0`` (``new_env(devices=["cuda:0"] * 4)``), each
   shard with tensors of its own: one exchange of ghost slabs between the
   shards' tensors per group of K steps, then K sub-steps of K5 (the
   per-shard region kernel) per shard.  (a) Small cases: iso3dfd r=8 at
   96³ on x=2·y=2 with K=1 and K=2 (overlap off, on, and on with
   ``-coalesce on``), iso3dfd_sponge r=2 on x=4 at K=2 (overlap auto,
   which declines on one card, ``-coalesce off``) and cube r=1 on x=2·y=2·z=2 at K=1 (8 shards, the
   minor dim sharded), 5 steps each.  Each is held against K5's plain
   version (``plain_shard_step`` in place of the kernel on the same CUDA
   tensors; max |Δ| printed, 0 mismatches at ``field_epsilon``), is
   bit-equal (``compare_data(epsilon=0)``) to the single-domain ``-mode
   fused`` run (K1) at the same K, overlap on and off and coalesce on and
   off are bit-equal, and K5 launches exactly shards × sub-steps × (1, or
   1 + shells in an overlapped group).  (b) The path at full width: iso3dfd
   r=8, 512³ fp32, ``-mode shard_pallas -wf_steps 2 -nr_x 2 -nr_y 2``,
   four 256×256×512 shards, phase 4's seed state, every auto gate (on one
   card the overlap and the packed exchange decline); 2 warm-up groups,
   then 3 trials of 20 steps with every counter zeroed just before (only
   K5 may launch): ms/step, points/s, whether the overlap engaged and why,
   K5's ms per launch (CUDA events) against its bound (each input once
   over the box grown by its reach and clipped to the global domain, each
   output once over the box) and its plain version's, the exchange's ms
   per group (CUDA events around each ``exchange_newest`` of one more run,
   outside the counted window), the share of the step's bound (16 B/pt
   plus the exchanged bytes), and phase 4's K1 ms/step beside it; the same
   runs with ``-overlap_x on`` and with ``-coalesce on`` from the same
   seeded state, each bit-equal to the main path after the same steps
   (compared on the card); one group against ``-mode shard_map`` (the
   per-shard torch step) from the same state, compared on the card;
9. the families path: K6's scratch arm (scratch vars computed in
   sub-stages over the block grown by their write halo, past the domain
   too) and rewrite arm (a var a later stage rewrites, a tile per writing
   stage).  (a) Each solution they open, and ssg and fsg, on a small
   ragged grid (three tile boundaries per slot and a partial last tile),
   K ∈ {1, 2}, 5 steps, ``-mode fused`` against ``-mode torch`` on CUDA
   tensors from one state seeded in a physical range (``seed_physical``):
   0 mismatches at ``field_epsilon``, the cells whose bits differ
   counted, finite states, 5 K6 launches and no other; (b) tti r=2 and
   awp against the numpy oracle at 32³ for 2 steps; (c) tti r=2 (the
   scratch arm) and awp (the rewrite arm) at 512³ fp32 ``-mode fused
   -wf_steps 2``: 2 warm-up steps, then 3 trials of 20 steps with the
   counters zeroed just before (60 K6 launches and no other), ms/step,
   points/s, K6's ms per launch (CUDA events) against the bound from the
   program (each input whose values can reach an output read once, as
   ``live_inputs`` finds them, each output written once, or its FLOP
   count, whichever is larger), the staged and computed cells per point
   of K6's block, the plain version's time, one 2-step chunk against it
   from the same state, and K6 at the ladder's next two smaller tiles
   (ms per launch and cells per point; the same bits required);
10. the misc, partial-dim and element-size-2 arms (ROADMAP.md A3): misc
   axes (each misc slice an input or output of its own, misc indices as
   per-equation constants, the unwritten slices of a var kept by a copy
   of its evicted slot, ``copy_base``), written vars lacking a domain dim
   (stride 0, the slab stored by the blocks at index 0), and bfloat16
   storage (computed in float, each op rounded once; the stream arm fills
   its rings with aligned pairs).  (a) On small ragged grids (three tile
   boundaries per slot, a partial last tile) box r=1 and gaussian r=2 (3
   channels, K6), test_misc_2d (K1), test_misc_value_2d and
   test_step_cond_1d (K6), the partial-dim solutions of
   ``tests/test_pallas.py`` built with the port's DSL (partial_written at
   K ∈ {1, 2, 3}, partial_written_cond, scratch_partial), and iso3dfd
   r=2, r=8 and 3axis r=1 at element size 2 under ``-skew`` and
   ``-no-skew``: K ∈ {1, 2}, 5 steps, ``-mode fused`` against ``-mode
   torch`` on CUDA tensors from one numpy-seeded state, 0 mismatches at
   ``field_epsilon`` 1e-4 (1e-2 at element size 2, an ulp of bfloat16),
   the cells whose bits differ counted, the expected launches and no
   other, the two arms bit-equal at element size 2; (b) each against the
   numpy oracle at 24x24x25 for 2 steps (``compare_data``'s defaults;
   (3e-2, 3e-2) at element size 2); (c) at full width: gaussian r=2 on
   one 8192x8192 image of 3 channels, fp32, ``-wf_steps 1`` (K6, 3
   stages) with ``conv2d(groups=3)`` timed beside it as the yardstick and
   held against it; iso3dfd r=8 at 512³ in bfloat16, ``-wf_steps 2``,
   the stream arm and then ``-no-skew`` (K1) from the same seed, bit-equal;
   each 2 warm-up steps, then 3 trials of 20 steps with the counters
   zeroed just before, ms/step, points/s, the kernel's ms per launch
   against its bound (each input slice read once, each output slice
   written once), the plain version's time, one chunk against it and the
   peak memory; and test_misc_2d at 2048² and partial_written at 512³
   for one trial of 10 steps, timed the same way;
11. the last A3 arms (ROADMAP.md A3): more than three domain dims on K1
   and K6 (the outer dim folded into the grid, a read at an outer offset
   an input of its own, K6's outer copies of the sub-stages a later
   stage reads at outer offsets) and K6 at element size 2 (its staged,
   stage and scratch tiles in bfloat16).  (a) On small ragged grids (three
   tile boundaries per slot and a partial last tile; 5 in the outer dim)
   test_4d (K1), ``four_d_stages`` (K6: a scratch var read at outer
   offsets, a domain condition on the outer dim, a second stage reading
   the first at outer offsets; built with the port's DSL) and, at element
   size 2, tti r=2 (scratch), ssg (2 stages), awp (4 stages, rewrites) and
   gaussian r=2 (misc): K ∈ {1, 2}, 5 steps, ``-mode fused`` against
   ``-mode torch`` on CUDA tensors from one state seeded in a physical
   range, 0 mismatches at ``field_epsilon`` 1e-4 (1e-2 at element size
   2), the cells whose bits differ counted, the expected launches and no
   other; (b) each against the numpy oracle at 24x24x25 (the 4-D ones at
   12⁴) for 2 steps (``compare_data``'s defaults, (3e-2, 3e-2) at
   element size 2); (c) at full width, each through the user's entry
   points with 2 warm-up steps and the counters zeroed just before the
   trials: test_4d at 128⁴ fp32 ``-wf_steps 2`` (K1; the stream arm
   ``skew_ineligible``), 3 trials of 20 steps; four_d_stages at 128⁴ fp32
   (K6), one trial of 10; tti r=2 at 512³ in bfloat16 ``-wf_steps 2``
   (K6 with scratch sub-stages), 3 trials of 20, beside phase 9 (c)'s
   fp32 tti of the same run and seed: ms/step, points/s, the kernel's ms
   per launch against its bound, the plain version's time, one chunk
   against it and the peak memory.

It prints the measurements, the card line, one ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Nothing of JAX or of
the ``yask_tpu`` package is imported.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): device memory and fp32 non-tensor.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FIELD_EPS = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0].strip()


def make_ctx(fac, env, stencil, radius, g, mode, wf=1, cli=""):
    ctx = fac.new_solution(env, stencil=stencil, radius=radius)
    ctx.apply_command_line_options(
        f"-g {g} -mode {mode} -wf_steps {wf} {cli}")
    ctx.prepare_solution()
    return ctx


#: The two arms of K1: the stream arm (``-skew``, the default) and K1's
#: 3-D tiles (``-no-skew``), with the counter each launch bumps.
ARMS = (("stream_step", "-skew"), ("fused_step", "-no-skew"))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter."""
    from yask_tpu_torch.ops import fused_stencil as fs
    return {"fused_step": fs.fused_step.launches,
            "stream_step": fs.stream_step.launches,
            "batched_step": fs.batched_step.launches,
            "stages_step": fs.stages_step.launches,
            "shard_step": fs.shard_step.launches,
            "trapezoid_phase1": fs.trapezoid_chunk.phase1_launches,
            "trapezoid_diamond": fs.trapezoid_chunk.diamond_launches,
            "copy_base": fs.copy_base.launches}


def zero_launch_counts() -> None:
    from yask_tpu_torch.ops import fused_stencil as fs
    for w in (fs.fused_step, fs.stream_step, fs.batched_step,
              fs.stages_step, fs.shard_step, fs.copy_base):
        w.launches = 0
    fs.trapezoid_chunk.phase1_launches = 0
    fs.trapezoid_chunk.diamond_launches = 0


def ptxas_summary(log_text: str) -> str:
    """Registers and spills per kernel from nvcc's ``-Xptxas -v``."""
    names = (("stream_step_kernel", "stream arm"), ("fused_region_kernel",
             "K5"), ("fused_step_kernelI4SpecLb1", "K7"),
             ("fused_step_kernelI4SpecLb0", "K1"),
             ("fused_stages_kernel", "K6"), ("trapezoid_kernel", "K4 phase 1"),
             ("diamond_kernel", "K4 diamond"))
    out, cur = [], None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            cur = next((label for key, label in names if key in ln), "?")
        elif cur and ("registers" in ln or "spill" in ln):
            out.append(f"{cur}: {ln.split(':', 1)[-1].strip()}")
    return " | ".join(out)


def seed_slices(ctx, seed: int):
    """The numpy-seeded random interior state of :func:`seed_random`, as
    ``(var, values, first, last)`` slices: written vars uniform in
    [0, 1), read-only coefficients 0.05 + 0.01·U (a stable wave speed)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for name in sorted(ctx.get_var_names()):
        v = ctx.get_var(name)
        dd = v.get_domain_dim_names()
        sizes = [ctx.get_overall_domain_size(d) for d in dd]
        steps = [None]
        if v.get_step_dim_name():
            steps = list(range(v.get_first_valid_step_index(),
                               v.get_last_valid_step_index() + 1))
        for t in steps:
            vals = rng.rand(*sizes)
            if name not in written:
                vals = 0.05 + 0.01 * vals
            first = ([t] if t is not None else []) + [0] * len(dd)
            last = ([t] if t is not None else []) + [s - 1 for s in sizes]
            yield name, vals.astype(np.float32), first, last


def seed_random(ctx, seed: int) -> None:
    """A numpy-seeded random interior state through the yk_var slice
    API."""
    for name, vals, first, last in list(seed_slices(ctx, seed)):
        ctx.get_var(name).set_elements_in_slice(vals, first, last)


def max_abs_diff(a, b) -> float:
    """Largest |Δ| over the interiors of two contexts' common vars."""
    import numpy as np
    from yask_tpu_torch.transfer import export_interiors
    xa, xb = export_interiors(a), export_interiors(b)
    return max(float(np.abs(x.astype(np.float64) - y).max())
               for n in xa for x, y in zip(xa[n], xb[n]))


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA
    events around the batch, after one warm call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase2(fac, env, cases, g: int = 64) -> None:
    """Each arm of K1 against its plain version, and the arms against each
    other (see the module docstring)."""
    for st, r in cases.items():
        for K in (1, 2):
            steps = 5
            plain = make_ctx(fac, env, st, r, g, "torch", K)
            seed_random(plain, 7)
            plain.run_solution(0, steps - 1)
            arms = {}
            for arm, cli in ARMS:
                fused = make_ctx(fac, env, st, r, g, "fused", K, cli)
                seed_random(fused, 7)
                c0 = launch_counts()
                fused.run_solution(0, steps - 1)
                got = {k: v - c0[k] for k, v in launch_counts().items()
                       if v != c0[k]}
                bad = fused.compare_data(plain, field_epsilon=FIELD_EPS)
                d = max_abs_diff(fused, plain)
                log(f"phase 2: {st} r={r} g={g} K={K} {steps} steps {cli}: "
                    f"fused vs torch max|d|={d:.3e} mismatches={bad} "
                    f"(field_epsilon={FIELD_EPS}), launches {got}")
                if bad:
                    raise RuntimeError(f"phase 2: {st} K={K} {cli}: {bad} "
                                       "mismatches")
                if got != {arm: steps}:
                    raise RuntimeError(
                        f"phase 2: {st} K={K} {cli}: launches {got}, "
                        f"expected {{{arm!r}: {steps}}}")
                arms[arm] = fused
            bad = arms["stream_step"].compare_data(
                arms["fused_step"], epsilon=0.0, abs_epsilon=0.0)
            log(f"phase 2: {st} r={r} g={g} K={K}: stream arm vs K1 "
                f"compare_data(epsilon=0) = {bad}")
            if bad:
                raise RuntimeError(f"phase 2: {st} K={K}: the stream arm is "
                                   "not bit-equal to K1")
            del arms


def phase3(fac, env, cases, g: int = 32) -> None:
    """Both arms of K1 against the numpy oracle (see the module
    docstring)."""
    from yask_tpu_torch.runtime.init_utils import init_solution_vars
    for st, r in cases.items():
        ref = make_ctx(fac, env, st, r, g, "ref")
        init_solution_vars(ref)
        ref.run_solution(0, 1)
        for _arm, cli in ARMS:
            fused = make_ctx(fac, env, st, r, g, "fused", 1, cli)
            init_solution_vars(fused)
            fused.run_solution(0, 1)
            bad = fused.compare_data(ref)
            log(f"phase 3: {st} r={r} g={g} 2 steps {cli}: fused vs ref "
                f"max|d|={max_abs_diff(fused, ref):.3e} mismatches={bad} "
                "(compare_data defaults)")
            if bad:
                raise RuntimeError(f"phase 3: {st} {cli}: {bad} mismatches "
                                   "vs ref")


def arm_run(fac, env, r: int, g: int, cli: str, warm: int, trials: int,
            steps: int, seed: int = 11):
    """One run of iso3dfd radius ``r`` at ``g``³ fp32, ``-mode fused
    -wf_steps 2`` plus ``cli``, through the user's entry points, from a
    numpy-seeded state: a warm-up, then ``trials`` runs of ``steps``
    steps, every launch counter zeroed just before and read just after.
    Returns the context, the next step, the sorted rates and the counts
    that moved."""
    import torch
    zero_launch_counts()
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=r)
    ctx.apply_command_line_options(f"-g {g} -mode fused -wf_steps 2 {cli}")
    ctx.prepare_solution()
    seed_random(ctx, seed)
    ctx.run_solution(0, warm - 1)
    t = warm
    rates = []
    for _ in range(trials):
        ctx.clear_stats()
        ctx.run_solution(t, t + steps - 1)
        t += steps
        rates.append(ctx.get_stats().get_pts_per_sec())
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    return ctx, t, sorted(rates), got


def phase4(fac, env, card: str, g: int = 512, warm: int = 2,
           trials: int = 3, steps: int = 20):
    """The main path at full width and K1's other arm beside it (see the
    module docstring); returns the main path's ms/step and the ``kernels``
    entries of K1 and of its stream arm."""
    import numpy as np
    import torch
    from yask_tpu_torch.ops.fused_stencil import (fused_step, plain_chunk,
                                                  stream_step)
    wrappers = {"fused_step": fused_step, "stream_step": stream_step}
    npts = g ** 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    # the main path takes -skew's default; then -no-skew from the same seed
    for arm, cli in (("stream_step", ""), ("fused_step", "-no-skew")):
        ctx, t, rates, got = arm_run(fac, env, 8, g, cli, warm, trials,
                                     steps)
        til = ctx.get_stats().get_tiling()
        if got != {arm: warm + trials * steps} or til["kernel"] != arm:
            raise RuntimeError(f"phase 4 {cli or '(default)'}: launches "
                               f"{got}, arm {til['kernel']}; expected "
                               f"{warm + trials * steps} of {arm}")
        out = ctx.get_var("pressure").get_elements_in_slice(
            [t, 0, 0, 0], [t, g - 1, g - 1, g - 1])
        if out.shape != (g, g, g) or not np.isfinite(out).all() \
                or not np.abs(out).max() > 0:
            raise RuntimeError("phase 4: pressure is not finite and "
                               "nonzero")
        del out
        mid = rates[len(rates) // 2]
        step_ms = npts / mid * 1e3
        log(f"phase 4: iso3dfd r=8 g={g} fp32 -mode fused -wf_steps 2 "
            f"{cli or '(the main path; -skew by default)'}: {trials} trials "
            f"x {steps} steps: mid {mid:.4e} points/s ({mid / 1e9:.3f} "
            f"GPts/s), {step_ms:.3f} ms/step (min "
            f"{npts / rates[-1] * 1e3:.3f}, max {npts / rates[0] * 1e3:.3f})"
            f"; launches in the window {got} ({warm} warm-up + "
            f"{trials}x{steps} steps, 1 per step); tiling: kernel "
            f"{til['kernel']}, tile {til['tile']}, smem {til['smem_bytes']} "
            f"B, skew {til['skew_reasons'][0]}")
        runs[arm] = {"ctx": ctx, "t": t, "step_ms": step_ms,
                     "launches": got[arm]}
    log(f"phase 4: torch.cuda.max_memory_allocated() = "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (both arms)")
    d, bad = device_diff(runs["stream_step"]["ctx"], runs["fused_step"]["ctx"],
                         exact=True)
    log(f"phase 4: after {runs['fused_step']['t']} steps from the same seed: "
        f"stream arm vs K1: {bad} cells differ (max|d|={d:.3e})")
    if bad:
        raise RuntimeError("phase 4: the stream arm and K1 differ at 512^3")

    # the bound: each input read once, each output written once, interior
    ctx = runs["fused_step"]["ctx"]
    ops_pp = ctx._ana.counters.num_ops
    prog = ctx._program
    spec = ctx._fused.spec
    bytes_step = 4 * npts * (len(spec.inputs) + len(spec.outputs))
    bytes_ms = bytes_step / HBM_BYTES_PER_S * 1e3
    flops_ms = ops_pp * npts / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    log(f"phase 4: bound {bound_ms:.3f} ms/step ({bound_by}: "
        f"{bytes_step / npts:.0f} B/pt -> {bytes_ms:.3f} ms at 3.35 TB/s; "
        f"{ops_pp} FLOP/pt -> {flops_ms:.3f} ms at 67 TFLOP/s fp32); share "
        f"of bound: stream arm {bound_ms / runs['stream_step']['step_ms']:.3f}"
        f", K1 {bound_ms / runs['fused_step']['step_ms']:.3f}")

    # outside the counted windows: per-launch times on the main path's
    # shapes, and one chunk of each arm against the plain version
    state = ctx._state
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, runs["fused_step"]
                                           ["t"], 2), 3) / 2
    entries = {}
    for arm, run in runs.items():
        kern, state, t = run["ctx"]._fused, run["ctx"]._state, run["t"]
        ms = cuda_ms(lambda: wrappers[arm](kern, state, t), 10)
        a = kern.chunk(dict(state), t, 2)
        b = plain_chunk(prog, dict(state), t, 2)
        err = max(float((x - y).abs().max()) for n in a
                  for x, y in zip(a[n], b[n]))
        scale = max(float(x.abs().max()) for n in b for x in b[n])
        del a, b
        log(f"phase 4: {arm}: one 2-step chunk at {g}^3 vs plain: max|d|="
            f"{err:.3e} (field max {scale:.3e}; tolerance field_epsilon "
            f"{FIELD_EPS} x field max); {ms:.3f} ms/launch (CUDA events, "
            f"{'the zero-filled' if arm == 'fused_step' else 'an empty'} "
            f"output included), share of bound {bound_ms / ms:.3f}; plain "
            f"version {plain_ms:.3f} ms/step [{card}]")
        if not err <= FIELD_EPS * scale:
            raise RuntimeError(f"phase 4: {arm} and its plain version "
                               "disagree")
        entries[arm] = {
            "name": arm, "route": "cuda", "launches": run["launches"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"launch, iso3dfd r=8 {g}^3 fp32",
            "step_ms": run["step_ms"]}
    entries["fused_step"].update(
        source="yask_tpu_torch/csrc/fused_step.cuh",
        replaces="yask_tpu/ops/pallas_stencil.py:2312",
        path="phase 4, -no-skew")
    entries["stream_step"].update(
        source="yask_tpu_torch/csrc/stream_step.cuh",
        replaces="yask_tpu/ops/pallas_stencil.py:1445 (K2: gate :1445-1502, "
                 "in_dmas/out_dmas :1668-1813, prefetch/retire :1815-1854; "
                 "K3: skew_* :306-441, carry_shape :1337, carry patch "
                 ":1955-2056)",
        path="phase 4, the main path")
    main_ms = runs["stream_step"]["step_ms"]
    del runs, ctx, state, kern

    torch_ctx = fac.new_solution(env, stencil="iso3dfd", radius=8)
    torch_ctx.apply_command_line_options(f"-g {g} -mode torch -wf_steps 2")
    torch_ctx.prepare_solution()
    seed_random(torch_ctx, 11)
    torch_ctx.run_solution(0, warm - 1)
    torch_ctx.clear_stats()
    torch_ctx.run_solution(warm, warm + steps - 1)
    tr = torch_ctx.get_stats().get_pts_per_sec()
    log(f"phase 4: -mode torch (the plain version, not a yardstick): "
        f"{tr:.4e} points/s, {npts / tr * 1e3:.3f} ms/step over {steps} "
        "steps")
    del torch_ctx
    torch.cuda.empty_cache()

    # iso3dfd r=2 at 512^3, both arms (the same 16 B/pt bound)
    r2 = {}
    for arm, cli in ARMS:
        ctx, t, rates, got = arm_run(fac, env, 2, g, cli, warm, trials,
                                     steps)
        if got != {arm: warm + trials * steps}:
            raise RuntimeError(f"phase 4: r=2 {cli}: launches {got}")
        step_ms = npts / rates[len(rates) // 2] * 1e3
        kern, state = ctx._fused, ctx._state
        ms = cuda_ms(lambda: wrappers[arm](kern, state, t), 10)
        log(f"phase 4: iso3dfd r=2 g={g} fp32 -mode fused -wf_steps 2 {cli}:"
            f" {step_ms:.3f} ms/step (min {npts / rates[-1] * 1e3:.3f}, max "
            f"{npts / rates[0] * 1e3:.3f}), {arm} {ms:.3f} ms/launch, share "
            f"of bound {bound_ms / ms:.3f}; launches {got} [{card}]")
        entries[arm].update(r2_ms=ms, r2_step_ms=step_ms)
        r2[arm] = ctx
        del kern, state
    d, bad = device_diff(r2["stream_step"], r2["fused_step"], exact=True)
    log(f"phase 4: r=2 after {warm + trials * steps} steps: stream arm vs "
        f"K1: {bad} cells differ (max|d|={d:.3e})")
    if bad:
        raise RuntimeError("phase 4: r=2: the stream arm and K1 differ")
    del r2
    torch.cuda.empty_cache()
    return main_ms, entries["fused_step"], entries["stream_step"]


def phase5(fac, env, phase4_step_ms: float, g: int = 256) -> dict:
    """The serving path at full width (see the module docstring); returns
    K7's entry of the ``kernels`` line."""
    import tempfile
    import numpy as np
    import torch
    from yask_tpu_torch.obs.tracer import read_spans
    from yask_tpu_torch.ops.fused_stencil import (batched_step,
                                                  plain_batched_chunk)
    from yask_tpu_torch.serve import StencilServer
    from yask_tpu_torch.serve.resident import run_per_request
    from yask_tpu_torch.serve.scheduler import extract_outputs

    nses, steps, warm = 8, 20, 2
    npts = g ** 3
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="yt_chip_smoke_")
    trace_path = os.path.join(tmp, "TRACE_EVENTS.jsonl")
    os.environ["YT_TRACE"] = "1"
    os.environ["YT_TRACE_EVENTS"] = trace_path
    srv = StencilServer(env, journal_path=os.path.join(tmp, "SERVE.jsonl"),
                        window_secs=0.05, max_batch=nses)
    try:
        t0 = time.perf_counter()
        sids = [srv.open_session(stencil="iso3dfd", radius=8, g=g,
                                 mode="fused", wf=2, bucket=False)
                for _ in range(nses)]
        for i, sid in enumerate(sids):
            with srv.scheduler.session_ctx(sid) as c:
                slices = list(seed_slices(c, 100 + i))
            for name, vals, first, last in slices:
                srv.set_var_slice(sid, name, vals, first, last)
        log(f"phase 5: opened and seeded {nses} fused sessions of iso3dfd "
            f"r=8 at {g}^3 in {time.perf_counter() - t0:.1f} s")
        warm_rs = [srv.wait(h, timeout=600) for h in
                   [srv.submit_run(sid, 0, warm - 1) for sid in sids]]
        if not all(r.ok for r in warm_rs):
            raise RuntimeError(f"phase 5: warm-up failed: "
                               f"{[(r.status, r.error) for r in warm_rs]}")

        # the counted window: 8 requests of 20 steps, submitted together
        zero_launch_counts()
        with open(trace_path, "a"):
            pass
        span0 = len(read_spans(trace_path))
        t0 = time.perf_counter()
        handles = [srv.submit_run(sid, warm, warm + steps - 1)
                   for sid in sids]
        resps = [srv.wait(h, timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        moved = {k: v for k, v in launch_counts().items() if v}
        k7_launches = moved.pop("batched_step", 0)
        for r in resps:
            if not (r.ok and r.batch == nses and r.batched
                    and not r.degraded):
                raise RuntimeError(
                    f"phase 5: response {r.rid}: status {r.status}, batch "
                    f"{r.batch}, batched {r.batched}, degraded "
                    f"{r.degraded}, error {r.error!r}")
        if k7_launches != steps or moved:
            raise RuntimeError(
                f"phase 5: {k7_launches} K7 launches and {moved} others in "
                f"the served window, expected {steps} and none")
        log(f"phase 5: {nses} requests of {steps} steps: all ok at "
            f"occupancy {nses}, batched, none degraded; batched_step "
            f"launches {k7_launches}, no other kernel launched")

        spans = read_spans(trace_path)[span0:]

        def dur(name):
            return [sp["dur"] for sp in spans if sp["name"] == name]
        snap_s, ens_s = sum(dur("serve.snapshot")), sum(dur("ensemble.run"))
        q = sorted(r.queue_secs * 1e3 for r in resps)
        rn = sorted(r.run_secs * 1e3 for r in resps)
        tot = sorted((r.queue_secs + r.run_secs) * 1e3 for r in resps)

        def p(xs, f):
            return xs[min(len(xs) - 1, int(round(f * (len(xs) - 1))))]
        log(f"phase 5: latency ms: total p50 {p(tot, .5):.1f} p99 "
            f"{p(tot, .99):.1f}; queue p50 {p(q, .5):.1f} p99 "
            f"{p(q, .99):.1f}; run p50 {p(rn, .5):.1f} p99 {p(rn, .99):.1f}")
        rate = nses * npts * steps / wall
        log(f"phase 5: aggregate {rate:.4e} points/s ({rate / 1e9:.3f} "
            f"GPts/s) over the batch's wall time {wall:.3f} s (submit to "
            f"last answer, release included)")
        log(f"phase 5: ensemble run {ens_s * 1e3:.1f} ms = "
            f"{ens_s * 1e3 / steps:.3f} ms per batched step (stacking, "
            f"{steps} K7 launches, sync, unstacking) beside phase 4's K1 "
            f"{phase4_step_ms:.3f} ms per 512^3 step")
        log(f"phase 5: per-chunk extract_snapshot host copies "
            f"{snap_s * 1e3:.1f} ms = {snap_s * 1e3 / p(tot, .5):.3f} of "
            f"the p50 request total, {snap_s * 1e3 / p(rn, .5):.3f} of the "
            f"p50 run latency")

        # two members against solo -mode fused contexts from the same seeds
        for i in (0, nses - 1):
            solo = fac.new_solution(env, stencil="iso3dfd", radius=8)
            solo.apply_command_line_options(f"-g {g} -mode fused -wf_steps 2")
            solo.prepare_solution()
            seed_random(solo, 100 + i)
            solo.run_solution(0, warm - 1)
            solo.run_solution(warm, warm + steps - 1)
            want = extract_outputs(solo)
            d = max(float(np.abs(want[n].astype(np.float64)
                                 - resps[i].outputs[n]).max())
                    for n in want)
            log(f"phase 5: member {i} vs solo -mode fused: max|d|={d:.3e}")
            if d != 0.0:
                raise RuntimeError(f"phase 5: member {i} is not "
                                   "bit-identical to its solo run")
            del solo

        # one batched chunk against its plain version; K7's time
        sess = [srv.registry.session(sid) for sid in sids]
        ctx = sess[0].ctx
        kern = ctx._fused_kernel()
        prog = ctx._program
        state = {n: [torch.stack([s.run_state.state[n][k] for s in sess])
                     for k in range(len(sess[0].run_state.state[n]))]
                 for n in sess[0].run_state.state}
        t = warm + steps
        a = kern.batched_chunk(dict(state), t, 2, nses)
        b = plain_batched_chunk(prog, dict(state), t, 2, nses)
        err = max(float((x - y).abs().max()) for n in a
                  for x, y in zip(a[n], b[n]))
        scale = max(float(x.abs().max()) for n in b for x in b[n])
        log(f"phase 5: one 2-step K7 chunk over {nses} x {g}^3, kernel vs "
            f"plain: max|d|={err:.3e} (field max {scale:.3e}; tolerance "
            f"field_epsilon {FIELD_EPS} x field max)")
        if not err <= FIELD_EPS * scale:
            raise RuntimeError("phase 5: K7 and its plain version disagree")
        del a, b
        ms = cuda_ms(lambda: batched_step(kern, state, t, nses), 10)
        plain_ms = cuda_ms(lambda: plain_batched_chunk(prog, state, t, 1,
                                                       nses), 3)
        spec = kern.spec
        bytes_step = 4 * nses * npts * (len(spec.inputs) + len(spec.outputs))
        bytes_ms = bytes_step / HBM_BYTES_PER_S * 1e3
        flops_ms = ctx._ana.counters.num_ops * nses * npts \
            / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        log(f"phase 5: batched_step {ms:.3f} ms/launch over {nses} x {g}^3 "
            f"(zero-filled outputs included) against its bound "
            f"{bound_ms:.3f} ms ({bound_by}); share {bound_ms / ms:.3f}; "
            f"plain version {plain_ms:.3f} ms/step (not a yardstick)")
        del state

        # run_resident against per-request dispatch, from one snapshot
        snaps = {sid: srv.snapshot(sid) for sid in sids}
        items = [(sid, t, t + 1) for sid in sids]
        t0 = time.perf_counter()
        res = srv.scheduler.run_resident(items)
        res_s = time.perf_counter() - t0
        for sid in sids:
            if not srv.restore(sid, snaps[sid]):
                raise RuntimeError("phase 5: snapshot restore failed")
        t0 = time.perf_counter()
        base = run_per_request(srv.scheduler, items, timeout=600)
        per_s = time.perf_counter() - t0
        for sid in sids:
            for n, arr in res[sid]["outputs"].items():
                if not np.array_equal(arr, base[sid]["outputs"][n]):
                    raise RuntimeError(
                        f"phase 5: run_resident differs from per-request "
                        f"dispatch on {sid} var {n}")
        log(f"phase 5: run_resident over {len(items)} items of 2 steps is "
            f"bit-identical to per-request dispatch ({res_s:.3f} s vs "
            f"{per_s:.3f} s)")
        log(f"phase 5: torch.cuda.max_memory_allocated() = "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        srv.shutdown()
        os.environ.pop("YT_TRACE", None)
        os.environ.pop("YT_TRACE_EVENTS", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"name": "batched_step", "route": "cuda",
            "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "replaces": "yask_tpu/runtime/ensemble.py:234-345 → "
                        "yask_tpu/ops/pallas_stencil.py:2312",
            "launches": k7_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def rtm_pipe(env, cli: str, fuse, g, radius: int = 2,
             accumulate: bool = False):
    """The RTM chain (``rtm_chain``) as a prepared ``SolutionPipeline``
    over ``g = (x, y, z)``."""
    from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
    pipe = SolutionPipeline(env, *rtm_chain(radius=radius,
                                            accumulate=accumulate))
    pipe.apply_command_line_options(
        f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} {cli}")
    pipe.prepare(fuse=fuse)
    return pipe


def seed_chain(pipe, g, seed: int) -> None:
    """``fwd.pressure`` in every ring slot from ``RandomState(seed)`` as
    the reference's bench seeds it ((U − 0.5)·0.1), and ``fwd.vel`` =
    0.05 + 0.01·U from the same generator (zero would hide the
    Laplacian)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    arr = (rng.rand(*g).astype(np.float32) - 0.5) * 0.1
    v = pipe.get_var("fwd", "pressure")
    last = [n - 1 for n in g]
    for t in range(v.get_first_valid_step_index(),
                   v.get_last_valid_step_index() + 1):
        v.set_elements_in_slice(arr, [t, 0, 0, 0], [t] + last)
    del arr
    vel = (0.05 + 0.01 * rng.rand(*g)).astype(np.float32)
    pipe.get_var("fwd", "vel").set_elements_in_slice(vel, [0, 0, 0], last)


def pipe_diff(a, b):
    """(max |Δ|, field max) over every written var both pipelines expose
    (pushed vars left out), at every step valid in both rings."""
    import numpy as np
    skip = a.pushed_vars() | b.pushed_vars()
    err = scale = 0.0
    for s in a.stage_names:
        for vn in a.written_vars(s):
            if f"{s}__{vn}" in skip:
                continue
            va, vb = a.get_var(s, vn), b.get_var(s, vn)
            for t in range(max(va.get_first_valid_step_index(),
                               vb.get_first_valid_step_index()),
                           min(va.get_last_valid_step_index(),
                               vb.get_last_valid_step_index()) + 1):
                x = a._interior(s, vn, t).astype(np.float64)
                y = b._interior(s, vn, t).astype(np.float64)
                err = max(err, float(np.abs(x - y).max()))
                scale = max(scale, float(np.abs(x).max()),
                            float(np.abs(y).max()))
    return err, scale


def phase6(env, ragged=(67, 45, 131), ladder: int = 64, mid: int = 96,
           full: int = 512) -> dict:
    """The pipeline path: the merged RTM chain through K6 (see the module
    docstring; the sizes are its grids); returns K6's entry of the
    ``kernels`` line."""
    import numpy as np
    import torch
    from yask_tpu_torch.ops.fused_stencil import (fused_step, plain_chunk,
                                                  stages_step)

    # (a) K6 against its plain version (-mode torch runs StepProgram.step
    #     of the same merged program), ragged grid and the r=8 ladder
    worst = 0.0
    for acc, r, g in ((False, 2, ragged), (True, 2, ragged),
                      (False, 8, (ladder,) * 3)):
        fused = rtm_pipe(env, "-mode fused -wf_steps 1", True, g, r, acc)
        plain = rtm_pipe(env, "-mode torch -wf_steps 1", True, g, r, acc)
        want = set() if acc else {"img__img"}
        if fused.pushed_vars() != want:
            raise RuntimeError(f"phase 6: pushed {fused.pushed_vars()}, "
                               f"expected {want}")
        for p in (fused, plain):
            seed_chain(p, g, 7)
        n0 = stages_step.launches
        fused.run(0, 3)
        launched = stages_step.launches - n0
        plain.run(0, 3)
        err, scale = pipe_diff(fused, plain)
        worst = max(worst, err)
        spec = fused.fused_ctx._fused.spec
        log(f"phase 6: rtm chain r={r} {'accumulating' if acc else 'pure'}"
            f" {g[0]}x{g[1]}x{g[2]} 4 steps: K6 ({spec.name}, tile "
            f"{list(spec.tile)}, smem {spec.smem_bytes} B, pushed "
            f"{sorted(fused.pushed_vars())}) vs plain max|d|={err:.3e} "
            f"(field max {scale:.3e}), launches={launched}")
        if not err <= FIELD_EPS * scale:
            raise RuntimeError("phase 6: K6 and its plain version disagree")
        if launched != 4:
            raise RuntimeError(f"phase 6: {launched} K6 launches for 4 "
                               "steps")
        fused.end()
        plain.end()

    # (b) fused (push and no push) against host-chained (K1 per stage)
    g = (mid,) * 3
    arms = {"push": rtm_pipe(env, "-mode fused -wf_steps 1", True, g),
            "no push": rtm_pipe(env, "-mode fused -wf_steps 1 -push off",
                                True, g),
            "chained": rtm_pipe(env, "-mode fused -wf_steps 1 -no-skew",
                                False, g)}
    n1, n6 = fused_step.launches, stages_step.launches
    for p in arms.values():
        seed_chain(p, g, 7)
        p.run(0, 3)
    for name in ("push", "no push"):
        bad = arms[name].compare(arms["chained"])
        log(f"phase 6: fused ({name}) vs host-chained at {mid}^3, 4 "
            f"steps: "
            f"compare = {bad} (pushed {sorted(arms[name].pushed_vars())})")
        if bad:
            raise RuntimeError(f"phase 6: fused ({name}) differs from the "
                               "host-chained arm")
    if (fused_step.launches - n1, stages_step.launches - n6) != (12, 8):
        raise RuntimeError("phase 6: the arms did not launch K1 12 times "
                           "and K6 8 times")
    for p in arms.values():
        p.end()
    del arms

    # (c) the path at full size, push and -push off
    g = (full,) * 3
    npts = g[0] * g[1] * g[2]
    warm, trials, steps = 2, 3, 20
    entry = None
    for name, cli, pushed in (("push", "", {"img__img"}),
                              ("-push off", "-push off", set())):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True, g)
        if pipe.pushed_vars() != pushed:
            raise RuntimeError(f"phase 6: {name}: pushed "
                               f"{pipe.pushed_vars()}")
        seed_chain(pipe, g, 7)
        pipe.run(0, warm - 1)
        t = warm
        zero_launch_counts()
        secs = []
        for _ in range(trials):
            t0 = time.perf_counter()
            pipe.run(t, t + steps - 1)      # ends in a synchronize
            secs.append(time.perf_counter() - t0)
            t += steps
        moved = {k: v for k, v in launch_counts().items() if v}
        launches = moved.get("stages_step", 0)
        if moved != {"stages_step": trials * steps}:
            raise RuntimeError(
                f"phase 6: {name}: launches {moved} in the window, expected "
                f"{trials * steps} of K6 alone")
        peak = torch.cuda.max_memory_allocated()
        secs.sort()
        step_ms = secs[len(secs) // 2] / steps * 1e3
        sv = pipe.get_var("smooth", "smooth")
        ts = sv.get_last_valid_step_index()
        out = sv.get_elements_in_slice([ts, 0, 0, 0],
                                       [ts] + [n - 1 for n in g])
        if out.shape != g or not np.isfinite(out).all() \
                or not np.abs(out).max() > 0:
            raise RuntimeError(f"phase 6: {name}: smooth is not finite "
                               "and nonzero")
        del out
        ctx = pipe.fused_ctx
        kern, prog, state = ctx._fused, ctx._program, ctx._state
        spec = kern.spec
        ms = cuda_ms(lambda: stages_step(kern, state, t), 10)
        plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, 1), 3)
        a = kern.chunk(dict(state), t, 1)
        b = plain_chunk(prog, dict(state), t, 1)
        err = max(float((a[n][-1] - b[n][-1]).abs().max())
                  for n in spec.outputs)
        scale = max(float(b[n][-1].abs().max()) for n in spec.outputs)
        del a, b
        if not err <= FIELD_EPS * scale:
            raise RuntimeError(f"phase 6: {name}: K6 and its plain version "
                               f"disagree at {full}^3")
        bytes_pt = 4 * (len(spec.inputs) + len(spec.outputs))
        bytes_ms = bytes_pt * npts / HBM_BYTES_PER_S * 1e3
        flops_ms = ctx._ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        log(f"phase 6: rtm chain r=2 pure {full}^3 fp32 -mode fused "
            f"-wf_steps 1"
            f" ({name}, pushed {sorted(pushed)}): {trials} trials x {steps}"
            f" steps: {step_ms:.3f} ms/step (min {secs[0] / steps * 1e3:.3f},"
            f" max {secs[-1] / steps * 1e3:.3f}), "
            f"{npts / step_ms * 1e3:.4e} points/s; stages_step launches in "
            f"the window {launches}")
        log(f"phase 6: {name}: stages_step {ms:.3f} ms/launch (CUDA events, "
            f"zero-filled outputs included) against its bound "
            f"{bound_ms:.3f} ms ({bound_by}: {bytes_pt} B/pt -> "
            f"{bytes_ms:.3f} ms; {ctx._ana.counters.num_ops} FLOP/pt -> "
            f"{flops_ms:.3f} ms); share {bound_ms / ms:.3f} per launch, "
            f"{bound_ms / step_ms:.3f} per step; plain version "
            f"{plain_ms:.3f} ms/step (not a yardstick); one step kernel vs "
            f"plain max|d|={err:.3e} (field max {scale:.3e}); "
            f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB")
        if entry is None:
            entry = {"name": "stages_step", "route": "cuda",
                     "source": "yask_tpu_torch/csrc/fused_step.cuh",
                     "replaces": "yask_tpu/ops/pallas_stencil.py:2312 "
                                 "(push= arm)",
                     "launches": launches,
                     "max_abs_err": max(err, worst), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None}
        pipe.end()
        del pipe, ctx, kern, prog, state
        torch.cuda.empty_cache()
    return entry


#: Phase 7's small cases: (stencil, radius, sizes in solution-dim order,
#: K, steps, options).  Each trapezoid dim's block divides its span with at
#: least three tile boundaries; the ragged extent is the minor dim; steps %
#: K != 0.
TRAP_CASES = (("iso3dfd", 2, (48, 64, 131), 4, 10, ""),
              ("iso3dfd", 2, (48, 64, 131), 3, 8, ""),
              ("cube", 1, (40, 48, 67), 4, 9, ""),
              ("iso3dfd_sponge", 2, (48, 64, 67), 2, 5, ""),
              ("wave2d", 8, (96, 131), 2, 5, "-b_x 24"))


def trap_ctx(fac, env, stencil, radius, g, mode, K, cli="", force=False):
    """A prepared context over sizes ``g`` (solution-dim order).
    ``force`` makes its trapezoid request True: K4 past the gate, raising
    where it cannot run (``yask_tpu``'s ``build_pallas_chunk(trapezoid=
    True)``, which its CLI does not reach either)."""
    ctx = fac.new_solution(env, stencil=stencil, radius=radius)
    if force:
        ctx._trapezoid_arg = lambda: True
    sizes = " ".join(f"-g_{d} {n}"
                     for d, n in zip(ctx.get_domain_dim_names(), g))
    ctx.apply_command_line_options(
        f"{sizes} -mode {mode} -wf_steps {K} -no-skew {cli}")
    ctx.prepare_solution()
    return ctx


def trap_specs(fac, env, full: int = 512) -> dict:
    """Phase 7's kernel sources (K4 per case, K1 for the remainders), for
    phase 1's parallel build."""
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    specs = {}
    for st, r, g, K, _steps, cli in TRAP_CASES:
        ctx = trap_ctx(fac, env, st, r, g, "fused", K, f"-trapezoid {cli}",
                       force=True)
        specs[f"K4 {st} r={r} K={K}"] = ctx._trapezoid_kernel().spec
        specs[f"K1 {st} r={r}"] = FusedKernel(ctx._program).spec
        del ctx
    ctx = trap_ctx(fac, env, "iso3dfd", 2, (full,) * 3, "fused", 4,
                   "-trapezoid", force=True)
    specs[f"K4 iso3dfd r=2 K=4 {full}^3"] = ctx._trapezoid_kernel().spec
    return specs


def phase7(fac, env, card: str, full: int = 512, warm_groups: int = 2,
           trials: int = 3, steps: int = 20) -> dict:
    """The trapezoid path (see the module docstring); returns K4's entry
    of the ``kernels`` line."""
    import numpy as np
    import torch
    from yask_tpu_torch.ops.fused_stencil import (
        call_trapezoid_entry, fused_step, plain_chunk, stream_step,
        trapezoid_chunk)

    def counts():
        """K4's phase-1 and diamond launches, K1's, and the stream arm's
        (the phase runs -no-skew: always 0)."""
        return (trapezoid_chunk.phase1_launches,
                trapezoid_chunk.diamond_launches, fused_step.launches,
                stream_step.launches)

    # (a) small ragged grids, forced
    worst = 0.0
    for st, r, g, K, nsteps, cli in TRAP_CASES:
        ctxs = {"plain": trap_ctx(fac, env, st, r, g, "torch", K, cli),
                "k4": trap_ctx(fac, env, st, r, g, "fused", K,
                               f"-trapezoid {cli}", force=True),
                "k1": trap_ctx(fac, env, st, r, g, "fused", K,
                               f"-no-trapezoid {cli}")}
        for c in ctxs.values():
            seed_random(c, 7)
        c0 = counts()
        ctxs["k4"].run_solution(0, nsteps - 1)
        got = tuple(b - a for a, b in zip(c0, counts()))
        ctxs["k1"].run_solution(0, nsteps - 1)
        ctxs["plain"].run_solution(0, nsteps - 1)
        til = ctxs["k4"].get_stats().get_tiling()
        groups, rem = divmod(nsteps, K)
        want = (groups, groups * len(til["trap_dims"]), rem, 0)
        d = max_abs_diff(ctxs["k4"], ctxs["plain"])
        worst = max(worst, d)
        bad_plain = ctxs["k4"].compare_data(ctxs["plain"],
                                            field_epsilon=FIELD_EPS)
        bad_k1 = ctxs["k4"].compare_data(ctxs["k1"], epsilon=0.0,
                                         abs_epsilon=0.0)
        log(f"phase 7: {st} r={r} {'x'.join(map(str, g))} K={K} {nsteps} "
            f"steps: K4 trap_dims {til['trap_dims']} block {til['block']}, "
            f"nbounds {[dd['nbounds'] for dd in til['diamond']]}; vs plain "
            f"(-mode torch on the card) max|d|={d:.3e} mismatches="
            f"{bad_plain} (field_epsilon={FIELD_EPS}); vs K1 (-no-trapezoid)"
            f" compare_data(epsilon=0) = {bad_k1}; launches phase-1/"
            f"diamond/K1/stream {got}")
        if not til["trapezoid"] or rem == 0 \
                or min(dd["nbounds"] for dd in til["diamond"]) < 3:
            raise RuntimeError(f"phase 7: {st} K={K}: not a forced "
                               "trapezoid case with 3 boundaries and a "
                               "remainder")
        if bad_plain or bad_k1:
            raise RuntimeError(f"phase 7: {st} K={K}: K4 differs from its "
                               "plain version or from the K1 path")
        if got != want:
            raise RuntimeError(f"phase 7: {st} K={K}: launches {got}, "
                               f"expected {want}")
        del ctxs

    # (b) the path at full width, then the K1 arm beside it
    g, K = full, 4
    npts = g ** 3
    out = {}
    for arm, cli in (("K4", "-trapezoid"), ("K1", "-no-trapezoid")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctx = trap_ctx(fac, env, "iso3dfd", 2, (g,) * 3, "fused", K, cli)
        how = "-"
        if arm == "K4":
            how = "auto"
            if ctx._trapezoid_kernel() is None:
                reasons = ctx._trap[1]
                ctx._trapezoid_arg = lambda: True
                ctx.prepare_solution()
                how = f"forced (the gate: {reasons})"
        seed_random(ctx, 11)
        ctx.run_solution(0, warm_groups * K - 1)
        t = warm_groups * K
        c0 = counts()
        rates = []
        for _ in range(trials):
            ctx.clear_stats()
            ctx.run_solution(t, t + steps - 1)
            t += steps
            rates.append(ctx.get_stats().get_pts_per_sec())
        got = tuple(b - a for a, b in zip(c0, counts()))
        peak = torch.cuda.max_memory_allocated()
        til = ctx.get_stats().get_tiling()
        ngroups = trials * steps // K
        want = ((ngroups, 2 * ngroups, 0, 0) if arm == "K4"
                else (0, 0, trials * steps, 0))
        if got != want:
            raise RuntimeError(f"phase 7: {arm} at {g}^3: launches "
                               f"phase-1/diamond/K1/stream {got}, expected "
                               f"{want}")
        if arm == "K4" and not (til["trapezoid"] is True
                                and til["trap_dims"] == ["x", "y"]):
            raise RuntimeError(f"phase 7: tiling {til}")
        p = ctx.get_var("pressure").get_elements_in_slice(
            [t, 0, 0, 0], [t, g - 1, g - 1, g - 1])
        if p.shape != (g, g, g) or not np.isfinite(p).all() \
                or not np.abs(p).max() > 0:
            raise RuntimeError(f"phase 7: {arm}: pressure is not finite "
                               "and nonzero")
        del p
        rates.sort()
        mid = rates[len(rates) // 2]
        step_ms = npts / mid * 1e3
        out[arm] = step_ms
        log(f"phase 7: iso3dfd r=2 {g}^3 fp32 -mode fused -wf_steps {K} "
            f"{cli} ({arm}{', ' + how if arm == 'K4' else ''}): {trials} "
            f"trials x {steps} steps: {step_ms:.3f} ms/step (min "
            f"{npts / rates[-1] * 1e3:.3f}, max {npts / rates[0] * 1e3:.3f})"
            f", {mid:.4e} points/s; launches phase-1/diamond/K1/stream "
            f"{got}; "
            f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB "
            f"[{card}]")
        if arm == "K1":
            del ctx
            break
        log(f"phase 7: K4 tiling: block {til['block']}, passes "
            f"{til['passes']}, level buffers {til['level_buffers']}, "
            f"{til['threads']} threads, reasons {til['reasons']}")
        kern, prog, state = ctx._trap[0], ctx._program, ctx._state
        spec = kern.spec
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.empty(tuple(prog.geoms[n].shape), dtype=kern.dtype,
                            device=ins[0].device) for n in spec.outputs]
        stream = torch.cuda.current_stream().cuda_stream
        pass_ms = []
        for pas in range(len(spec.trap["passes"])):
            pass_ms.append(cuda_ms(lambda: call_trapezoid_entry(
                kern.fn, prog, spec, ins, outs, pas, t, stream), 10))
        del outs
        ms = cuda_ms(lambda: trapezoid_chunk(kern, state, t, K), 10)
        plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, K), 3)
        a = kern.chunk(dict(state), t, K)
        b = plain_chunk(prog, dict(state), t, K)
        err = max(float((x - y).abs().max()) for n in a
                  for x, y in zip(a[n], b[n]))
        scale = max(float(x.abs().max()) for n in b for x in b[n])
        del a, b
        if not err <= FIELD_EPS * scale:
            raise RuntimeError("phase 7: K4 and its plain version disagree "
                               f"at {g}^3")
        bytes_pt = 4 * (len(spec.inputs) + len(spec.outputs))
        bytes_ms = bytes_pt * npts / HBM_BYTES_PER_S * 1e3
        flops_ms = ctx._ana.counters.num_ops * npts * K \
            / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        cells = sum(pp["computed_cells"] for pp in til["passes"])
        log(f"phase 7: K4 per group of {K} steps: {ms:.3f} ms (phase 1 "
            f"{pass_ms[0]:.3f} ms/launch, diamonds "
            f"{', '.join(f'{x:.3f}' for x in pass_ms[1:])} ms/launch; "
            f"fresh outputs and pad re-zero included in the group) against "
            f"its bound {bound_ms:.3f} ms ({bound_by}: {bytes_pt} B/pt per "
            f"group = {bytes_pt / K:.1f} B/pt/step -> {bytes_ms:.3f} ms; "
            f"{ctx._ana.counters.num_ops * K} FLOP/pt -> {flops_ms:.3f} ms);"
            f" share {bound_ms / ms:.3f} per group, "
            f"{bound_ms / K / step_ms:.3f} per step; computed cells "
            f"{cells / (K * npts):.3f} x the useful; plain version "
            f"{plain_ms:.3f} ms/group (not a yardstick); one group vs plain "
            f"max|d|={err:.3e} (field max {scale:.3e}) [{card}]")
        entry = {"name": "trapezoid_chunk", "route": "cuda",
                 "source": "yask_tpu_torch/csrc/trapezoid.cuh",
                 "replaces": "yask_tpu/ops/pallas_stencil.py:2312 "
                             "(trapezoid arm: :812-930, :1514-1553, "
                             ":1725-1752, :2372-2416)",
                 "launches": got[0] + got[1],
                 "max_abs_err": max(err, worst), "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "per": f"group of {K} steps ({len(pass_ms)} launches)",
                 "phase1_ms": pass_ms[0], "diamond_ms": pass_ms[1:],
                 "trapezoid": how}
        del ctx, kern, prog, state, ins
    log(f"phase 7: K4 {out['K4']:.3f} ms/step vs K1 {out['K1']:.3f} ms/step "
        f"at {g}^3 [{card}]")
    return entry


#: Phase 8 (a): label, stencil, radius, global size, mesh, K, options.
SHARD_CASES = (
    ("iso3dfd r=8 K=1", "iso3dfd", 8, 96, (("x", 2), ("y", 2)), 1, ""),
    ("iso3dfd r=8 K=2 overlap off", "iso3dfd", 8, 96, (("x", 2), ("y", 2)),
     2, "-overlap_x off"),
    ("iso3dfd r=8 K=2 overlap on", "iso3dfd", 8, 96, (("x", 2), ("y", 2)),
     2, "-overlap_x on -coalesce off"),
    ("iso3dfd r=8 K=2 overlap on coalesce on", "iso3dfd", 8, 96,
     (("x", 2), ("y", 2)), 2, "-overlap_x on -coalesce on"),
    ("iso3dfd_sponge r=2 x=4 K=2", "iso3dfd_sponge", 2, 96, (("x", 4),), 2,
     "-coalesce off"),
    ("cube r=1 x=2 y=2 z=2 K=1", "cube", 1, 48,
     (("x", 2), ("y", 2), ("z", 2)), 1, "-coalesce on"),
)


def shard_ctx(fac, devices, stencil, radius, g, mode, K, ranks=(), cli=""):
    """A prepared context over ``devices`` (repeats allowed) with the
    rank grid ``ranks``."""
    ctx = fac.new_solution(fac.new_env(devices=devices), stencil=stencil,
                           radius=radius)
    nr = " ".join(f"-nr_{d} {n}" for d, n in ranks)
    ctx.apply_command_line_options(
        f"-g {g} -mode {mode} -wf_steps {K} {nr} {cli}")
    ctx.prepare_solution()
    return ctx


def shard_specs(fac, dev: str = "cuda:0") -> dict:
    """Phase 8's kernel sources (K5 shares each solution's library with
    K1 and K7), for phase 1's parallel build."""
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    specs = {}
    for label, st, r, g, ranks, K, cli in SHARD_CASES + (
            ("iso3dfd r=8 512^3", "iso3dfd", 8, 512, (("x", 2), ("y", 2)),
             2, ""),):
        n = 1
        for _d, k in ranks:
            n *= k
        ctx = shard_ctx(fac, [dev] * n, st, r, g, "shard_pallas", K, ranks,
                        cli)
        specs[f"K5 {label}"] = shard_pallas_plan(ctx).kernel.spec
        del ctx
    return specs


def k5_launches(shards: int, n: int, K: int, overlap: bool,
                shells: int) -> int:
    """K5 launches of one shard_pallas run of ``n`` steps: every shard,
    every sub-step, and in an overlapped group after the first (of two
    steps or more) the core and each shell chain."""
    groups, rem = divmod(n, K)
    total = 0
    for gi in range(groups + (1 if rem else 0)):
        gk = K if gi < groups else rem
        split = overlap and gi > 0 and gk >= 2
        total += shards * gk * (1 + shells if split else 1)
    return total


def box_bytes(kern, box, off) -> int:
    """Bytes one K5 launch over ``box`` of the shard with global origin
    ``off`` must move: each input read once over the box grown by its
    reach and clipped to the global domain (outside it the pads hold
    zeros that need no reading; inside it, past the shard's interior, lie
    the cells exchanged from its neighbours), each output written once
    over the box."""
    import numpy as np
    prog, spec = kern.program, kern.spec
    dims = list(prog.ana.domain_dims)
    slot = {d: 3 - len(dims) + i for i, d in enumerate(dims)}
    esize = np.dtype(prog.dtype).itemsize

    def cells(name, reach):
        c = 1
        for d in prog.geoms[name].domain_dims:
            lo, hi = reach[slot[d]]
            a = max(box[d][0] - lo, -off[d])
            b = min(box[d][1] + hi, prog.global_last[d] + 1 - off[d])
            c *= max(b - a, 0)
        return c

    def whole(name):
        c = 1
        for d in prog.geoms[name].domain_dims:
            c *= box[d][1] - box[d][0]
        return c
    total = sum(cells(n, spec.reach[a])
                for a, (n, _s) in enumerate(spec.inputs))
    total += sum(whole(n) for n in spec.outputs)
    return esize * total


def phase8a(fac, dev: str = "cuda:0", cases=SHARD_CASES) -> float:
    """Phase 8 (a): the small cases (see the module docstring); returns
    the largest |Δ| against K5's plain version."""
    from yask_tpu_torch.ops import fused_stencil
    from yask_tpu_torch.ops.fused_stencil import (plain_shard_step,
                                                  shard_step)
    nsteps = 5
    worst = 0.0
    arms = {}
    for label, st, r, g, ranks, K, cli in cases:
        S = 1
        for _d, n in ranks:
            S *= n
        ctx = shard_ctx(fac, [dev] * S, st, r, g, "shard_pallas", K,
                        ranks, cli)
        plain = shard_ctx(fac, [dev] * S, st, r, g, "shard_pallas", K,
                          ranks, cli)
        k1 = shard_ctx(fac, [dev], st, r, g, "fused", K)
        for c in (ctx, plain, k1):
            seed_random(c, 7)
        n0 = fused_stencil.shard_step.launches
        ctx.run_solution(0, nsteps - 1)
        got = fused_stencil.shard_step.launches - n0
        fused_stencil.shard_step = plain_shard_step
        try:
            plain.run_solution(0, nsteps - 1)
        finally:
            fused_stencil.shard_step = shard_step
        k1.run_solution(0, nsteps - 1)
        til = ctx.get_stats().get_tiling()
        ov = til["overlap_exchange"]
        want = k5_launches(S, nsteps, K, ov, 2 * len(til.get(
            "overlap_core", {})))
        d = max_abs_diff(ctx, plain)
        worst = max(worst, d)
        bad_plain = ctx.compare_data(plain, field_epsilon=FIELD_EPS)
        bad_k1 = ctx.compare_data(k1, epsilon=0.0, abs_epsilon=0.0)
        log(f"phase 8: {label}, {g}^3, mesh {til['mesh']} ({S} shards on "
            f"{dev}), {nsteps} steps: overlap {ov} "
            f"{[rr['code'] for rr in til['overlap_reasons']]}, comm order "
            f"{til['comm']['order']} coalesce {til['comm']['coalesce']}; "
            f"vs plain (plain_shard_step on the card) max|d|={d:.3e} "
            f"mismatches={bad_plain} (field_epsilon={FIELD_EPS}); vs "
            f"single-domain K1 compare_data(epsilon=0) = {bad_k1}; K5 "
            f"launches {got} (expected {want})")
        if bad_plain or bad_k1:
            raise RuntimeError(f"phase 8: {label}: {bad_plain} mismatches "
                               f"vs plain, {bad_k1} vs K1")
        if got != want:
            raise RuntimeError(f"phase 8: {label}: {got} K5 launches, "
                               f"expected {want}")
        if "overlap on" in label and not ov:
            raise RuntimeError(f"phase 8: {label}: the overlap did not "
                               "engage")
        arms[label] = ctx
        del plain, k1
    for a, b in (("iso3dfd r=8 K=2 overlap off",
                  "iso3dfd r=8 K=2 overlap on"),
                 ("iso3dfd r=8 K=2 overlap on",
                  "iso3dfd r=8 K=2 overlap on coalesce on")):
        if a in arms and b in arms:
            bad = arms[a].compare_data(arms[b], epsilon=0.0,
                                       abs_epsilon=0.0)
            log(f"phase 8: '{a}' vs '{b}': compare_data(epsilon=0) = {bad}")
            if bad:
                raise RuntimeError(f"phase 8: '{a}' and '{b}' differ")
    return worst


def device_diff(a, b, exact=False):
    """Largest |Δ| and the mismatches over the interiors of two contexts'
    common vars, computed on the card (no host copy of a 512³ state):
    under ``compare_data``'s rule with ``field_epsilon``, or, with
    ``exact``, every cell whose bits differ."""
    import torch
    worst, bad = 0.0, 0
    sa, sb = a._state, b._state
    for name, ring in sa.items():
        for x, y in zip(ring[::-1], sb[name][::-1]):
            x = x[a._interior_idx(name)]
            y = y[b._interior_idx(name)]
            if exact:
                worst = max(worst, float((x - y).abs().max()))
                bad += int((x != y).sum())
                continue
            x, y = x.double(), y.double()
            d = (x - y).abs()
            tol = 1e-7 + 1e-4 * torch.maximum(x.abs(), y.abs()) \
                + FIELD_EPS * max(float(x.abs().max()), float(y.abs().max()))
            worst = max(worst, float(d.max()))
            bad += int((d > tol).sum())
    return worst, bad


def k5_launch_times(ctx, t: int, g: int, r: int, card: str):
    """K5 per launch on the main path's shapes, from the shards resident
    in ``ctx`` at step ``t``: over the box grown by ``r`` (sub-step 0 of a
    2-step group) and over the interior (sub-step 1), each against its
    bound, and one launch against its plain version.  Returns (max |Δ|,
    plain ms, mean ms, mean bound ms, bound_by, layout)."""
    from yask_tpu_torch.ops.fused_stencil import (plain_shard_step,
                                                  shard_step)
    kern = ctx._shard.kernel
    layout, shards = ctx._run.resident
    n = g // 2
    boxes = [{"x": (-r, n + r), "y": (-r, n + r), "z": (0, g)},
             {"x": (0, n), "y": (0, n), "z": (0, g)}]
    off = layout.offsets[0]
    st0 = shards[0]
    ms = [cuda_ms(lambda b=b: shard_step(kern, st0, t, b, off), 10)
          for b in boxes]
    k5_ms = sum(ms) / len(ms)
    plain_ms = cuda_ms(lambda: plain_shard_step(kern, st0, t, boxes[0],
                                                off), 3)
    a = shard_step(kern, dict(st0), t, boxes[0], off)
    b = plain_shard_step(kern, dict(st0), t, boxes[0], off)
    err = max(float((x - y).abs().max()) for nm in a
              for x, y in zip(a[nm], b[nm]))
    scale = max(float(x.abs().max()) for nm in b for x in b[nm])
    del a, b, st0, shards
    if not err <= FIELD_EPS * scale:
        raise RuntimeError("phase 8: K5 and its plain version disagree at "
                           f"{g}^3")
    bounds = [box_bytes(kern, bx, off) / HBM_BYTES_PER_S * 1e3
              for bx in boxes]
    flops = [ctx._ana.counters.num_ops * (bx["x"][1] - bx["x"][0])
             * (bx["y"][1] - bx["y"][0]) * g / FP32_FLOP_PER_S * 1e3
             for bx in boxes]
    bound_ms = max(sum(bounds), sum(flops)) / len(boxes)
    bound_by = "bytes" if sum(bounds) >= sum(flops) else "operations"
    log(f"phase 8: K5 per launch at a {n}x{n}x{g} shard: {ms[0]:.3f} ms "
        f"over the box grown by r (sub-step 0, {n + 2 * r}x{n + 2 * r}x{g}),"
        f" bound {bounds[0]:.4f} ms; {ms[1]:.3f} ms over the interior "
        f"(sub-step 1), bound {bounds[1]:.4f} ms (each input once over the "
        f"box grown by its reach, clipped to the global domain; each output "
        f"once over the box); mean {k5_ms:.3f} ms against {bound_ms:.4f} ms "
        f"({bound_by}; share {bound_ms / k5_ms:.3f}); 4 shards x (sub-step "
        f"0 + sub-step 1) = {4 * (ms[0] + ms[1]):.3f} ms of K5 per group; "
        f"plain version {plain_ms:.3f} ms (not a yardstick); one launch vs "
        f"plain max|d|={err:.3e} (field max {scale:.3e}) [{card}]")
    return err, plain_ms, k5_ms, bound_ms, bound_by, layout


def phase8(fac, card: str, k1_step_ms: float, full: int = 512,
           warm_groups: int = 2, trials: int = 3, steps: int = 20,
           dev: str = "cuda:0", cases=SHARD_CASES) -> dict:
    """The distributed path (see the module docstring); returns K5's
    entry of the ``kernels`` line."""
    import torch
    from yask_tpu_torch.parallel import shard_step as shard_mod
    t_phase = time.perf_counter()

    worst = phase8a(fac, dev, cases)

    # (b) the path at full width: the main path (every auto gate), then
    # -overlap_x on and -coalesce on from the same seeded state, each
    # held to the main path's bits after the same steps
    g, K = full, 2
    npts = g ** 3
    ranks = (("x", 2), ("y", 2))
    r, n = 8, g // 2
    step_ms, xch_ms = {}, {}
    seed = None
    exchange_newest = shard_mod.exchange_newest
    for arm, cli in (("auto", ""), ("overlap on", "-overlap_x on"),
                     ("coalesce on", "-coalesce on")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctx = shard_ctx(fac, [dev] * 4, "iso3dfd", r, g, "shard_pallas", K,
                        ranks, cli)
        if seed is None:
            seed_random(ctx, 11)
            seed = {k: [a.clone() for a in ring]
                    for k, ring in ctx._state.items()}
        else:
            ctx._state = {k: [a.clone() for a in ring]
                          for k, ring in seed.items()}
        ctx.run_solution(0, warm_groups * K - 1)
        t = warm_groups * K
        zero_launch_counts()
        rates = []
        for _ in range(trials):
            ctx.clear_stats()
            ctx.run_solution(t, t + steps - 1)
            t += steps
            rates.append(ctx.get_stats().get_pts_per_sec())
        got = {k: v for k, v in launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated()
        til = ctx.get_stats().get_tiling()
        ov = til["overlap_exchange"]
        want = trials * k5_launches(4, steps, K, ov, 2 * len(til.get(
            "overlap_core", {})))
        if got != {"shard_step": want}:
            raise RuntimeError(f"phase 8: {arm} at {g}^3: launches {got}, "
                               f"expected {want} K5 and no other")
        if (arm == "overlap on") is not ov or (
                arm == "coalesce on") is not til["comm"]["coalesce"]:
            raise RuntimeError(f"phase 8: {arm} at {g}^3: overlap {ov}, "
                               f"coalesce {til['comm']['coalesce']}")
        rates.sort()
        mid = rates[len(rates) // 2]
        step_ms[arm] = npts / mid * 1e3

        # outside the counted window: one more trial with CUDA events
        # around each group's exchange, on the stream it runs on
        marks = []

        def timed(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            exchange_newest(*a, **kw)
            e1.record()
            marks.append((e0, e1))
        shard_mod.exchange_newest = timed
        try:
            ctx.run_solution(t, t + steps - 1)
        finally:
            shard_mod.exchange_newest = exchange_newest
        t += steps
        torch.cuda.synchronize()
        xch_ms[arm] = sum(e0.elapsed_time(e1) for e0, e1 in marks) \
            / len(marks)
        where = ", on the side stream beside the core" if ov else ""
        still = " (the main path's context still allocated)" if cli else ""
        log(f"phase 8: iso3dfd r={r} {g}^3 fp32 -mode shard_pallas "
            f"-wf_steps {K} -nr_x 2 -nr_y 2 {cli} (4 shards of {n}x{n}x{g} "
            f"on {dev}): {trials} trials x {steps} steps: "
            f"{step_ms[arm]:.3f} ms/step (min {npts / rates[-1] * 1e3:.3f}, "
            f"max {npts / rates[0] * 1e3:.3f}), {mid:.4e} points/s; K5 "
            f"launches {got['shard_step']}; overlap {ov}: "
            f"{til['overlap_reasons']}; "
            f"comm {til['comm']['order']} coalesce "
            f"{til['comm']['coalesce']} ({til['comm']['reasons'][-1]}); "
            f"exchange {xch_ms[arm]:.3f} ms per group (CUDA events around "
            f"the {len(marks)} exchanges of one more {steps}-step "
            f"run{where}); torch.cuda.max_memory_allocated() = "
            f"{peak / 2**30:.2f} GiB{still} [{card}]")
        if arm == "auto":
            main_ctx, main_t = ctx, t
            launches = got["shard_step"]
            k5 = k5_launch_times(ctx, t, g, r, card)
            continue
        # the same steps from the same state: the same bits
        d, bad = device_diff(main_ctx, ctx, exact=True)
        log(f"phase 8: {g}^3 after {t} steps: {cli} vs the main path: "
            f"max|d|={d:.3e}, {bad} cells differ (epsilon 0)")
        if bad:
            raise RuntimeError(f"phase 8: {cli} and the main path differ at "
                               f"{g}^3")
        del ctx
    del seed
    ctx, t = main_ctx, main_t
    err, plain_ms, k5_ms, bound_ms, bound_by, layout = k5
    # bytes the exchange moves per group: every slab read and written once
    xbytes = 0
    for name in layout.names:
        gm = ctx._shard.kernel.program.geoms[name]
        if not gm.is_written:
            continue
        for dim in ("x", "y"):
            cross = 1
            for ax, (dn, _k) in enumerate(gm.axes):
                if dn != dim:
                    cross *= gm.shape[ax]
            slabs = 2 * len(layout.mesh.neighbour_pairs(dim))
            xbytes += min(K, gm.num_slots) * slabs * r * K * cross * 4
    step_bound = (16 * npts + 2 * xbytes / K) / HBM_BYTES_PER_S * 1e3
    log(f"phase 8: exchange per group: {xbytes / 2**20:.1f} MiB of slabs "
        f"({K} newest pressure slots, {r * K}-wide); step bound "
        f"{step_bound:.3f} ms (16 B/pt + the exchange read and written "
        f"once), share {step_bound / step_ms['auto']:.3f} (main path), "
        f"{step_bound / step_ms['overlap on']:.3f} (-overlap_x on), "
        f"{step_bound / step_ms['coalesce on']:.3f} (-coalesce on); phase "
        f"4's K1 on the same {g}^3 domain: {k1_step_ms:.3f} ms/step; "
        f"shard_pallas {step_ms['auto']:.3f} (main path: overlap and "
        f"coalescing declined on one card), {step_ms['overlap on']:.3f} "
        f"(-overlap_x on), {step_ms['coalesce on']:.3f} (-coalesce on) "
        f"ms/step [{card}]")

    # one group against the per-shard torch step from the same state
    sm = shard_ctx(fac, [dev] * 4, "iso3dfd", 8, g, "shard_map", 1, ranks)
    sm._state = {k: [x.clone() for x in ring]
                 for k, ring in ctx._state.items()}
    sm._cur_step = t
    ctx.run_solution(t, t + K - 1)
    sm.run_solution(t, t + K - 1)
    p = ctx.get_var("pressure").get_elements_in_slice(
        [t + K, 0, 0, 0], [t + K, g - 1, g - 1, g - 1])
    import numpy as np
    if p.shape != (g, g, g) or not np.isfinite(p).all() \
            or not np.abs(p).max() > 0:
        raise RuntimeError("phase 8: pressure is not finite and nonzero")
    del p
    d, bad = device_diff(ctx, sm)
    log(f"phase 8: one group of {K} steps from the same {g}^3 state: "
        f"shard_pallas vs -mode shard_map (per-shard torch step) max|d|="
        f"{d:.3e} mismatches={bad} (field_epsilon={FIELD_EPS}); phase 8 "
        f"took {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise RuntimeError("phase 8: shard_pallas and shard_map disagree")
    del sm, ctx, main_ctx, layout
    return {"name": "shard_step", "route": "cuda",
            "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "replaces": "yask_tpu/ops/pallas_stencil.py:736 (region= and "
                        "distributed=True arms: :736-811, :1948-1953; "
                        "parallel/shard_step.py:1017)",
            "launches": launches, "max_abs_err": max(err, worst),
            "ms": k5_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"launch over a {n}x{n}x{g} shard (mean of the grown "
                   "and the interior box)",
            "exchange_ms_per_group": xch_ms["auto"],
            "exchange_ms_per_group_coalesce_on": xch_ms["coalesce on"],
            "step_ms": step_ms["auto"],
            "step_ms_overlap_on": step_ms["overlap on"],
            "step_ms_coalesce_on": step_ms["coalesce on"]}


# ---- phase 9: the families path (K6's scratch and rewrite arms) --------

#: Phase 9 (a)'s solutions: those K6's scratch and rewrite arms open, and
#: ssg and fsg (multi-stage, registered with the rest of the library).
FAMILY_CASES = (("tti", 2), ("tti", 4), ("awp", None), ("awp_abc", None),
                ("awp_elastic", None), ("awp_elastic_abc", None),
                ("swe2d", None), ("ssg", 2), ("fsg", 2),
                ("test_scratch_1d", None), ("test_scratch_2d", None),
                ("test_scratch_3d", None), ("test_scratch_stages_1d", None),
                ("test_scratch_boundary_1d", None),
                ("test_boundary_3d", None))
#: Phase 9 (c)'s solutions at 512³: K6's scratch arm and its rewrite arm.
FULL_CASES = (("tti", 2), ("awp", None))
#: Read-only coefficients in a physical range, uniform in [lo, hi): a
#: positive slowness m, density and Lame parameters, attenuation and
#: sponge factors, AWP's dt/h and the SWE's dt/dx and gravity (others:
#: 0.05 + 0.01 U).  Written vars start small (0.01 U), the SWE's depth
#: near 0.5.
COEFF_RANGES = {"m": (0.2, 0.3), "damp": (0.0, 0.01), "epsilon": (0.0, 0.1),
                "delta": (0.0, 0.1), "theta": (0.0, 3.14159),
                "phi": (0.0, 3.14159), "rho": (1.0, 2.0),
                "lambda_": (1.0, 2.0), "mu": (1.0, 2.0), "qp": (0.1, 0.3),
                "sponge": (0.9, 1.0), "h": (0.05, 0.1), "lam": (0.1, 0.1),
                "grav": (9.8, 9.8), **{f"c{i}{j}": (1.0, 2.0)
                                       for i in "123456" for j in "123456"}}
WRITTEN_RANGES = {("swe2d", "h"): (0.5, 0.51)}


def seed_physical(ctx, seed: int) -> None:
    """A numpy-seeded state in the ranges above, through the yk_var slice
    API (``numpy.random.default_rng(seed)``, float32 draws)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for name in sorted(ctx.get_var_names()):
        v = ctx.get_var(name)
        dd = v.get_domain_dim_names()
        sizes = tuple(ctx.get_overall_domain_size(d) for d in dd)
        lo, hi = (WRITTEN_RANGES.get((ctx.get_name(), name), (0.0, 0.01))
                  if name in written else
                  COEFF_RANGES.get(name, (0.05, 0.06)))
        steps = [None]
        if v.get_step_dim_name():
            steps = list(range(v.get_first_valid_step_index(),
                               v.get_last_valid_step_index() + 1))
        for t in steps:
            vals = (lo + (hi - lo) * rng.random(sizes, dtype=np.float32)
                    ).astype(np.float32)
            first = ([t] if t is not None else []) + [0] * len(dd)
            last = ([t] if t is not None else []) + [n - 1 for n in sizes]
            v.set_elements_in_slice(vals, first, last)


def ragged_sizes(tile) -> tuple:
    """At least three tile boundaries per slot, and a partial last
    tile: 3 T + T/2 + 1 points (4 where T = 1)."""
    return tuple(3 * t + t // 2 + 1 for t in tile)


def family_specs(fac, env) -> dict:
    """Phase 9's kernels (K6 per solution), for phase 1's parallel
    build; the sources do not depend on the domain size."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r in FAMILY_CASES:
        ctx = a3_ctx(fac, env, st, r, 4, (16, 16, 16), "fused")
        spec = fused_stencil.FusedKernel(ctx._program).spec
        out[f"{st} r={r}"] = spec
        if (st, r) in FULL_CASES:
            for tile in ladder_below(spec.tile):
                out[f"{st} r={r} tile {tile}"] = tile_kernel(
                    ctx._program, ctx._push_arg(), tile).spec
    return out


def finite(ctx) -> bool:
    import torch
    return all(bool(torch.isfinite(a).all()) for ring in ctx._state.values()
               for a in ring)


def phase9a(fac, env, steps: int = 5) -> float:
    """Phase 9 (a): each family solution's K6 against its plain version
    on CUDA tensors; returns the largest |Δ|."""
    from yask_tpu_torch.ops import cuda_emit
    worst = 0.0
    for st, r in FAMILY_CASES:
        probe = a3_ctx(fac, env, st, r, 4, (16, 16, 16), "torch")
        tile = cuda_emit.emit(probe._program).tile
        sizes = ragged_sizes(tile)
        del probe
        for K in (1, 2):
            fused = a3_ctx(fac, env, st, r, 4, sizes, "fused", K)
            plain = a3_ctx(fac, env, st, r, 4, sizes, "torch", K)
            for c in (fused, plain):
                seed_physical(c, 5)
            zero_launch_counts()
            fused.run_solution(0, steps - 1)
            got = {k: v for k, v in launch_counts().items() if v}
            plain.run_solution(0, steps - 1)
            til = fused.get_stats().get_tiling()
            d, nbits = device_diff(fused, plain, exact=True)
            bad = fused.compare_data(plain, field_epsilon=FIELD_EPS)
            worst = max(worst, d)
            log(f"phase 9: {st} r={r} {'x'.join(map(str, sizes))} K={K} "
                f"{steps} steps: K6 ({til['stages']} sub-stages, "
                f"{til['scratch_stages']} of scratch vars, tile "
                f"{til['tile']}, smem {til['smem_bytes']} B) vs plain "
                f"(-mode torch on the card): max|d|={d:.3e}, {nbits} cells "
                f"differ in their bits, mismatches={bad} (field_epsilon="
                f"{FIELD_EPS}); launches {got}")
            if not (finite(fused) and finite(plain)):
                raise RuntimeError(f"phase 9: {st} K={K}: the state is not "
                                   "finite")
            if bad:
                raise RuntimeError(f"phase 9: {st} K={K}: {bad} mismatches "
                                   "against the plain version")
            if got != {"stages_step": steps}:
                raise RuntimeError(f"phase 9: {st} K={K}: launches {got}, "
                                   f"expected {steps} of stages_step")
            del fused, plain
    return worst


def phase9b(fac, env, g: int = 32) -> None:
    """Phase 9 (b): tti and awp against the numpy oracle."""
    for st, r in (("tti", 2), ("awp", None)):
        fused = a3_ctx(fac, env, st, r, 4, (g, g, g), "fused", 2)
        ref = a3_ctx(fac, env, st, r, 4, (g, g, g), "ref")
        for c in (fused, ref):
            seed_physical(c, 9)
        fused.run_solution(0, 1)
        ref.run_solution(0, 1)
        bad = fused.compare_data(ref)
        log(f"phase 9: {st} r={r} g={g} 2 steps: fused vs ref (numpy "
            f"oracle) max|d|={max_abs_diff(fused, ref):.3e}, compare_data "
            f"mismatches={bad}")
        if bad:
            raise RuntimeError(f"phase 9: {st}: {bad} mismatches against "
                               "the oracle")


def live_inputs(fac, env, st: str, r, g: int = 20) -> list:
    """The (var, ring slot) inputs of ``st``'s K6 whose values can reach
    an output.  On a ``g``³ grid each input in turn takes other values
    (+1 + U) and the plain version's step runs again: an input whose
    change moves no output bit is dead, as awp's evicted stress slots are
    (the base of a conditional write whose masked-out cells a later stage
    rewrites)."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import FusedKernel, plain_chunk
    ctx = a3_ctx(fac, env, st, r, 4, (g, g, g), "fused")
    seed_physical(ctx, 13)
    prog, spec = ctx._program, FusedKernel(ctx._program).spec

    def step(state):
        out = plain_chunk(prog, {n: list(v) for n, v in state.items()}, 0, 1)
        return [out[n][-1] for n in spec.outputs]
    base = step(ctx._state)
    gen = torch.Generator(device=ctx._device).manual_seed(13)
    live = []
    for name, slot in spec.inputs:
        state = {n: list(v) for n, v in ctx._state.items()}
        a = state[name][slot]
        state[name][slot] = a + 1.0 + torch.rand(
            a.shape, generator=gen, dtype=a.dtype, device=a.device)
        if not all(torch.equal(x, y) for x, y in zip(step(state), base)):
            live.append((name, slot))
    return live


def io_bytes(ctx, live) -> int:
    """Bytes one sub-step must move: each ``live`` input read once and
    each output written once, over the interior."""
    import numpy as np
    prog, spec = ctx._program, ctx._fused.spec

    def cells(name):
        c = 1
        for d in prog.geoms[name].domain_dims:
            c *= prog.sizes[d]
        return c
    return np.dtype(prog.dtype).itemsize * (
        sum(cells(n) for n, _s in live) + sum(cells(n) for n in spec.outputs))


def cells_per_point(spec) -> tuple:
    """K6's shared-memory work per point of its block: the staged input
    cells, and the computed cells of each sub-stage."""
    import math
    pts = math.prod(spec.tile)

    def box(lo, hi):
        return math.prod(t + a + b for t, a, b in zip(spec.tile, lo, hi))
    staged = sum(box(*zip(*spec.halos[a])) for a in spec.tiled) / pts
    return staged, [box(lo, hi) / pts for lo, hi in spec.sub_regions]


def ladder_below(tile, n: int = 2) -> list:
    """The next ``n`` tiles of the emitter's ladder below ``tile``."""
    from yask_tpu_torch.ops import cuda_emit
    lad = list(cuda_emit._TILE_LADDER)
    return lad[lad.index(tuple(tile)) + 1:][:n]


def tile_kernel(program, push, tile):
    """K6 for ``program`` emitted at ``tile`` in place of the ladder's."""
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    kern = FusedKernel(program, push)
    kern.spec = cuda_emit.emit(program, push, ladder=(tile,))
    return kern


def family_full(fac, env, card: str, st: str, r, arm: str, g: int = 512,
                warm: int = 2, trials: int = 3, steps: int = 20,
                eb: int = 4, sweep: bool = True) -> dict:
    """Phase 9 (c), and phase 11 (c) at element size ``eb`` = 2: ``st``
    at ``g``³ ``-mode fused -wf_steps 2`` through the user's entry
    points; with ``sweep``, K6 at the ladder's next smaller tiles too;
    returns the arm's ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, stages_step
    npts = g ** 3
    live = live_inputs(fac, env, st, r)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = a3_ctx(fac, env, st, r, eb, (g, g, g), "fused", 2)
    seed_physical(ctx, 11)
    dt = "bf16" if eb == 2 else "fp32"
    what = f"{st} r={r} {g}^3 {dt} ({arm})"
    eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
    state_bytes = sum(a.numel() * a.element_size()
                      for ring in ctx._state.values() for a in ring)
    seed_s = time.perf_counter() - t0
    ctx.run_solution(0, warm - 1)
    t = warm
    zero_launch_counts()
    rates = []
    for _ in range(trials):
        ctx.clear_stats()
        ctx.run_solution(t, t + steps - 1)
        t += steps
        rates.append(ctx.get_stats().get_pts_per_sec())
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    til = ctx.get_stats().get_tiling()
    if got != {"stages_step": trials * steps}:
        raise RuntimeError(f"{what}: launches {got}, expected "
                           f"{trials * steps} of stages_step")
    if not finite(ctx):
        raise RuntimeError(f"{what}: the state is not finite")
    rates.sort()
    mid = rates[len(rates) // 2]
    step_ms = npts / mid * 1e3
    peak = torch.cuda.max_memory_allocated()
    nbytes = io_bytes(ctx, live)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_pp = ctx._ana.counters.num_ops
    flops_ms = ops_pp * npts / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    kern, state = ctx._fused, ctx._state
    ms = cuda_ms(lambda: stages_step(kern, state, t), 5)
    prog = ctx._program
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, 1), 2)
    a = kern.chunk(dict(state), t, 2)
    b = plain_chunk(prog, dict(state), t, 2)
    err, nbits, scale = 0.0, 0, 0.0
    for n in kern.spec.outputs:
        for x, y in zip(a[n][-2:], b[n][-2:]):
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
    del b
    staged, computed = cells_per_point(kern.spec)
    # the same sub-step at the ladder's smaller tiles: how the launch time
    # follows the staged and computed cells per point; each gives K6's bits
    rows = []
    for tile in ladder_below(kern.spec.tile) if sweep else []:
        var = tile_kernel(prog, ctx._push_arg(), tile)
        c = var.chunk(dict(state), t, 2)
        same = all(torch.equal(x, y) for n in kern.spec.outputs
                   for x, y in zip(a[n][-2:], c[n][-2:]))
        del c
        if not same:
            raise RuntimeError(f"{what}: K6 at tile {list(tile)} gives "
                               "other bits than at its own tile")
        v_staged, v_computed = cells_per_point(var.spec)
        rows.append({"tile": list(tile),
                      "ms": cuda_ms(lambda: stages_step(var, state, t), 5),
                      "smem_bytes": var.spec.smem_bytes,
                      "staged_cells_per_point": v_staged,
                      "computed_cells_per_point": v_computed})
        del var
    del a
    log(f"{what} -mode fused -wf_steps 2: state {state_bytes / 2**30:.2f} GiB ({state_bytes} B, seeded in "
        f"{seed_s:.1f} s); {trials} trials x {steps} steps: "
        f"{step_ms:.3f} ms/step (min {npts / rates[-1] * 1e3:.3f}, max "
        f"{npts / rates[0] * 1e3:.3f}), {mid:.4e} points/s; launches "
        f"{got}; K6 {ms:.3f} ms/launch (CUDA events, the zero-filled "
        f"outputs included); bound {bound_ms:.3f} ms ({bound_by}: "
        f"{nbytes / npts:.0f} B/pt -> {bytes_ms:.3f} ms at 3.35 TB/s; "
        f"{ops_pp} FLOP/pt -> {flops_ms:.3f} ms at 67 TFLOP/s fp32), share "
        f"{bound_ms / ms:.3f} per launch, {bound_ms / step_ms:.3f} per step;"
        f" tiling: {til['stages']} sub-stages ({til['scratch_stages']} of "
        f"scratch vars), tile {til['tile']}, smem {til['smem_bytes']} B; "
        f"per point of the block: {staged:.2f} staged input cells "
        f"({len(kern.spec.tiled)} inputs), computed cells per sub-stage "
        f"{[round(x, 2) for x in computed]}; live inputs {len(live)} of "
        f"{len(kern.spec.inputs)} (dead: "
        f"{sorted(set(kern.spec.inputs) - set(live))}); "
        f"plain version {plain_ms:.3f} ms/step (not a yardstick); one "
        f"2-step chunk vs plain: max|d|={err:.3e} (field max {scale:.3e}), "
        f"{nbits} cells differ in their bits; "
        f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB "
        f"[{card}]")
    for v in rows:
        log(f"{what}: K6 at tile {v['tile']} "
            f"({v['smem_bytes']} B): {v['ms']:.3f} ms/launch (CUDA events; "
            f"{ms:.3f} at its own tile {list(kern.spec.tile)}), "
            f"{v['staged_cells_per_point']:.2f} staged cells per point, "
            f"computed per sub-stage "
            f"{[round(x, 2) for x in v['computed_cells_per_point']]}; the "
            f"same bits [{card}]")
    if not err <= eps * scale:
        raise RuntimeError(f"{what}: K6 and its plain version disagree")
    del ctx, kern, state
    torch.cuda.empty_cache()
    return {"name": f"stages_step ({arm})", "route": "cuda",
            "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "launches": got["stages_step"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"launch, {st} r={r} {g}^3 {dt}",
            "step_ms": step_ms, "bytes_per_point": nbytes / npts,
            "state_bytes": state_bytes, "staged_cells_per_point": staged,
            "computed_cells_per_point": computed, "tile_sweep": rows}


def phase9(fac, env, card: str, full: int = 512) -> list:
    """The families path (see the module docstring); returns the
    ``kernels`` entries of K6's scratch arm (tti) and rewrite arm
    (awp)."""
    t_phase = time.perf_counter()
    worst = phase9a(fac, env)
    phase9b(fac, env)
    scratch = family_full(fac, env, card, "tti", 2, "scratch arm", full)
    scratch.update(replaces="yask_tpu/ops/pallas_stencil.py:175 (_TileEval."
                            "read scratch :175-179, the stage loop's reset "
                            ":2003 and scratch writes :2105-2147)",
                   path="phase 9 (c), tti r=2")
    rewrite = family_full(fac, env, card, "awp", None, "rewrite arm", full)
    rewrite.update(replaces="yask_tpu/ops/pallas_stencil.py:2155 (the stage "
                            "loop's rewrite on the earlier stage's tile "
                            ":2155-2187)",
                   path="phase 9 (c), awp")
    for e in (scratch, rewrite):
        e["max_abs_err"] = max(e["max_abs_err"], worst)
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return [scratch, rewrite]


# ---- phase 10: the misc, partial-dim and element-size-2 arms (A3) ------

#: Phase 10 (a) and (b): (stencil, radius, element bytes, the arm that
#: runs it under -skew's default, its K values).  The partial-dim
#: solutions are built with the port's DSL (:func:`partial_solution`).
A3_CASES = (("box", 1, 4, "stages_step", (1, 2)),
            ("gaussian", 2, 4, "stages_step", (1, 2)),
            ("test_misc_2d", None, 4, "fused_step", (1, 2)),
            ("test_misc_value_2d", None, 4, "stages_step", (1, 2)),
            ("test_step_cond_1d", None, 4, "stages_step", (1, 2)),
            ("partial_written", None, 4, "stages_step", (1, 2, 3)),
            ("partial_written_cond", None, 4, "fused_step", (1, 2)),
            ("scratch_partial", None, 4, "stages_step", (1, 2)),
            ("iso3dfd", 2, 2, "stream_step", (1, 2)),
            ("iso3dfd", 8, 2, "stream_step", (1, 2)),
            ("3axis", 1, 2, "stream_step", (1, 2)))
#: compare_data's field tolerance at element size 2: one bfloat16 ulp is
#: 2^-8 of a value, so 1e-2 of the field scale passes an ulp and nothing
#: coarser.
BF16_FIELD_EPS = 1e-2
#: The oracle's tolerance at element size 2 (tests/test_config_matrix.py:66)
BF16_ORACLE_EPS = 3e-2


def partial_solution(name: str):
    """The partial-dim written solutions of ``tests/test_pallas.py``
    (382-470) in the port's DSL: ``P`` lacks a domain dim and ``A`` reads
    this step's ``P`` (``partial_written``), a conditional partial write
    (``partial_written_cond``), a partial scratch var
    (``scratch_partial``)."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution(name)
    t = soln.new_step_index("t")
    x = soln.new_domain_index("x")
    y = soln.new_domain_index("y")
    if name == "partial_written":
        z = soln.new_domain_index("z")
        a = soln.new_var("A", [t, x, y, z])
        p = soln.new_var("P", [t, y, z])
        p(t + 1, y, z).EQUALS(p(t, y, z) * 0.7 + p(t, y + 1, z - 1) * 0.2
                              + 0.05)
        a(t + 1, x, y, z).EQUALS(a(t, x, y, z) * 0.6
                                 + a(t, x + 1, y - 1, z) * 0.2
                                 + p(t + 1, y, z) * 0.1)
    elif name == "partial_written_cond":
        a = soln.new_var("A", [t, x, y])
        p = soln.new_var("P", [t, y])
        p(t + 1, y).EQUALS(p(t, y) * 0.8 + 0.1).IF_DOMAIN(y >= 4)
        a(t + 1, x, y).EQUALS(a(t, x, y) * 0.5 + p(t, y) * 0.3)
    else:
        a = soln.new_var("A", [t, x, y])
        s = soln.new_scratch_var("s", [y])
        s(y).EQUALS(3.0)
        a(t + 1, x, y).EQUALS(a(t, x, y) * 0.5 + s(y + 1) * 0.1)
    return soln


def four_d_stages(name: str = "four_d_stages"):
    """Phase 11's 4-D solution on K6 in the port's DSL (the one
    ``tests/test_torch_4d.py`` holds against ``yask_tpu``): a scratch var
    ``s`` read at outer offsets (w ± 1) by a conditional write of ``a``
    whose domain condition takes the outer dim, and a second stage ``b``
    reading this step's ``a`` at outer offsets."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution(name)
    t = soln.new_step_index("t")
    w, x, y, z = (soln.new_domain_index(d) for d in "wxyz")
    a = soln.new_var("a", [t, w, x, y, z])
    b = soln.new_var("b", [t, w, x, y, z])
    c = soln.new_var("c", [w, x, y, z])
    s = soln.new_scratch_var("s", [w, x, y, z])
    s(w, x, y, z).EQUALS(a(t, w, x, y, z) * c(w, x, y, z)
                         + a(t, w - 1, x, y, z) * 0.25
                         + a(t, w, x, y + 1, z) * 0.125)
    a(t + 1, w, x, y, z).EQUALS(
        a(t, w, x, y, z) * 0.5
        + (s(w + 1, x, y, z) + s(w, x - 1, y, z) + s(w - 1, x, y, z + 1))
        * 0.1).IF_DOMAIN((w > 1) | (x < 3))
    b(t + 1, w, x, y, z).EQUALS(b(t, w, x, y, z) * 0.5
                                + a(t + 1, w - 1, x, y + 1, z) * 0.2
                                + a(t + 1, w + 1, x + 1, y, z) * 0.1)
    return soln


def a3_ctx(fac, env, stencil, radius, eb, sizes, mode, K=1, cli=""):
    """A context of ``stencil`` over ``sizes`` (per slot 0-2, fewer dims
    taking the last slots; or one per domain dim in solution order) at
    element size ``eb``, ``-mode mode -wf_steps K``."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    if stencil.startswith(("partial_", "scratch_partial", "four_d_")):
        src = (four_d_stages(stencil) if stencil.startswith("four_d_")
               else partial_solution(stencil))
        src.set_element_bytes(eb)
    else:
        src = create_solution(stencil, radius=radius)
        src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(env, src)
    dims = list(ctx._ana.domain_dims)
    if len(sizes) != len(dims):
        sizes = sizes[3 - len(dims):]
    g = " ".join(f"-g_{d} {n}" for d, n in zip(dims, sizes))
    ctx.apply_command_line_options(f"{g} -mode {mode} -wf_steps {K} {cli}")
    ctx.prepare_solution()
    return ctx


def seed_interiors(ctx, seed: int) -> None:
    """A numpy-seeded interior state through ``transfer.import_interiors``
    (misc axes at their full extent): written vars uniform in [0, 1),
    read-only ones 0.05 + 0.01 U."""
    import numpy as np
    from yask_tpu_torch.transfer import export_interiors, import_interiors
    rng = np.random.RandomState(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    import_interiors(ctx, {
        n: [rng.rand(*a.shape) if n in written
            else 0.05 + 0.01 * rng.rand(*a.shape) for a in slots]
        for n, slots in sorted(export_interiors(ctx).items())})


def a3_specs(fac, env) -> dict:
    """Phase 10's kernels, for phase 1's parallel build."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r, eb, _arm, _ks in A3_CASES:
        ctx = a3_ctx(fac, env, st, r, eb, (16, 16, 70), "fused")
        out[f"{st} r={r} {eb} B"] = fused_stencil.FusedKernel(
            ctx._program).spec
    return out


def expected_launches(ctx, arm: str, steps: int) -> dict:
    """The launches ``steps`` steps of a phase-10 context must make: one
    of ``arm`` per step, and a copy of the evicted slot per step and var
    whose unwritten misc slices it keeps."""
    want = {arm: steps}
    nb = len(ctx._fused_spec_kernel().spec.base_outputs)
    if nb:
        want["copy_base"] = nb * steps
    return want


def phase10a(fac, env, steps: int = 5) -> dict:
    """Phase 10 (a): each case against its plain version on CUDA tensors
    from one numpy-seeded state; at element size 2 both arms of K1, which
    must agree to the bit.  Returns the largest |Δ| per (arm, element
    size 2)."""
    from yask_tpu_torch.ops import cuda_emit
    worst: dict = {}
    for st, r, eb, arm0, ks in A3_CASES:
        probe = a3_ctx(fac, env, st, r, eb, (16, 16, 70), "torch")
        sizes = ragged_sizes(cuda_emit.emit(probe._program).tile)
        del probe
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        arms = ARMS if eb == 2 else ((arm0, ""),)
        for K in ks:
            plain = a3_ctx(fac, env, st, r, eb, sizes, "torch", K)
            seed_interiors(plain, 5)
            plain.run_solution(0, steps - 1)
            runs = {}
            for arm, cli in arms:
                fused = a3_ctx(fac, env, st, r, eb, sizes, "fused", K, cli)
                seed_interiors(fused, 5)
                zero_launch_counts()
                fused.run_solution(0, steps - 1)
                got = {k: v for k, v in launch_counts().items() if v}
                want = expected_launches(fused, arm, steps)
                d, nbits = device_diff(fused, plain, exact=True)
                bad = fused.compare_data(plain, field_epsilon=eps)
                worst[arm, eb == 2] = max(worst.get((arm, eb == 2), 0.0), d)
                log(f"phase 10: {st} r={r} {eb} B "
                    f"{'x'.join(map(str, sizes))} K={K} {steps} steps "
                    f"{cli}: {arm} vs plain (-mode torch on the card): "
                    f"max|d|={d:.3e}, {nbits} cells differ in their bits, "
                    f"mismatches={bad} (field_epsilon={eps}); launches "
                    f"{got}")
                if bad:
                    raise RuntimeError(f"phase 10: {st} r={r} K={K} {cli}: "
                                       f"{bad} mismatches")
                if got != want:
                    raise RuntimeError(f"phase 10: {st} r={r} K={K} {cli}: "
                                       f"launches {got}, expected {want}")
                runs[arm] = fused
            if len(runs) == 2:
                d, nbits = device_diff(runs["stream_step"],
                                       runs["fused_step"], exact=True)
                log(f"phase 10: {st} r={r} {eb} B K={K}: stream arm vs K1: "
                    f"{nbits} cells differ (max|d|={d:.3e})")
                if nbits:
                    raise RuntimeError(f"phase 10: {st} r={r} K={K}: the "
                                       "stream arm and K1 differ")
            del runs, plain
    return worst


def phase10b(fac, env, g: int = 24) -> None:
    """Phase 10 (b): each case against the numpy oracle for 2 steps."""
    for st, r, eb, _arm, _ks in A3_CASES:
        eps = ((BF16_ORACLE_EPS, BF16_ORACLE_EPS) if eb == 2
               else (1e-4, 1e-7))
        fused = a3_ctx(fac, env, st, r, eb, (g, g, g + 1), "fused", 2)
        ref = a3_ctx(fac, env, st, r, eb, (g, g, g + 1), "ref")
        for c in (fused, ref):
            seed_interiors(c, 9)
        fused.run_solution(0, 1)
        ref.run_solution(0, 1)
        bad = fused.compare_data(ref, *eps)
        log(f"phase 10: {st} r={r} {eb} B g={g} 2 steps: fused vs ref "
            f"(numpy oracle) max|d|={max_abs_diff(fused, ref):.3e}, "
            f"mismatches={bad} (epsilon, abs_epsilon = {eps})")
        if bad:
            raise RuntimeError(f"phase 10: {st} r={r} {eb} B: {bad} "
                               "mismatches against the oracle")


def seed_device(ctx, seed: int) -> None:
    """A seeded random interior state made on the card (a torch CUDA
    generator, bulk): written vars uniform in [0, 1), read-only ones
    0.05 + 0.01 U."""
    import torch
    gen = torch.Generator(device=ctx._device).manual_seed(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for name in sorted(ctx._state):
        for slot in range(len(ctx._state[name])):
            shape = ctx._interior_shape(name)
            v = torch.rand(shape, generator=gen, device=ctx._device)
            if name not in written:
                v = 0.05 + 0.01 * v
            ctx._fill_interior(name, slot,
                               lambda xp, n, v=v: v.reshape(-1))


def a3_bound(ctx) -> tuple:
    """The least time of one sub-step of ``ctx``'s kernel: each input (a
    var's ring slot and misc slice) read once and each output slice
    written once over the interior, against 3.35 TB/s, or its FLOPs at
    67 TFLOP/s fp32 (the kernel computes in float at every element
    size), whichever is larger.  Returns (ms, "bytes"/"operations",
    bytes)."""
    import numpy as np
    prog, spec = ctx._program, ctx._fused_spec_kernel().spec

    def cells(name):
        c = 1
        for d in prog.geoms[name].domain_dims:
            c *= prog.sizes[d]
        return c
    nslices = spec.out_slices or [(i, ()) for i in range(len(spec.outputs))]
    # an input read at an outer offset is the same array: counted once
    arrays = {(n, s, m) for (n, s), m in
              zip(spec.inputs, spec.in_misc or [()] * len(spec.inputs))}
    nbytes = np.dtype(prog.dtype).itemsize * (
        sum(cells(n) for n, _s, _m in arrays)
        + sum(cells(spec.outputs[i]) for i, _m in nslices))
    npts = 1
    for d in prog.ana.domain_dims:
        npts *= prog.sizes[d]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = ctx._ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes)


def a3_full(fac, env, card: str, st, r, eb, sizes, arm: str, label: str,
            K: int = 2, warm: int = 2, trials: int = 3, steps: int = 20,
            cli: str = "") -> dict:
    """Phase 10 (c) and phase 11 (c): one case at full width through the
    user's entry points (``-mode fused -wf_steps K``): warm-up, then
    ``trials`` runs of ``steps`` steps with every counter zeroed just
    before; the arm's ms per launch against its bound, its plain
    version's time and one chunk against it, from :func:`seed_device`'s
    state.  Returns the ``kernels`` entry, with the context under
    ``ctx``."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = a3_ctx(fac, env, st, r, eb, sizes, "fused", K, cli)
    seed_device(ctx, 11)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    npts = 1
    for d in ctx._ana.domain_dims:
        npts *= ctx._program.sizes[d]
    ctx.run_solution(0, warm - 1)
    t = warm
    zero_launch_counts()
    rates = []
    for _ in range(trials):
        ctx.clear_stats()
        ctx.run_solution(t, t + steps - 1)
        t += steps
        rates.append(ctx.get_stats().get_pts_per_sec())
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    want = expected_launches(ctx, arm, trials * steps)
    if got != want:
        raise RuntimeError(f"{label}: launches {got}, expected {want}")
    if not finite(ctx):
        raise RuntimeError(f"{label}: the state is not finite")
    rates.sort()
    mid = rates[len(rates) // 2]
    step_ms = npts / mid * 1e3
    peak = torch.cuda.max_memory_allocated()
    bound_ms, bound_by, nbytes = a3_bound(ctx)
    kern, prog, s0 = ctx._fused, ctx._program, dict(ctx._state)
    wrapper = getattr(fs, arm)
    ms = cuda_ms(lambda: wrapper(kern, s0, t), 5)
    plain_ms = cuda_ms(lambda: fs.plain_chunk(prog, s0, t, 1), 2)
    a = kern.chunk(dict(s0), t, K)
    b = fs.plain_chunk(prog, dict(s0), t, K)
    err, nbits, scale = 0.0, 0, 0.0
    for n in kern.spec.outputs:
        for x, y in zip(a[n][-K:], b[n][-K:]):
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
    del a, b
    eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
    log(f"{label}: {'x'.join(map(str, sizes))} ({eb} B) -mode "
        f"fused -wf_steps {K} {cli}: seeded on the card in {seed_s:.1f} s; "
        f"{trials} trials x {steps} steps: {step_ms:.3f} ms/step (min "
        f"{npts / rates[-1] * 1e3:.3f}, max {npts / rates[0] * 1e3:.3f}), "
        f"{mid:.4e} points/s; launches {got}; {arm} {ms:.3f} ms/launch "
        f"(CUDA events); bound {bound_ms:.3f} ms ({bound_by}: "
        f"{nbytes / npts:.1f} B/pt -> {nbytes / HBM_BYTES_PER_S * 1e3:.3f} "
        f"ms at 3.35 TB/s), share {bound_ms / ms:.3f} per launch, "
        f"{bound_ms / step_ms:.3f} per step; plain version "
        f"{plain_ms:.3f} ms/step (not a yardstick); one {K}-step chunk vs "
        f"plain: max|d|={err:.3e} (field max {scale:.3e}), {nbits} cells "
        f"differ in their bits; torch.cuda.max_memory_allocated() = "
        f"{peak / 2**30:.2f} GiB [{card}]")
    if not err <= eps * scale:
        raise RuntimeError(f"{label}: {arm} and its plain version "
                           "disagree")
    return {"name": f"{arm} ({label.split(': ')[0]})", "route": "cuda",
            "launches": got[arm], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"launch, {label.split(': ', 1)[-1]}",
            "step_ms": step_ms, "bytes_per_point": nbytes / npts,
            "peak_bytes": peak, "ctx": ctx}


def gaussian_library(entry, card: str, r: int = 2) -> None:
    """The one PyTorch call that computes the Gaussian filter's step
    (off the port's path, a yardstick): ``conv2d(img, w, padding=r,
    groups=3)`` with the weights ``w1[i] w1[j]`` and zero pads as the
    ghost cells, in full float32 (cuDNN's TF32 off).  Its time is the
    entry's ``library_ms``; its output is held against the kernel's."""
    import math
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    ctx = entry["ctx"]
    src = ctx._state["img"][-1][ctx._interior_idx("img")].unsqueeze(0) \
        .contiguous()
    sigma = max(r / 2.0, 0.5)
    w1 = [math.exp(-(i * i) / (2 * sigma * sigma)) for i in range(-r, r + 1)]
    w1 = [w / sum(w1) for w in w1]
    w = torch.tensor([[a * b for b in w1] for a in w1], dtype=torch.float32,
                     device=src.device).expand(3, 1, 2 * r + 1, 2 * r + 1) \
        .contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            src, w, padding=r, groups=3), 5)
        lib = torch.nn.functional.conv2d(src, w, padding=r, groups=3)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t = ctx._cur_step
    out = fs.stages_step(ctx._fused, dict(ctx._state), t)["img"][-1]
    mine = out[ctx._interior_idx("img")]
    scale = float(mine.abs().max())
    err = float((mine - lib).abs().max())
    log(f"phase 10: gaussian r={r}: torch.nn.functional.conv2d(groups=3, "
        f"padding={r}, TF32 off) {lib_ms:.3f} ms (CUDA events; the "
        f"yardstick, off the port's path) against the kernel's "
        f"{entry['ms']:.3f} ms/launch; kernel vs conv2d max|d|={err:.3e} "
        f"(field max {scale:.3e}) [{card}]")
    if not err <= FIELD_EPS * scale:
        raise RuntimeError("phase 10: gaussian: the kernel and conv2d "
                           "disagree")
    entry["library_ms"] = lib_ms


def phase10(fac, env, card: str, image: int = 8192, full: int = 512,
            misc: int = 2048) -> list:
    """The misc, partial-dim and element-size-2 arms (see the module
    docstring); returns their ``kernels`` entries."""
    import torch
    t_phase = time.perf_counter()
    worst = phase10a(fac, env)
    phase10b(fac, env)
    gauss = a3_full(fac, env, card, "gaussian", 2, 4, (1, image, image),
                    "stages_step", f"misc arm of K6: gaussian r=2 "
                    f"{image}^2x3 fp32", K=1)
    gaussian_library(gauss, card)
    gauss.update(source="yask_tpu_torch/csrc/fused_step.cuh",
                 replaces="yask_tpu/ops/pallas_stencil.py:199 (_TileEval "
                          "misc reads :199-204, misc values :252-260, "
                          "misc-pinned writes region_idxs :1879-1897, the "
                          "stage loop's misc binding :2150-2165)",
                 path="phase 10 (c), gaussian r=2")
    del gauss["ctx"]
    torch.cuda.empty_cache()
    stream = a3_full(fac, env, card, "iso3dfd", 8, 2, (full,) * 3,
                     "stream_step", "element size 2 of the stream arm: "
                     f"iso3dfd r=8 {full}^3 bf16")
    k1 = a3_full(fac, env, card, "iso3dfd", 8, 2, (full,) * 3,
                 "fused_step", f"element size 2 of K1: iso3dfd r=8 {full}^3 "
                 "bf16", cli="-no-skew")
    d, nbits = device_diff(stream["ctx"], k1["ctx"], exact=True)
    log(f"phase 10: iso3dfd r=8 {full}^3 bf16 after 62 steps from the same "
        f"seed: stream arm vs K1: {nbits} cells differ (max|d|={d:.3e})")
    if nbits:
        raise RuntimeError("phase 10: at element size 2 the stream arm and "
                           f"K1 differ at {full}^3")
    for e, src, rep in ((stream, "stream_step.cuh", "yask_tpu/ops/"
                         "pallas_stencil.py:734 (tpu_tile_dims in the "
                         "program dtype :346, :734; VMEM in dtype "
                         ":2264-2289), with K2/K3's DMA and carry arms"),
                        (k1, "fused_step.cuh", "yask_tpu/ops/"
                         "pallas_stencil.py:734 (tpu_tile_dims in the "
                         "program dtype :346, :734; VMEM in dtype "
                         ":2264-2289)")):
        e.update(source=f"yask_tpu_torch/csrc/{src}", replaces=rep,
                 path="phase 10 (c), iso3dfd r=8 bf16" + (
                     ", -no-skew" if e is k1 else ""))
        del e["ctx"]
    torch.cuda.empty_cache()
    misc1 = a3_full(fac, env, card, "test_misc_2d", None, 4,
                    (1, misc, misc), "fused_step", "misc arm of K1: "
                    f"test_misc_2d {misc}^2 fp32", trials=1, steps=10)
    misc1.update(source="yask_tpu_torch/csrc/fused_step.cuh",
                 replaces="yask_tpu/ops/pallas_stencil.py:199 (_TileEval "
                          "misc reads :199-204, misc-pinned writes "
                          "region_idxs :1879-1897)",
                 path="phase 10 (c), test_misc_2d (a copy of the evicted "
                      "slot per step included in ms/step)")
    del misc1["ctx"]
    torch.cuda.empty_cache()
    part = a3_full(fac, env, card, "partial_written", None, 4,
                   (full,) * 3, "stages_step", "partial-dim arm of "
                   f"K6: partial_written {full}^3 fp32", trials=1, steps=10)
    part.update(source="yask_tpu_torch/csrc/fused_step.cuh",
                replaces="yask_tpu/ops/pallas_stencil.py:1899 "
                         "(to_var_region :1899-1915, admitted by "
                         "pallas_applicable :83-101)",
                path="phase 10 (c), partial_written")
    del part["ctx"]
    torch.cuda.empty_cache()
    entries = [gauss, misc1, part, k1, stream]
    for e in entries:
        key = (e["name"].split()[0], "element size 2" in e["name"])
        e["max_abs_err"] = max(e["max_abs_err"], worst.get(key, 0.0))
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return entries

# ---- phase 11: the last A3 arms: 4-D on K1 and K6, K6 at element size 2

#: Phase 11 (a) and (b): (case, radius, element bytes, the arm).  The 4-D
#: K6 solution is built with the port's DSL (:func:`four_d_stages`).
A3B_CASES = (("test_4d", None, 4, "fused_step"),
             ("four_d_stages", None, 4, "stages_step"),
             ("tti", 2, 2, "stages_step"),
             ("ssg", 2, 2, "stages_step"),
             ("awp", None, 2, "stages_step"),
             ("gaussian", 2, 2, "stages_step"))
#: the outer dim's extent in phase 11 (a)'s ragged 4-D grids
OUTER_RAGGED = 5


def a3b_sizes(fac, env, st, r, eb) -> tuple:
    """Phase 11 (a)'s ragged grid for a case: :func:`ragged_sizes` of its
    emitted tile in the three slots, the outer dim of a 4-D solution
    :data:`OUTER_RAGGED` first."""
    from yask_tpu_torch.ops import cuda_emit
    nd = 4 if st in ("test_4d", "four_d_stages") else 3
    probe = a3_ctx(fac, env, st, r, eb, (4, 16, 16, 70)[4 - nd:], "torch")
    sizes = ragged_sizes(cuda_emit.emit(probe._program).tile)
    return ((OUTER_RAGGED,) + sizes) if nd == 4 else sizes


def a3b_specs(fac, env) -> dict:
    """Phase 11's kernels, for phase 1's parallel build (the sources do
    not depend on the domain size)."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r, eb, _arm in A3B_CASES:
        ctx = a3_ctx(fac, env, st, r, eb, (4, 16, 16, 70), "fused")
        out[f"{st} r={r} {eb} B"] = fused_stencil.FusedKernel(
            ctx._program).spec
    return out


def seed_case(ctx, seed: int) -> None:
    """Phase 11's seeding: :func:`seed_physical`, or :func:`seed_interiors`
    for a solution with misc axes (which ``seed_physical``'s slices of
    the domain dims do not cover)."""
    if any(k == "misc" for g in ctx._program.geoms.values()
           for _d, k in g.axes):
        seed_interiors(ctx, seed)
    else:
        seed_physical(ctx, seed)


def phase11a(fac, env, steps: int = 5) -> dict:
    """Phase 11 (a): each case against its plain version on CUDA tensors
    from one state seeded in a physical range (:func:`seed_case`),
    K ∈ {1, 2}; returns the largest |Δ| per case."""
    worst: dict = {}
    for st, r, eb, arm in A3B_CASES:
        sizes = a3b_sizes(fac, env, st, r, eb)
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        for K in (1, 2):
            plain = a3_ctx(fac, env, st, r, eb, sizes, "torch", K)
            fused = a3_ctx(fac, env, st, r, eb, sizes, "fused", K)
            for c in (plain, fused):
                seed_case(c, 5)
            plain.run_solution(0, steps - 1)
            zero_launch_counts()
            fused.run_solution(0, steps - 1)
            got = {k: v for k, v in launch_counts().items() if v}
            want = expected_launches(fused, arm, steps)
            til = fused.get_stats().get_tiling()
            d, nbits = device_diff(fused, plain, exact=True)
            bad = fused.compare_data(plain, field_epsilon=eps)
            worst[st] = max(worst.get(st, 0.0), d)
            log(f"phase 11: {st} r={r} {eb} B {'x'.join(map(str, sizes))} "
                f"K={K} {steps} steps: {arm} ({til['stages']} sub-stages, "
                f"tile {til['tile']}, smem {til['smem_bytes']} B) vs plain "
                f"(-mode torch on the card): max|d|={d:.3e}, {nbits} cells "
                f"differ in their bits, mismatches={bad} (field_epsilon="
                f"{eps}); launches {got}")
            if not (finite(fused) and finite(plain)):
                raise RuntimeError(f"phase 11: {st} K={K}: the state is not "
                                   "finite")
            if bad:
                raise RuntimeError(f"phase 11: {st} K={K}: {bad} mismatches")
            if got != want:
                raise RuntimeError(f"phase 11: {st} K={K}: launches {got}, "
                                   f"expected {want}")
            del plain, fused
    return worst


def phase11b(fac, env, g: int = 24, g4: int = 12) -> None:
    """Phase 11 (b): each case against the numpy oracle for 2 steps, at
    ``g``x``g``x``g + 1`` (4-D: ``g4`` in every dim)."""
    for st, r, eb, _arm in A3B_CASES:
        sizes = ((g4,) * 4 if st in ("test_4d", "four_d_stages")
                 else (g, g, g + 1))
        eps = ((BF16_ORACLE_EPS, BF16_ORACLE_EPS) if eb == 2
               else (1e-4, 1e-7))
        fused = a3_ctx(fac, env, st, r, eb, sizes, "fused", 2)
        ref = a3_ctx(fac, env, st, r, eb, sizes, "ref")
        for c in (fused, ref):
            seed_case(c, 9)
        fused.run_solution(0, 1)
        ref.run_solution(0, 1)
        bad = fused.compare_data(ref, *eps)
        log(f"phase 11: {st} r={r} {eb} B {'x'.join(map(str, sizes))} 2 "
            f"steps: fused vs ref (numpy oracle) max|d|="
            f"{max_abs_diff(fused, ref):.3e}, mismatches={bad} (epsilon, "
            f"abs_epsilon = {eps})")
        if bad:
            raise RuntimeError(f"phase 11: {st} {eb} B: {bad} mismatches "
                               "against the oracle")


def phase11(fac, env, card: str, tti32: dict, full4: int = 128,
            full: int = 512) -> list:
    """The 4-D arms of K1 and K6 and K6 at element size 2 (see the module
    docstring); ``tti32`` is phase 9 (c)'s fp32 tti entry from the same
    run, the yardstick of the bf16 one.  Returns the ``kernels``
    entries."""
    import torch
    t_phase = time.perf_counter()
    worst = phase11a(fac, env)
    phase11b(fac, env)
    k1 = a3_full(fac, env, card, "test_4d", None, 4, (full4,) * 4,
                 "fused_step", f"4-D arm of K1: test_4d {full4}^4 fp32")
    til = k1["ctx"].get_stats().get_tiling()
    log(f"phase 11: test_4d {full4}^4: tiling {til['kernel']}, tile "
        f"{til['tile']}, smem {til['smem_bytes']} B; the stream arm: "
        f"{sorted({x['code'] for x in til['skew_reasons']})} "
        f"({til['skew_reasons'][0]['detail']})")
    if til["kernel"] != "fused_step" or any(
            x["code"] != "skew_ineligible" for x in til["skew_reasons"]):
        raise RuntimeError("phase 11: test_4d did not run on K1 with the "
                           "stream arm ineligible")
    k1.update(source="yask_tpu_torch/csrc/fused_step.cuh",
              replaces="yask_tpu/ops/pallas_stencil.py:1442 (the grid over "
                       "every lead dim; test_4d in tests/test_pallas.py:"
                       "135)", path="phase 11 (c), test_4d")
    del k1["ctx"]
    torch.cuda.empty_cache()
    k6 = a3_full(fac, env, card, "four_d_stages", None, 4, (full4,) * 4,
                 "stages_step", f"4-D arm of K6: four_d_stages {full4}^4 "
                 "fp32", trials=1, steps=10)
    k6.update(source="yask_tpu_torch/csrc/fused_step.cuh",
              replaces="yask_tpu/ops/pallas_stencil.py:1442 (the grid over "
                       "every lead dim) with the stage loop :2058-2188",
              path="phase 11 (c), four_d_stages (one trial of 10 steps)")
    del k6["ctx"]
    torch.cuda.empty_cache()
    bf = family_full(fac, env, card, "tti", 2, "element size 2", full,
                     eb=2, sweep=False)
    log(f"phase 11: tti r=2 {full}^3: bf16 {bf['ms']:.3f} ms/launch, "
        f"{bf['step_ms']:.3f} ms/step against fp32's {tti32['ms']:.3f} "
        f"ms/launch, {tti32['step_ms']:.3f} ms/step (phase 9 (c) of this "
        f"run, the same seed): {tti32['ms'] / bf['ms']:.3f}x; bound "
        f"{bf['bound_ms']:.3f} against {tti32['bound_ms']:.3f} ms [{card}]")
    bf.update(replaces="yask_tpu/ops/pallas_stencil.py:2058 (the stage "
                       "loop :2058-2188 with its VMEM tiles in the program "
                       "dtype :2264-2289)",
              path="phase 11 (c), tti r=2 bf16",
              fp32_ms=tti32["ms"], fp32_step_ms=tti32["step_ms"])
    entries = [k1, k6, bf]
    for e, st in zip(entries, ("test_4d", "four_d_stages", "tti")):
        e["max_abs_err"] = max(e["max_abs_err"], worst.get(st, 0.0))
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return entries


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from yask_tpu_torch import yk_factory
    from yask_tpu_torch.ops import _build, fused_stencil

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")
    fac = yk_factory()
    env = fac.new_env()
    dev_name = torch.cuda.get_device_name(0)

    # ---- phase 1: build every kernel of the path ----------------------
    t0 = time.perf_counter()
    cases = {"iso3dfd": 8, "3axis": 1}
    specs = {}
    for st, r in cases.items():
        ctx = make_ctx(fac, env, st, r, 64, "fused")
        specs[st] = fused_stencil.FusedKernel(ctx._program).spec
    # phase 6's: the merged RTM chains (K6) and the chained arm's stages
    for label, r, acc, cli in (("rtm r=2 pure", 2, False, ""),
                               ("rtm r=2 pure -push off", 2, False,
                                "-push off"),
                               ("rtm r=2 accumulating", 2, True, ""),
                               ("rtm r=8 pure", 8, False, "")):
        pipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True,
                        (16, 16, 16), r, acc)
        specs[label] = pipe.fused_ctx._fused_spec_kernel().spec
        pipe.end()
    chained = rtm_pipe(env, "-mode fused -wf_steps 1", False, (16, 16, 16))
    for s in chained.stage_names:
        specs[f"rtm stage {s}"] = \
            chained.stage_ctx(s)._fused_spec_kernel().spec
    chained.end()
    specs.update(trap_specs(fac, env))
    specs.update(shard_specs(fac))
    specs.update(family_specs(fac, env))
    specs.update(a3_specs(fac, env))
    specs.update(a3b_specs(fac, env))
    _paths, logs = _build.build_many(
        list({s.name: s.source for s in specs.values()}.items()),
        ptxas_info=True)
    build_secs = time.perf_counter() - t0
    for st, s in specs.items():
        entries = (f"entry {s.name} (K4: trapezoid_kernel, then "
                   f"diamond_kernel per dim; passes "
                   f"{[(pp['tile'], pp['smem_bytes']) for pp in s.trap['passes']]})"
                   if s.trap else
                   f"entries {s.name} (K1)"
                   + ("" if s.outer else ", _batched (K7), _region (K5)")
                   + (f", _stream (stream arm: {s.stream.record()})"
                      if s.stream is not None else "")
                   if s.stages == 1 else
                   f"entry {s.name} (K6, {s.stages} sub-stages, "
                   f"{s.scratch_stages} of scratch vars, pushed "
                   f"{s.push_vars})")
        log(f"phase 1: built {s.name} ({st}): {entries}, tile "
            f"{list(s.tile)}, smem {s.smem_bytes} B; ptxas: "
            f"{ptxas_summary(logs.get(s.name, ''))}")
    log(f"phase 1: kernel build {build_secs:.1f} s ({len(logs)} nvcc "
        "run(s) in parallel)")

    phase2(fac, env, cases)
    phase3(fac, env, cases)
    _step_ms, k1, k_stream = phase4(fac, env, card)
    k7 = phase5(fac, env, k1["step_ms"])
    torch.cuda.empty_cache()
    k6 = phase6(env)
    torch.cuda.empty_cache()
    k4 = phase7(fac, env, card)
    torch.cuda.empty_cache()
    k5 = phase8(fac, card, k1["step_ms"])
    torch.cuda.empty_cache()
    k6_arms = phase9(fac, env, card)
    torch.cuda.empty_cache()
    a3_arms = phase10(fac, env, card)
    torch.cuda.empty_cache()
    last_arms = phase11(fac, env, card, k6_arms[0])
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [k1, k_stream, k4, k5, k6, k7]
                      + k6_arms + a3_arms + last_arms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
