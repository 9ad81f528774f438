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
   member-batched kernel, over K1's stream arm under ``-skew``, the
   default: ``<name>_stream_batched``, counted in
   ``batched_step_stream``) per step.  Every response must be ``ok`` at
   occupancy 8, batched, not degraded; K7 must launch exactly 20 times
   in that window; two members must be bit-identical to solo ``-mode
   fused`` contexts from the same seeds; one batched chunk must agree
   with its plain version; ``run_resident`` over 8 items must be
   bit-identical to per-request dispatch.  It prints the latency split,
   the aggregate rate, K7's time against its bound, and the share of a
   request spent in the per-chunk ``extract_snapshot`` host copies (from
   the span trace, ``YT_TRACE``);
6. the pipeline path: the RTM chain (``rtm_chain``: forward step → imaging
   condition → smoothing) merged by ``SolutionPipeline`` and run ``-mode
   fused -wf_steps 1 -no-skew`` with ``prepare(fuse=True)``, one launch of
   K6's body (the multi-stage kernel, the image pushed: it never leaves
   shared memory) per step; phase 17 (a) and (d) run K6's stream arm, the
   default, on the same chains.  (a) K6 against its plain version (``-mode
   torch`` on the same merged program) from one numpy-seeded state: the
   pure (push) and accumulating chains at a ragged 67×45×131 and the pure
   r=8 chain at 64³ (the shared-memory ladder steps down), 4 steps, one
   launch each; (b) the push and ``-push off`` fused arms against the
   host-chained arm (one K1 per stage under ``-no-skew``, bindings copied
   through the host) at 96³, ``compare == 0``; (c) the path at full size:
   r=2, 512³ fp32, ``fwd.pressure`` seeded in every ring slot from
   ``RandomState(7)`` (and ``fwd.vel``), 2 warm-up steps, then 3 trials of
   20 steps with the counters zeroed just before (60 K6 launches and no
   other), for the push arm and the ``-push off`` arm, each against its
   bound (20 and 24 B per point), then ``end()``;
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
   per-shard region kernel, over K1's stream arm under ``-skew``, the
   default: ``<name>_stream_region``, counted in ``shard_step_stream``;
   phase 13 runs K5 over the bodies under ``-no-skew``) per shard.  (a)
   Small cases: iso3dfd r=8 at
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
   counted, finite states, 5 K6 launches and no other (K6's body,
   ``-no-skew``: phase 17 (a) holds the stream arm to it); (b) tti r=2
   and awp (on K6's stream arm, the default) against the numpy oracle at
   32³ for 2 steps; (c) tti r=2 (the scratch arm) and awp (the rewrite
   arm), both on K6's body under ``-no-skew`` (phases 18 (b) and 17 (b)
   run the stream arm from the same seed, and take this run's final
   state's digest) at
   512³ fp32 ``-mode fused -wf_steps 2``, seeded on the card in physical
   ranges: 2 warm-up steps, then 3 trials of 20 steps with the
   counters zeroed just before (60 K6 launches and no other), ms/step,
   points/s, K6's ms per launch (CUDA events) against the bound from the
   program (each input whose values can reach an output read once, as
   ``live_inputs`` finds them, each output written once, or its FLOP
   count, whichever is larger), the staged and computed cells per point
   of K6's block, the plain version's time, one 2-step chunk against it
   from the same state, and tti's K6 at the ladder's next two smaller
   tiles (ms per launch and cells per point; the same bits required;
   awp's, 9.6 s of launches, is left out for the run's time);
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
   test_4d (K1's body under ``-no-skew``, phase 24 runs the default,
   K1's stream arm), ``four_d_stages`` (K6: a scratch var read at outer
   offsets, a domain condition on the outer dim, a second stage reading
   the first at outer offsets; built with the port's DSL) and, at element
   size 2, tti r=2 (scratch), ssg (2 stages), awp (4 stages, rewrites;
   these three on K6's body under ``-no-skew``, phase 22 runs the
   default, K6's stream arm) and gaussian r=2 (misc): K ∈ {1, 2}, 5
   steps, ``-mode fused`` against
   ``-mode torch`` on CUDA tensors from one state seeded in a physical
   range, 0 mismatches at ``field_epsilon`` 1e-4 (1e-2 at element size
   2), the cells whose bits differ counted, the expected launches and no
   other; (b) each against the numpy oracle at 24x24x25 (the 4-D ones at
   12⁴) for 2 steps (``compare_data``'s defaults, (3e-2, 3e-2) at
   element size 2); (c) at full width, each through the user's entry
   points with 2 warm-up steps and the counters zeroed just before the
   trials: test_4d at 128⁴ fp32 ``-wf_steps 2`` (K1's body under
   ``-no-skew``: the twin of phase 24 (b), which takes its final state's
   digest), 3 trials of 20 steps; four_d_stages at 128⁴ fp32
   (K6's body under ``-no-skew``, as in (a) and (b): the twin of phase
   21), one trial of 10; tti r=2 at 512³ in bfloat16 ``-wf_steps 2``
   (K6's body with scratch sub-stages under ``-no-skew``, the twin of
   phase 22 (b), which takes its final state's digest), 3 trials of 20,
   beside phase 9 (c)'s
   fp32 tti of the same run and seed: ms/step, points/s, the kernel's ms
   per launch against its bound, the plain version's time, one chunk
   against it and the peak memory;
12. K7 on every arm of the member batch (the reference vmaps whatever
   ``build_pallas_chunk`` returns): K7 over K1's body (``batched_step``)
   and over K6's (``batched_stages_step``), each block one member and
   one outer cell, the batch built push-off as the reference's; every
   batch of this phase runs ``-no-skew`` (the bodies: phases 17 (a) and
   (c), 23 and 24 run K7 over K6's and K1's stream arms; phase 24 (b)
   takes the final state's digest of (b)'s test_4d cell).  (a)
   ``-mode fused -wf_steps 2 -ensemble 3`` through ``EnsembleRun`` at mid
   width, 5 steps, the counters zeroed just before: tti r=2 (scratch),
   awp (rewrite), ssg (stages), gaussian r=2 and test_misc_2d (misc),
   partial_written (partial-dim), iso3dfd r=8 in bfloat16, test_4d and
   four_d_stages (4-D); the expected launches and no other, every member
   bit-equal to its solo ``-mode fused`` run, one K7 chunk against
   ``plain_batched_chunk`` on the card (``field_epsilon`` 1e-4, 1e-2 at
   element size 2), K7's ms per launch; (b) at full width, seeded on the
   card in physical ranges, 2 warm-up steps and 3 trials of 20 steps
   with the counters zeroed just before: tti r=2 fp32 at 8 x 256³,
   iso3dfd r=8 bf16 at 8 x 256³, test_4d at 8 x 64⁴, gaussian r=2 at 4 x
   4096²x3 and awp at 8 x 256³, each beside the solo row of the same
   points from phases 9-11 (test_4d: half of 128⁴): ms/step, K7's ms per
   launch against its bound (the solo bound times the members), the
   plain version's time, one chunk against it and the peak memory; (c) a
   ``StencilServer`` batch of 4 fused tti r=2 sessions at 128³, 10
   steps (the sessions take ``-skew``'s default): all ``ok`` and
   batched, 10 launches of K7 over K6's stream arm
   (``batched_stages_stream``) and no other, each member bit-identical
   to its solo run; (d) the RTM
   pipeline's push arm in bfloat16 on K6's body (``-no-skew``: the twin
   of phase 22 (b), which takes its final state's digest): at 64³ K6
   against its plain version
   on the card and both against the numpy oracle at (3e-2, 3e-2), then
   at 512³ as phase 6 (c) (10 B/pt), beside phase 6's fp32 row;
13. K5 on every arm of the reference's shard_pallas: ``-mode
   shard_pallas -no-skew`` over ``new_env(devices=["cuda:0"] * n)``, K5
   over K1's body (one stage) or K6's (several stages, scratch
   sub-stages, rewrites), with misc slices, partial-dim outputs, bfloat16
   and outer dims, each shard's box clipped at the global domain (phase
   19 runs the 3-D K6 cases on K6's stream arm, the default).  (a) At mid width
   (48-96 per dim), 5 steps from one state seeded in a physical range
   (``seed_case``), meshes with an inner face in every sharded dim: ssg
   (K=1, K=2), tti r=2 (K=1 on x=2, K=2 on x=2 y=2), awp, swe2d,
   test_scratch_3d, test_boundary_3d, gaussian r=2 and test_misc_2d (misc),
   test_step_cond_1d, partial_written (x sharded, the dim its ``P``
   lacks), iso3dfd r=2 in bfloat16, test_4d with ``w`` (outer) and with
   ``x`` sharded, and ssg and tti with ``-overlap_x on -coalesce on``: each
   against K5's plain version on the card (``field_epsilon``, 1e-2 at
   element size 2), bit-equal (``compare_data(epsilon=0)``) to the
   single-domain ``-mode fused`` run, the overlap runs to those without,
   K5's launches as ``k5_launches`` says (and a copy of the evicted slot
   per launch for test_misc_2d), one launch over shard 0's sub-step-0 box
   timed against its bound and its plain version; (b) at full width on
   2x2 shards, seeded on the card in physical ranges (``seed_device``),
   a warm-up group, then 3 trials of 20 steps with every counter zeroed
   just before (K5 alone launches): tti r=2 512³ fp32 and iso3dfd r=8 512³
   bf16 at ``-wf_steps 2``, awp 256³ fp32 at ``-wf_steps 1`` (512³ would
   not fit beside its twin): ms/step, K5's ms per launch over each
   sub-step's box (grown, then the interior; CUDA events) against its
   bound (the live inputs over the box's reach clipped to the global
   domain, the outputs over the box: ``k5_bound``), the exchange's ms per
   group, the step's bound (four shards' launches and the exchanged
   slabs, ``exchange_bytes``) and share, one launch against its plain
   version, the peak memory, and the state bit-equal to the
   single-domain ``-mode fused`` twin's after the same steps (and the
   final shards' digest, which phase 19 (b) and (c) are held to);
14. K4 on the multi-stage, scratch, rewrite, misc and element-size-2 arms
   (each level of a group runs K6's sub-stages; level buffers past shared
   memory in a workspace of the card's resident blocks) and K4's member
   batch (``<name>_trap_batched``, ``batched_trapezoid_chunk``), every
   K4 request forced (``k4_ctx(force=True)``) and under ``-no-skew`` (the
   two-phase passes; phase 20 runs the default, K4's stream arm).  (a) At mid width, one
   group of K = 2 each: ssg r=2 and r=4, tti r=2, awp, gaussian r=2 and
   tti r=2 in bfloat16 at 64³ (gaussian 256²), and the RTM chain merged
   by ``SolutionPipeline`` (``prepare(fuse=True)``) at 64³: one phase-1
   launch and one diamond launch per trapezoid dim and nothing else, 0
   mismatches against the plain version (``-mode torch``) at
   ``field_epsilon`` (1e-2 at element size 2) and bit-equal
   (``compare_data(epsilon=0)``) to the ``-no-trapezoid`` twin (K6, or
   K1; ssg r=4's runs on the ladder's 1×1×16 rung, ROADMAP.md C17);
   one group timed against its bound and its plain version.  (b) At full width, seeded on the card in physical ranges
   (``seed_device``): tti r=2 512³ fp32 ``-wf_steps 2`` and iso3dfd r=2
   512³ bf16 ``-wf_steps 4``, a warm-up group, then 3 trials of 5 groups
   with the counters zeroed just before (K4 alone launches), each
   bit-equal on the card to its ``-no-trapezoid`` twin (K6, K1) run from
   the same seed: ms/step against the twin's, one group and each pass
   per launch (CUDA events) against the bound (each K4 input read once,
   each output level written once), the plain version's group, and what
   the auto gate chooses.  (c) An ``EnsembleRun`` of 8 × 256³ iso3dfd r=2
   at ``-wf_steps 4 -trapezoid``: 2 groups, K4's member batch alone, each
   member bit-equal to its solo K4 run, the batched group against 8 solo
   groups; then a ``StencilServer`` batch of 4 tti r=2 sessions at 128³
   under ``-trapezoid``, all ok and batched, each bit-identical to its
   solo K4 run;
15. the workspace arm of K1 and K6 (solutions whose tiles fit no rung of
   the shared-memory ladder: the tiles past 227 KB in a device-memory
   workspace of the card's resident blocks, which walk the tiles) and
   K4's 4-D arm (the outer dims as uniform window dims).  (a) tti r=8 and
   ssg r=8 at 512³ fp32, ``-mode fused -wf_steps 2 -no-skew`` (phase 18
   (b) runs K6's stream arm from the same seed and steps and takes this
   run's final states' digests), seeded in physical ranges: a warm-up,
   then one trial of 5 steps with the counters zeroed just before (K6's
   wrapper alone launches), ms/step and per launch
   against the bound (the live inputs read once, each output written
   once), the workspace and the peak memory; against the plain version
   at ``field_epsilon``: one launch at 512³ over nine boxes of 32³ (the
   eight corners and the centre; a full-width plain step of tti r=8 does
   not fit the card), and one 2-step chunk at 256³ seeded alike; (b) at
   mid width, each bit-equal to its twin: a K7 batch of 3 tti r=8
   members against each member's solo run, ssg r=8 under ``-mode
   shard_pallas -nr_x 2 -nr_y 2`` against the single-domain run, tti r=8
   in bfloat16 (``-no-skew``) against the arm at another rung (and its
   plain version at the bfloat16 tolerance); (c) test_4d at 128⁴ fp32 ``-wf_steps 2`` under forced
   ``-trapezoid``: a warm-up group, then 3 trials of 5 groups (K4 alone
   launches), bit-equal on the card to its ``-no-trapezoid`` twin (K1),
   ms per group and per step against the bound (each K4 input read
   once, each output level written once); (d) at mid width, one group
   each, bit-equal to the ``-no-trapezoid`` twin and against the plain
   version: four_d_stages, test_4d in bfloat16, and an ``EnsembleRun``
   of 4 test_4d members under K4, each member bit-equal to its solo K4
   run;
16. K6's flat arm (the 1-D and 2-D solutions on K6's body: wide tiles
   served by fewer threads, the card's resident blocks walking them, the
   next tile's staged inputs copied with ``cp.async`` while the current
   one computes, every output cell written once); phase 10 (c)'s
   gaussian (now held to its plain version's bits) and phase 12 (b)'s
   gaussian batch run it too, the batch beside ``conv2d(groups=3)`` over
   its member stack.  (a) One gaussian r=2 8192²x3 launch under
   ``torch.profiler``, on the flat arm and on the 1x8x64 body it
   replaces (the flat arm off): each kernel's device time against any
   fill or copy in the launch, and the device's idle share (in phase 10
   (c)'s gaussian entry of the ``kernels`` line, with (b)); (b) the flat
   ladder's rungs (:data:`FLAT_SWEEP`) on the same launch, one trial of
   10 each, each bit-equal to the plain version: ms, share, staged cells
   per point; (c) swe2d at 8192² fp32 seeded in physical ranges, ``-wf_steps
   2``, 3 trials of 20 steps with the counters zeroed just before: ms/step
   and per launch against the bound from ``live_inputs`` (24 B/pt), one
   chunk against the plain version; (d) gaussian in bfloat16 at 8192²x3,
   one trial of 10 steps, bit-equal to its plain version, against 12 B/pt,
   beside ``conv2d(groups=3)`` on the bfloat16 image; (e) at mid width
   (2-D 2100x2100, 1-D 2100000 points: more tiles per launch than the
   card's resident blocks, so they walk) every 1-D and 2-D K6 solution
   and box at r=1 and r=3: solo against the plain version on
   the card (to the bit, but box's division and test_func_1d's math
   functions, which PyTorch rounds otherwise: 0 mismatches at
   ``field_epsilon``, the cells whose bits differ counted), a K7 batch
   of 3 (each member bit-equal to its solo run) and, 2-D, 2x2 K5 shards
   (bit-equal to the single-domain run);
17. K6's stream arm (``csrc/stream_stages.cuh``: every sub-stage at its
   lag walking slot 0, the card's resident blocks walking the columns,
   segments and members, rings of staged and computed planes fed by
   ``cp.async``, every output cell written once), solo (``stages_step``
   launching ``<name>_stages_stream``, counted apart) and as K7's batch
   (``batched_stages_step``, ``<name>_stages_stream_batched``), the
   default of ``-mode fused`` on a 3-D solution of K6's body (phase 18
   has those with scratch vars or rings past shared memory).  (a) At mid
   width (67x45x131: several plane tiles per
   slot, the last partial, several segments) every solution it takes,
   and awp at element size 8, K = 2, 5 steps from one state seeded on
   the card: the arm alone launches, bit-equal
   (``compare_data(epsilon=0)``, every cell's bits) to its ``-no-skew``
   twin (K6's body) and held to its plain version at ``field_epsilon``;
   a K7 batch of 3 over the arm, each member bit-equal to its solo run,
   one chunk of the batch held to ``plain_batched_chunk`` at
   ``field_epsilon``; one launch of each arm, of the batch and of the
   plain versions timed; the same for the RTM chains phase 6 (a) runs on
   K6's body (:data:`SS_RTM`: pure with the image pushed, accumulating
   and ``-push off`` at 67x45x131, pure r=8 at 64³, 4 steps each).
   (b) awp at 512³ fp32 as phase 9 (c) runs it (3 trials of 20 steps,
   the counters zeroed just before), from phase 9 (c)'s seed: ms per
   launch and per step against the same bound, the final state's digest
   equal to phase 9 (c)'s (the body's), 3 launches of the arm and 3 of
   the body from one state under ``torch.profiler`` (each kernel's time
   over the launches the window saw; the span and idle share only from a
   window that saw all six, else null), ptxas's registers and spills,
   and the arm at the other plane tiles of :data:`SS_SWEEP` (each the
   same bits); (c) K7 over the arm, awp 8 x 256³, as phase 12 (b) runs
   it, beside the solo arm and phase 12 (b)'s batch on the body; (d) the
   RTM chain at 512³, its image pushed and ``-push off``, as phase 6 (c)
   runs it, each beside phase 6 (c)'s body; (e) ssg and fsg at 512³ on
   the arm and their ``-no-skew`` twins from one seed, bit-equal after
   12 steps, one launch of each timed;
18. K6's stream arm with scratch sub-stages (a scratch var a computed
   ring, its planes past the domain computed from the pads) and with its
   rings past shared memory (where no plane tile's fit: the computed
   rings first in shared memory, the rest in a workspace slice per
   resident block, the staged inputs left without a ring read from
   their allocations), solo and as K7's batch.  (a) As phase 17 (a) at
   67x45x131 (no RTM chains): tti at r=2, 4 and 8, test_scratch_3d, ssg
   and fsg at r=8, each bit-equal to its ``-no-skew`` twin (K6's body,
   the workspace arm at r=8) and held to its plain version, and as a K7
   batch of 3, each member bit-equal to its solo run; (b) at 512³ fp32
   on the arm, each from the seed and steps of its ``-no-skew`` twin, the
   final states' digests equal: tti r=2 beside phase 9 (c)'s body, tti
   r=4 beside its body run here (1 warm-up step and 1 step: the body's
   1x1x32 rung takes seconds a launch), tti r=8 and ssg r=8 beside phase
   15 (a)'s workspace arm (1 warm-up step, one trial of 5); r=4 and r=8
   with the plain version at 256³ and one launch held to it over boxes:
   ms per launch and per step against the bound, 3 launches of the arm
   and 3 of the twin (the arm alone at r=4) under ``torch.profiler``;
   (c) K7 over the
   arm, tti r=2 8 x 256³, as phase 12 (b) runs it, beside the solo arm
   and phase 12 (b)'s batch on the body; (d) tti r=2 and ssg r=8 with
   the arm at the other plane tiles of :data:`SS18_SWEEP` (each the same
   bits), in (b);
19. K5 over K6's stream arm (``shard_step`` launching
   ``<name>_stages_stream_region``, counted in its ``stream_launches``:
   the walk over each shard's box at the box's segment length, the plain
   region clipped at the global domain, the box's cells stored and no
   pad written), the default of ``-mode shard_pallas`` on a 3-D K6
   solution.  (a) Phase 13 (a)'s 3-D K6 cases (ssg K=1 and K=2, tti r=2
   K=1 x=2 and K=2, awp, test_scratch_3d, test_boundary_3d, ssg and tti
   with ``-overlap_x on -coalesce on``) and phase 15 (b)'s ssg r=8 on
   2x2 shards of 64³ (rings past shared memory): the arm alone launches,
   each bit-equal to its ``-no-skew`` twin (K5's body) and to the
   single-domain run, held to K5's plain version, one launch of the arm
   and of the twin timed; (b) tti r=2 512³ ``-wf_steps 2`` and awp 256³
   ``-wf_steps 1`` on 2x2 shards as phase 13 (b) runs them, from its
   seed and steps, the final shards bit-equal to phase 13 (b)'s body:
   ms per launch over the grown and the interior box, ms/step, the share
   of ``k5_bound``, each box's segments, 3 launches of the arm and 3 of
   the body under ``torch.profiler`` (kernels, fills, idle share); (c)
   tti r=2 512³ with ``-overlap_x on`` on the arm and on the body, each
   bit-equal to (b)'s;
20. K4's stream arm (``trapezoid_chunk`` launching ``<name>_trap_stream``,
   counted in its ``stream_launches``: one launch per K-step group, K6's
   stream arm over the K levels' sub-stages, each level lagged along slot
   0 by what the later levels read of it, every output cell written
   once), the default of ``-trapezoid`` on a 3-D solution K6's stream arm
   takes; phases 7, 14 and 15 hold the two-phase passes under
   ``-no-skew``.  (a) Phase 14 (a)'s 3-D fp32 cases (ssg r=2 and r=4, tti
   r=2, awp at 64³) and the RTM chain at 64³, one group of K = 2 each,
   the arm alone launching once, bit-equal (``compare_data(epsilon=0)``)
   to its ``-no-skew`` twin (the two-phase passes) and held to its plain
   version at ``field_epsilon``, one group of each arm timed, the plan
   and ptxas's registers and spills; (b) iso3dfd r=2 512³ K=4 and tti r=2
   512³ K=2, each beside its twin from one seed on the card: a warm-up
   group, then 3 trials of 3 groups with the counters zeroed just before
   (one launch a group, or three passes), the final states bit-equal; ms
   per group and per step, one group by CUDA events against the bound
   (each input read once, each output level written once) and the
   twin's, the plain version's group and one group against it,
   ``torch.profiler`` over 3 groups (kernels, fills, idle share), the
   plan and ptxas's report; for iso3dfd the arm at the plane tiles of
   :data:`K4S_SWEEP` (the same bits), K1's stream arm (``-no-trapezoid``)
   from the same seed (bit-equal, ms per step) and what the auto gate
   chooses; (c) an ``EnsembleRun`` of 8 × iso3dfd r=2 256³ K=4: 2 groups,
   K7 over the arm alone (``_trap_stream_batched``, one launch a group),
   each member bit-equal to its solo run, the batched group against 8
   solo groups and against the two-phase batch on the same stack (the
   same bits);
21. the stream arm past three domain dims (a window of every outer dim
   a work item, each sub-stage once over its region in every slot, a read
   at an outer offset from the ring there): K6's (``stages_step``
   launching ``<name>_stages_stream``, the ``StreamSpec`` beside the
   body), K7's over it and K4's 4-D groups (``<name>_trap_stream``), the
   defaults under ``-skew``; phases 11, 12 and 15 hold the bodies and the
   two-phase passes under ``-no-skew``.  (a) At mid width from one seed:
   four_d_stages (21x40x36x70) and five_d (6x7x40x20x70, two outer dims),
   5 steps each, the arm alone launching, bit-equal to its ``-no-skew``
   twin (K6's body with its outer copies) and held to its plain version;
   K7 over it with 3 members, each bit-equal to its solo run; test_4d and
   four_d_stages under forced ``-trapezoid`` K=2, one group, bit-equal to
   the two-phase twin, and K7 over K4's arm on test_4d with 3 members;
   one launch of each timed beside its twin; (b) test_4d at 128⁴
   ``-trapezoid`` K=2 (a warm-up group, one trial of 3 groups) and
   four_d_stages at 128⁴ (a warm-up step, one trial of 10), each beside
   its twin from one seed, the final states bit-equal: ms per group or
   launch against the bound and the twin's, the plain version's, one
   launch against it, ``torch.profiler`` (kernels, fills, idle share),
   the plan, ptxas's report and the rungs of :data:`S4_SWEEP` (narrower
   outer windows; the same bits);
22. K6's stream arm at element size 2: its staged rings of bfloat16
   filled with aligned 4-byte pairs, each row from the pair holding its
   first cell, the default under ``-skew`` of every solution it takes at
   element size 4, K7, K5 and K4 over it included; phases 11, 12 and 15
   hold K6's body and phase 14 the two-phase passes under ``-no-skew``.
   (a) At mid width from one seed, each beside its ``-no-skew`` twin,
   bit-equal, the arm alone launching: tti r=2, awp, ssg and tti r=8 at
   67x45x131 solo and as K7 x3 (each member bit-equal to its solo run),
   the RTM chain with its image pushed and under ``-push off``; K5 over
   the arm on 2x2 shards of 64³ (tti r=2 K=2, awp); K4's stream arm, one
   group of K=2 (iso3dfd r=2, tti r=2 at 64³); the 4-D arms
   (four_d_stages on K6's and K7 x3, test_4d on K4's and K7 x3 over it,
   21x40x36x70); each held to its plain version within an ulp of
   bfloat16, one launch of each timed; (b) tti r=2 and the RTM chain
   (image pushed) at 512³, each from the seed and steps of its twin
   (phase 11 (c), phase 12 (d)), the final states bit-equal: ms per
   launch and per step against the bound and the twin's, ptxas's report,
   ``torch.profiler`` over 3 launches (tti: 3 of the arm and 3 of the
   body); (c) iso3dfd r=2 512³ K=4 on K4's stream arm beside its
   two-phase twin and K1's bfloat16 stream arm from one seed, as phase
   20 (b) runs it;
23. K7 and K5 over K1's stream arm (``stream_step_kernel<S, true,
   false>`` and ``<S, false, true>``: the member a coordinate of the grid
   beside the segments; the walk over one shard's box), the default under
   ``-skew`` of every 3-D single-stage solution the solo arm takes;
   phases 12 and 13 hold K7 and K5 over K1's body under ``-no-skew``.
   (a) At mid width from one seed, each beside its ``-no-skew`` twin,
   bit-equal, the arm alone launching: phase 8 (a)'s iso3dfd r=8 cases
   (96³ on 2x2 shards, K=1 and K=2 with the overlap off, on, and on with
   ``-coalesce on``) as phase 13 (a) runs them, and K7 x3 of iso3dfd r=2
   and r=8, fp32 and bf16, at 67x45x130; each held to its plain version,
   one launch of each timed beside its twin's; (b) at full width, each
   from the seed and steps of its ``-no-skew`` twin (fp32: run here;
   bf16: phase 13 (b)'s and phase 12 (b)'s rows), the final states
   bit-equal: iso3dfd r=8 512³ on 2x2 shards K=2, fp32 and bf16 (ms per
   launch over the grown and the interior box, per step, against the
   bounds), and K7 over 8 x iso3dfd r=8 256³, fp32 and bf16; each with
   ptxas's report and ``torch.profiler`` over 3 launches of the arm alone;
24. K1's stream arm past three domain dims (``stream_step_kernel<S,
   BATCH, false>`` with ``NOUTER``: each outer cell a coordinate of the
   work items beside the segments and the member, each read at an outer
   offset an input with a ring of its own, the pad pass over every
   slot's pads), solo (``stream_step``) and as K7's batch
   (``batched_step``, ``<name>_stream_batched``), the default under
   ``-skew`` of a single-stage solution with outer dims; phases 11 and
   12 hold K1's and K7's bodies under ``-no-skew``.  (a) At mid width
   (:data:`S24_MID`: test_4d fp32 and bf16 at 5x67x45x130) from one
   seed, each beside its ``-no-skew`` twin, bit-equal, the arm alone
   launching: solo, held to its plain version, and K7 x3, each member
   bit-equal to the twin's; one launch of each timed beside its twin's;
   (b) test_4d at 128⁴, fp32 (3 trials of 20 steps, from phase 11 (c)'s
   seed, its final state's digest equal to phase 11 (c)'s) and bf16 (one
   trial of 10, beside its twin run here), and K7 over 8 x 64⁴ fp32 (from
   phase 12 (b)'s seeds, the final states' digests equal): ms per launch
   and per step against the bound and the twin's, ptxas's registers and
   spills, ``torch.profiler`` over 3 launches of the arm and 3 of the
   twin (kernels, fills, idle share), and the fp32 arm at the plane
   tiles of :data:`S24_SWEEP` (each the same bits).

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


#: when the script started (each log line carries the seconds since)
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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
#: K1's stream arm's header (and K7's and K5's over it)
K1S_SOURCE = "yask_tpu_torch/csrc/stream_step.cuh"
#: the kernel (a substring of its name under ``torch.profiler``) a launch
#: counted in each counter runs
PROFILE_NAMES = {"batched_step_stream": "stream_step_kernel",
                 "shard_step_stream": "stream_step_kernel",
                 "batched_stages_stream": "stream_stages_kernel",
                 "batched_step": "fused_step_kernel",
                 "batched_stages_step": "fused_stages_kernel"}
#: what K7 and K5 over K1's stream arm replace: the reference's vmapped
#: chunk and its region= and distributed=True arms, each with the skewed
#: carry along slot 0 and the prefetch
K1S_K7_REPLACES = ("yask_tpu/runtime/ensemble.py:234-345 (jax.vmap of "
                   "build_pallas_chunk :253-263) -> yask_tpu/ops/"
                   "pallas_stencil.py:2312 with the skewed carry :306-441, "
                   ":1955-2056 and the prefetch :1668-1854")
K1S_K5_REPLACES = ("yask_tpu/ops/pallas_stencil.py:736-811, :1948-1953 "
                   "(region= and distributed=True arms; parallel/"
                   "shard_step.py:1017, :1093-1160) with the skewed carry "
                   ":306-441, :1955-2056 and the prefetch :1668-1854")


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter."""
    from yask_tpu_torch.ops import fused_stencil as fs
    return {"fused_step": fs.fused_step.launches,
            "stream_step": fs.stream_step.launches,
            "batched_step": fs.batched_step.launches,
            "batched_step_stream": fs.batched_step.stream_launches,
            "batched_stages_step": fs.batched_stages_step.launches,
            "stages_step": fs.stages_step.launches,
            "stages_stream": fs.stages_step.stream_launches,
            "batched_stages_stream": fs.batched_stages_step.stream_launches,
            "shard_step": fs.shard_step.launches,
            "shard_step_stream": fs.shard_step.stream_launches,
            "trapezoid_phase1": fs.trapezoid_chunk.phase1_launches,
            "trapezoid_diamond": fs.trapezoid_chunk.diamond_launches,
            "batched_trapezoid_phase1":
                fs.batched_trapezoid_chunk.phase1_launches,
            "batched_trapezoid_diamond":
                fs.batched_trapezoid_chunk.diamond_launches,
            "trapezoid_stream": fs.trapezoid_chunk.stream_launches,
            "batched_trapezoid_stream":
                fs.batched_trapezoid_chunk.stream_launches,
            "copy_base": fs.copy_base.launches}


def zero_launch_counts() -> None:
    from yask_tpu_torch.ops import fused_stencil as fs
    for w in (fs.fused_step, fs.stream_step, fs.batched_step,
              fs.batched_stages_step, fs.stages_step, fs.shard_step,
              fs.copy_base):
        w.launches = 0
    for w in (fs.stages_step, fs.batched_stages_step, fs.shard_step,
              fs.batched_step):
        w.stream_launches = 0
    for w in (fs.trapezoid_chunk, fs.batched_trapezoid_chunk):
        w.phase1_launches = 0
        w.diamond_launches = 0
        w.stream_launches = 0


def stages_counter(kern, wrapper: str = "stages_step") -> str:
    """The counter a launch of ``wrapper`` over ``kern`` bumps: where the
    kernel's tiling (``FusedKernel.tiling``, of K7's batches for
    ``batched_stages_step`` and ``batched_step``) reports K6's stream arm
    (``stages_stream``), the arm's (``stages_stream``,
    ``batched_stages_stream``); where it reports K7 over K1's stream arm,
    ``batched_step_stream``; else the wrapper's own."""
    til = kern.tiling(1, 3 if wrapper.startswith("batched_") else 0)
    if wrapper in ("stages_step", "batched_stages_step") \
            and "stages_stream" in til:
        return wrapper.replace("_step", "_stream")
    if wrapper == "batched_step" and til["skew"]:
        return "batched_step_stream"
    return wrapper


def stages_source(kern, wrapper: str = "stages_step") -> str:
    """The header of the kernel a launch of ``wrapper`` over ``kern``
    runs, from the same tiling as :func:`stages_counter`."""
    counter = stages_counter(kern, wrapper)
    return (K1S_SOURCE if counter == "batched_step_stream"
            else SS_SOURCE if counter.endswith("_stream")
            else "yask_tpu_torch/csrc/fused_step.cuh")


def state_digest(ctx) -> list:
    """Two sums over the bits of every ring slot of ``ctx``'s state (one
    plain, one weighted by position), on the card: equal states give equal
    digests, so two runs from one seed compare without a host copy."""
    return [bits_digest(a) for name in sorted(ctx._state)
            for a in ctx._state[name]]


def bits_digest(a) -> tuple:
    """:func:`state_digest`'s two sums over the bits of one tensor."""
    import torch
    b = a.contiguous().view(-1)
    b = b.view({2: torch.int16, 4: torch.int32,
                8: torch.int64}[b.element_size()]).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device) % 1021 + 1
    return int(b.sum()), int((b * w).sum())


def ptxas_summary(log_text: str) -> str:
    """Registers and spills per kernel from nvcc's ``-Xptxas -v``."""
    names = (("stream_stages_kernelI10StreamSpecLb1",
              "K7 over K6's 4-D stream arm"),
             ("stream_stages_kernelI10StreamSpecLb0", "K6 4-D stream arm"),
             ("stream_stages_kernelI8TrapSpecLb1", "K7 over K4's stream arm"),
             ("stream_stages_kernelI8TrapSpecLb0", "K4 stream arm"),
             ("stream_stages_kernelI4SpecLb1", "K7 stream arm (K6 body)"),
             ("stream_stages_kernelI4SpecLb0ELb1E", "K5 stream arm (K6 body)"),
             ("stream_stages_kernelI4SpecLb0", "K6 stream arm"),
             ("stream_step_kernelI4SpecLb1", "K7 over K1's stream arm"),
             ("stream_step_kernelI4SpecLb0ELb1", "K5 over K1's stream arm"),
             ("stream_step_kernel", "stream arm"),
             ("fused_step_kernelI4SpecLb0ELb1E", "K5 (K1 body)"),
             ("fused_step_kernelI4SpecLb1", "K7 (K1 body)"),
             ("fused_step_kernelI4SpecLb0", "K1"),
             ("fused_stages_kernelI4SpecLb0ELb1E", "K5 (K6 body)"),
             ("fused_stages_kernelI4SpecLb1", "K7 (K6 body)"),
             ("fused_stages_kernelI4SpecLb0", "K6"),
             ("flat_stages_kernelI4SpecLb0ELb1E", "K5 (flat arm)"),
             ("flat_stages_kernelI4SpecLb1", "K7 (flat arm)"),
             ("flat_stages_kernelI4SpecLb0", "K6 flat arm"),
             ("trapezoid_kernelI4SpecLb1", "K4 phase 1 (member batch)"),
             ("trapezoid_kernel", "K4 phase 1"),
             ("diamond_kernelI4SpecLi1ELb1", "K4 diamond (member batch)"),
             ("diamond_kernelI4SpecLi2ELb1", "K4 diamond (member batch)"),
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


def profile_launches(fn, reps: int = 10, expect=(), tries: int = 3):
    """``torch.profiler`` (CUPTI) over ``reps`` calls of ``fn()`` after a
    warm one: each kernel's device milliseconds per launch (by name,
    shortened; its device time over the launches of it the window saw),
    those launches, and, where the window is whole, each kernel's device
    milliseconds per call of ``fn``, the span from the first kernel's
    start to the last one's end per call and the device's idle share of
    that span (its gaps between kernels).  ``expect`` names (substrings
    of kernel names) the kernels each call launches once: a window that
    saw one of them fewer than ``reps`` times is taken again, up to
    ``tries`` windows, and if none is whole, ``per_call_ms``,
    ``span_ms`` and ``idle_share`` are None (a window in a long process
    has missed launches; a window that saw no device activity at all is
    taken again too).  None where no window saw device activity (then
    time the parts with CUDA events).  The events of every profiler
    cycle are kept (``acc_events``, where this PyTorch has it)."""
    import inspect
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acc = ({"acc_events": True}
           if "acc_events" in inspect.signature(profile).parameters else {})
    out = None
    for window in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **acc) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and e.time_range.end > e.time_range.start)
        if not spans:
            # a window that saw no device activity at all: take it again
            continue
        total, seen, busy, end = {}, {}, 0.0, spans[0][0]
        for s, t, name in spans:
            key = name.split("(")[0].replace("void ", "")[:70]
            total[key] = total.get(key, 0.0) + (t - s) / 1e3
            seen[key] = seen.get(key, 0) + 1
            busy += max(0.0, t - max(s, end))
            end = max(end, t)
        whole = all(sum(n for k, n in seen.items() if x in k) == reps
                    for x in expect)
        out = {"kernels": {k: v / seen[k] for k, v in total.items()},
               "launches_seen": seen, "reps": reps, "windows": window,
               "whole": whole, "per_call_ms": None, "span_ms": None,
               "idle_share": None}
        if whole:
            span = (end - spans[0][0]) / 1e3
            out.update(per_call_ms={k: v / reps for k, v in total.items()},
                       span_ms=span / reps,
                       idle_share=(1.0 - busy / 1e3 / span if span > 0
                                   else 0.0))
            break
    return out


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
        k7_launches = moved.pop("batched_step_stream", 0)
        for r in resps:
            if not (r.ok and r.batch == nses and r.batched
                    and not r.degraded):
                raise RuntimeError(
                    f"phase 5: response {r.rid}: status {r.status}, batch "
                    f"{r.batch}, batched {r.batched}, degraded "
                    f"{r.degraded}, error {r.error!r}")
        if k7_launches != steps or moved:
            raise RuntimeError(
                f"phase 5: {k7_launches} launches of K7 over K1's stream "
                f"arm and {moved} others in the served window, expected "
                f"{steps} and none")
        log(f"phase 5: {nses} requests of {steps} steps: all ok at "
            f"occupancy {nses}, batched, none degraded; batched_step "
            f"launches of K7 over K1's stream arm ({k7_launches}, "
            f"batched_step_stream), no other kernel launched")

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
        seg = kern.batch_segment(nses)
        log(f"phase 5: batched_step (K7 over K1's stream arm, "
            f"{seg['segments']} segment(s) of {seg['segment_planes']} "
            f"planes per member, {seg['blocks']} blocks) {ms:.3f} ms/launch "
            f"over {nses} x {g}^3 against its bound {bound_ms:.3f} ms "
            f"({bound_by}); share {bound_ms / ms:.3f}; plain version "
            f"{plain_ms:.3f} ms/step (not a yardstick)")
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
    return {"name": f"batched_step (K7 over K1's stream arm: the served "
                    f"path, {nses} x iso3dfd r=8 {g}^3)", "route": "cuda",
            "source": K1S_SOURCE, "replaces": K1S_K7_REPLACES,
            "launches": k7_launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "path": "phase 5"}


def rtm_pipe(env, cli: str, fuse, g, radius: int = 2,
             accumulate: bool = False, dtype=None):
    """The RTM chain (``rtm_chain``) as a prepared ``SolutionPipeline``
    over ``g = (x, y, z)``, in ``dtype`` (``lowering.BFLOAT16`` for
    element size 2; float32 by default)."""
    from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
    pipe = SolutionPipeline(env, *rtm_chain(radius=radius,
                                            accumulate=accumulate),
                            dtype=dtype)
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


def rtm_full(env, full: int, name: str, cli: str, pushed: set,
             dtype=None, warm: int = 2, trials: int = 3,
             steps: int = 20, phase: str = None, digest: bool = False,
             profile: bool = False) -> dict:
    """The RTM pipeline at ``full``³ (phase 6 (c); phase 12 (d) in
    bfloat16): ``fwd`` seeded as :func:`seed_chain`, ``warm`` steps, then
    ``trials`` runs of ``steps`` with every counter zeroed just before
    (K6 alone may launch); K6's ms per launch against its bound (each
    input read once, each output written once), the plain version's time
    and one step against it; ``phase`` labels its lines (6, or 12 in
    bfloat16, by default).  With ``digest`` the entry holds the merged
    context's final state's :func:`state_digest` under ``state_digest``,
    with ``profile`` 3 launches under :func:`profile_launches` under
    ``profile``.  Returns the ``kernels`` entry."""
    import numpy as np
    import torch
    from yask_tpu_torch.compiler.lowering import is_bfloat16
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, stages_step
    g = (full,) * 3
    npts = g[0] * g[1] * g[2]
    bf16 = dtype is not None and is_bfloat16(dtype)
    dt, esize = ("bf16", 2) if bf16 else ("fp32", 4)
    phase = phase or ("12" if bf16 else "6")
    eps = BF16_FIELD_EPS if bf16 else FIELD_EPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True, g,
                    dtype=dtype)
    if pipe.pushed_vars() != pushed:
        raise RuntimeError(f"rtm {dt} {name}: pushed {pipe.pushed_vars()}")
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
    key = stages_counter(pipe.fused_ctx._fused)
    launches = moved.get(key, 0)
    if moved != {key: trials * steps}:
        raise RuntimeError(
            f"rtm {dt} {name}: launches {moved} in the window, expected "
            f"{trials * steps} of {key} alone")
    peak = torch.cuda.max_memory_allocated()
    secs.sort()
    step_ms = secs[len(secs) // 2] / steps * 1e3
    sv = pipe.get_var("smooth", "smooth")
    ts = sv.get_last_valid_step_index()
    out = sv.get_elements_in_slice([ts, 0, 0, 0], [ts] + [n - 1 for n in g])
    if out.shape != g or not np.isfinite(out).all() \
            or not np.abs(out).max() > 0:
        raise RuntimeError(f"rtm {dt} {name}: smooth is not finite and "
                           "nonzero")
    del out
    ctx = pipe.fused_ctx
    kern, prog, state = ctx._fused, ctx._program, ctx._state
    spec = kern.spec
    dig = state_digest(ctx) if digest else None
    ms = cuda_ms(lambda: stages_step(kern, state, t), 10)
    prof = (profile_launches(lambda: stages_step(kern, state, t), 3,
                             expect=("_stages_kernel",))
            if profile else None)
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, 1), 3)
    a = kern.chunk(dict(state), t, 1)
    b = plain_chunk(prog, dict(state), t, 1)
    err = max(float((a[n][-1].float() - b[n][-1].float()).abs().max())
              for n in spec.outputs)
    scale = max(float(b[n][-1].float().abs().max()) for n in spec.outputs)
    del a, b
    if not err <= eps * scale:
        raise RuntimeError(f"rtm {dt} {name}: K6 and its plain version "
                           f"disagree at {full}^3")
    bytes_pt = esize * (len(spec.inputs) + len(spec.outputs))
    bytes_ms = bytes_pt * npts / HBM_BYTES_PER_S * 1e3
    flops_ms = ctx._ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    log(f"phase {phase}: rtm chain r=2 pure {full}^3 {dt} "
        f"-mode fused -wf_steps 1"
        f" ({name}, pushed {sorted(pushed)}): {trials} trials x {steps}"
        f" steps: {step_ms:.3f} ms/step (min {secs[0] / steps * 1e3:.3f},"
        f" max {secs[-1] / steps * 1e3:.3f}), "
        f"{npts / step_ms * 1e3:.4e} points/s; {key} launches in "
        f"the window {launches}")
    log(f"phase {phase}: {name}: {key} {ms:.3f} "
        f"ms/launch (CUDA events, "
        f"the outputs' allocation included) against its bound "
        f"{bound_ms:.3f} ms ({bound_by}: {bytes_pt} B/pt -> "
        f"{bytes_ms:.3f} ms; {ctx._ana.counters.num_ops} FLOP/pt -> "
        f"{flops_ms:.3f} ms); share {bound_ms / ms:.3f} per launch, "
        f"{bound_ms / step_ms:.3f} per step; plain version "
        f"{plain_ms:.3f} ms/step (not a yardstick); one step kernel vs "
        f"plain max|d|={err:.3e} (field max {scale:.3e}); "
        f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB"
        + (f"; 3 launches under torch.profiler: {json.dumps(prof)}"
           if profile else ""))
    source = stages_source(kern)
    pipe.end()
    del pipe, ctx, kern, prog, state
    torch.cuda.empty_cache()
    entry = {"name": "stages_step", "route": "cuda", "source": source,
             "replaces": "yask_tpu/ops/pallas_stencil.py:2312 (push= arm)",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None, "step_ms": step_ms}
    if digest:
        entry["state_digest"] = dig
    if profile:
        entry["profile"] = prof
    return entry


def phase6(env, ragged=(67, 45, 131), ladder: int = 64, mid: int = 96,
           full: int = 512) -> dict:
    """The pipeline path: the merged RTM chain through K6 (see the module
    docstring; the sizes are its grids); returns K6's entry of the
    ``kernels`` line."""
    from yask_tpu_torch.ops.fused_stencil import fused_step, stages_step

    # (a) K6 against its plain version (-mode torch runs StepProgram.step
    #     of the same merged program), ragged grid and the r=8 ladder
    worst = 0.0
    for acc, r, g in ((False, 2, ragged), (True, 2, ragged),
                      (False, 8, (ladder,) * 3)):
        fused = rtm_pipe(env, "-mode fused -wf_steps 1 -no-skew", True, g,
                         r, acc)
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
    arms = {"push": rtm_pipe(env, "-mode fused -wf_steps 1 -no-skew", True,
                             g),
            "no push": rtm_pipe(env, "-mode fused -wf_steps 1 -push off "
                                "-no-skew", True, g),
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
    entry = None
    for name, cli, pushed in (("push", "-no-skew", {"img__img"}),
                              ("-push off", "-push off -no-skew", set())):
        e = rtm_full(env, full, name, cli, pushed)
        if entry is None:
            entry = e
            entry["max_abs_err"] = max(e["max_abs_err"], worst)
        else:
            # beside phase 17 (d)'s -push off row on K6's stream arm
            entry["push_off"] = {"ms": e["ms"], "step_ms": e["step_ms"]}
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
        zero_launch_counts()
        ctx.run_solution(0, nsteps - 1)
        moved = {k: v for k, v in launch_counts().items() if v}
        # K5 over K1's stream arm under -skew, the default
        got = moved.pop("shard_step_stream", 0)
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
            f"single-domain K1 compare_data(epsilon=0) = {bad_k1}; "
            f"launches of K5 over K1's stream arm ({til['name']}) {got} "
            f"(expected {want}), others {moved}")
        if bad_plain or bad_k1:
            raise RuntimeError(f"phase 8: {label}: {bad_plain} mismatches "
                               f"vs plain, {bad_k1} vs K1")
        if got != want or moved or not til["skew"]:
            raise RuntimeError(f"phase 8: {label}: {got} launches of K5 over "
                               f"K1's stream arm and {moved} others, "
                               f"expected {want} and none: "
                               f"{til['skew_reasons']}")
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


def device_diff(a, b, exact=False, skip=()):
    """Largest |Δ| and the mismatches over the interiors of two contexts'
    common vars but ``skip``, computed on the card (no host copy of a
    512³ state): under ``compare_data``'s rule with ``field_epsilon``, or,
    with ``exact``, every cell whose bits differ."""
    import torch
    worst, bad = 0.0, 0
    sa, sb = a._state, b._state
    for name, ring in sa.items():
        if name in skip:
            continue
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
    bounds = [k5_bound(kern, bx, off)[2] / HBM_BYTES_PER_S * 1e3
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
        if got != {"shard_step_stream": want}:
            raise RuntimeError(f"phase 8: {arm} at {g}^3: launches {got}, "
                               f"expected {want} of K5 over K1's stream arm "
                               "and no other")
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
            f"max {npts / rates[0] * 1e3:.3f}), {mid:.4e} points/s; "
            f"launches of K5 over K1's stream arm "
            f"{got['shard_step_stream']}; overlap {ov}: "
            f"{til['overlap_reasons']}; "
            f"comm {til['comm']['order']} coalesce "
            f"{til['comm']['coalesce']} ({til['comm']['reasons'][-1]}); "
            f"exchange {xch_ms[arm]:.3f} ms per group (CUDA events around "
            f"the {len(marks)} exchanges of one more {steps}-step "
            f"run{where}); torch.cuda.max_memory_allocated() = "
            f"{peak / 2**30:.2f} GiB{still} [{card}]")
        if arm == "auto":
            main_ctx, main_t = ctx, t
            launches = got["shard_step_stream"]
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
    # the slabs one group's exchange moves (each read and written once)
    xbytes = exchange_bytes(ctx._shard, K) // 2
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
    return {"name": "shard_step (K5 over K1's stream arm: the distributed "
                    f"path, iso3dfd r={r} {g}^3 on 2x2 shards)",
            "route": "cuda", "source": K1S_SOURCE,
            "replaces": K1S_K5_REPLACES, "path": "phase 8",
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


def full_seed(ctx):
    """The full-width state of :func:`family_full` (phases 9 (c), 11 (c),
    15 (a) and 17 (b)), made on the card in physical ranges
    (:func:`seed_device`): phase 17 (b)'s awp starts where phase 9 (c)'s
    did."""
    seed_device(ctx, 11, physical=True)
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
    for name, vals, first, last in physical_slices(ctx, seed):
        ctx.get_var(name).set_elements_in_slice(vals, first, last)


def physical_slices(ctx, seed: int):
    """:func:`seed_physical`'s state as ``(var, values, first, last)``
    slices."""
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
            yield name, vals, first, last


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
            # K6's body (phase 17 (a) holds the stream arm to it)
            fused = a3_ctx(fac, env, st, r, 4, sizes, "fused", K,
                           "-no-skew")
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


def stream_kernel(program, push, rung):
    """K6's stream arm for ``program`` at plane tile ``rung`` (T1, T2,
    threads) in place of its ladder's, emitted at the program's size (the
    segment length follows it)."""
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    kern = FusedKernel(program, push)
    kern.spec = cuda_emit.emit(program, push, stream_tiles=(rung,))
    kern.skew_dims = cuda_emit.skew_engaged_dims(program, None, 2, [],
                                                 kern.spec)
    return kern


def boxes_vs_plain(kern, state, t: int, edge: int = 32) -> tuple:
    """One launch of ``kern`` over its whole state (one sub-step from step
    ``t``) against the plain version over boxes of ``edge``³ interior
    cells of the same inputs: the eight corners and the centre
    (``plain_shard_chunk`` of the program at global origin 0, each stage
    over the box grown by the later stages' ghost widths; a full-width
    plain step of tti r=8 does not fit the card).  Returns (max |d|,
    cells whose bits differ, the boxes' field max, boxes)."""
    import itertools
    from yask_tpu_torch.ops.fused_stencil import (
        _box_idx, _with_offset, plain_shard_chunk)
    prog, spec = kern.program, kern.spec
    dims = list(prog.ana.domain_dims)
    n = {d: prog.sizes[d] for d in dims}
    boxes = [{d: (0, edge) if lo else (n[d] - edge, n[d])
              for d, lo in zip(dims, c)}
             for c in itertools.product((True, False), repeat=len(dims))]
    boxes.append({d: (n[d] // 2 - edge // 2, n[d] // 2 + edge // 2)
                  for d in dims})
    dev = state[spec.outputs[0]][0].device
    shifted = _with_offset(prog, {}, dev)
    a = kern.chunk(dict(state), t, 1)
    err, nbits, scale = 0.0, 0, 0.0
    for box in boxes:
        b = plain_shard_chunk(shifted, state, t, box, spec.base_outputs)
        for name in spec.outputs:
            idx = _box_idx(prog.geoms[name], box)
            x, y = a[name][-1][idx], b[name][-1][idx]
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
        del b
    del a
    return err, nbits, scale, len(boxes)


def family_full(fac, env, card: str, st: str, r, arm: str, g: int = 512,
                warm: int = 2, trials: int = 3, steps: int = 20,
                eb: int = 4, sweep: bool = True, seed=None,
                plain_g: int = 0, cli: str = "", digest: bool = False,
                profile: bool = False, stream_sweep=(), reps: int = 5,
                profile_body: bool = True) -> dict:
    """Phase 9 (c), and phase 11 (c) at element size ``eb`` = 2: ``st``
    at ``g``³ ``-mode fused -wf_steps 2`` through the user's entry
    points, seeded by ``seed(ctx)`` (:func:`full_seed` by default);
    with ``sweep``, K6 at the ladder's next smaller tiles too; with
    ``plain_g``, the plain version is timed and held against a 2-step
    chunk on a context of ``plain_g``³ seeded alike (its full-width run
    does not fit the card: tti r=8's memoized sub-expressions), and one
    launch at ``g``³ is held against it over the corner and centre boxes
    (:func:`boxes_vs_plain`).  ``cli`` is added to the context's options
    (``-no-skew``: K6's body where its stream arm would engage); with
    ``stream_sweep`` K6's stream arm at those (T1, T2, threads) plane
    tiles too (:func:`stream_kernel`); with ``digest`` the entry holds the
    final state's :func:`state_digest` under ``state_digest``, with
    ``profile`` the device times of 3 launches under
    :func:`profile_launches` (on K6's stream arm, of 3 of the arm and,
    with ``profile_body``, 3 of K6's body from the same state in one
    window) under ``profile``, for the caller to take out; ``reps``
    launches are timed.  Returns the arm's ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops import fused_stencil
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, stages_step
    npts = g ** 3
    live = live_inputs(fac, env, st, r)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = a3_ctx(fac, env, st, r, eb, (g, g, g), "fused", 2, cli)
    (seed or full_seed)(ctx)
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
    key = stages_counter(ctx._fused)
    if got != {key: trials * steps}:
        raise RuntimeError(f"{what}: launches {got}, expected "
                           f"{trials * steps} of {key}")
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
    ms = cuda_ms(lambda: stages_step(kern, state, t), reps)
    prof = None
    if profile:
        # the stream arm and the body it replaces in one profiler window
        both = stages_counter(kern) == "stages_stream" and profile_body
        prof = profile_launches(
            (lambda: (stages_step(kern, state, t),
                      fused_stencil._launch(kern, state, t, "K6 body")))
            if both else (lambda: stages_step(kern, state, t)), 3,
            expect=(("stream_stages_kernel", "fused_stages_kernel")
                    if both else ("_stages_kernel",)))
    digest = state_digest(ctx) if digest else None
    prog = ctx._program
    pk, pstate, pprog, pt, pg = kern, state, prog, t, g
    full_check = ""
    if plain_g:
        # the kernel at full width against the plain version over boxes
        b_err, b_bits, b_scale, nbox = boxes_vs_plain(kern, state, t)
        full_check = (f"one launch at {g}^3 vs plain over {nbox} boxes of "
                      f"32^3 (the corners and the centre): max|d|="
                      f"{b_err:.3e} (field max {b_scale:.3e}), {b_bits} "
                      "cells differ in their bits; ")
        if not b_err <= eps * b_scale:
            raise RuntimeError(f"{what}: K6 at {g}^3 and its plain version "
                               "disagree over the boxes")
        small = a3_ctx(fac, env, st, r, eb, (plain_g,) * 3, "fused", 2,
                       cli)
        (seed or full_seed)(small)
        pk, pstate, pprog, pt, pg = (small._fused_kernel(), small._state,
                                     small._program, 0, plain_g)
    plain_ms = cuda_ms(lambda: plain_chunk(pprog, pstate, pt, 1), 2)
    a = pk.chunk(dict(pstate), pt, 2)
    b = plain_chunk(pprog, dict(pstate), pt, 2)
    err, nbits, scale = 0.0, 0, 0.0
    for n in kern.spec.outputs:
        for x, y in zip(a[n][-2:], b[n][-2:]):
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
    del b
    staged, computed = cells_per_point(kern.spec)
    if "stages_stream" in til:
        # K6's stream arm: its plane tile's staged and computed cells
        staged = til["stages_stream"]["staged_per_point"]
        computed = til["stages_stream"]["computed_per_point"]
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
    if stream_sweep and plain_g:
        # ``a`` is the small context's chunk: the sweep's reference is
        # the kernel's own at full width
        del a
        a = kern.chunk(dict(state), t, 2)
    for rung in stream_sweep:
        var = stream_kernel(prog, ctx._push_arg(), rung)
        c = var.chunk(dict(state), t, 2)
        same = all(torch.equal(x, y) for n in kern.spec.outputs
                   for x, y in zip(a[n][-2:], c[n][-2:]))
        del c
        if not same:
            raise RuntimeError(f"{what}: the stream arm at {rung} gives "
                               "other bits")
        rec = var.spec.stages_stream.record()
        rows.append({"tile": [1] + rec["plane_tile"],
                     "threads": rec["threads"],
                     "ms": cuda_ms(lambda: stages_step(var, state, t), 5),
                     "smem_bytes": rec["smem_bytes"],
                     "staged_cells_per_point": rec["staged_per_point"],
                     "computed_cells_per_point": rec["computed_per_point"]})
        del var
    del a
    log(f"{what} -mode fused -wf_steps 2: state {state_bytes / 2**30:.2f} GiB ({state_bytes} B, seeded in "
        f"{seed_s:.1f} s); {trials} trials x {steps} steps: "
        f"{step_ms:.3f} ms/step (min {npts / rates[-1] * 1e3:.3f}, max "
        f"{npts / rates[0] * 1e3:.3f}), {mid:.4e} points/s; launches "
        f"{got}; K6 ({key}) {ms:.3f} ms/launch (CUDA events, the "
        f"outputs' allocation included); bound {bound_ms:.3f} ms ({bound_by}: "
        f"{nbytes / npts:.0f} B/pt -> {bytes_ms:.3f} ms at 3.35 TB/s; "
        f"{ops_pp} FLOP/pt -> {flops_ms:.3f} ms at 67 TFLOP/s fp32), share "
        f"{bound_ms / ms:.3f} per launch, {bound_ms / step_ms:.3f} per step;"
        f" tiling: {til['stages']} sub-stages ({til['scratch_stages']} of "
        f"scratch vars), tile {til['tile']}, smem {til['smem_bytes']} B; "
        + (f"workspace arm {til['workspace']}; " if "workspace" in til
           else "") +
        f"per point of the block: {staged:.2f} staged input cells "
        f"({len(kern.spec.tiled)} inputs), computed cells per sub-stage "
        f"{[round(x, 2) for x in computed]}; live inputs {len(live)} of "
        f"{len(kern.spec.inputs)} (dead: "
        f"{sorted(set(kern.spec.inputs) - set(live))}); "
        f"plain version {plain_ms:.3f} ms/step at {pg}^3 (not a "
        f"yardstick); one 2-step chunk vs plain at {pg}^3: max|d|="
        f"{err:.3e} (field max {scale:.3e}), "
        f"{nbits} cells differ in their bits; {full_check}"
        f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB "
        f"[{card}]")
    if profile:
        log(f"{what}: 3 launches under torch.profiler: "
            + (json.dumps(prof) if prof else "no device activity seen")
            + f" [{card}]")
    for v in rows:
        log(f"{what}: K6 at tile {v['tile']}"
            + (f" (stream arm, {v['threads']} threads)" if "threads" in v
               else "") + " "
            f"({v['smem_bytes']} B): {v['ms']:.3f} ms/launch (CUDA events; "
            f"{ms:.3f} at its own tile {til['tile']}), "
            f"{v['staged_cells_per_point']:.2f} staged cells per point, "
            f"computed per sub-stage "
            f"{[round(x, 2) for x in v['computed_cells_per_point']]}; the "
            f"same bits [{card}]")
    if not err <= eps * scale:
        raise RuntimeError(f"{what}: K6 and its plain version disagree")
    if plain_g:
        err = max(err, b_err)
    source = stages_source(kern)
    del ctx, kern, state
    torch.cuda.empty_cache()
    entry = {"name": f"stages_step ({arm})", "route": "cuda",
             "source": source, "launches": got[key], "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None,
             "per": f"launch, {st} r={r} {g}^3 {dt}",
             "plain_per": f"step at {pg}^3",
             "step_ms": step_ms, "bytes_per_point": nbytes / npts,
             "state_bytes": state_bytes, "staged_cells_per_point": staged,
             "computed_cells_per_point": computed, "tile_sweep": rows}
    if digest is not None:
        entry.update(state_digest=digest)
    if profile:
        entry.update(profile=prof)
    return entry


def phase9(fac, env, card: str, full: int = 512) -> list:
    """The families path (see the module docstring); returns the
    ``kernels`` entries of K6's scratch arm (tti) and rewrite arm (awp),
    both on K6's body under ``-no-skew``, seeded on the card; each entry
    holds the final state's digest for phase 18 (b) and 17 (b)."""
    t_phase = time.perf_counter()
    worst = phase9a(fac, env)
    phase9b(fac, env)
    scratch = family_full(fac, env, card, "tti", 2,
                          "scratch arm, the -no-skew body", full,
                          cli="-no-skew", digest=True)
    scratch.update(replaces="yask_tpu/ops/pallas_stencil.py:175 (_TileEval."
                            "read scratch :175-179, the stage loop's reset "
                            ":2003 and scratch writes :2105-2147)",
                   path="phase 9 (c), tti r=2")
    # (awp's body at the ladder's smaller tiles, 2.7 and 6.9 s of
    # launches, is left out for the run's time: PERF.md has its times)
    rewrite = family_full(fac, env, card, "awp", None,
                          "rewrite arm, the -no-skew body", full,
                          cli="-no-skew", digest=True, sweep=False)
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


def five_d(name: str = "five_d"):
    """Phase 21's 5-D solution on K6 in the port's DSL (the one
    ``tests/test_torch_4d.py`` holds against ``yask_tpu``): two outer dims
    (v, w), a scratch var and a second stage read at offsets in both."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution(name)
    t = soln.new_step_index("t")
    v, w, x, y, z = (soln.new_domain_index(d) for d in "vwxyz")
    a = soln.new_var("a", [t, v, w, x, y, z])
    b = soln.new_var("b", [t, v, w, x, y, z])
    s = soln.new_scratch_var("s", [v, w, x, y, z])
    s(v, w, x, y, z).EQUALS(a(t, v, w, x, y, z)
                            + a(t, v - 1, w + 1, x, y, z) * 0.5)
    a(t + 1, v, w, x, y, z).EQUALS(
        a(t, v, w, x, y, z) * 0.25 + s(v + 1, w, x, y, z) * 0.25
        + s(v, w - 1, x, y + 1, z) * 0.125).IF_DOMAIN(v > 0)
    b(t + 1, v, w, x, y, z).EQUALS(b(t, v, w, x, y, z) * 0.5
                                   + a(t + 1, v - 1, w + 1, x, y, z) * 0.2)
    return soln


def dsl_solution(stencil: str):
    """The solutions this script builds with the port's DSL."""
    return (five_d(stencil) if stencil.startswith("five_d")
            else four_d_stages(stencil) if stencil.startswith("four_d_")
            else partial_solution(stencil))


def a3_ctx(fac, env, stencil, radius, eb, sizes, mode, K=1, cli=""):
    """A context of ``stencil`` over ``sizes`` (per slot 0-2, fewer dims
    taking the last slots; or one per domain dim in solution order) at
    element size ``eb``, ``-mode mode -wf_steps K``."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    if stencil.startswith(("partial_", "scratch_partial", "four_d_",
                           "five_d")):
        src = dsl_solution(stencil)
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
    """Phase 10's kernels, for phase 1's parallel build.  At element size
    2 a source follows the parity of the minor extent (the context pads
    it to even), so those cases are emitted at phase 10 (a)'s ragged
    sizes too."""
    from yask_tpu_torch.ops import cuda_emit, fused_stencil
    out = {}
    for st, r, eb, _arm, _ks in A3_CASES:
        ctx = a3_ctx(fac, env, st, r, eb, (16, 16, 70), "fused")
        out[f"{st} r={r} {eb} B"] = fused_stencil.FusedKernel(
            ctx._program).spec
        if eb == 2:
            sizes = ragged_sizes(cuda_emit.emit(ctx._program).tile)
            ctx = a3_ctx(fac, env, st, r, eb, sizes, "fused")
            out[f"{st} r={r} {eb} B ragged"] = fused_stencil.FusedKernel(
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


def seed_device(ctx, seed: int, physical: bool = False) -> None:
    """A seeded random interior state made on the card (a torch CUDA
    generator, bulk): written vars uniform in [0, 1), read-only ones
    0.05 + 0.01 U; with ``physical``, in :func:`seed_physical`'s ranges
    (read-only coefficients by :data:`COEFF_RANGES`, written vars in
    [0, 0.01))."""
    import torch
    gen = torch.Generator(device=ctx._device).manual_seed(seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for name in sorted(ctx._state):
        lo, hi = (WRITTEN_RANGES.get((ctx.get_name(), name), (0.0, 0.01))
                  if name in written else
                  COEFF_RANGES.get(name, (0.05, 0.06)))
        for slot in range(len(ctx._state[name])):
            shape = ctx._interior_shape(name)
            v = torch.rand(shape, generator=gen, device=ctx._device)
            if physical:
                v = lo + (hi - lo) * v
            elif name not in written:
                v = 0.05 + 0.01 * v
            ctx._fill_interior(name, slot,
                               lambda xp, n, v=v: v.reshape(-1))


def a3_bound(ctx, spec=None) -> tuple:
    """The least time of one sub-step of ``ctx``'s kernel: each input (a
    var's ring slot and misc slice) read once and each output slice
    written once over the interior, against 3.35 TB/s, or its FLOPs at
    67 TFLOP/s fp32 (the kernel computes in float at every element
    size), whichever is larger; ``spec`` replaces the context's kernel
    (K7's push-off batch of a pushing solution writes what it pushes).
    Returns (ms, "bytes"/"operations", bytes)."""
    import numpy as np
    prog, spec = ctx._program, spec or ctx._fused_spec_kernel().spec

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
            cli: str = "", exact: bool = False, physical: bool = False,
            live=None) -> dict:
    """Phase 10 (c), phase 11 (c) and phase 16: one case at full width
    through the user's entry points (``-mode fused -wf_steps K``):
    warm-up, then ``trials`` runs of ``steps`` steps with every counter
    zeroed just before; the arm's ms per launch against its bound (the
    ``live`` inputs read once where given, else :func:`a3_bound`'s
    arrays), its plain version's time and one chunk against it (with
    ``exact``, to the bit), from :func:`seed_device`'s state (in physical
    ranges with ``physical``).  Returns the ``kernels`` entry, with the
    context under ``ctx``."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = a3_ctx(fac, env, st, r, eb, sizes, "fused", K, cli)
    seed_device(ctx, 11, physical=physical)
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
    if live is not None:
        nbytes = io_bytes(ctx, live)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = ctx._ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
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
    if not err <= eps * scale or (exact and nbits):
        raise RuntimeError(f"{label}: {arm} and its plain version "
                           f"disagree ({nbits} cells differ in their bits)")
    return {"name": f"{arm} ({label.split(': ')[0]})", "route": "cuda",
            "launches": got[arm], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"launch, {label.split(': ', 1)[-1]}",
            "step_ms": step_ms, "bytes_per_point": nbytes / npts,
            "peak_bytes": peak, "ctx": ctx}


#: The bfloat16 conv2d yardstick against the kernel, of the field's
#: scale: the call may round its partial sums to bfloat16 (on the CPU it
#: lands 4 bfloat16 ulps from the kernel, which rounds once), so it is
#: held at the tests' bfloat16 tolerance, not BF16_FIELD_EPS.
BF16_LIBRARY_EPS = 3e-2


def gaussian_conv2d(src, r: int = 2):
    """The one PyTorch call that computes the Gaussian filter's step (off
    the port's path, a yardstick) on ``src`` (N, 3, H, W): ``conv2d(src,
    w, padding=r, groups=3)`` with the weights ``w1[i] w1[j]`` (in
    ``src``'s dtype) and zero pads as the ghost cells, in full float32
    (cuDNN's TF32 off) or bfloat16.  Returns its ms (CUDA events) and its
    output."""
    import math
    import torch
    sigma = max(r / 2.0, 0.5)
    w1 = [math.exp(-(i * i) / (2 * sigma * sigma)) for i in range(-r, r + 1)]
    w1 = [w / sum(w1) for w in w1]
    w = torch.tensor([[a * b for b in w1] for a in w1], dtype=torch.float32,
                     device=src.device).expand(3, 1, 2 * r + 1, 2 * r + 1) \
        .contiguous().to(src.dtype)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
            src, w, padding=r, groups=3), 5)
        lib = torch.nn.functional.conv2d(src, w, padding=r, groups=3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return lib_ms, lib


def gaussian_library(entry, card: str, r: int = 2,
                     phase: str = "phase 10") -> None:
    """:func:`gaussian_conv2d` over the solo image of phase 10 (c) (in
    float32) or phase 16 (d) (in bfloat16): its time is the entry's
    ``library_ms``; its output is held against the kernel's within
    ``FIELD_EPS`` (:data:`BF16_LIBRARY_EPS` in bfloat16) of the field."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    ctx = entry["ctx"]
    src = ctx._state["img"][-1][ctx._interior_idx("img")].unsqueeze(0) \
        .contiguous()
    lib_ms, lib = gaussian_conv2d(src, r)
    t = ctx._cur_step
    out = fs.stages_step(ctx._fused, dict(ctx._state), t)["img"][-1]
    mine = out[ctx._interior_idx("img")].float()
    scale = float(mine.abs().max())
    err = float((mine - lib[0].float()).abs().max())
    eps = BF16_LIBRARY_EPS if src.dtype == torch.bfloat16 else FIELD_EPS
    log(f"{phase}: gaussian r={r} {src.dtype}: torch.nn.functional.conv2d("
        f"groups=3, padding={r}, TF32 off) {lib_ms:.3f} ms (CUDA events; "
        f"the yardstick, off the port's path) against the kernel's "
        f"{entry['ms']:.3f} ms/launch; kernel vs conv2d max|d|={err:.3e} "
        f"(field max {scale:.3e}, tolerance {eps} of it) [{card}]")
    if not err <= eps * scale:
        raise RuntimeError(f"{phase}: gaussian: the kernel and conv2d "
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
                    f"{image}^2x3 fp32", K=1, exact=True)
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
#: Phase 11 runs test_4d on K1's body, four_d_stages and the bfloat16 3-D
#: solutions on K6's body (``-no-skew``): the twins that phases 24, 21 and
#: 22 hold K1's and K6's stream arms (the default) to
A3B_CLI = {"test_4d": "-no-skew", "four_d_stages": "-no-skew",
           "tti": "-no-skew", "ssg": "-no-skew", "awp": "-no-skew"}


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
    not depend on the domain size, but at element size 2 on the parity
    of the minor extent, which the context pads to even: those cases are
    emitted at phase 11 (a)'s ragged sizes too)."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r, eb, _arm in A3B_CASES:
        ctx = a3_ctx(fac, env, st, r, eb, (4, 16, 16, 70), "fused")
        out[f"{st} r={r} {eb} B"] = fused_stencil.FusedKernel(
            ctx._program).spec
        if eb == 2:
            ctx = a3_ctx(fac, env, st, r, eb, a3b_sizes(fac, env, st, r, eb),
                         "fused")
            out[f"{st} r={r} {eb} B ragged"] = fused_stencil.FusedKernel(
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
            fused = a3_ctx(fac, env, st, r, eb, sizes, "fused", K,
                           A3B_CLI.get(st, ""))
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
        fused = a3_ctx(fac, env, st, r, eb, sizes, "fused", 2,
                       A3B_CLI.get(st, ""))
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
    entries, test_4d's and the bf16 one holding their final states'
    digests under ``state_digest`` (phase 24 (b)'s and phase 22 (b)'s
    twins) for the caller to take out."""
    import torch
    t_phase = time.perf_counter()
    worst = phase11a(fac, env)
    phase11b(fac, env)
    k1 = a3_full(fac, env, card, "test_4d", None, 4, (full4,) * 4,
                 "fused_step", f"4-D arm of K1: test_4d {full4}^4 fp32 "
                 "(-no-skew, K1's body)", cli=A3B_CLI["test_4d"])
    til = k1["ctx"].get_stats().get_tiling()
    log(f"phase 11: test_4d {full4}^4: tiling {til['kernel']}, tile "
        f"{til['tile']}, smem {til['smem_bytes']} B; the stream arm: "
        f"{sorted({x['code'] for x in til['skew_reasons']})} "
        f"({til['skew_reasons'][0]['detail']})")
    if til["kernel"] != "fused_step" or any(
            x["code"] != "skew_disabled" for x in til["skew_reasons"]):
        raise RuntimeError("phase 11: test_4d did not run on K1's body "
                           "under -no-skew")
    # its final state's digest: phase 24 (b)'s twin (main pops it)
    k1["state_digest"] = state_digest(k1["ctx"])
    k1.update(source="yask_tpu_torch/csrc/fused_step.cuh",
              replaces="yask_tpu/ops/pallas_stencil.py:1442 (the grid over "
                       "every lead dim; test_4d in tests/test_pallas.py:"
                       "135)", path="phase 11 (c), test_4d")
    del k1["ctx"]
    torch.cuda.empty_cache()
    k6 = a3_full(fac, env, card, "four_d_stages", None, 4, (full4,) * 4,
                 "stages_step", f"4-D arm of K6: four_d_stages {full4}^4 "
                 "fp32 (-no-skew, K6's body)", trials=1, steps=10,
                 cli=A3B_CLI["four_d_stages"])
    k6.update(source="yask_tpu_torch/csrc/fused_step.cuh",
              replaces="yask_tpu/ops/pallas_stencil.py:1442 (the grid over "
                       "every lead dim) with the stage loop :2058-2188",
              path="phase 11 (c), four_d_stages (one trial of 10 steps)")
    del k6["ctx"]
    torch.cuda.empty_cache()
    bf = family_full(fac, env, card, "tti", 2, "element size 2, the "
                     "-no-skew body", full, eb=2, sweep=False,
                     cli=A3B_CLI["tti"], digest=True)
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

# ---- phase 12: K7 on every arm of the member batch -----------------------

#: Phase 12's arms of a member batch: (arm, solution, radius, element
#: bytes, mid-width sizes per slot (or per dim of a 4-D solution), the K7
#: wrapper that runs it).  Phase 12 (a) runs each at its mid width.
K7_CASES = (("scratch", "tti", 2, 4, (48, 48, 70), "batched_stages_step"),
            ("rewrite", "awp", None, 4, (48, 48, 70),
             "batched_stages_step"),
            ("stages", "ssg", 2, 4, (48, 48, 70), "batched_stages_step"),
            ("misc", "gaussian", 2, 4, (1, 512, 512),
             "batched_stages_step"),
            ("misc", "test_misc_2d", None, 4, (1, 512, 512),
             "batched_step"),
            ("partial-dim", "partial_written", None, 4, (48, 48, 70),
             "batched_stages_step"),
            ("element size 2", "iso3dfd", 8, 2, (48, 48, 70),
             "batched_step"),
            ("4-D", "test_4d", None, 4, (16, 16, 16, 16), "batched_step"),
            ("4-D", "four_d_stages", None, 4, (16, 16, 16, 16),
             "batched_stages_step"))
#: Phase 12 (b)'s cells at full width: (arm, solution, radius, element
#: bytes, members, sizes per member, the wrapper, the solo row's key): the
#: members hold the points of the solo row of an earlier phase (test_4d:
#: half of phase 11's 128^4).
K7_FULL = (("scratch", "tti", 2, 4, 8, (256,) * 3, "batched_stages_step",
            "tti"),
           ("element size 2", "iso3dfd", 8, 2, 8, (256,) * 3,
            "batched_step", "iso3dfd bf16"),
           ("4-D", "test_4d", None, 4, 8, (64,) * 4, "batched_step",
            "test_4d"),
           ("misc", "gaussian", 2, 4, 4, (1, 4096, 4096),
            "batched_stages_step", "gaussian"),
           ("rewrite", "awp", None, 4, 8, (256,) * 3, "batched_stages_step",
            "awp"))
#: what K7 replaces: the reference's vmap of ``build_pallas_chunk``
K7_REPLACES = ("yask_tpu/runtime/ensemble.py:234-345 (jax.vmap of "
               "build_pallas_chunk :253-263, :334) -> "
               "yask_tpu/ops/pallas_stencil.py:2312")


def k7_specs(fac, env) -> dict:
    """Phase 12's kernels, for phase 1's parallel build: each arm's
    push-off source (K7's entry ``<name>_batched`` is in every emitted
    source) and the bfloat16 RTM chain's (phase 12 (d))."""
    from yask_tpu_torch.compiler.lowering import BFLOAT16
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for _arm, st, r, eb, sizes, _w in K7_CASES:
        ctx = a3_ctx(fac, env, st, r, eb, tuple(min(n, 16) for n in sizes),
                     "fused")
        out[f"{st} r={r} {eb} B (K7)"] = fused_stencil.FusedKernel(
            ctx._program).spec
    pipe = rtm_pipe(env, "-mode fused -wf_steps 1", True, (16, 16, 16),
                    dtype=BFLOAT16)
    out["rtm r=2 pure bf16"] = pipe.fused_ctx._fused_spec_kernel().spec
    pipe.end()
    return out


def member_batch(fac, env, st, r, eb, sizes, nm: int, seed, K: int = 2,
                 cli: str = ""):
    """A ``-mode fused -wf_steps K`` context of ``st`` (and ``cli``) and
    an ``EnsembleRun`` of ``nm`` members, member i seeded by ``seed(c,
    i)``."""
    ctx = a3_ctx(fac, env, st, r, eb, sizes, "fused", K, cli)
    ens = ctx.new_ensemble(nm)
    for i in range(nm):
        with ens.member(i) as c:
            seed(c, i)
    return ctx, ens


def k7_chunk_vs_plain(ctx, ens, t: int, k: int):
    """One ``k``-step K7 chunk of the stacked members against
    ``plain_batched_chunk`` on the card: (max |d|, cells whose bits
    differ, field max)."""
    from yask_tpu_torch.ops.fused_stencil import plain_batched_chunk
    kern, prog, nm = ctx._batched_kernel(), ctx._program, ens.n
    state = ens._stack_states()
    a = kern.batched_chunk(dict(state), t, k, nm)
    b = plain_batched_chunk(prog, dict(state), t, k, nm)
    err, nbits, scale = 0.0, 0, 0.0
    for n in kern.spec.outputs:
        for x, y in zip(a[n][-k:], b[n][-k:]):
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
    return err, nbits, scale


def k7_bound(ctx, nm: int, live=None, spec=None) -> tuple:
    """K7's least time for ``nm`` members: a member's bound (phase 9's
    live inputs where given, else :func:`a3_bound`'s arrays, of ``spec``
    where given) times ``nm``.  Returns (ms, "bytes"/"operations",
    bytes)."""
    if live is None:
        _ms, _by, nbytes = a3_bound(ctx, spec)
    else:
        nbytes = io_bytes(ctx, live)
    npts = 1
    for d in ctx._ana.domain_dims:
        npts *= ctx._program.sizes[d]
    bytes_ms = nm * nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = nm * ctx._ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nm * nbytes)


def phase12a(fac, env, card: str, nm: int = 3, steps: int = 5,
             cases=None, cli: str = "-no-skew") -> list:
    """Phase 12 (a): each arm's member batch at mid width through
    ``EnsembleRun`` (K = 2, ``steps`` steps, the counters zeroed just
    before and read just after), each member against its solo ``-mode
    fused`` run to the bit, one K7 chunk against ``plain_batched_chunk``
    on the card, and K7's ms per launch at that width.  The batches run
    with ``cli`` (by default ``-no-skew``: K6's body, which phase 17 (a)
    holds the stream arm's batches to), the solo runs with the defaults.
    Returns the ``kernels`` entries."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    entries = []
    for arm, st, r, eb, sizes, wrapper in cases or K7_CASES:
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        ctx, ens = member_batch(fac, env, st, r, eb, sizes, nm,
                                lambda c, i: seed_case(c, 100 + i), cli=cli)
        zero_launch_counts()
        ens.run(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        spec = ctx._batched_kernel().spec
        key = stages_counter(ctx._batched_kernel(), wrapper)
        want = {key: steps}
        if spec.base_outputs:
            want["copy_base"] = len(spec.base_outputs) * steps
        if got != want:
            raise RuntimeError(f"phase 12: {st}: launches {got}, expected "
                               f"{want}")
        if ens.tiling["kernel"] != wrapper:
            raise RuntimeError(f"phase 12: {st} ran {ens.tiling['kernel']}")
        for i in range(nm):
            solo = a3_ctx(fac, env, st, r, eb, sizes, "fused", 2)
            seed_case(solo, 100 + i)
            solo.run_solution(0, steps - 1)
            with ens.member(i) as c:
                d, nbits = device_diff(c, solo, exact=True)
                ok = finite(c)
            if nbits or not ok:
                raise RuntimeError(f"phase 12: {st} member {i}: {nbits} "
                                   "cells differ from its solo run "
                                   f"(max|d|={d:.3e}), finite {ok}")
            del solo
        err, nbits, scale = k7_chunk_vs_plain(ctx, ens, steps, 2)
        state = ens._stack_states()
        kern, prog = ctx._batched_kernel(), ctx._program
        ms = cuda_ms(lambda: getattr(fs, wrapper)(kern, state, steps, nm), 5)
        plain_ms = cuda_ms(lambda: fs.plain_batched_chunk(
            prog, state, steps, 1, nm), 2)
        bound_ms, bound_by, nbytes = k7_bound(ctx, nm)
        shape = "x".join(map(str, sizes[-len(ctx._ana.domain_dims):]))
        log(f"phase 12: {arm} arm, {st} r={r} {eb} B, {nm} x {shape} "
            f"K=2 {steps} steps: launches {got}; every member bit-equal to "
            f"its solo -mode fused run; one 2-step {wrapper} chunk vs plain "
            f"(plain_batched_chunk on the card): max|d|={err:.3e} (field "
            f"max {scale:.3e}), {nbits} cells differ in their bits; "
            f"{wrapper} {ms:.3f} ms/launch (CUDA events), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms; "
            f"tile {list(spec.tile)}, {spec.stages} sub-stage(s) [{card}]")
        if not err <= eps * scale:
            raise RuntimeError(f"phase 12: {st}: K7 and its plain version "
                               "disagree")
        entries.append({
            "name": f"{wrapper} ({arm} arm: {st} r={r} {eb} B, {nm} x "
                    f"{shape}, mid width)",
            "route": "cuda", "source": stages_source(kern, wrapper),
            "replaces": K7_REPLACES, "launches": got[key],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": "phase 12 (a)"})
        del ctx, ens, state, kern
        release()
    return entries


def k7_gaussian_library(ctx, ens, kern, t: int, card: str) -> float:
    """:func:`gaussian_conv2d` over the member stack (N, 3, H, W) of
    phase 12 (b)'s gaussian batch, held against one K7 launch from the
    same state within ``FIELD_EPS`` of the field; returns its ms."""
    from yask_tpu_torch.ops import fused_stencil as fs
    state = ens._stack_states()
    idx = (slice(None),) + ctx._interior_idx("img")
    lib_ms, lib = gaussian_conv2d(state["img"][-1][idx].contiguous())
    mine = fs.batched_stages_step(kern, dict(state), t, ens.n)["img"][-1][idx]
    scale = float(mine.abs().max())
    err = float((mine - lib).abs().max())
    log(f"phase 12: gaussian r=2, {ens.n} members: torch.nn.functional."
        f"conv2d(groups=3, padding=2, TF32 off) over the {tuple(lib.shape)} "
        f"stack {lib_ms:.3f} ms (CUDA events; the yardstick, off the "
        f"port's path); K7 vs conv2d max|d|={err:.3e} (field max "
        f"{scale:.3e}) [{card}]")
    if not err <= FIELD_EPS * scale:
        raise RuntimeError("phase 12: gaussian: K7 and conv2d disagree")
    return lib_ms


def phase12b(fac, env, card: str, solo: dict, warm: int = 2,
             trials: int = 3, steps: int = 20, cells=None,
             cli: str = "-no-skew", phase: str = "12",
             digest: bool = False, profile: bool = False) -> list:
    """Phase 12 (b): each cell of :data:`K7_FULL` through ``EnsembleRun``
    (``-wf_steps 2``): ``warm`` steps, then ``trials`` runs of ``steps``
    with every counter zeroed just before; ms/step (host clock around
    ``run``, which stacks, launches, synchronizes and unstacks), K7's ms
    per launch against its bound, the plain version's time, one chunk
    against it, the peak memory, and the solo row of an earlier phase
    (``solo``) beside it.  ``cells`` replaces :data:`K7_FULL`; the
    batches run with ``cli`` (by default ``-no-skew``: the bodies, phases
    17 (c) and 23 (b) run the stream arms').  With ``digest`` each entry
    holds the members' states after the trials (``state_digest``, before
    any timed launch); with ``profile``, 3 launches under
    ``torch.profiler``.  Returns the ``kernels`` entries."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    entries = []
    for arm, st, r, eb, nm, sizes, wrapper, key in cells or K7_FULL:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = live_inputs(fac, env, st, r) if st in ("tti", "awp") else None
        t0 = time.perf_counter()
        ctx, ens = member_batch(
            fac, env, st, r, eb, sizes, nm,
            lambda c, i: seed_device(c, 11 + i, physical=True), cli=cli)
        torch.cuda.synchronize()
        seed_s = time.perf_counter() - t0
        npts = 1
        for d in ctx._ana.domain_dims:
            npts *= ctx._program.sizes[d]
        ens.run(0, warm - 1)
        t = warm
        zero_launch_counts()
        secs = []
        for _ in range(trials):
            t0 = time.perf_counter()
            ens.run(t, t + steps - 1)
            secs.append(time.perf_counter() - t0)
            t += steps
        got = {k: v for k, v in launch_counts().items() if v}
        kern, prog = ctx._batched_kernel(), ctx._program
        counter = stages_counter(kern, wrapper)
        want = {counter: trials * steps}
        digests = None
        if digest:
            digests = []
            for i in range(nm):
                with ens.member(i) as c:
                    digests += state_digest(c)
        if kern.spec.base_outputs:
            want["copy_base"] = len(kern.spec.base_outputs) * trials * steps
        if got != want:
            raise RuntimeError(f"phase 12: {st} {nm} members: launches "
                               f"{got}, expected {want}")
        for i in range(nm):
            with ens.member(i) as c:
                if not finite(c):
                    raise RuntimeError(f"phase 12: {st} member {i} is not "
                                       "finite")
        secs.sort()
        step_ms = secs[len(secs) // 2] / steps * 1e3
        state = ens._stack_states()
        ms = cuda_ms(lambda: getattr(fs, wrapper)(kern, state, t, nm), 5)
        plain_ms = cuda_ms(lambda: fs.plain_batched_chunk(
            prog, state, t, 1, nm), 2)
        prof = None
        if profile:
            prof = profile_launches(
                lambda: getattr(fs, wrapper)(kern, state, t, nm), 3,
                expect=(PROFILE_NAMES[counter],))
        del state
        err, nbits, scale = k7_chunk_vs_plain(ctx, ens, t, 2)
        peak = torch.cuda.max_memory_allocated()
        bound_ms, bound_by, nbytes = k7_bound(ctx, nm, live)
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        shape = "x".join(map(str, sizes[-len(ctx._ana.domain_dims):]))
        s_row = solo[key]
        s_pts = s_row["points"]
        log(f"phase {phase}: {arm} arm, {st} r={r} {eb} B, {nm} x {shape} "
            f"-mode fused -wf_steps 2 -ensemble {nm}: seeded on the card in "
            f"{seed_s:.1f} s; {trials} trials x {steps} steps: "
            f"{step_ms:.3f} ms/step (min {secs[0] / steps * 1e3:.3f}, max "
            f"{secs[-1] / steps * 1e3:.3f}; stacking and unstacking "
            f"included), {nm * npts / step_ms * 1e3:.4e} points/s; "
            f"launches {got}; {counter} {ms:.3f} ms/launch (CUDA events); "
            f"bound {bound_ms:.3f} ms ({bound_by}: {nbytes / nm / npts:.1f} "
            f"B/pt), share {bound_ms / ms:.3f} per launch, "
            f"{bound_ms / step_ms:.3f} per step; plain version "
            f"{plain_ms:.3f} ms/step (not a yardstick); one 2-step chunk "
            f"vs plain: max|d|={err:.3e} (field max {scale:.3e}), {nbits} "
            f"cells differ in their bits; torch.cuda.max_memory_allocated()"
            f" = {peak / 2**30:.2f} GiB; solo row ({s_row['label']}, "
            f"{s_pts} points) {s_row['ms']:.3f} ms/launch, "
            f"{s_row['step_ms']:.3f} ms/step: the batch per point "
            f"{(ms / (nm * npts)) / (s_row['ms'] / s_pts):.3f}x the solo "
            f"launch [{card}]")
        if not err <= eps * scale:
            raise RuntimeError(f"phase 12: {st}: K7 and its plain version "
                               "disagree at full width")
        lib_ms = None
        if st == "gaussian":
            lib_ms = k7_gaussian_library(ctx, ens, kern, t, card)
        entries.append({
            "name": f"{wrapper} ({arm} arm: {st} r={r} {eb} B, {nm} x "
                    f"{shape})",
            "route": "cuda", "source": stages_source(kern, wrapper),
            "replaces": K7_REPLACES, "launches": got[counter],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "path": "phase 12 (b)",
            "step_ms": step_ms, "bytes_per_point": nbytes / nm / npts,
            "peak_bytes": peak, "solo_ms": s_row["ms"],
            "solo_step_ms": s_row["step_ms"], "solo_points": s_pts,
            **({"state_digest": digests} if digest else {}),
            **({"profile": prof} if profile else {})})
        del ctx, ens, kern
        release()
    return entries


def phase12c(fac, env, card: str, g: int = 128, nses: int = 4,
             steps: int = 10) -> None:
    """Phase 12 (c): a ``StencilServer`` batch of ``nses`` fused tti r=2
    sessions at ``g``³, seeded in physical ranges through
    ``set_var_slice``: every response ok, batched at occupancy ``nses``,
    K7 over K6's stream arm (``-skew``'s default) launched once per step
    and nothing else, and each member bit-identical to a solo ``-mode
    fused`` run from its seed."""
    import tempfile
    import numpy as np
    from yask_tpu_torch.serve import StencilServer
    from yask_tpu_torch.serve.scheduler import extract_outputs
    tmp = tempfile.mkdtemp(prefix="yt_chip_smoke_")
    srv = StencilServer(env, journal_path=os.path.join(tmp, "SERVE.jsonl"),
                        window_secs=0.05, max_batch=nses)
    try:
        sids = [srv.open_session(stencil="tti", radius=2, g=g,
                                 mode="fused", wf=2, bucket=False)
                for _ in range(nses)]
        for i, sid in enumerate(sids):
            with srv.scheduler.session_ctx(sid) as c:
                slices = list(physical_slices(c, 200 + i))
            for name, vals, first, last in slices:
                srv.set_var_slice(sid, name, vals, first, last)
        zero_launch_counts()
        handles = [srv.submit_run(sid, 0, steps - 1) for sid in sids]
        resps = [srv.wait(h, timeout=600) for h in handles]
        got = {k: v for k, v in launch_counts().items() if v}
        for r in resps:
            if not (r.ok and r.batched and r.batch == nses
                    and not r.degraded):
                raise RuntimeError(
                    f"phase 12: served tti {r.rid}: status {r.status}, "
                    f"batch {r.batch}, batched {r.batched}, degraded "
                    f"{r.degraded}, error {r.error!r}")
        # the sessions take -skew's default: K7 over K6's stream arm
        with srv.scheduler.session_ctx(sids[0]) as c:
            key = stages_counter(c._batched_kernel(), "batched_stages_step")
        if got != {key: steps}:
            raise RuntimeError(f"phase 12: served tti: launches {got}, "
                               f"expected {steps} of {key}")
        for i, r in enumerate(resps):
            solo = fac.new_solution(env, stencil="tti", radius=2)
            solo.apply_command_line_options(f"-g {g} -mode fused "
                                            "-wf_steps 2")
            solo.prepare_solution()
            seed_physical(solo, 200 + i)
            solo.run_solution(0, steps - 1)
            want = extract_outputs(solo)
            d = max(float(np.abs(want[n].astype(np.float64)
                                 - r.outputs[n]).max()) for n in want)
            if d != 0.0:
                raise RuntimeError(f"phase 12: served tti member {i} is "
                                   f"not bit-identical to its solo run "
                                   f"(max|d|={d:.3e})")
            del solo
        log(f"phase 12: StencilServer, {nses} fused tti r=2 sessions at "
            f"{g}^3, {steps} steps: all ok, batched at occupancy {nses}, "
            f"none degraded; launches {got}; every member bit-identical to "
            f"its solo -mode fused run [{card}]")
    finally:
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def phase12d(env, card: str, fp32: dict, mid: int = 64,
             full: int = 512) -> dict:
    """Phase 12 (d): the RTM pipeline's push arm in bfloat16 (K6's body,
    ``-no-skew``, with the image pushed in a bfloat16 tile: the twin of
    phase 22 (b), its entry holding its final state's digest under
    ``state_digest``): at ``mid``³ for 4 steps, the fused
    pipeline on the card against its plain version on the card (within
    an ulp of bfloat16 of the field) and both against the numpy oracle
    (``-mode ref``) at (3e-2, 3e-2); then at ``full``³ as phase 6 (c),
    beside phase 6's fp32 row (``fp32``).  Returns the ``kernels``
    entry."""
    from yask_tpu_torch.compiler.lowering import BFLOAT16
    g = (mid,) * 3
    pipes = {mode: rtm_pipe(env, f"-mode {mode} -wf_steps 1"
                            + (" -no-skew" if mode == "fused" else ""),
                            True, g, dtype=BFLOAT16)
             for mode in ("fused", "torch", "ref")}
    if pipes["fused"].pushed_vars() != {"img__img"}:
        raise RuntimeError(f"phase 12: bf16 rtm pushed "
                           f"{pipes['fused'].pushed_vars()}")
    for p in pipes.values():
        seed_chain(p, g, 7)
    zero_launch_counts()
    pipes["fused"].run(0, 3)
    got = {k: v for k, v in launch_counts().items() if v}
    for mode in ("torch", "ref"):
        pipes[mode].run(0, 3)
    err, scale = pipe_diff(pipes["fused"], pipes["torch"])
    bad = {m: pipes[m].compare(pipes["ref"], BF16_ORACLE_EPS,
                               BF16_ORACLE_EPS) for m in ("fused", "torch")}
    log(f"phase 12: rtm chain r=2 pure bf16 {mid}^3, 4 steps, image pushed: "
        f"K6 vs plain on the card max|d|={err:.3e} (field max "
        f"{scale:.3e}); against the numpy oracle at (3e-2, 3e-2): fused "
        f"{bad['fused']}, plain {bad['torch']} mismatches; launches {got}")
    if got != {"stages_step": 4}:
        raise RuntimeError(f"phase 12: bf16 rtm launches {got}")
    if not err <= BF16_FIELD_EPS * scale or any(bad.values()):
        raise RuntimeError("phase 12: the bf16 push arm disagrees")
    for p in pipes.values():
        p.end()
    del pipes
    e = rtm_full(env, full, "push, the -no-skew body", "-no-skew",
                 {"img__img"}, dtype=BFLOAT16, digest=True)
    log(f"phase 12: rtm chain r=2 pure {full}^3 push: bf16 {e['ms']:.3f} "
        f"ms/launch, {e['step_ms']:.3f} ms/step against fp32's "
        f"{fp32['ms']:.3f}, {fp32['step_ms']:.3f} (phase 6 (c) of this run); "
        f"bound {e['bound_ms']:.3f} against {fp32['bound_ms']:.3f} ms "
        f"[{card}]")
    e.update(name="stages_step (push arm, element size 2: rtm chain r=2 "
                  f"{full}^3 bf16)",
             replaces="yask_tpu/ops/pallas_stencil.py:2312 (push= arm, "
                      "VMEM tiles in the program dtype :2264-2289)",
             max_abs_err=max(e["max_abs_err"], err), path="phase 12 (d)",
             fp32_ms=fp32["ms"], fp32_step_ms=fp32["step_ms"])
    return e


def phase12(fac, env, card: str, solo: dict, rtm32: dict) -> list:
    """K7 on every arm of the member batch, the served batch of a K6
    solution, and the bfloat16 push arm (see the module docstring).
    Returns the ``kernels`` entries."""
    import torch
    t_phase = time.perf_counter()
    entries = phase12a(fac, env, card)
    torch.cuda.empty_cache()
    # each cell's final state's digest: phase 23 (b)'s twin of the bf16
    # iso3dfd batch (main pops them)
    entries += phase12b(fac, env, card, solo, digest=True)
    torch.cuda.empty_cache()
    phase12c(fac, env, card)
    torch.cuda.empty_cache()
    entries.append(phase12d(env, card, rtm32))
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# ---- phase 13: K5 on every arm (shard_pallas over K1's and K6's bodies)

X2 = (("x", 2),)
X2Y2 = (("x", 2), ("y", 2))
#: Phase 13 (a)'s cases: (label, stencil, radius, element bytes, sizes,
#: K, ranks, options); the overlap cases are held to the bits of the case
#: of the same solution and K without them.
K5_CASES = (
    ("ssg K=1", "ssg", None, 4, (64, 64, 64), 1, X2Y2, ""),
    ("ssg K=2", "ssg", None, 4, (64, 64, 64), 2, X2Y2, ""),
    ("tti r=2 K=1 x=2", "tti", 2, 4, (64, 64, 64), 1, X2, ""),
    ("tti r=2 K=2", "tti", 2, 4, (64, 64, 64), 2, X2Y2, ""),
    ("awp", "awp", None, 4, (64, 64, 64), 1, X2Y2, ""),
    ("swe2d K=2 x=2", "swe2d", None, 4, (96, 96), 2, X2, ""),
    ("test_scratch_3d", "test_scratch_3d", None, 4, (48, 48, 48), 1, X2Y2,
     ""),
    ("test_boundary_3d", "test_boundary_3d", None, 4, (48, 48, 48), 1,
     X2Y2, ""),
    ("gaussian r=2 K=2 x=2", "gaussian", 2, 4, (96, 96), 2, X2, ""),
    ("test_misc_2d K=2 x=2", "test_misc_2d", None, 4, (96, 96), 2, X2, ""),
    ("test_step_cond_1d x=2", "test_step_cond_1d", None, 4, (96,), 1, X2,
     ""),
    ("partial_written K=2 x=2", "partial_written", None, 4, (48, 48, 48), 2,
     X2, ""),
    ("iso3dfd r=2 bf16 K=2", "iso3dfd", 2, 2, (64, 64, 64), 2, X2Y2, ""),
    ("test_4d K=2 w=2", "test_4d", None, 4, (48, 48, 48, 48), 2,
     (("w", 2),), ""),
    ("test_4d K=2 x=2", "test_4d", None, 4, (48, 48, 48, 48), 2, X2, ""),
    ("ssg K=2 overlap on coalesce on", "ssg", None, 4, (64, 64, 64), 2,
     X2Y2, "-overlap_x on -coalesce on"),
    ("tti r=2 K=2 overlap on coalesce on", "tti", 2, 4, (64, 64, 64), 2,
     X2Y2, "-overlap_x on -coalesce on"),
)
#: Phase 13 (b): (label, stencil, radius, element bytes, edge, K)
K5_FULL = (("tti r=2 fp32", "tti", 2, 4, 512, 2),
           ("iso3dfd r=8 bf16", "iso3dfd", 8, 2, 512, 2),
           ("awp fp32", "awp", None, 4, 256, 1))


def k5_ctx(fac, st, r, eb, sizes, K, ranks, cli="", mode="shard_pallas",
           dev="cuda:0"):
    """A prepared context of ``st`` over ``sizes``: ``-mode
    shard_pallas`` on ``ranks`` shards of one card (one per shard in the
    env's device list), or another mode on the card alone."""
    S = 1
    for _d, n in ranks:
        S *= n
    if mode != "shard_pallas":
        S, ranks = 1, ()
    nr = " ".join(f"-nr_{d} {n}" for d, n in ranks)
    return a3_ctx(fac, fac.new_env(devices=[dev] * S), st, r, eb, sizes,
                  mode, K, f"{nr} {cli}")


def k5_specs(fac) -> dict:
    """Phase 13's kernels (K5 over each case's shard program, whose pads
    grow with K, and the single-domain twins), for phase 1's parallel
    build."""
    from yask_tpu_torch.ops import fused_stencil
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    out = {}
    for label, st, r, eb, sizes, K, ranks, cli in K5_CASES:
        small = tuple(max(16, 2 * 8 * K) for _ in sizes)
        ctx = k5_ctx(fac, st, r, eb, small, K, ranks, cli)
        out[f"K5 {label}"] = shard_pallas_plan(ctx).kernel.spec
        one = k5_ctx(fac, st, r, eb, small, K, ranks, mode="fused")
        out[f"{label} single domain"] = fused_stencil.FusedKernel(
            one._program).spec
    for label, st, r, eb, g, K in K5_FULL:
        ctx = k5_ctx(fac, st, r, eb, (64, 64, 64), K, X2Y2)
        out[f"K5 {label} full"] = shard_pallas_plan(ctx).kernel.spec
    return out


def k5_bound(kern, box, off, live=None) -> tuple:
    """The least time of one K5 launch over ``box`` of the shard at
    global origin ``off``: each input (a var's ring slot and misc slice;
    with ``live``, only those (var, slot) whose values can reach an
    output) read once over the box grown by its reach and clipped to the
    global domain (past it the pads hold zeros that need no reading;
    inside it, past the shard's interior, lie the cells exchanged from its
    neighbours), each output slice written once over the box, against
    3.35 TB/s, or its FLOPs at 67 TFLOP/s, whichever is larger.  Returns
    (ms, "bytes"/"operations", bytes)."""
    import numpy as np
    from yask_tpu_torch.ops import cuda_emit
    prog, spec = kern.program, kern.spec
    dims = list(prog.ana.domain_dims)
    slot = cuda_emit.slot_map(dims)
    nouter = max(len(slot) - 3, 0)
    esize = np.dtype(prog.dtype).itemsize
    # an input read at an outer offset is the same array: one reach
    arrays = {}
    for a, (n, s_) in enumerate(spec.inputs):
        if live is not None and (n, s_) not in live:
            continue
        key = (n, s_, spec.in_misc[a] if spec.in_misc else ())
        reach = [list(x) for x in spec.reach[a]]
        for o in (spec.in_outer[a] if spec.in_outer else [0] * nouter):
            reach.append([max(-o, 0), max(o, 0)])
        if key in arrays:
            reach = [[max(u[0], v[0]), max(u[1], v[1])]
                     for u, v in zip(arrays[key], reach)]
        arrays[key] = reach

    def cells(name, reach=None):
        c = 1
        for d in prog.geoms[name].domain_dims:
            lo, hi = box[d]
            if reach is not None:
                rl, rh = reach[slot[d]]
                lo = max(lo - rl, -off[d])
                hi = min(hi + rh, prog.global_last[d] + 1 - off[d])
            c *= max(hi - lo, 0)
        return c
    nslices = spec.out_slices or [(i, ()) for i in range(len(spec.outputs))]
    nbytes = esize * (sum(cells(n, r_) for (n, _s, _m), r_ in arrays.items())
                      + sum(cells(spec.outputs[i]) for i, _m in nslices))
    npts = 1
    for d in dims:
        npts *= box[d][1] - box[d][0]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = prog.ana.counters.num_ops * npts / FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes)


def exchange_bytes(sp, K: int) -> int:
    """Bytes one group's exchange moves (``exchange_newest``): the
    min(K, slots) newest slots of every written var, each ghost slab of
    ``hK`` per sharded dim read and written once, over the padded
    cross-section."""
    import numpy as np
    from yask_tpu_torch.parallel.shard_step import _widths_hK
    layout = sp.layout
    prog = sp.kernel.program
    esize = np.dtype(prog.dtype).itemsize
    total = 0
    for name in layout.names:
        g = prog.geoms[name]
        if not g.is_written:
            continue
        for d, (lo, hi) in _widths_hK(sp, K, g).items():
            cross = 1
            for ax, (dn, _k) in enumerate(g.axes):
                if dn != d:
                    cross *= g.shape[ax]
            pairs = len(layout.mesh.neighbour_pairs(d))
            total += (min(K, g.num_slots) * pairs * (lo + hi) * cross
                      * esize * 2)
    return total


def k5_time_launch(ctx, t: int, box, live=None):
    """K5 over ``box`` of shard 0 from the shards resident in ``ctx`` at
    step ``t``: (ms per launch with CUDA events, its bound, bound_by,
    bytes, plain ms, max |Δ| against the plain version and the field's
    max)."""
    from yask_tpu_torch.ops.fused_stencil import (plain_shard_step,
                                                  shard_step)
    sp = ctx._shard
    kern = sp.kernel
    layout, shards = ctx._run.resident
    off = layout.offsets[0]
    st0 = shards[0]
    ms = cuda_ms(lambda: shard_step(kern, st0, t, box, off), 5)
    plain_ms = cuda_ms(lambda: plain_shard_step(kern, st0, t, box, off), 1)
    a = shard_step(kern, dict(st0), t, box, off)
    b = plain_shard_step(kern, dict(st0), t, box, off)
    err, scale = 0.0, 0.0
    for n in kern.spec.outputs:
        err = max(err, float((a[n][-1].float() - b[n][-1].float()).abs()
                             .max()))
        scale = max(scale, float(b[n][-1].float().abs().max()))
    del a, b, st0, shards
    bound_ms, bound_by, nbytes = k5_bound(kern, box, off, live)
    return ms, bound_ms, bound_by, nbytes, plain_ms, err, scale


def phase13a(fac, card: str, steps: int = 5, cases=K5_CASES,
             dev: str = "cuda:0", stream: bool = False,
             phase: str = "13") -> list:
    """Phase 13 (a): each arm at mid width on K5's body (``-no-skew``)
    against K5's plain version on the card, the single-domain fused run to
    the bit, and its launch counts; returns per arm (label, body, ms per
    launch, bound, bound_by, plain ms, max |Δ|, launches, the -no-skew
    twin's ms per launch or None).  With ``stream`` (phase 19 (a)) each
    case runs K6's stream arm over its boxes (``-skew``, the default),
    bit-equal to its ``-no-skew`` twin (K5's body) too."""
    import torch
    from yask_tpu_torch.ops import fused_stencil
    from yask_tpu_torch.ops.fused_stencil import (plain_shard_step,
                                                  shard_step)
    from yask_tpu_torch.parallel.shard_step import _full_box
    arms, rows = {}, []
    counter = "shard_step_stream" if stream else "shard_step"
    for label, st, r, eb, sizes, K, ranks, cli in cases:
        S = 1
        for _d, n in ranks:
            S *= n
        arm = cli if stream else f"{cli} -no-skew"
        ctx = k5_ctx(fac, st, r, eb, sizes, K, ranks, arm, dev=dev)
        plain = k5_ctx(fac, st, r, eb, sizes, K, ranks, arm, dev=dev)
        one = k5_ctx(fac, st, r, eb, sizes, K, ranks, mode="fused",
                     dev=dev)
        twin = (k5_ctx(fac, st, r, eb, sizes, K, ranks, f"{cli} -no-skew",
                       dev=dev) if stream else None)
        for c in (ctx, plain, one, twin):
            if c is not None:
                seed_case(c, 13)
        zero_launch_counts()
        ctx.run_solution(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        fused_stencil.shard_step = plain_shard_step
        try:
            plain.run_solution(0, steps - 1)
        finally:
            fused_stencil.shard_step = shard_step
        one.run_solution(0, steps - 1)
        til = ctx.get_stats().get_tiling()
        ov = til["overlap_exchange"]
        want = {counter: k5_launches(S, steps, K, ov, 2 * len(
            til.get("overlap_core", {})))}
        nb = len(ctx._shard.kernel.spec.base_outputs)
        if nb:
            want["copy_base"] = nb * S * steps
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        body = ("K6" if til["stages"] > 1 or til["scratch_stages"]
                else "K1")
        # one launch while the shards are resident (a read gathers them)
        box = _full_box(ctx._shard, K, 0)
        ms, bound_ms, bound_by, _nb, plain_ms, err, scale = \
            k5_time_launch(ctx, steps, box)
        twin_ms, bad_twin = None, 0
        if stream:
            twin.run_solution(0, steps - 1)
            twin_ms = k5_time_launch(twin, steps, box)[0]
            bad_twin = ctx.compare_data(twin, epsilon=0.0, abs_epsilon=0.0)
        d = max_abs_diff(ctx, plain)
        bad_plain = ctx.compare_data(plain, field_epsilon=eps)
        bad_one = ctx.compare_data(one, epsilon=0.0, abs_epsilon=0.0)
        rec = til.get("stages_stream") or til.get("stream") or {}
        segs = [b["segment_planes"] for b in rec.get("box_segments", [])]
        what = (f"K5 over {body}'s stream arm ({til['name']}, segments "
                f"{segs})" if til["skew"] else f"K5 over {body}'s body")
        log(f"phase {phase}: {label} ({'x'.join(map(str, sizes))}, {eb} B, "
            f"mesh {til['mesh']}, {S} shards on {dev}, {what}, "
            f"{til['stages']} sub-stages): {steps} steps: overlap "
            f"{ov}; vs plain (plain_shard_step on the card) max|d|={d:.3e} "
            f"mismatches={bad_plain} (field_epsilon={eps}); vs "
            f"single-domain -mode fused compare_data(epsilon=0) = "
            f"{bad_one}"
            + (f"; vs the -no-skew twin (K5's body) compare_data(epsilon=0)"
               f" = {bad_twin}" if stream else "")
            + f"; launches {got} (expected {want}); finite "
            f"{finite(ctx)}; one launch over shard 0's sub-step-0 box "
            f"{ms:.4f} ms"
            + (f" (the twin's {twin_ms:.4f} ms)" if stream else "")
            + f", bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.3f} ms, max|d|={err:.3e} (field max {scale:.3e}) "
            f"[{card}]")
        if bad_plain or bad_one or bad_twin or not finite(ctx) \
                or not err <= eps * scale:
            raise RuntimeError(f"phase {phase}: {label}: {bad_plain} "
                               f"mismatches vs plain, {bad_one} vs "
                               f"single-domain, {bad_twin} vs the twin")
        if got != want:
            raise RuntimeError(f"phase {phase}: {label}: launches {got}, "
                               f"expected {want}")
        if "overlap on" in cli and not ov:
            raise RuntimeError(f"phase {phase}: {label}: the overlap did "
                               "not engage")
        if bool(til["skew"]) != stream:
            raise RuntimeError(f"phase {phase}: {label}: K6's stream arm "
                               f"{'did not engage' if stream else 'engaged'}"
                               f": {til['skew_reasons']}")
        arms[label] = ctx
        rows.append((label, body, ms, bound_ms, bound_by, plain_ms,
                     max(d, err), got[counter], twin_ms))
        del plain, one, twin
        torch.cuda.empty_cache()
    for a, b in (("ssg K=2", "ssg K=2 overlap on coalesce on"),
                 ("tti r=2 K=2", "tti r=2 K=2 overlap on coalesce on"),
                 ("iso3dfd r=8 K=2 overlap off",
                  "iso3dfd r=8 K=2 overlap on"),
                 ("iso3dfd r=8 K=2 overlap on",
                  "iso3dfd r=8 K=2 overlap on coalesce on")):
        if a in arms and b in arms:
            bad = arms[a].compare_data(arms[b], epsilon=0.0,
                                       abs_epsilon=0.0)
            log(f"phase {phase}: '{a}' vs '{b}': compare_data(epsilon=0) = "
                f"{bad}")
            if bad:
                raise RuntimeError(f"phase {phase}: '{a}' and '{b}' differ")
    return rows


def phase13b(fac, card: str, label, st, r, eb, g, K, warm: int = 1,
             trials: int = 3, steps: int = 20, dev: str = "cuda:0",
             stream: bool = False, twin: dict = None, cli: str = "",
             phase: str = "13", profile: bool = False) -> dict:
    """Phase 13 (b): one case at full width, ``-mode shard_pallas -nr_x 2
    -nr_y 2 -wf_steps K`` (and ``cli``) on four shards of the card, on
    K5's body (``-no-skew``), from :func:`seed_device`'s physical state,
    and its single-domain twin (``-mode fused``) from the same state,
    bit-equal after the same steps.  With ``stream`` (phase 19) K6's
    stream arm over each box instead.  With ``twin`` (an entry of a run
    from the same seed and steps) no single-domain run: the final
    shards' digest (:func:`shard_digest`, in the entry as
    ``state_digest``) must equal the twin's.  With ``profile``, 3
    launches of the arm and 3 of K5's body from one state under
    ``torch.profiler``.  Returns the ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import FusedKernel, shard_step
    from yask_tpu_torch.parallel import shard_step as shard_mod
    from yask_tpu_torch.parallel.shard_step import _full_box
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sizes = (g, g, g)
    npts = g ** 3
    counter = "shard_step_stream" if stream else "shard_step"
    ctx = k5_ctx(fac, st, r, eb, sizes, K, X2Y2,
                 cli if stream else f"{cli} -no-skew", dev=dev)
    seed_device(ctx, 11, physical=True)
    ctx.run_solution(0, warm * K - 1)
    t = warm * K
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
    ov = til["overlap_exchange"]
    want = {counter: trials * k5_launches(4, steps, K, ov, 2 * len(
        til.get("overlap_core", {})))}
    if ov != ("-overlap_x on" in cli) or got != want \
            or bool(til["skew"]) != stream:
        raise RuntimeError(f"phase {phase}: {label} at {g}^3: launches "
                           f"{got}, expected {want} (overlap {ov}, the "
                           f"stream arm {til['skew']})")
    peak = torch.cuda.max_memory_allocated()
    rates.sort()
    mid = rates[len(rates) // 2]
    step_ms = npts / mid * 1e3
    # outside the counted window: CUDA events around each exchange
    marks = []
    exchange_newest = shard_mod.exchange_newest

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
    xch_ms = (sum(e0.elapsed_time(e1) for e0, e1 in marks) / len(marks)
              if marks else 0.0)
    digest = shard_digest(ctx)
    sp = ctx._shard
    live = None if st == "iso3dfd" else live_inputs(fac, fac.new_env(
        devices=[dev]), st, r)
    boxes = [_full_box(sp, K, s_) for s_ in range(K)]
    timed_rows = [k5_time_launch(ctx, t, b, live) for b in boxes]
    prof = None
    body = "K6" if til["stages"] > 1 or til["scratch_stages"] else "K1"
    if profile:
        kern = sp.kernel
        layout, shards = ctx._run.resident
        st0, off = shards[0], layout.offsets[0]
        if body == "K1":
            # 3 launches of K5 over K1's stream arm alone over the grown
            # box (its -no-skew twin ran in a run of its own)
            prof = profile_launches(
                lambda: shard_step(kern, st0, t, boxes[0], off), 3,
                expect=("stream_step_kernel",))
        else:
            # 3 launches of the arm and 3 of K5's body (the -no-skew
            # kernel of the same source) over the grown box, from one
            # state
            body_kern = FusedKernel(kern.program, skew=False, region=True)
            body_kern.build()
            prof = profile_launches(
                lambda: (shard_step(kern, st0, t, boxes[0], off),
                         shard_step(body_kern, st0, t, boxes[0], off)), 3,
                expect=("stream_stages_kernel", "fused_stages_kernel"))
            del body_kern
        del st0, shards
    ms = [row[0] for row in timed_rows]
    k5_ms = sum(ms) / len(ms)
    bound_ms = sum(row[1] for row in timed_rows) / len(ms)
    bound_by = timed_rows[0][2]
    plain_ms = timed_rows[0][4]
    err = max(row[5] for row in timed_rows)
    scale = max(row[6] for row in timed_rows)
    xbytes = exchange_bytes(sp, K)
    # the step's bound: every shard's sub-steps over their boxes, and the
    # exchange, per step
    step_bytes = (4 * sum(row[3] for row in timed_rows) + xbytes) / K
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
    del timed_rows
    if twin is not None:
        # a run from the same seed and steps: its digest
        d, bad = None, int(digest != twin["state_digest"])
        vs = (f"{twin['what']} after the same {t} steps: final shards "
              f"bit-equal {not bad}")
    else:
        # the single-domain twin from the same seed, the same steps
        one = k5_ctx(fac, st, r, eb, sizes, K, X2Y2, mode="fused", dev=dev)
        seed_device(one, 11, physical=True)
        one.run_solution(0, t - 1)
        d, bad = device_diff(ctx, one, exact=True)
        del one
        vs = (f"the single-domain -mode fused twin after {t} steps: "
              f"max|d|={d:.3e}, {bad} cells differ (epsilon 0)")
    ok_finite = finite(ctx)
    peak = max(peak, torch.cuda.max_memory_allocated())
    n = g // 2
    rec = til.get("stages_stream") or til.get("stream") or {}
    segs = rec.get("box_segments", [])
    what = (f"K5 over {body}'s stream arm, segments per box "
            f"{[b['segment_planes'] for b in segs]} on "
            f"{[b['blocks'] for b in segs]} blocks" if stream
            else f"K5 over {body}'s body")
    opts = f"-wf_steps {K} -nr_x 2 -nr_y 2" + (f" {cli}" if cli else "")
    log(f"phase {phase}: {label} {g}^3 -mode shard_pallas {opts} (4 shards "
        f"of {n}x{n}x{g} on {dev}, "
        f"{what}): {trials} trials x {steps} steps: {step_ms:.3f} ms/step "
        f"(min {npts / rates[-1] * 1e3:.3f}, max "
        f"{npts / rates[0] * 1e3:.3f}), {mid:.4e} points/s; K5 launches "
        f"{got[counter]}; K5 per launch {', '.join(f'{m:.3f}' for m in ms)}"
        f" ms over the sub-step boxes {[{k: list(v) for k, v in b.items()} for b in boxes]} "
        f"(grown, then interior), bound {bound_ms:.4f} ms per launch "
        f"({bound_by}; live inputs over each box's reach clipped to the "
        f"global domain, outputs over the box), share "
        f"{bound_ms / k5_ms:.3f}; exchange {xch_ms:.3f} ms per group "
        f"({xbytes / 2**20:.1f} MiB read and written); step bound "
        f"{step_bound:.3f} ms, share {step_bound / step_ms:.3f}; plain "
        f"version {plain_ms:.3f} ms per launch (not a yardstick), one "
        f"launch vs plain max|d|={err:.3e} (field max {scale:.3e}); vs "
        f"{vs}; finite {ok_finite}; "
        + (f"3 launches of the arm"
           f"{' and 3 of the body' if body == 'K6' else ''} under "
           f"torch.profiler (ms per launch by kernel): {json.dumps(prof)}; "
           if profile else "")
        + f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB"
        + ("" if twin is not None else " (the twin included)")
        + f" [{card}]")
    if bad or not ok_finite or not err <= eps * scale:
        raise RuntimeError(f"phase {phase}: {label} at {g}^3: {bad} cells "
                           "differ from the twin, or K5 and its plain "
                           "version disagree")
    del ctx
    return {"name": f"shard_step ({label} {g}^3{' ' + cli if cli else ''}, "
                    "K5 over "
                    + (f"{body}'s stream arm" if stream else body) + ")",
            "route": "cuda",
            "source": ((SS_SOURCE if body == "K6" else K1S_SOURCE)
                       if stream else "yask_tpu_torch/csrc/fused_step.cuh"),
            "replaces": "yask_tpu/ops/pallas_stencil.py:736 (region= and "
                        "distributed=True arms with the stage loop "
                        ":2058-2188; parallel/shard_step.py:1093)",
            "launches": got[counter], "max_abs_err": err, "ms": k5_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"launch over a {n}x{n}x{g} shard (mean of the "
                   f"{K} sub-step boxes)",
            "step_ms": step_ms, "step_bound_ms": step_bound,
            "exchange_ms_per_group": xch_ms, "peak_bytes": peak,
            "box_ms": ms, "state_digest": digest, "profile": prof,
            "box_segments": segs if stream else None}


def shard_digest(ctx) -> list:
    """:func:`state_digest` over the shards resident in ``ctx`` (every
    ring slot of every shard, pads included), without gathering them."""
    return [bits_digest(a) for shard in ctx._run.resident[1]
            for name in sorted(shard) for a in shard[name]]


def phase13(fac, card: str) -> list:
    """Phase 13 (see the module docstring); returns the ``kernels``
    entries."""
    import torch
    t0 = time.perf_counter()
    rows = phase13a(fac, card)
    entries, twins = [], {}
    for label, st, r, eb, g, K in K5_FULL:
        e = phase13b(fac, card, label, st, r, eb, g, K)
        twins[label] = {"state_digest": e.pop("state_digest"),
                        "ms": e["ms"], "step_ms": e["step_ms"],
                        "box_ms": e["box_ms"],
                        "what": f"phase 13 (b)'s {label} {g}^3 on K5's body "
                                "(-no-skew)"}
        for k in ("profile", "box_segments", "box_ms"):
            e.pop(k)
        entries.append(e)
        torch.cuda.empty_cache()
    # the mid-width arms of (a), one entry per body
    for body in ("K1", "K6"):
        mine = [row for row in rows if row[1] == body]
        entries.append({
            "name": f"shard_step (phase 13 (a) arms on {body}'s body)",
            "route": "cuda", "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "replaces": "yask_tpu/ops/pallas_stencil.py:736 (region= and "
                        "distributed=True arms; parallel/shard_step.py:1093)",
            "launches": sum(row[7] for row in mine),
            "max_abs_err": max(row[6] for row in mine),
            "ms": sum(row[2] for row in mine),
            "plain_ms": sum(row[5] for row in mine),
            "bound_ms": sum(row[3] for row in mine),
            "bound_by": "bytes" if all(row[4] == "bytes" for row in mine)
            else "operations", "library_ms": None,
            "per": "sum over the arms of one launch each over shard 0's "
                   "sub-step-0 box: " + ", ".join(row[0] for row in mine)})
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return entries, twins



# ---- phase 14: K4 on the multi-stage, scratch, rewrite, misc and bf16
#      arms, and K4's member batch

#: Phase 14 (a): (label, stencil, radius, element bytes, sizes).  ssg
#: r=4's twin runs K6 on the ladder's 1×1×16 rung (ROADMAP.md C17).
K4_MID = (("ssg r=2", "ssg", 2, 4, (64, 64, 64)),
          ("ssg r=4", "ssg", 4, 4, (64, 64, 64)),
          ("tti r=2", "tti", 2, 4, (64, 64, 64)),
          ("awp", "awp", None, 4, (64, 64, 64)),
          ("gaussian r=2", "gaussian", 2, 4, (256, 256)),
          ("tti r=2 bf16", "tti", 2, 2, (64, 64, 64)))
#: Phase 14 (b): (label, stencil, radius, element bytes, edge, K, twin arm)
K4_FULL = (("tti r=2 fp32", "tti", 2, 4, 512, 2, "K6"),
           ("iso3dfd r=2 bf16", "iso3dfd", 2, 2, 512, 4, "K1"))


def k4_ctx(fac, env, st, r, eb, sizes, mode, K, cli="", force=False):
    """:func:`a3_ctx` with K4's request forced (``force``)."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    if st.startswith(("four_d_", "five_d")):
        src = dsl_solution(st)
        src.set_element_bytes(eb)
    else:
        src = create_solution(st, radius=r)
        src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(env, src)
    if force:
        ctx._trapezoid_arg = lambda: True
    dims = list(ctx._ana.domain_dims)
    sizes = sizes[len(sizes) - len(dims):]
    g = " ".join(f"-g_{d} {n}" for d, n in zip(dims, sizes))
    ctx.apply_command_line_options(f"{g} -mode {mode} -wf_steps {K} "
                                   f"-no-skew {cli}")
    ctx.prepare_solution()
    return ctx


def k4_specs(fac, env) -> dict:
    """Phase 14's kernels (K4 per case and its twins), for phase 1's
    parallel build.  A K4 source holds its plan, so each is emitted at the
    size the phase runs it (a full-width context allocates its state on
    the card for a moment)."""
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    out = {}
    for label, st, r, eb, sizes in K4_MID:
        ctx = k4_ctx(fac, env, st, r, eb, sizes, "fused", 2, "-trapezoid",
                     force=True)
        out[f"K4 {label}"] = ctx._trapezoid_kernel().spec
        out[f"K6/K1 {label}"] = FusedKernel(ctx._program).spec
        del ctx
    pipe = rtm_pipe(env, "-mode fused -wf_steps 2 -trapezoid -no-skew",
                    True, (64, 64, 64))
    pipe.fused_ctx._trapezoid_arg = lambda: True
    out["K4 rtm chain"] = pipe.fused_ctx._trapezoid_kernel().spec
    out["K6 rtm chain"] = FusedKernel(pipe.fused_ctx._program).spec
    pipe.end()
    for label, st, r, eb, g, K, _arm in K4_FULL:
        ctx = k4_ctx(fac, env, st, r, eb, (g, g, g), "fused", K,
                     "-trapezoid", force=True)
        out[f"K4 {label}"] = ctx._trapezoid_kernel().spec
        out[f"twin {label}"] = FusedKernel(ctx._program).spec
        del ctx
    for st, r, g, K in (("iso3dfd", 2, 256, 4), ("tti", 2, 128, 2)):
        ctx = k4_ctx(fac, env, st, r, 4, (g, g, g), "fused", K,
                     "-trapezoid", force=True)
        out[f"K4 {st} r={r} {g}^3 K={K}"] = ctx._trapezoid_kernel().spec
        del ctx
    return out


def k4_bound(ctx, spec) -> tuple:
    """The least time of one K4 group: each of its inputs read once and
    each output (the newest levels of the group) written once over the
    interior, or the group's FLOPs.  Returns (ms, "bytes"/"operations",
    bytes)."""
    import numpy as np
    prog = ctx._program

    def cells(name):
        c = 1
        for dn, kind in prog.geoms[name].axes:
            c *= (prog.sizes[dn] if kind == "domain"
                  else prog.geoms[name].misc_ext[dn])
        return c
    npts = 1
    for d in ctx._ana.domain_dims:
        npts *= prog.sizes[d]
    nbytes = np.dtype(prog.dtype).itemsize * (
        sum(cells(n) for n, _s in dict.fromkeys(spec.inputs))
        + sum(cells(n) for n in spec.outputs))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = (ctx._ana.counters.num_ops * npts * spec.trap["K"]
                / FP32_FLOP_PER_S * 1e3)
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes)


def k4_group_vs_plain(kern, state, t: int):
    """One K4 group against ``plain_chunk`` from the same state on the
    card: (max |d|, cells whose bits differ, field max)."""
    from yask_tpu_torch.ops.fused_stencil import plain_chunk
    K = kern.K
    a = kern.chunk(dict(state), t, K)
    b = plain_chunk(kern.program, dict(state), t, K)
    err, nbits, scale = 0.0, 0, 0.0
    for n in set(kern.spec.outputs):
        k = kern.spec.outputs.count(n)
        for x, y in zip(a[n][-k:], b[n][-k:]):
            err = max(err, float((x.float() - y.float()).abs().max()))
            nbits += int((x != y).sum())
            scale = max(scale, float(y.float().abs().max()))
    return err, nbits, scale


def phase14a(fac, env, card: str, cases=K4_MID, rtm: int = 64) -> list:
    """Phase 14 (a): each arm at mid width, one group of K = 2 forced on
    K4 with the counters zeroed just before and read just after, against
    its ``-no-trapezoid`` twin (K6 or K1) to the bit and its plain version
    (``-mode torch``) at ``field_epsilon`` (1e-2 at element size 2); one
    group timed (CUDA events) against its bound and the plain version's
    group.  Returns one row per case."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, trapezoid_chunk
    rows = []

    def timed(label, ctx, eb, got, twin_bad, diff):
        kern, state = ctx._trapezoid_kernel(), ctx._state
        t = ctx._cur_step
        ms = cuda_ms(lambda: trapezoid_chunk(kern, state, t, 2), 3)
        plain_ms = cuda_ms(lambda: plain_chunk(kern.program, state, t, 2),
                           2)
        err, nbits, scale = k4_group_vs_plain(kern, state, t)
        bound_ms, bound_by, nbytes = k4_bound(ctx, kern.spec)
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        tr = kern.spec.trap
        log(f"phase 14: {label}: K4 one group (K=2) vs plain on the card "
            f"max|d|={diff[0]:.3e} mismatches={diff[1]} (field_epsilon="
            f"{eps}); vs the -no-trapezoid twin compare_data(epsilon=0) = "
            f"{twin_bad}; launches {got}; {tr['sub_stages']} sub-stages "
            f"({tr['scratch_stages']} of scratch vars), {tr['buffers']} "
            f"level buffers, workspace {tr['ws_block_bytes']} B per block, "
            f"passes {[(p['tile'], p['smem_buffers'], p['ws_buffers']) for p in tr['passes']]}; "
            f"{ms:.3f} ms/group (CUDA events) against its bound "
            f"{bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}; "
            f"plain {plain_ms:.3f} ms/group; a second group vs plain "
            f"max|d|={err:.3e} ({nbits} cells differ in their bits, field "
            f"max {scale:.3e}) [{card}]")
        if not err <= eps * scale:
            raise RuntimeError(f"phase 14: {label}: K4 and its plain "
                               "version disagree")
        rows.append((label, ms, plain_ms, bound_ms, bound_by,
                     max(err, diff[0]), sum(got.values())))

    for label, st, r, eb, sizes in cases:
        ctxs = {"k4": k4_ctx(fac, env, st, r, eb, sizes, "fused", 2,
                             "-trapezoid", force=True),
                "plain": k4_ctx(fac, env, st, r, eb, sizes, "torch", 2),
                "twin": k4_ctx(fac, env, st, r, eb, sizes, "fused", 2,
                               "-no-trapezoid")}
        misc = any(kind == "misc" for gm in ctxs["k4"]._program.geoms.values()
                   for _d, kind in gm.axes)
        for c in ctxs.values():
            (seed_interiors if misc else seed_physical)(c, 7)
        zero_launch_counts()
        ctxs["k4"].run_solution(0, 1)
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        ndia = len(ctxs["k4"]._trapezoid_kernel().spec.trap["trap_dims"])
        nbase = len(ctxs["k4"]._trapezoid_kernel().spec.base_outputs)
        want = {"trapezoid_phase1": 1, "trapezoid_diamond": ndia}
        if nbase:
            want["copy_base"] = nbase
        if got != want:
            raise RuntimeError(f"phase 14: {label}: launches {got}, "
                               f"expected {want}")
        for k in ("plain", "twin"):
            ctxs[k].run_solution(0, 1)
        twin_bad = ctxs["k4"].compare_data(ctxs["twin"], epsilon=0.0,
                                           abs_epsilon=0.0)
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        diff = (max_abs_diff(ctxs["k4"], ctxs["plain"]),
                ctxs["k4"].compare_data(ctxs["plain"], field_epsilon=eps))
        if twin_bad or diff[1] or not finite(ctxs["k4"]):
            raise RuntimeError(f"phase 14: {label}: K4 differs from its "
                               f"twin ({twin_bad}) or its plain version "
                               f"({diff[1]} mismatches)")
        timed(label, ctxs["k4"], eb, got, twin_bad, diff)
        del ctxs
        torch.cuda.empty_cache()

    if not rtm:
        return rows
    # the RTM chain merged by SolutionPipeline, prepare(fuse=True)
    g = (rtm,) * 3
    pipes = {"k4": rtm_pipe(env, "-mode fused -wf_steps 2 -trapezoid "
                                 "-no-skew", True, g),
             "twin": rtm_pipe(env, "-mode fused -wf_steps 2 -no-trapezoid "
                                   "-no-skew -push off", True, g),
             "plain": rtm_pipe(env, "-mode torch -wf_steps 2", True, g)}
    pipes["k4"].fused_ctx._trapezoid_arg = lambda: True
    for p in pipes.values():
        seed_chain(p, g, 7)
    zero_launch_counts()
    pipes["k4"].run(0, 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != {"trapezoid_phase1": 1, "trapezoid_diamond": 2}:
        raise RuntimeError(f"phase 14: rtm chain: launches {got}")
    pipes["twin"].run(0, 1)
    pipes["plain"].run(0, 1)
    twin_bad = pipes["k4"].compare(pipes["twin"])
    err, scale = pipe_diff(pipes["k4"], pipes["plain"])
    if twin_bad or not err <= FIELD_EPS * scale:
        raise RuntimeError(f"phase 14: rtm chain: K4 vs K6 {twin_bad} "
                           f"mismatches, vs plain max|d|={err:.3e}")
    timed(f"rtm chain r=2 {rtm}^3 (3 stages)", pipes["k4"].fused_ctx, 4,
          got, twin_bad, (err, 0))
    for p in pipes.values():
        p.end()
    return rows


def phase14b(fac, env, card: str, label, st, r, eb, g, K, arm,
             warm: int = 1, trials: int = 3, steps: int = 0) -> dict:
    """Phase 14 (b): ``st`` at ``g``³ under forced ``-trapezoid`` through
    the user's entry points, seeded on the card in physical ranges
    (:func:`seed_device`), and its ``-no-trapezoid`` twin from the same
    seed: ``warm`` groups, then ``trials`` runs of ``steps`` steps with
    the counters zeroed just before (K4 alone launches), the two states
    bit-equal on the card after the same steps; ms per group and per
    step against the twin's, each pass's ms per launch, the bound, the
    plain version's group, and what the auto gate chooses.  Returns the
    ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import (
        call_trapezoid_entry, plain_chunk, trapezoid_chunk, trap_outputs)
    import math
    steps = steps or 5 * K
    out = {}
    ctxs = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for which, cli in (("K4", "-trapezoid"), (arm, "-no-trapezoid")):
        torch.cuda.empty_cache()
        ctx = k4_ctx(fac, env, st, r, eb, (g,) * 4, "fused", K, cli,
                     force=which == "K4")
        nd = len(ctx._ana.domain_dims)
        npts = math.prod(ctx._program.sizes[d] for d in ctx._ana.domain_dims)
        seed_device(ctx, 11, physical=True)
        ctx.run_solution(0, warm * K - 1)
        t = warm * K
        zero_launch_counts()
        rates = []
        for _ in range(trials):
            ctx.clear_stats()
            ctx.run_solution(t, t + steps - 1)
            t += steps
            rates.append(ctx.get_stats().get_pts_per_sec())
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        ngroups = trials * steps // K
        want = ({"trapezoid_phase1": ngroups,
                 "trapezoid_diamond": 2 * ngroups} if which == "K4" else
                {"stages_step" if arm == "K6" else "fused_step":
                 trials * steps})
        if got != want:
            raise RuntimeError(f"phase 14: {label} {which}: launches {got},"
                               f" expected {want}")
        if not finite(ctx):
            raise RuntimeError(f"phase 14: {label} {which}: not finite")
        rates.sort()
        out[which] = (npts / rates[len(rates) // 2] * 1e3, got, t)
        ctxs[which] = ctx
    bad = device_diff(ctxs["K4"], ctxs[arm], exact=True)
    step_ms, got, t = out["K4"]
    twin_ms = out[arm][0]
    if bad[1]:
        raise RuntimeError(f"phase 14: {label}: K4 and {arm} differ in "
                           f"{bad[1]} cells (max|d|={bad[0]:.3e})")
    del ctxs[arm]
    torch.cuda.empty_cache()
    ctx = ctxs["K4"]
    kern, prog, state = ctx._trapezoid_kernel(), ctx._program, ctx._state
    spec = kern.spec
    auto = []
    cuda_emit.resolve_trapezoid(prog, K, None, reasons=auto)
    ms = cuda_ms(lambda: trapezoid_chunk(kern, state, t, K), 3)
    ins = [state[n][s] for n, s in spec.inputs]
    outs = trap_outputs(kern, state, ins[0].device)
    ws, nres = kern.workspace(ins[0].device, False)
    stream = torch.cuda.current_stream().cuda_stream
    pass_ms = [cuda_ms(lambda p=p: call_trapezoid_entry(
        kern.fn, prog, spec, ins, outs, p, t, stream, ws, nres), 3)
        for p in range(len(spec.trap["passes"]))]
    del outs, ws
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, K), 1)
    err, nbits, scale = k4_group_vs_plain(kern, state, t)
    eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
    if not err <= eps * scale:
        raise RuntimeError(f"phase 14: {label}: K4 and its plain version "
                           "disagree")
    bound_ms, bound_by, nbytes = k4_bound(ctx, spec)
    tr = spec.trap
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 14: {label} {g}^{nd} -mode fused -wf_steps {K} -trapezoid "
        f"(forced): {trials} trials x {steps} steps: {step_ms:.3f} ms/step "
        f"against {arm}'s {twin_ms:.3f} (-no-trapezoid, same seed, "
        f"bit-equal: {bad[1]} cells differ); launches {got}; one group "
        f"{ms:.3f} ms (CUDA events; passes {[round(x, 3) for x in pass_ms]}"
        f" ms/launch), bound {bound_ms:.3f} ms ({bound_by}: {nbytes / npts:.1f}"
        f" B/pt per group), share {bound_ms / ms:.3f} per group, "
        f"{bound_ms / K / step_ms:.3f} per step; {tr['sub_stages']} "
        f"sub-stages, {tr['buffers']} level buffers, block {tr['block']}, "
        f"passes {[(p['tile'], p['smem_buffers'], p['ws_buffers'], p['ws_block_bytes']) for p in tr['passes']]}, "
        f"workspace of {nres} resident blocks; plain {plain_ms:.3f} "
        f"ms/group (not a yardstick); a group vs plain max|d|={err:.3e} "
        f"({nbits} cells differ in their bits); the auto gate: "
        f"{[(x['code'], x.get('detail', x.get('cause', ''))) for x in auto[:1]]}; "
        f"torch.cuda.max_memory_allocated() = {peak / 2**30:.2f} GiB "
        f"(both contexts) [{card}]")
    del ctxs, ctx, kern, state, ins
    torch.cuda.empty_cache()
    return {"name": f"trapezoid_chunk ({label}, {g}^{nd}, K={K})",
            "route": "cuda", "source": "yask_tpu_torch/csrc/trapezoid.cuh",
            "replaces": "yask_tpu/ops/pallas_stencil.py:2312 (trapezoid arm"
                        " with the stage loop :2058-2188)",
            "launches": got["trapezoid_phase1"] + got["trapezoid_diamond"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"group of {K} steps ({len(pass_ms)} launches)",
            "step_ms": step_ms, "twin": arm, "twin_step_ms": twin_ms,
            "pass_ms": pass_ms, "auto_gate": auto[:1]}


def phase14c(fac, env, card: str, nm: int = 8, g: int = 256,
             nses: int = 4, gs: int = 128) -> dict:
    """Phase 14 (c): an ``EnsembleRun`` of ``nm`` members of iso3dfd r=2
    at ``g``³, ``-wf_steps 4 -trapezoid`` (forced where the gate rejects
    it), each member seeded on the card: 2 groups with the counters zeroed
    just before (K4's member batch alone launches, once per pass and
    group), each member bit-equal to its solo K4 run; the batched group
    timed against ``nm`` solo groups and its bound; then a
    ``StencilServer`` batch of ``nses`` fused tti r=2 sessions at ``gs``³
    under ``-trapezoid`` (K4 forced on the profile's context): all ok and
    batched, K4's member batch alone, each member bit-identical to its
    solo run.  Returns the ``kernels`` entry."""
    import tempfile
    import numpy as np
    import torch
    from yask_tpu_torch.ops.fused_stencil import (
        batched_trapezoid_chunk, plain_batched_chunk, trapezoid_chunk)
    from yask_tpu_torch.serve import StencilServer
    from yask_tpu_torch.serve.scheduler import extract_outputs
    K, steps = 4, 8
    ctx = k4_ctx(fac, env, "iso3dfd", 2, 4, (g, g, g), "fused", K,
                 "-trapezoid")
    how = "auto"
    if ctx._trapezoid_kernel() is None:
        ctx._trapezoid_arg = lambda: True
        ctx._trap = None
        how = "forced"
    ens = ctx.new_ensemble(nm)
    for i in range(nm):
        with ens.member(i) as c:
            seed_device(c, 300 + i)
    zero_launch_counts()
    ens.run(0, steps - 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    ng = steps // K
    if got != {"batched_trapezoid_phase1": ng,
               "batched_trapezoid_diamond": 2 * ng}:
        raise RuntimeError(f"phase 14: ensemble: launches {got}")
    solo = k4_ctx(fac, env, "iso3dfd", 2, 4, (g, g, g), "fused", K,
                  "-trapezoid", force=True)
    for i in range(nm):
        seed_device(solo, 300 + i)
        solo.run_solution(0, steps - 1)
        with ens.member(i) as c:
            bad = device_diff(c, solo, exact=True)
        if bad[1]:
            raise RuntimeError(f"phase 14: member {i} differs from its "
                               f"solo K4 run in {bad[1]} cells")
    kern = ctx._trapezoid_kernel()
    st = ens._stack_states()
    ms = cuda_ms(lambda: batched_trapezoid_chunk(kern, st, steps, K, nm), 3)
    solo_ms = cuda_ms(lambda: trapezoid_chunk(kern, solo._state, steps, K),
                      3)
    plain_ms = cuda_ms(lambda: plain_batched_chunk(kern.program, st, steps,
                                                   K, nm), 1)
    a = kern.batched_chunk(dict(st), steps, K, nm)
    b = plain_batched_chunk(kern.program, dict(st), steps, K, nm)
    err = max(float((x - y).abs().max()) for n in set(kern.spec.outputs)
              for x, y in zip(a[n][-2:], b[n][-2:]))
    scale = max(float(y.abs().max()) for n in b for y in b[n])
    del a, b, st
    if not err <= FIELD_EPS * scale:
        raise RuntimeError("phase 14: the member batch disagrees with "
                           "its plain version")
    bound_ms, bound_by, nbytes = k4_bound(ctx, kern.spec)
    bound_ms *= nm
    log(f"phase 14: EnsembleRun {nm} x iso3dfd r=2 {g}^3 -wf_steps {K} "
        f"-trapezoid ({how}): {steps} steps, launches {got}; every member "
        f"bit-equal to its solo K4 run; one batched group {ms:.3f} ms "
        f"(CUDA events) against {nm} x {solo_ms:.3f} ms solo, bound "
        f"{bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.3f}; plain "
        f"{plain_ms:.3f} ms; vs plain max|d|={err:.3e} [{card}]")
    del ctx, ens, solo, kern
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="yt_chip_smoke_")
    srv = StencilServer(env, journal_path=os.path.join(tmp, "SERVE.jsonl"),
                        window_secs=0.05, max_batch=nses)
    sk = 4
    try:
        sids = [srv.open_session(stencil="tti", radius=2, g=gs,
                                 mode="fused", wf=2,
                                 options="-trapezoid -no-skew",
                                 bucket=False) for _ in range(nses)]
        with srv.scheduler.session_ctx(sids[0]) as c:
            c._trapezoid_arg = lambda: True
            c._trap = None
        for i, sid in enumerate(sids):
            with srv.scheduler.session_ctx(sid) as c:
                slices = list(physical_slices(c, 400 + i))
            for name, vals, first, last in slices:
                srv.set_var_slice(sid, name, vals, first, last)
        zero_launch_counts()
        handles = [srv.submit_run(sid, 0, sk - 1) for sid in sids]
        resps = [srv.wait(h, timeout=600) for h in handles]
        sgot = {k: v for k, v in launch_counts().items() if v}
        for r in resps:
            if not (r.ok and r.batched and r.batch == nses
                    and not r.degraded):
                raise RuntimeError(
                    f"phase 14: served tti {r.rid}: status {r.status}, "
                    f"batch {r.batch}, batched {r.batched}, error "
                    f"{r.error!r}")
        if sgot != {"batched_trapezoid_phase1": sk // 2,
                    "batched_trapezoid_diamond": sk}:
            raise RuntimeError(f"phase 14: served tti: launches {sgot}")
        alone = k4_ctx(fac, env, "tti", 2, 4, (gs, gs, gs), "fused", 2,
                       "-trapezoid", force=True)
        for i, r in enumerate(resps):
            seed_physical(alone, 400 + i)
            alone.run_solution(0, sk - 1)
            want = extract_outputs(alone)
            d = max(float(np.abs(want[n].astype(np.float64)
                                 - r.outputs[n]).max()) for n in want)
            if d != 0.0:
                raise RuntimeError(f"phase 14: served tti member {i} is "
                                   f"not bit-identical to its solo run "
                                   f"(max|d|={d:.3e})")
        log(f"phase 14: StencilServer, {nses} fused tti r=2 sessions at "
            f"{gs}^3 -trapezoid (K4 forced), {sk} steps: all ok, batched "
            f"at occupancy {nses}; launches {sgot}; every member "
            f"bit-identical to its solo K4 run [{card}]")
    finally:
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"name": f"batched_trapezoid_chunk ({nm} x iso3dfd r=2 {g}^3, "
                    f"K={K})", "route": "cuda",
            "source": "yask_tpu_torch/csrc/trapezoid.cuh",
            "replaces": "yask_tpu/runtime/ensemble.py:253-263 (the vmapped "
                        "trapezoid chunk of pallas_stencil.py:2312)",
            "launches": got["batched_trapezoid_phase1"]
            + got["batched_trapezoid_diamond"] + sum(sgot.values()),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"group of {K} steps of {nm} members (3 launches)",
            "solo_ms": solo_ms, "trapezoid": how}


def phase14(fac, env, card: str) -> list:
    """Phase 14 (see the module docstring); returns the ``kernels``
    entries."""
    import torch
    t0 = time.perf_counter()
    rows = phase14a(fac, env, card)
    entries = [{
        "name": "trapezoid_chunk (phase 14 (a) arms: stages, scratch, "
                "rewrite, misc, bf16)",
        "route": "cuda", "source": "yask_tpu_torch/csrc/trapezoid.cuh",
        "replaces": "yask_tpu/ops/pallas_stencil.py:2312 (trapezoid arm "
                    "with the stage loop :2058-2188)",
        "launches": sum(row[6] for row in rows),
        "max_abs_err": max(row[5] for row in rows),
        "ms": sum(row[1] for row in rows),
        "plain_ms": sum(row[2] for row in rows),
        "bound_ms": sum(row[3] for row in rows),
        "bound_by": "bytes" if all(row[4] == "bytes" for row in rows)
        else "operations", "library_ms": None,
        "per": "sum over the arms of one group each: "
               + ", ".join(row[0] for row in rows)}]
    torch.cuda.empty_cache()
    for case in K4_FULL:
        entries.append(phase14b(fac, env, card, *case))
    entries.append(phase14c(fac, env, card))
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 15: the workspace arm (C17) and K4's 4-D arm ----------------

#: Phase 15 (a): the workspace arm at full width, 512^3 fp32 ``-mode
#: fused``, and how each is seeded: tti in physical ranges on the card
#: (:func:`full_seed`, ``None``); ssg with its
#: material vars at 0.05 + 0.01 U (its dt/h is the user's scaling of them:
#: at the physical ranges' 1-2 its r=8 step grows the field ~150x per step)
WS_FULL = (("tti", 8, None),
           ("ssg", 8, lambda c: seed_device(c, 11)))
#: Phase 15 (b): the arm through K7 (3 members) and K5 (2x2 shards of one
#: card), at mid width, each bit-equal to its solo or single-domain run
WS_K7 = (("workspace", "tti", 8, 4, (48, 48, 70), "batched_stages_step"),)
WS_K5 = (("ssg r=8 K=1 workspace", "ssg", 8, 4, (64, 64, 64), 1, X2Y2,
          ""),)
#: Phase 15 (b): tti r=8 in bfloat16 at mid width, and the ladder rung it
#: is held to the bit against
WS_BF16 = ("tti", 8, (48, 48, 70), (4, 8, 64))
#: Phase 15 (c): 4-D K4 at full width (label, stencil, radius, element
#: bytes, edge, K, twin arm); (d) at mid width (label, stencil, radius,
#: element bytes, sizes) and the member batch (members, edge)
K4_4D_FULL = ("test_4d fp32", "test_4d", None, 4, 128, 2, "K1")
K4_4D_MID = (("four_d_stages", "four_d_stages", None, 4, (24, 32, 32, 33)),
             ("test_4d bf16", "test_4d", None, 2, (24, 32, 32, 33)))
K4_4D_BATCH = (4, 32)
#: what the workspace arm replaces: K1's and K6's tiles (the reference's
#: VMEM tiles of the scratch and multi-stage chunk)
WS_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (the chunk's VMEM "
               "tiles of the stage loop :2058-2188 and scratch chains "
               ":175-179, :2105-2147)")
K4_4D_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (trapezoid arm on "
                  "more than three domain dims: the grid over every lead "
                  "dim :1442, resolution :812-930)")


def ws_specs(fac, env) -> dict:
    """Phase 15's kernels, for phase 1's parallel build (the K4 sources
    hold their plan, so each is emitted at its size)."""
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    out = {}
    for st, r, _seed in WS_FULL:
        ctx = a3_ctx(fac, env, st, r, 4, (16, 16, 16), "fused")
        out[f"workspace {st} r={r}"] = FusedKernel(ctx._program).spec
    st, r, sizes, tile = WS_BF16
    ctx = a3_ctx(fac, env, st, r, 2, sizes, "fused", 2)
    out[f"workspace {st} r={r} bf16"] = FusedKernel(ctx._program).spec
    out[f"workspace {st} r={r} bf16 {tile}"] = tile_kernel(
        ctx._program, False, tile).spec
    for label, st, r, eb, sizes, K, ranks, cli in WS_K5:
        ctx = k5_ctx(fac, st, r, eb, sizes, K, ranks, cli)
        out[f"K5 {label}"] = shard_pallas_plan(ctx).kernel.spec
    label, st, r, eb, g, K, _arm = K4_4D_FULL
    cases = [(label, st, r, eb, (g,) * 4, K)] + [
        (lab, s_, r_, e_, sz, 2) for lab, s_, r_, e_, sz in K4_4D_MID]
    nm, gb = K4_4D_BATCH
    cases.append(("test_4d batch", "test_4d", None, 4, (gb,) * 4, 2))
    for label, st, r, eb, sizes, K in cases:
        ctx = k4_ctx(fac, env, st, r, eb, sizes, "fused", K, "-trapezoid",
                     force=True)
        out[f"K4 {label}"] = ctx._trapezoid_kernel().spec
        out[f"K1/K6 {label}"] = FusedKernel(ctx._program).spec
        del ctx
    return out


def phase15b_bf16(fac, env, card: str, steps: int = 5) -> dict:
    """Phase 15 (b): tti r=8 in bfloat16 at mid width on the workspace
    arm, ``steps`` steps with the counters zeroed just before; against
    its plain version (``-mode torch``) at the bfloat16 field tolerance
    and, to the bit, against the arm at another rung of the ladder (other
    tiles, another walk); one launch timed against its bound."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, stages_step
    st, r, sizes, tile = WS_BF16
    # the workspace arm is K6's body: -no-skew (at element size 2 the
    # default is K6's stream arm, phase 22)
    ctxs = {k: a3_ctx(fac, env, st, r, 2, sizes, m, 2, cli)
            for k, m, cli in (("ws", "fused", "-no-skew"),
                              ("rung", "fused", "-no-skew"),
                              ("plain", "torch", ""))}
    ctxs["rung"]._fused = tile_kernel(ctxs["rung"]._program, False, tile)
    for c in ctxs.values():
        seed_physical(c, 17)
    zero_launch_counts()
    ctxs["ws"].run_solution(0, steps - 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != {"stages_step": steps}:
        raise RuntimeError(f"phase 15: tti r=8 bf16: launches {got}")
    for k in ("rung", "plain"):
        ctxs[k].run_solution(0, steps - 1)
    rung_bad = ctxs["ws"].compare_data(ctxs["rung"], epsilon=0.0,
                                       abs_epsilon=0.0)
    d = max_abs_diff(ctxs["ws"], ctxs["plain"])
    bad = ctxs["ws"].compare_data(ctxs["plain"],
                                  field_epsilon=BF16_FIELD_EPS)
    ctx = ctxs["ws"]
    kern, state, prog = ctx._fused, ctx._state, ctx._program
    spec = kern.spec
    ms = cuda_ms(lambda: stages_step(kern, state, steps), 5)
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, steps, 1), 2)
    bound_ms, bound_by, _nb = a3_bound(ctx)
    til = ctx.get_stats().get_tiling()
    log(f"phase 15: tti r=8 bf16 {'x'.join(map(str, sizes))} workspace arm "
        f"(tile {list(spec.tile)}): {steps} steps, launches {got}; vs plain"
        f" max|d|={d:.3e} mismatches={bad} (field_epsilon="
        f"{BF16_FIELD_EPS}); vs the arm at tile {list(tile)} "
        f"compare_data(epsilon=0) = {rung_bad}; {ms:.3f} ms/launch (CUDA "
        f"events), bound {bound_ms:.4f} ms ({bound_by}), share "
        f"{bound_ms / ms:.4f}; plain {plain_ms:.3f} ms; workspace "
        f"{til['workspace']} [{card}]")
    if bad or rung_bad or not finite(ctx):
        raise RuntimeError(f"phase 15: tti r=8 bf16: {bad} mismatches vs "
                           f"plain, {rung_bad} vs tile {list(tile)}")
    del ctxs, ctx, kern, state
    torch.cuda.empty_cache()
    return {"name": "stages_step (workspace arm, element size 2: tti r=8 "
                    f"bf16 {'x'.join(map(str, sizes))}, mid width)",
            "route": "cuda", "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "replaces": WS_REPLACES, "launches": got["stages_step"],
            "max_abs_err": d, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "path": "phase 15 (b)"}


def phase15d_batch(fac, env, card: str, groups: int = 2) -> dict:
    """Phase 15 (d): an ``EnsembleRun`` of test_4d members at mid width
    under forced ``-trapezoid`` (K = 2): ``groups`` groups with the
    counters zeroed just before (K4's member batch alone launches, once
    per pass and group), each member bit-equal to its solo K4 run; one
    batched group timed against its solo group, its bound and its plain
    version.  Returns the ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import (
        batched_trapezoid_chunk, plain_batched_chunk, trapezoid_chunk)
    nm, g = K4_4D_BATCH
    K, steps = 2, 2 * groups
    sizes = (g,) * 4
    ctx = k4_ctx(fac, env, "test_4d", None, 4, sizes, "fused", K,
                 "-trapezoid", force=True)
    ens = ctx.new_ensemble(nm)
    for i in range(nm):
        with ens.member(i) as c:
            seed_device(c, 500 + i)
    zero_launch_counts()
    ens.run(0, steps - 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != {"batched_trapezoid_phase1": groups,
               "batched_trapezoid_diamond": 2 * groups}:
        raise RuntimeError(f"phase 15: test_4d batch: launches {got}")
    solo = k4_ctx(fac, env, "test_4d", None, 4, sizes, "fused", K,
                  "-trapezoid", force=True)
    for i in range(nm):
        seed_device(solo, 500 + i)
        solo.run_solution(0, steps - 1)
        with ens.member(i) as c:
            bad = device_diff(c, solo, exact=True)
        if bad[1]:
            raise RuntimeError(f"phase 15: test_4d member {i} differs from "
                               f"its solo K4 run in {bad[1]} cells")
    kern = ctx._trapezoid_kernel()
    st = ens._stack_states()
    ms = cuda_ms(lambda: batched_trapezoid_chunk(kern, st, steps, K, nm), 3)
    solo_ms = cuda_ms(lambda: trapezoid_chunk(kern, solo._state, steps, K),
                      3)
    plain_ms = cuda_ms(lambda: plain_batched_chunk(kern.program, st, steps,
                                                   K, nm), 1)
    a = kern.batched_chunk(dict(st), steps, K, nm)
    b = plain_batched_chunk(kern.program, dict(st), steps, K, nm)
    err = max(float((x - y).abs().max()) for n in set(kern.spec.outputs)
              for x, y in zip(a[n][-K:], b[n][-K:]))
    scale = max(float(y.abs().max()) for n in b for y in b[n])
    del a, b, st
    if not err <= FIELD_EPS * scale:
        raise RuntimeError("phase 15: the test_4d member batch disagrees "
                           "with its plain version")
    bound_ms, bound_by, _nb = k4_bound(ctx, kern.spec)
    bound_ms *= nm
    log(f"phase 15: EnsembleRun {nm} x test_4d {g}^4 -wf_steps {K} "
        f"-trapezoid (forced): {steps} steps, launches {got}; every member "
        f"bit-equal to its solo K4 run; one batched group {ms:.3f} ms (CUDA"
        f" events) against {nm} x {solo_ms:.3f} ms solo, bound "
        f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.4f}; plain "
        f"{plain_ms:.3f} ms; vs plain max|d|={err:.3e} [{card}]")
    del ctx, ens, solo, kern
    torch.cuda.empty_cache()
    return {"name": f"batched_trapezoid_chunk (4-D: {nm} x test_4d {g}^4, "
                    f"K={K})", "route": "cuda",
            "source": "yask_tpu_torch/csrc/trapezoid.cuh",
            "replaces": "yask_tpu/runtime/ensemble.py:253-263 (the vmapped "
                        "trapezoid chunk of pallas_stencil.py:2312)",
            "launches": got["batched_trapezoid_phase1"]
            + got["batched_trapezoid_diamond"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "per": f"group of {K} steps of {nm} members (3 launches)",
            "solo_ms": solo_ms, "path": "phase 15 (d)"}


def phase15(fac, env, card: str, full: int = 512,
            dev: str = "cuda:0") -> list:
    """Phase 15 (see the module docstring); returns the ``kernels``
    entries."""
    import torch
    t0 = time.perf_counter()
    entries = []
    # (a) the workspace arm at full width (the -no-skew body: phase 18
    #     (b) runs the stream arm from the same seed and steps)
    for st, r, seed in WS_FULL:
        e = family_full(fac, env, card, st, r,
                        "workspace arm, C17, the -no-skew body", full,
                        warm=1, trials=1, steps=5, sweep=False, seed=seed,
                        plain_g=full // 2, cli="-no-skew", digest=True)
        e.update(replaces=WS_REPLACES, path=f"phase 15 (a), {st} r={r}")
        entries.append(e)
        torch.cuda.empty_cache()
    # (b) through K7 and K5, and at element size 2, at mid width
    entries += phase12a(fac, env, card, cases=WS_K7)
    entries[-1]["path"] = "phase 15 (b)"
    torch.cuda.empty_cache()
    rows = phase13a(fac, card, cases=WS_K5, dev=dev)
    for label, body, ms, bound_ms, bound_by, plain_ms, err, n, _t in rows:
        entries.append({
            "name": f"shard_step (workspace arm over K6's body: {label}, "
                    "2x2 shards of 64^3)", "route": "cuda",
            "source": "yask_tpu_torch/csrc/fused_step.cuh",
            "replaces": "yask_tpu/ops/pallas_stencil.py:736-811 (region= "
                        "and distributed=True arms, the stage loop "
                        ":2058-2188)", "launches": n, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "path": "phase 15 (b)"})
    torch.cuda.empty_cache()
    entries.append(phase15b_bf16(fac, env, card))
    # (c) 4-D K4 at full width; (d) at mid width and a member batch
    e = phase14b(fac, env, card, *K4_4D_FULL)
    e.update(replaces=K4_4D_REPLACES, path="phase 15 (c)")
    entries.append(e)
    torch.cuda.empty_cache()
    rows = phase14a(fac, env, card, cases=K4_4D_MID, rtm=0)
    entries.append({
        "name": "trapezoid_chunk (4-D at mid width: "
                + ", ".join(row[0] for row in rows) + ")",
        "route": "cuda", "source": "yask_tpu_torch/csrc/trapezoid.cuh",
        "replaces": K4_4D_REPLACES,
        "launches": sum(row[6] for row in rows),
        "max_abs_err": max(row[5] for row in rows),
        "ms": sum(row[1] for row in rows),
        "plain_ms": sum(row[2] for row in rows),
        "bound_ms": sum(row[3] for row in rows),
        "bound_by": "bytes" if all(row[4] == "bytes" for row in rows)
        else "operations", "library_ms": None,
        "per": "sum over the cases of one group each",
        "path": "phase 15 (d)"})
    torch.cuda.empty_cache()
    entries.append(phase15d_batch(fac, env, card))
    log(f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 16: K6's flat arm (the 1-D and 2-D solutions on K6's body) --

#: Phase 16 (b): the flat ladder's rungs swept on gaussian r=2 8192^2x3,
#: (T1, T2, threads); the emitter's ladder (``cuda_emit._FLAT_LADDER``)
#: keeps the rungs the registered solutions take, led by this sweep's.
#: The ladder came from a sweep of ten rungs (PERF.md's flat arm row);
#: this sweep keeps the ladder's first two, the fastest of the ten and a
#: 256-thread one, to hold the script's time.
FLAT_SWEEP = ((32, 128, 512), (64, 64, 512), (32, 64, 512),
              (16, 128, 256))
#: Phase 16 (e): every 1-D and 2-D solution K6 carries (and box at r=1
#: and r=3), at mid width: 2-D over 2100 x 2100 (33 x 33 tiles of 64x64,
#: a 2x2 shard's box 17 x 17; 3000 x 3000 until the script's time called
#: for less), 1-D over 2100000 points (513 tiles of 4096), each launch's
#: last tiles partial and more tiles than the card's resident blocks (2 a
#: SM on the H100), so the blocks walk on the card
FLAT_MID = (("box", 1), ("box", 3), ("gaussian", 2), ("swe2d", None),
            ("test_boundary_2d", None), ("test_misc_value_2d", None),
            ("test_scratch_2d", None), ("test_stages_2d", None),
            ("test_boundary_1d", None), ("test_func_1d", None),
            ("test_scratch_1d", None), ("test_scratch_boundary_1d", None),
            ("test_scratch_stages_1d", None), ("test_stages_1d", None),
            ("test_step_cond_1d", None))
#: the cases whose plain version on the card rounds otherwise than the
#: kernel (and the numpy oracle and the host build): box divides by a
#: constant, which PyTorch's CUDA division takes as a multiply by the
#: reciprocal (ROADMAP.md C5); test_func_1d's math functions are
#: PyTorch's own.  The others must match it to the bit.
FLAT_PLAIN_ROUNDING = ("box", "test_func_1d")
FLAT_MID_SIZES = (1, 2100, 2100)
FLAT_MID_1D = (1, 1, 2100000)
FLAT_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (the push=/stage "
                 "loop :2058-2188 over 1-D and 2-D domains, with the "
                 "input prefetch under the compute :1815-1854)")


def flat_sizes(st: str) -> tuple:
    return FLAT_MID_1D if st.endswith("_1d") else FLAT_MID_SIZES


def flat_walk(flat: dict, sizes: tuple, st: str) -> str:
    """Phase 16 (e)'s tiles per launch (solo, K7 over 3 members, and a 2x2
    shard's box in 2-D) against the solo launch's resident blocks; raises
    unless the smallest launch has more tiles than blocks, so every arm's
    blocks walk (the prefetch, the walk index and the last empty group
    run on the card)."""
    t1, t2 = flat["tile"][1:]
    nres = flat["resident_blocks"][0]

    def tiles(n1, n2):
        return -(-n1 // t1) * -(-n2 // t2)
    solo = tiles(*sizes[1:])
    box = solo if st.endswith("_1d") else tiles(-(-sizes[1] // 2),
                                                -(-sizes[2] // 2))
    if box <= nres:
        raise RuntimeError(f"phase 16: {st}: {box} tiles per launch do not "
                           f"pass the {nres} resident blocks")
    return (f"tiles per launch: solo {solo}, K7 x3 {3 * solo}"
            + ("" if st.endswith("_1d") else f", a 2x2 shard's box {box}")
            + f", over {nres} resident blocks")


def flat_kernel(program, rung):
    """K6 for ``program`` on the flat arm at ``rung`` alone, built (where
    the rung fits)."""
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    kern = FusedKernel(program)
    kern.spec = cuda_emit.emit(program, flat_ladder=(rung,))
    if kern.spec.flat:
        kern.build()
    return kern


def flat_specs(fac, env) -> dict:
    """Phase 16's kernels, for phase 1's parallel build: gaussian's at
    every rung of the sweep and in bfloat16, every solution of (e) solo
    (K7 runs the same source) and on 2x2 shards (2-D)."""
    from yask_tpu_torch.ops import cuda_emit, fused_stencil
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    out = {}
    g = a3_ctx(fac, env, "gaussian", 2, 4, (1, 16, 16), "fused")
    for rung in FLAT_SWEEP:
        spec = cuda_emit.emit(g._program, flat_ladder=(rung,))
        if spec.flat:
            out[f"gaussian rung {rung}"] = spec
    for st, r in FLAT_MID:
        ctx = a3_ctx(fac, env, st, r, 4, (1, 16, 16), "fused")
        out[f"{st} r={r} 4 B"] = fused_stencil.FusedKernel(
            ctx._program).spec
        if not st.endswith("_1d"):
            k5 = k5_ctx(fac, st, r, 4, (32, 32), 1, X2Y2)
            out[f"K5 {st} r={r}"] = shard_pallas_plan(k5).kernel.spec
    out["gaussian r=2 flat arm off"] = cuda_emit.emit(g._program,
                                                      flat_ladder=())
    ctx = a3_ctx(fac, env, "gaussian", 2, 2, (1, 16, 16), "fused")
    out["gaussian r=2 2 B"] = fused_stencil.FusedKernel(ctx._program).spec
    return out


def phase16a(fac, env, card: str, image: int = 8192) -> tuple:
    """Phase 16 (a): one gaussian r=2 launch at ``image``^2x3 under the
    profiler, on the flat arm and on the 1x8x64 body it replaces (the
    same source with the flat arm off, PR 14's kernel): each kernel's
    device time against any fill or copy in the launch, and the device's
    idle share.  Returns the context and the flat arm's profile."""
    import json as _json
    from yask_tpu_torch.ops import cuda_emit, fused_stencil as fs
    ctx = a3_ctx(fac, env, "gaussian", 2, 4, (1, image, image), "fused", 1)
    seed_device(ctx, 11)
    ctx.run_solution(0, 1)
    kern, s0, t = ctx._fused, dict(ctx._state), 2
    old = fs.FusedKernel(ctx._program)
    old.spec = cuda_emit.emit(ctx._program, flat_ladder=())
    old.build()
    flat = ctx.get_stats().get_tiling()["flat"]
    prof = None
    for label, k in (("the flat arm", kern),
                     ("the 1x8x64 body (flat arm off)", old)):
        p = profile_launches(lambda: fs.stages_step(k, s0, t), 10,
                             expect=("_stages_kernel",))
        if p is None or not p["whole"]:
            whole = cuda_ms(lambda: fs.stages_step(k, s0, t), 10)
            log(f"phase 16: gaussian r=2 {image}^2x3 on {label}: the "
                f"profiler saw no whole window ({_json.dumps(p)}); "
                f"stages_step {whole:.4f} ms/launch (CUDA events)")
            p = None
        else:
            log(f"phase 16: gaussian r=2 {image}^2x3, one stages_step launch "
                f"on {label} under torch.profiler (10 launches): device ms "
                f"per stages_step launch by kernel "
                f"{_json.dumps(p['per_call_ms'])}; span "
                f"{p['span_ms']:.4f} ms per launch, idle share "
                f"{p['idle_share']:.4f}; tile {list(k.spec.tile)} [{card}]")
        prof = prof or p
    log(f"phase 16: flat arm {_json.dumps(flat)}")
    return ctx, prof


def phase16b(ctx, card: str) -> list:
    """Phase 16 (b): gaussian's launch at each rung of
    :data:`FLAT_SWEEP` (one trial of 10 launches, CUDA events), each
    bit-equal to the plain version and so to the others.  Returns
    (rung, ms, staged cells per point) per rung that fits."""
    import torch
    from yask_tpu_torch.ops import cuda_emit, fused_stencil as fs
    prog, s0, t = ctx._program, dict(ctx._state), ctx._cur_step
    want = fs.plain_chunk(prog, dict(s0), t, 1)["img"][-1]
    bound_ms, _by, _nb = a3_bound(ctx)
    rows = []
    for rung in FLAT_SWEEP:
        kern = flat_kernel(prog, rung)
        if not kern.spec.flat:
            log(f"phase 16: rung {rung}: does not fit shared memory")
            continue
        ms = cuda_ms(lambda: fs.stages_step(kern, s0, t), 10)
        got = fs.stages_step(kern, dict(s0), t)["img"][-1]
        nbits = int((got != want).sum())
        f = kern.spec.flat
        log(f"phase 16: gaussian r=2 flat rung {rung}: {ms:.4f} ms/launch "
            f"(CUDA events, 10 launches), share {bound_ms / ms:.3f} of "
            f"{bound_ms:.3f} ms; {f['staged_cells_per_point']:.3f} staged "
            f"cells per point and input, {f['smem_bytes']} B shared, "
            f"{f['min_blocks']} block(s) per SM asked; {nbits} cells differ "
            f"from the plain version [{card}]")
        if nbits:
            raise RuntimeError(f"phase 16: rung {rung} differs from the "
                               "plain version")
        rows.append((rung, ms, f["staged_cells_per_point"]))
        del kern, got
        torch.cuda.empty_cache()
    best = min(rows, key=lambda row: row[1])
    first = next(row for row in rows if row[0] == cuda_emit._FLAT_LADDER[0])
    log(f"phase 16: the fastest rung {best[0]}, {best[1]:.4f} ms; the "
        f"emitter's first rung {first[0]}, {first[1]:.4f} ms")
    return rows


def phase16e(fac, env, card: str, steps: int = 5,
             dev: str = "cuda:0") -> list:
    """Phase 16 (e): each solution of :data:`FLAT_MID` at mid width: solo
    against its plain version on the card (to the bit, but
    :data:`FLAT_PLAIN_ROUNDING`'s cases, held to 0 mismatches at
    ``field_epsilon``), a K7 batch of 3 (each member bit-equal to its solo
    run) and, 2-D, 2x2 K5 shards (bit-equal to the single-domain run).
    Returns the ``kernels`` entries, one per body."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    nbits_all, solo_ms, solo_plain, solo_bound, n_solo, worst = 0, 0.0, \
        0.0, 0.0, 0, 0.0
    for st, r in FLAT_MID:
        sizes = flat_sizes(st)
        plain = a3_ctx(fac, env, st, r, 4, sizes, "torch", 2)
        fused = a3_ctx(fac, env, st, r, 4, sizes, "fused", 2)
        for c in (plain, fused):
            seed_case(c, 5)
        plain.run_solution(0, steps - 1)
        zero_launch_counts()
        fused.run_solution(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        d, nbits = device_diff(fused, plain, exact=True)
        bad = fused.compare_data(plain, field_epsilon=FIELD_EPS)
        flat = fused.get_stats().get_tiling()["flat"]
        walk = flat_walk(flat, sizes, st)
        kern, s0 = fused._fused, dict(fused._state)
        ms = cuda_ms(lambda: fs.stages_step(kern, s0, steps), 5)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(fused._program, s0, steps,
                                                  1), 2)
        bound_ms = a3_bound(fused)[0]
        log(f"phase 16: {st} r={r} {'x'.join(map(str, sizes))} K=2 "
            f"{steps} steps on the flat arm ({flat['tile']}, "
            f"{flat['threads']} threads): vs plain (-mode torch on the "
            f"card) max|d|={d:.3e}, {nbits} cells differ in their bits, "
            f"mismatches={bad} (field_epsilon={FIELD_EPS}); launches {got}; "
            f"{walk}; {ms:.4f} ms/launch, bound {bound_ms:.4f}, plain "
            f"{plain_ms:.3f} [{card}]")
        if bad or got != {"stages_step": steps} \
                or flat["code"] != "flat_engaged" \
                or (nbits and st not in FLAT_PLAIN_ROUNDING):
            raise RuntimeError(f"phase 16: {st}: {bad} mismatches, {nbits} "
                               f"cells differ, launches {got}, "
                               f"{flat['code']}")
        nbits_all += nbits
        worst = max(worst, d)
        solo_ms += ms
        solo_plain += plain_ms
        solo_bound += bound_ms
        n_solo += steps
        del plain, fused, kern, s0
        torch.cuda.empty_cache()
    entries = [{
        "name": "stages_step (flat arm, K6 solo: every 1-D and 2-D solution "
                "at mid width)", "route": "cuda",
        "source": "yask_tpu_torch/csrc/fused_step.cuh",
        "replaces": FLAT_REPLACES, "launches": n_solo, "max_abs_err": worst,
        "ms": solo_ms, "plain_ms": solo_plain, "bound_ms": solo_bound,
        "bound_by": "bytes", "library_ms": None,
        "per": "sum over the cases of one launch each",
        "cells_differing_from_plain": nbits_all, "path": "phase 16 (e)"}]
    k7 = phase12a(fac, env, card, cases=[
        ("flat", st, r, 4, flat_sizes(st), "batched_stages_step")
        for st, r in FLAT_MID])
    entries.append({
        "name": "batched_stages_step (flat arm, K7: 3 members of every 1-D "
                "and 2-D solution at mid width)", "route": "cuda",
        "source": "yask_tpu_torch/csrc/fused_step.cuh",
        "replaces": K7_REPLACES, "launches": sum(e["launches"] for e in k7),
        "max_abs_err": max(e["max_abs_err"] for e in k7),
        "ms": sum(e["ms"] for e in k7),
        "plain_ms": sum(e["plain_ms"] for e in k7),
        "bound_ms": sum(e["bound_ms"] for e in k7), "bound_by": "bytes",
        "library_ms": None, "per": "sum over the cases of one launch each",
        "path": "phase 16 (e)"})
    torch.cuda.empty_cache()
    rows = phase13a(fac, card, dev=dev, cases=[
        (f"{st} r={r} flat", st, r, 4, flat_sizes(st)[1:], 1, X2Y2, "")
        for st, r in FLAT_MID if not st.endswith("_1d")])
    entries.append({
        "name": "shard_step (flat arm, K5: every 2-D solution on 2x2 shards "
                "at mid width)", "route": "cuda",
        "source": "yask_tpu_torch/csrc/fused_step.cuh",
        "replaces": "yask_tpu/ops/pallas_stencil.py:736-811 (region= and "
                    "distributed=True arms, the stage loop :2058-2188)",
        "launches": sum(row[7] for row in rows),
        "max_abs_err": max(row[6] for row in rows),
        "ms": sum(row[2] for row in rows),
        "plain_ms": sum(row[5] for row in rows),
        "bound_ms": sum(row[3] for row in rows), "bound_by": "bytes",
        "library_ms": None,
        "per": "sum over the cases of one launch over shard 0's box",
        "path": "phase 16 (e)"})
    return entries


def phase16(fac, env, card: str, gauss: dict, image: int = 8192,
            dev: str = "cuda:0") -> list:
    """Phase 16 (see the module docstring); returns the ``kernels``
    entries.  (a)'s profile and (b)'s sweep time gaussian's K6 launch, so
    they go to ``gauss``, phase 10 (c)'s entry for that launch."""
    import torch
    t0 = time.perf_counter()
    ctx, prof = phase16a(fac, env, card, image)
    rows = phase16b(ctx, card)
    del ctx
    torch.cuda.empty_cache()
    entries = []
    live = live_inputs(fac, env, "swe2d", None)
    e = a3_full(fac, env, card, "swe2d", None, 4, (1, image, image),
                "stages_step", f"flat arm of K6 on swe2d: {image}^2 fp32",
                physical=True, live=live)
    e.update(source="yask_tpu_torch/csrc/fused_step.cuh",
             replaces=FLAT_REPLACES, path="phase 16 (c), swe2d",
             live_inputs=[list(x) for x in live])
    del e["ctx"]
    entries.append(e)
    torch.cuda.empty_cache()
    e = a3_full(fac, env, card, "gaussian", 2, 2, (1, image, image),
                "stages_step", "flat arm of K6 at element size 2: "
                f"gaussian r=2 {image}^2x3 bf16", K=1, trials=1, steps=10,
                exact=True)
    gaussian_library(e, card, phase="phase 16 (d)")
    e.update(source="yask_tpu_torch/csrc/fused_step.cuh",
             replaces=FLAT_REPLACES, path="phase 16 (d), gaussian bf16")
    del e["ctx"]
    entries.append(e)
    torch.cuda.empty_cache()
    entries += phase16e(fac, env, card, dev=dev)
    case = f"gaussian r=2 {image}^2x3 fp32, one stages_step launch"
    gauss["sweep"] = {"case": f"{case} per rung, phase 16 (b)",
                      "rows": [[list(rung), ms, c] for rung, ms, c in rows]}
    if prof is not None:
        gauss["profile"] = dict(prof, case=f"{case} on the flat arm under "
                                "torch.profiler, phase 16 (a)")
    log(f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 17: K6's stream arm, solo and over member batches -----------

#: Phase 17 (a): every solution K6's stream arm takes, (solution, radius,
#: element bytes), at :data:`SS_MID_SIZES`: solo against its ``-no-skew``
#: twin (K6's body) to the bit and against its plain version, and as a
#: K7 batch of 3, each member against its solo run to the bit.
SS_MID = tuple((st, None, 4) for st in (
    "awp", "awp_abc", "awp_elastic", "awp_elastic_abc", "fsg", "fsg2",
    "fsg_abc", "fsg2_abc", "fsg_merged", "fsg_merged_abc", "ssg", "ssg2",
    "ssg_merged", "test_stages_3d", "test_boundary_3d")) + (("awp", None, 8),)
#: (slot 0, 1, 2): several plane tiles per slot, the last one partial,
#: and several segments of slot 0
SS_MID_SIZES = (67, 45, 131)
#: Phase 17 (a)'s RTM chains (``rtm_chain`` merged, ``-wf_steps 1``), each
#: as phase 6 (a) and (c) run K6's body: (label, radius, accumulating,
#: options, grid (x, y, z)); the arm takes all of them
SS_RTM = (("pure, image pushed", 2, False, "", SS_MID_SIZES),
          ("accumulating", 2, True, "", SS_MID_SIZES),
          ("pure, -push off", 2, False, "-push off", SS_MID_SIZES),
          ("pure, image pushed", 8, False, "", (64, 64, 64)))
#: Phase 17 (b): the stream arm's other plane tiles (T1, T2, threads) on
#: awp at 512^3
SS_SWEEP = ((8, 64, 512), (8, 32, 256), (4, 64, 256))
#: Phase 17 (e): the other families at 512^3, the arm beside its twin
SS_PAIRS = ("ssg", "fsg")
SS_SOURCE = "yask_tpu_torch/csrc/stream_stages.cuh"
SS_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2058-2188 (the stage loop, "
               "its rewrite :2155-2187) under the input prefetch "
               ":1815-1854 and the carry along the stream dim :1955-2056")
SS_K7_REPLACES = ("yask_tpu/runtime/ensemble.py:234-345 (jax.vmap of "
                  "build_pallas_chunk) -> yask_tpu/ops/pallas_stencil.py:"
                  "2155-2187 (the stage loop's rewrite, in the loop "
                  ":2058-2188) under the prefetch :1815-1854 and the carry "
                  ":1955-2056")


def ss_specs(fac, env) -> dict:
    """Phase 17's kernels, for phase 1's parallel build (the arm's
    entries are in each admitted solution's K6 source)."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r, eb in SS_MID:
        ctx = a3_ctx(fac, env, st, r, eb, (16, 16, 16), "fused")
        out[f"{st} r={r} {eb} B (K6 stream arm)"] = \
            fused_stencil.FusedKernel(ctx._program).spec
        if (st, eb) == ("awp", 4):
            for rung in SS_SWEEP:
                out[f"awp (K6 stream arm at {rung})"] = stream_kernel(
                    ctx._program, False, rung).spec
    return out


def phase17a(fac, env, card: str, steps: int = 5, cases=SS_MID,
             sizes=SS_MID_SIZES, rtm=SS_RTM, phase: str = "17 (a)",
             what: str = "K6 stream arm", rtm_dtype=None) -> list:
    """Phase 17 (a): each solution of ``cases`` at ``sizes`` (K = 2,
    ``steps`` steps, one seed made on the card): the stream arm (the
    counters zeroed just before, read just after) bit-equal to its
    ``-no-skew`` twin and held to its plain version at ``field_epsilon``;
    a K7 batch of 3 over the arm, each member bit-equal to its solo run
    and one 2-step chunk of the batch held to ``plain_batched_chunk`` at
    ``field_epsilon`` (an ulp of bfloat16, :data:`BF16_FIELD_EPS`, at
    element size 2); one launch of each arm, of the batch and of the
    plain versions timed; then the RTM chains of ``rtm``
    (:data:`SS_RTM`'s shape; none where false) in ``rtm_dtype``
    (:func:`phase17a_rtm`).  Returns the ``kernels``
    entries of the two arms at mid width (``what`` in their names, ``phase``
    in their logs and paths), summed over the cases and the chains."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    solo = {"launches": 0, "ms": 0.0, "twin_ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "err": 0.0}
    k7 = {k: v for k, v in solo.items() if k != "twin_ms"}
    for st, r, eb, *how in cases:
        # (an optional fourth field: False seeds with small material vars)
        phys = how[0] if how else True
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        case = (f"phase {phase}: {st} r={r} {eb} B "
                f"{'x'.join(map(str, sizes))}")
        ctxs = {k: a3_ctx(fac, env, st, r, eb, sizes, mode, 2, cli)
                for k, mode, cli in (("stream", "fused", ""),
                                     ("twin", "fused", "-no-skew"),
                                     ("plain", "torch", ""))}
        for c in ctxs.values():
            seed_device(c, 17, physical=phys)
        zero_launch_counts()
        ctxs["stream"].run_solution(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        ctxs["twin"].run_solution(0, steps - 1)
        ctxs["plain"].run_solution(0, steps - 1)
        arm, twin = ctxs["stream"], ctxs["twin"]
        if got != {"stages_stream": steps}:
            raise RuntimeError(f"{case}: launches {got}, expected {steps} "
                               "of K6's stream arm")
        twin_bad = arm.compare_data(twin, epsilon=0.0, abs_epsilon=0.0)
        _d, twin_bits = device_diff(arm, twin, exact=True)
        err, nbits = device_diff(arm, ctxs["plain"], exact=True)
        bad = arm.compare_data(ctxs["plain"], field_epsilon=eps)
        if twin_bad or twin_bits or bad or not finite(arm):
            raise RuntimeError(f"{case}: {twin_bad} mismatches ({twin_bits} "
                               f"cells' bits) against the -no-skew twin, "
                               f"{bad} against the plain version, finite "
                               f"{finite(arm)}")
        kern, prog, state = arm._fused, arm._program, arm._state
        ms = cuda_ms(lambda: fs.stages_step(kern, state, steps), 5)
        twin_ms = cuda_ms(lambda: fs.stages_step(twin._fused, twin._state,
                                                 steps), 5)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(prog, state, steps, 1), 2)
        bound_ms = a3_bound(arm)[0]
        solo["launches"] += got["stages_stream"]
        solo["err"] = max(solo["err"], err)
        for k, v in (("ms", ms), ("twin_ms", twin_ms),
                     ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            solo[k] += v
        # K7 over the arm: member 0 holds the stream run's seed
        bctx, ens = member_batch(fac, env, st, r, eb, sizes, 3,
                                 lambda c, i: seed_device(c, 17 + i,
                                                          physical=phys))
        zero_launch_counts()
        ens.run(0, steps - 1)
        bgot = {k: v for k, v in launch_counts().items() if v}
        if bgot != {"batched_stages_stream": steps} \
                or ens.tiling["kernel"] != "batched_stages_step" \
                or not ens.tiling["skew"]:
            raise RuntimeError(f"{case}: K7 launches {bgot}, tiling "
                               f"{ens.tiling['kernel']} skew "
                               f"{ens.tiling['skew']}")
        solos = [arm]
        for i in (1, 2):
            c = a3_ctx(fac, env, st, r, eb, sizes, "fused", 2)
            seed_device(c, 17 + i, physical=phys)
            c.run_solution(0, steps - 1)
            solos.append(c)
        for i, c0 in enumerate(solos):
            with ens.member(i) as c:
                _d, mb = device_diff(c, c0, exact=True)
            if mb:
                raise RuntimeError(f"{case}: K7 member {i}: {mb} cells "
                                   "differ from its solo run")
        # one 2-step K7 chunk of the stacked members against the plain
        # version of the batch
        err7, bits7, scale7 = k7_chunk_vs_plain(bctx, ens, steps, 2)
        if not err7 <= eps * scale7:
            raise RuntimeError(f"{case}: K7 over the arm and "
                               "plain_batched_chunk disagree: max|d|="
                               f"{err7:.3e} (field max {scale7:.3e})")
        bkern, bstate = bctx._batched_kernel(), ens._stack_states()
        bms = cuda_ms(lambda: fs.batched_stages_step(bkern, bstate, steps,
                                                     3), 5)
        bplain = cuda_ms(lambda: fs.plain_batched_chunk(
            bctx._program, bstate, steps, 1, 3), 2)
        k7["launches"] += bgot["batched_stages_stream"]
        k7["err"] = max(k7["err"], err7)
        for k, v in (("ms", bms), ("plain_ms", bplain),
                     ("bound_ms", k7_bound(bctx, 3)[0])):
            k7[k] += v
        plan = kern.spec.stages_stream.record()
        log(f"{case}: the stream arm (plane tile {plan['plane_tile']} by "
            f"{plan['threads']} threads, lags {plan['lags']}, "
            f"{plan['smem_bytes']} B, {plan['segments']} segment(s)) "
            f"launches {got}, bit-equal to its -no-skew twin "
            f"(compare_data(epsilon=0) = {twin_bad}, {twin_bits} cells' "
            f"bits differ); vs plain max|d|={err:.3e}, {nbits} cells "
            f"differ in their bits, mismatches={bad} (field_epsilon="
            f"{eps}); K7 x3 launches {bgot}, each member bit-equal to"
            f" its solo run, one 2-step chunk vs plain_batched_chunk "
            f"max|d|={err7:.3e} (field max {scale7:.3e}), {bits7} cells "
            f"differ in their bits; ms/launch: arm {ms:.3f}, twin "
            f"{twin_ms:.3f}, K7 x3 {bms:.3f}, plain {plain_ms:.3f} (not a "
            "yardstick) "
            f"[{card}]")
        del ctxs, arm, twin, kern, state, bctx, ens, bkern, bstate, solos
        release()
    if rtm:
        phase17a_rtm(env, card, solo, k7, cases=rtm, dtype=rtm_dtype,
                     phase=phase)
    n = len(cases) + len(rtm or ())
    log(f"phase {phase}: {n} cases summed: the stream arm {solo['ms']:.3f} "
        f"ms, its -no-skew twins {solo['twin_ms']:.3f} ms, K7 x3 "
        f"{k7['ms']:.3f} ms [{card}]")
    common = {"route": "cuda", "source": SS_SOURCE, "bound_by": "bytes",
              "library_ms": None, "path": f"phase {phase}"}
    return [dict(common, name=f"stages_step ({what}: {n} cases at "
                              "mid width, one launch each, summed)",
                 replaces=SS_REPLACES, launches=solo["launches"],
                 max_abs_err=solo["err"], ms=solo["ms"],
                 plain_ms=solo["plain_ms"], bound_ms=solo["bound_ms"],
                 twin_ms=solo["twin_ms"]),
            dict(common, name=f"batched_stages_step (K7 over the {what}: "
                              f"{n} cases x 3 members at mid width, "
                              "summed)",
                 replaces=SS_K7_REPLACES, launches=k7["launches"],
                 max_abs_err=k7["err"], ms=k7["ms"],
                 plain_ms=k7["plain_ms"], bound_ms=k7["bound_ms"])]


def phase17a_rtm(env, card: str, solo: dict, k7: dict, steps: int = 4,
                 cases=SS_RTM, nm: int = 3, dtype=None,
                 phase: str = "17 (a)") -> None:
    """Phase 17 (a)'s RTM chains: each of ``cases`` through
    ``SolutionPipeline`` (``prepare(fuse=True)``, ``-mode fused
    -wf_steps 1``) from one state seeded on the card, ``steps`` steps:
    the stream arm (the counters zeroed just before, read just after)
    bit-equal to its ``-no-skew`` twin (``compare`` at epsilon 0 and
    every cell's bits but the pushed image's, which neither writes) and
    held to its plain version (``-mode torch`` on the merged program) at
    ``field_epsilon``; a K7 batch of ``nm`` over the arm (push-off, as
    every batch), each member bit-equal to its solo run and one chunk of
    the batch held to ``plain_batched_chunk`` at ``field_epsilon``; one
    launch of each timed; in ``dtype`` (``lowering.BFLOAT16``: the
    bfloat16 field tolerance), ``phase`` labelling the lines.  Adds to
    the phase's sums ``solo`` and ``k7``."""
    from yask_tpu_torch.compiler.lowering import is_bfloat16
    from yask_tpu_torch.ops import fused_stencil as fs
    eps = (BF16_FIELD_EPS if dtype is not None and is_bfloat16(dtype)
           else FIELD_EPS)
    for label, r, acc, cli, g in cases:
        what = (f"phase {phase}: rtm chain r={r} {label} "
                f"{'x'.join(map(str, g))}")
        pipes = {k: rtm_pipe(env, f"-mode {mode} -wf_steps 1 {cli} {more}",
                             True, g, r, acc, dtype)
                 for k, mode, more in (("stream", "fused", ""),
                                       ("twin", "fused", "-no-skew"),
                                       ("plain", "torch", ""))}
        pushed = pipes["stream"].pushed_vars()
        want = set() if acc or cli else {"img__img"}
        if pushed != want or pipes["twin"].pushed_vars() != want:
            raise RuntimeError(f"{what}: pushed {pushed}, expected {want}")
        for p in pipes.values():
            seed_device(p.fused_ctx, 17, physical=True)
        zero_launch_counts()
        pipes["stream"].run(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        pipes["twin"].run(0, steps - 1)
        pipes["plain"].run(0, steps - 1)
        if got != {"stages_stream": steps}:
            raise RuntimeError(f"{what}: launches {got}, expected {steps} "
                               "of K6's stream arm")
        arm, twin = pipes["stream"].fused_ctx, pipes["twin"].fused_ctx
        twin_bad = pipes["stream"].compare(pipes["twin"])
        _d, twin_bits = device_diff(arm, twin, exact=True, skip=pushed)
        err, scale = pipe_diff(pipes["stream"], pipes["plain"])
        if twin_bad or twin_bits or not err <= eps * scale \
                or not finite(arm):
            raise RuntimeError(f"{what}: {twin_bad} mismatches ({twin_bits} "
                               "cells' bits) against the -no-skew twin; vs "
                               f"plain max|d|={err:.3e} (field max "
                               f"{scale:.3e}); finite {finite(arm)}")
        kern, prog, state = arm._fused, arm._program, arm._state
        ms = cuda_ms(lambda: fs.stages_step(kern, state, steps), 5)
        twin_ms = cuda_ms(lambda: fs.stages_step(twin._fused, twin._state,
                                                 steps), 5)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(prog, state, steps, 1), 2)
        solo["launches"] += got["stages_stream"]
        solo["err"] = max(solo["err"], err)
        for k, v in (("ms", ms), ("twin_ms", twin_ms),
                     ("plain_ms", plain_ms), ("bound_ms", a3_bound(arm)[0])):
            solo[k] += v
        # K7 over the arm: member i seeded as a solo run of seed 17 + i
        bpipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True, g, r,
                         acc, dtype)
        bctx = bpipe.fused_ctx
        ens = bctx.new_ensemble(nm)
        for i in range(nm):
            with ens.member(i) as c:
                seed_device(c, 17 + i, physical=True)
        zero_launch_counts()
        ens.run(0, steps - 1)
        bgot = {k: v for k, v in launch_counts().items() if v}
        if bgot != {"batched_stages_stream": steps} \
                or ens.tiling["kernel"] != "batched_stages_step" \
                or not ens.tiling["skew"]:
            raise RuntimeError(f"{what}: K7 launches {bgot}, tiling "
                               f"{ens.tiling['kernel']} skew "
                               f"{ens.tiling['skew']}")
        for i in range(nm):
            sp = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True, g, r,
                          acc, dtype)
            seed_device(sp.fused_ctx, 17 + i, physical=True)
            sp.run(0, steps - 1)
            with ens.member(i) as c:
                _d, mb = device_diff(sp.fused_ctx, c, exact=True,
                                     skip=pushed)
            sp.end()
            if mb:
                raise RuntimeError(f"{what}: K7 member {i}: {mb} cells "
                                   "differ from its solo run")
        err7, bits7, scale7 = k7_chunk_vs_plain(bctx, ens, steps, 1)
        if not err7 <= eps * scale7:
            raise RuntimeError(f"{what}: K7 over the arm and "
                               "plain_batched_chunk disagree: max|d|="
                               f"{err7:.3e} (field max {scale7:.3e})")
        bkern, bstate = bctx._batched_kernel(), ens._stack_states()
        bms = cuda_ms(lambda: fs.batched_stages_step(bkern, bstate, steps,
                                                     nm), 5)
        bplain = cuda_ms(lambda: fs.plain_batched_chunk(
            bctx._program, bstate, steps, 1, nm), 2)
        k7["launches"] += bgot["batched_stages_stream"]
        k7["err"] = max(k7["err"], err7)
        for k, v in (("ms", bms), ("plain_ms", bplain),
                     ("bound_ms", k7_bound(bctx, nm, spec=bkern.spec)[0])):
            k7[k] += v
        plan = kern.spec.stages_stream.record()
        log(f"{what}: the stream arm (plane tile {plan['plane_tile']} by "
            f"{plan['threads']} threads, lags {plan['lags']}, "
            f"{plan['smem_bytes']} B, {plan['segments']} segment(s), pushed "
            f"{sorted(pushed)}) launches {got}, bit-equal to its -no-skew "
            f"twin (compare = {twin_bad}, {twin_bits} cells' bits differ); "
            f"vs plain max|d|={err:.3e} (field max {scale:.3e}, "
            f"field_epsilon={eps}); K7 x{nm} launches {bgot}, each "
            f"member bit-equal to its solo run, one chunk vs "
            f"plain_batched_chunk max|d|={err7:.3e} (field max "
            f"{scale7:.3e}), {bits7} cells differ in their bits; ms/launch: "
            f"arm {ms:.3f}, twin {twin_ms:.3f}, K7 x{nm} {bms:.3f}, plain "
            f"{plain_ms:.3f} (not a yardstick) [{card}]")
        for p in list(pipes.values()) + [bpipe]:
            p.end()
        del pipes, arm, twin, kern, prog, state, bpipe, bctx, ens, bkern
        del bstate
        release()


def phase17e(fac, env, card: str, g: int = 512, warm: int = 2,
             steps: int = 10) -> None:
    """Phase 17 (e): each of :data:`SS_PAIRS` at ``g``³ on the arm and
    its ``-no-skew`` twin from one seed made on the card: ``warm`` steps,
    then ``steps`` with the counters zeroed just before (the arm's alone
    launches), the two states bit-equal after, one launch of each
    timed."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    for st in SS_PAIRS:
        torch.cuda.empty_cache()
        arm = a3_ctx(fac, env, st, None, 4, (g,) * 3, "fused", 2)
        twin = a3_ctx(fac, env, st, None, 4, (g,) * 3, "fused", 2,
                      "-no-skew")
        for c in (arm, twin):
            seed_device(c, 11, physical=True)
            c.run_solution(0, warm - 1)
        zero_launch_counts()
        t0 = time.perf_counter()
        arm.run_solution(warm, warm + steps - 1)
        arm_step = (time.perf_counter() - t0) / steps * 1e3
        got = {k: v for k, v in launch_counts().items() if v}
        t0 = time.perf_counter()
        twin.run_solution(warm, warm + steps - 1)
        twin_step = (time.perf_counter() - t0) / steps * 1e3
        _d, nbits = device_diff(arm, twin, exact=True)
        t = warm + steps
        ms = cuda_ms(lambda: fs.stages_step(arm._fused, arm._state, t), 5)
        tms = cuda_ms(lambda: fs.stages_step(twin._fused, twin._state, t),
                      5)
        log(f"phase 17 (e): {st} {g}^3 fp32 -wf_steps 2: the stream arm "
            f"{ms:.3f} ms/launch, {arm_step:.3f} ms/step; its -no-skew twin"
            f" {tms:.3f} ms/launch, {twin_step:.3f} ms/step ({tms / ms:.2f}x"
            f"); launches {got}; {nbits} cells differ in their bits after "
            f"{warm + steps} steps [{card}]")
        if got != {"stages_stream": steps} or nbits or not finite(arm):
            raise RuntimeError(f"phase 17 (e): {st}: launches {got}, "
                               f"{nbits} cells differ from the twin")
        del arm, twin


def phase17(fac, env, card: str, ptxas: dict, awp_body: dict,
            awp_twin: dict, k7_body: dict, rtm_body: dict,
            full: int = 512) -> list:
    """K6's stream arm and K7's over it (see the module docstring):
    ``awp_body`` is phase 9 (c)'s awp entry (K6's body, ``-no-skew``, from
    :func:`full_seed`), ``awp_twin`` its final state's digest,
    ``k7_body`` phase 12 (b)'s awp batch, ``rtm_body`` phase 6 (c)'s push
    arm (its ``-push off`` row under ``push_off``), all of this run;
    ``full`` is the edge of (b), (d) and (e), and twice (c)'s.  Returns
    the ``kernels`` entries."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    t_phase = time.perf_counter()
    entries = phase17a(fac, env, card)
    torch.cuda.empty_cache()
    # (b) awp at 512^3 on the arm, from phase 9 (c)'s seed
    e = family_full(fac, env, card, "awp", None, "K6 stream arm", full,
                    sweep=False, digest=True, profile=True,
                    stream_sweep=SS_SWEEP)
    digest, prof = e.pop("state_digest"), e.pop("profile")
    name = FusedKernel(a3_ctx(fac, env, "awp", None, 4, (16, 16, 16),
                              "fused")._program).spec.name
    same = digest == awp_twin["state_digest"]
    log(f"phase 17 (b): awp {full}^3 fp32: the stream arm {e['ms']:.3f} "
        f"ms/launch, {e['step_ms']:.3f} ms/step, share "
        f"{e['bound_ms'] / e['ms']:.3f} of {e['bound_ms']:.3f} ms; K6's "
        f"body (-no-skew, phase 9 (c), the same seed and steps) "
        f"{awp_body['ms']:.3f} ms/launch, {awp_body['step_ms']:.3f} "
        f"ms/step: {awp_body['ms'] / e['ms']:.2f}x per launch; final "
        f"states bit-equal: {same}; 3 launches of each from one state under"
        f" torch.profiler (ms per launch by kernel): {json.dumps(prof)}; "
        f"ptxas ({name}): {ptxas.get(name, 'not built in phase 1')} "
        f"[{card}]")
    if not same:
        raise RuntimeError(f"phase 17 (b): awp at {full}^3: the stream arm "
                           "and K6's body end in other states")
    e.update(name=f"stages_step (K6 stream arm: awp {full}^3 fp32)",
             replaces=SS_REPLACES, path="phase 17 (b)",
             body_ms=awp_body["ms"], body_step_ms=awp_body["step_ms"],
             profile=prof)
    entries.append(e)
    torch.cuda.empty_cache()
    # (c) K7 over the arm, awp 8 x 256^3, beside the solo arm and the body
    half = full // 2
    solo = {"awp": dict(e, label=f"phase 17 (b), K6 stream arm, {full}^3",
                        points=full ** 3)}
    k7 = phase12b(fac, env, card, solo, cells=(
        ("stream", "awp", None, 4, 8, (half,) * 3, "batched_stages_step",
         "awp"),), cli="", phase="17 (c)")[0]
    log(f"phase 17 (c): K7 over the stream arm, awp 8 x {half}^3: "
        f"{k7['ms']:.3f} ms/launch, {k7['step_ms']:.3f} ms/step; over K6's "
        f"body (phase 12 (b), -no-skew) {k7_body['ms']:.3f} ms/launch, "
        f"{k7_body['step_ms']:.3f} ms/step: {k7_body['ms'] / k7['ms']:.2f}x"
        f" [{card}]")
    k7.update(name=f"batched_stages_step (K7 over K6's stream arm: awp 8 x "
                   f"{half}^3 fp32)", replaces=SS_K7_REPLACES,
              path="phase 17 (c)", body_ms=k7_body["ms"],
              body_step_ms=k7_body["step_ms"])
    entries.append(k7)
    torch.cuda.empty_cache()
    # (d) the RTM chain at 512^3, the image pushed and -push off, each
    #     beside phase 6 (c)'s run of K6's body
    for label, cli, pushed, body in (
            ("image pushed", "", {"img__img"}, rtm_body),
            ("-push off", "-push off", set(), rtm_body["push_off"])):
        rtm = rtm_full(env, full, f"{label}, K6 stream arm", cli, pushed,
                       phase="17 (d)")
        log(f"phase 17 (d): rtm chain r=2 {full}^3, {label}: the stream arm "
            f"{rtm['ms']:.3f} ms/launch, {rtm['step_ms']:.3f} ms/step; K6's "
            f"body (phase 6 (c), -no-skew) {body['ms']:.3f} ms/launch, "
            f"{body['step_ms']:.3f} ms/step: "
            f"{body['ms'] / rtm['ms']:.3f}x [{card}]")
        rtm.update(name=f"stages_step (K6 stream arm: rtm chain r=2 "
                        f"{full}^3, {label})", replaces=SS_REPLACES,
                   path="phase 17 (d)", body_ms=body["ms"],
                   body_step_ms=body["step_ms"])
        entries.append(rtm)
        torch.cuda.empty_cache()
    phase17e(fac, env, card, full)
    log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return entries




# ---- phase 18: K6's stream arm with scratch sub-stages and rings past
#      shared memory --------------------------------------------------------

#: Phase 18 (a): the solutions the arm newly takes, at
#: :data:`SS_MID_SIZES` (stencil, radius, element bytes, seeded in physical
#: ranges): the scratch sub-stages (tti, test_scratch_3d) and the rings
#: past shared memory (r=8; ssg and fsg with small material vars, as
#: :data:`WS_FULL` seeds ssg)
SS18_MID = (("tti", 2, 4, True), ("tti", 4, 4, True), ("tti", 8, 4, True),
            ("test_scratch_3d", None, 4, True), ("ssg", 8, 4, False),
            ("fsg", 8, 4, False))
#: Phase 18 (d): two other plane tiles (T1, T2, threads) of the arm's
#: ladder, swept on tti r=2 and ssg r=8 at 512^3 (both plans take 16x32;
#: the ladder's two thinner rungs are slower still, PERF.md)
SS18_SWEEP = ((8, 64, 512), (8, 32, 256))
SS18_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2058-2188 (the stage "
                 "loop) with its scratch chains (_TileEval.read scratch "
                 ":175-179, the reset :2003, scratch writes :2105-2147) "
                 "under the prefetch :1815-1854 and the carry :1955-2056")
SS18_WS_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (the chunk's VMEM "
                    "tiles of the stage loop :2058-2188 and scratch chains "
                    ":175-179, :2105-2147), streamed along slot 0 "
                    "(:1955-2056)")


def ss18_specs(fac, env) -> dict:
    """Phase 18's kernels, for phase 1's parallel build: each solution's
    K6 source (its stream arm's entries in it) and the swept plane
    tiles'."""
    from yask_tpu_torch.ops import fused_stencil
    out = {}
    for st, r, eb, _phys in SS18_MID:
        ctx = a3_ctx(fac, env, st, r, eb, (16, 16, 16), "fused")
        out[f"{st} r={r} {eb} B (K6 stream arm, phase 18)"] = \
            fused_stencil.FusedKernel(ctx._program).spec
        if (st, r) in (("tti", 2), ("ssg", 8)):
            for rung in SS18_SWEEP:
                out[f"{st} r={r} (K6 stream arm at {rung})"] = \
                    stream_kernel(ctx._program, False, rung).spec
    return out


def phase18b(fac, env, card: str, twins: dict, full: int = 512) -> list:
    """Phase 18 (b) and (d): tti r=2, r=4 and r=8 and ssg r=8 at
    ``full``³ fp32 on the arm, each from the seed and steps of its
    ``-no-skew`` twin (``twins``: phase 9 (c)'s tti r=2 and phase 15
    (a)'s r=8 rows, with their final states' digests; tti r=4's twin runs
    here, 2 launches, its body being the 1x1x32 rung), the final states
    bit-equal, 3 launches of the arm and 3 of the twin (not tti r=4's)
    under :func:`profile_launches`; tti r=2 and ssg r=8 with the
    arm's other plane tiles (:data:`SS18_SWEEP`).  Returns the
    ``kernels`` entries."""
    import torch
    entries = []
    for st, r, how, twin in (
            ("tti", 2, dict(stream_sweep=SS18_SWEEP), twins["tti2"]),
            ("tti", 4, dict(warm=1, trials=1, steps=1, plain_g=full // 2),
             None),
            ("tti", 8, dict(warm=1, trials=1, steps=5, plain_g=full // 2),
             twins["tti8"]),
            ("ssg", 8, dict(warm=1, trials=1, steps=5, plain_g=full // 2,
                            seed=WS_FULL[1][2], stream_sweep=SS18_SWEEP),
             twins["ssg8"])):
        kind = "scratch sub-stages" if st == "tti" and r < 8 \
            else "rings past shared memory"
        if twin is None:
            # tti r=4's body takes the 1x1x32 rung (~5 s a launch at
            # 512^3): 2 launches of the run, 1 timed
            twin = family_full(fac, env, card, st, r, "the -no-skew body",
                               full, sweep=False, cli="-no-skew",
                               digest=True, reps=1, **how)
            twin.update(name=f"stages_step (K6's scratch arm, the -no-skew "
                             f"body: {st} r={r} {full}^3 fp32)",
                        replaces=SS18_REPLACES, path="phase 18 (b), twin")
            entries.append(twin)
            torch.cuda.empty_cache()
        e = family_full(fac, env, card, st, r, f"K6 stream arm, {kind}",
                        full, sweep=False, digest=True, profile=True,
                        profile_body=r != 4, **how)
        digest, prof = e.pop("state_digest"), e.pop("profile")
        same = digest == twin.pop("state_digest")
        log(f"phase 18 (b): {st} r={r} {full}^3 fp32: the stream arm "
            f"{e['ms']:.3f} ms/launch, {e['step_ms']:.3f} ms/step, share "
            f"{e['bound_ms'] / e['ms']:.3f} of {e['bound_ms']:.3f} ms; its "
            f"-no-skew twin ({twin['name']}, the same seed and steps) "
            f"{twin['ms']:.3f} ms/launch, {twin['step_ms']:.3f} ms/step: "
            f"{twin['ms'] / e['ms']:.2f}x per launch; final states "
            f"bit-equal: {same}; 3 launches of each from one state under "
            f"torch.profiler (ms per launch by kernel): {json.dumps(prof)} "
            f"[{card}]")
        if not same:
            raise RuntimeError(f"phase 18 (b): {st} r={r} at {full}^3: the "
                               "stream arm and its -no-skew twin end in "
                               "other states")
        e.update(name=f"stages_step (K6 stream arm, {kind}: {st} r={r} "
                      f"{full}^3 fp32)",
                 replaces=SS18_REPLACES if r < 8 else SS18_WS_REPLACES,
                 path="phase 18 (b)", body_ms=twin["ms"],
                 body_step_ms=twin["step_ms"], profile=prof)
        entries.append(e)
        torch.cuda.empty_cache()
    return entries


def phase18(fac, env, card: str, twins: dict, k7_body: dict,
            full: int = 512) -> list:
    """K6's stream arm with scratch sub-stages and rings past shared
    memory (see the module docstring): (a) :data:`SS18_MID` through
    :func:`phase17a`; (b) and (d) :func:`phase18b` (``twins``: the
    ``-no-skew`` rows of phases 9 (c) and 15 (a)); (c) K7 over the arm,
    tti r=2 8 x (``full`` / 2)³, beside the solo arm and ``k7_body``
    (phase 12 (b)'s tti batch on K6's body).  Returns the ``kernels``
    entries."""
    import torch
    t_phase = time.perf_counter()
    entries = phase17a(fac, env, card, cases=SS18_MID, rtm=False,
                       phase="18 (a)",
                       what="K6 stream arm, scratch sub-stages and rings "
                            "past shared memory")
    torch.cuda.empty_cache()
    rows = phase18b(fac, env, card, twins, full)
    entries += rows
    half = full // 2
    solo = next(e for e in rows if "tti r=2" in e["name"]
                and "stream arm" in e["name"])
    k7 = phase12b(fac, env, card, {"tti": dict(
        solo, label=f"phase 18 (b), K6 stream arm, {full}^3",
        points=full ** 3)}, cells=(
        ("stream", "tti", 2, 4, 8, (half,) * 3, "batched_stages_step",
         "tti"),), cli="", phase="18 (c)")[0]
    log(f"phase 18 (c): K7 over the stream arm, tti r=2 8 x {half}^3: "
        f"{k7['ms']:.3f} ms/launch, {k7['step_ms']:.3f} ms/step; over K6's "
        f"body (phase 12 (b), -no-skew) {k7_body['ms']:.3f} ms/launch, "
        f"{k7_body['step_ms']:.3f} ms/step: {k7_body['ms'] / k7['ms']:.2f}x"
        f" [{card}]")
    k7.update(name=f"batched_stages_step (K7 over K6's stream arm, scratch "
                   f"sub-stages: tti r=2 8 x {half}^3 fp32)",
              replaces=SS_K7_REPLACES, path="phase 18 (c)",
              body_ms=k7_body["ms"], body_step_ms=k7_body["step_ms"])
    entries.append(k7)
    log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return entries


# ---- phase 19: K5 over K6's stream arm (the region arm) -----------------

#: Phase 19 (a): phase 13 (a)'s 3-D cases on K6's body, all of which the
#: arm takes, and phase 15 (b)'s ssg r=8 on 2x2 shards (rings past shared
#: memory)
K5SS_MID = tuple(c for c in K5_CASES if c[1] in (
    "ssg", "tti", "awp", "test_scratch_3d", "test_boundary_3d")) + WS_K5
#: Phase 19 (b): phase 13 (b)'s cells on K6's body
K5SS_FULL = tuple(c for c in K5_FULL if c[1] != "iso3dfd")
K5SS_REPLACES = ("yask_tpu/ops/pallas_stencil.py:736-811, :1948-1953 "
                 "(region= and distributed=True arms) over the stage loop "
                 ":2058-2188, streamed along slot 0 (:1955-2056); "
                 "parallel/shard_step.py:1093-1160")


def phase19(fac, card: str, twins: dict) -> list:
    """K5 over K6's stream arm (see the module docstring): (a)
    :data:`K5SS_MID` through :func:`phase13a` with ``stream``; (b) and
    (c) :data:`K5SS_FULL` and tti with ``-overlap_x on`` through
    :func:`phase13b`, each from the seed and steps of phase 13 (b)'s
    ``-no-skew`` run (``twins``), the final shards bit-equal to it.
    Returns the ``kernels`` entries."""
    import torch
    t0 = time.perf_counter()
    rows = phase13a(fac, card, cases=K5SS_MID, stream=True, phase="19 (a)")
    entries = [summed(rows, "shard_step (K5 over K6's stream arm, phase 19 "
                            "(a): phase 13 (a)'s 3-D K6 cases and phase 15 "
                            "(b)'s ssg r=8 at mid width, one launch each "
                            "over shard 0's sub-step-0 box)", K5SS_REPLACES,
                      "phase 19 (a)", **K5_COLUMNS)]
    torch.cuda.empty_cache()
    for label, st, r, eb, g, K in K5SS_FULL:
        twin = twins[label]
        e = phase13b(fac, card, label, st, r, eb, g, K, stream=True,
                     twin=twin, phase="19 (b)", profile=True)
        e.pop("state_digest")
        log(f"phase 19 (b): {label} {g}^3 on 2x2 shards: K5 over K6's "
            f"stream arm {', '.join(f'{m:.3f}' for m in e['box_ms'])} ms "
            f"per launch over the sub-step boxes, {e['step_ms']:.3f} "
            f"ms/step, share {e['bound_ms'] / e['ms']:.3f} of "
            f"{e['bound_ms']:.4f} ms; K5's body (phase 13 (b), -no-skew) "
            f"{', '.join(f'{m:.3f}' for m in twin['box_ms'])} ms per "
            f"launch, {twin['step_ms']:.3f} ms/step: "
            f"{twin['ms'] / e['ms']:.2f}x per launch [{card}]")
        e.update(path="phase 19 (b)", replaces=K5SS_REPLACES,
                 body_ms=twin["ms"], body_step_ms=twin["step_ms"])
        entries.append(e)
        torch.cuda.empty_cache()
    # (c) tti with the overlap on, both arms, from the same seed and steps
    label, st, r, eb, g, K = K5SS_FULL[0]
    pair = []
    for stream in (True, False):
        e = phase13b(fac, card, label, st, r, eb, g, K, stream=stream,
                     twin=twins[label], cli="-overlap_x on",
                     phase="19 (c)")
        e.pop("state_digest")
        e.update(path="phase 19 (c)",
                 replaces=K5SS_REPLACES if stream else e["replaces"])
        pair.append(e)
        torch.cuda.empty_cache()
    log(f"phase 19 (c): {label} {g}^3 -overlap_x on: K5 over K6's stream "
        f"arm {pair[0]['step_ms']:.3f} ms/step, over K5's body "
        f"{pair[1]['step_ms']:.3f} ms/step; without the overlap "
        f"{entries[1]['step_ms']:.3f} and {twins[label]['step_ms']:.3f} "
        f"[{card}]")
    entries += pair
    log(f"phase 19 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 20: K4's stream arm (one launch per K-step group) ----------

#: Phase 20 (a): K4_MID's 3-D fp32 cases (the stream arm's), one group of
#: K = 2 each beside its ``-no-skew`` twin (the two-phase passes), and the
#: RTM chain at 64³
K4S_MID = tuple(c for c in K4_MID if c[3] == 4 and len(c[4]) == 3)
#: Phase 20 (b): (label, stencil, radius, edge, K) at full width, each
#: beside its ``-no-skew`` twin from one seed: phase 7 (b)'s and phase 14
#: (b)'s shapes
K4S_FULL = (("iso3dfd r=2", "iso3dfd", 2, 512, 4),
            ("tti r=2", "tti", 2, 512, 2))
#: Phase 20 (b)'s plane-tile sweep on iso3dfd (T1, T2, threads): the
#: planner's rung (16x32 by 512) and this one
K4S_SWEEP = ((32, 32, 1024),)
#: Phase 20 (c): K7 over the arm, members x edge (phase 14 (c)'s shape)
K4S_BATCH = (8, 256)
K4S_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (the trapezoid arm "
                ":812-930, :2058-2188, :2372-2416; the K levels lagged "
                "along slot 0 as its skewed-wavefront carry :306-441, "
                ":1955-2056)")
K4S_K7_REPLACES = ("yask_tpu/runtime/ensemble.py:253-263 (the vmapped "
                   "trapezoid chunk of pallas_stencil.py:2312)")


def k4s_specs(fac, env) -> dict:
    """Phase 20's K4 stream-arm sources (every case, and iso3dfd at the
    rungs of :data:`K4S_SWEEP`), for phase 1's parallel build; their
    ``-no-skew`` twins are phases 7 and 14's."""
    from yask_tpu_torch.ops import cuda_emit
    out = {}
    for label, st, r, _eb, sizes in K4S_MID:
        ctx = k4_ctx(fac, env, st, r, 4, sizes, "fused", 2,
                     "-trapezoid -skew", force=True)
        out[f"K4 stream {label}"] = ctx._trapezoid_kernel().spec
        del ctx
    pipe = rtm_pipe(env, "-mode fused -wf_steps 2 -trapezoid", True,
                    (64, 64, 64))
    pipe.fused_ctx._trapezoid_arg = lambda: True
    out["K4 stream rtm chain"] = pipe.fused_ctx._trapezoid_kernel().spec
    pipe.end()
    for label, st, r, g, K in K4S_FULL:
        ctx = k4_ctx(fac, env, st, r, 4, (g, g, g), "fused", K,
                     "-trapezoid -skew", force=True)
        out[f"K4 stream {label} {g}^3 K={K}"] = \
            ctx._trapezoid_kernel().spec
        if st == "iso3dfd":
            for rung in K4S_SWEEP:
                out[f"K4 stream {label} rung {rung}"] = \
                    cuda_emit.resolve_trapezoid(
                        ctx._program, K, True, skew=True,
                        stream_tiles=(rung,))
        del ctx
    return out


def k4s_plan(spec) -> str:
    """The stream arm's plan as phase 20 prints it."""
    from yask_tpu_torch.ops.cuda_emit import trap_stream_cells
    rec, tr = spec.stages_stream.record(), spec.trap
    return (f"plane tile {rec['plane_tile']} by {rec['threads']} threads, "
            f"lags per level {tr['level_lags']}, rings "
            f"{rec['ring_depths']} (computed {rec['computed_ring_depths']}),"
            f" {rec['smem_bytes']} B, places "
            f"{sorted(set(rec['ring_places'].values()))}/"
            f"{sorted(set(rec['computed_ring_places']))}, "
            f"{rec['segments']} segment(s) of {rec['segment_planes']} "
            f"planes, {rec['staged_per_point']} staged cells per point, "
            f"computed {trap_stream_cells(spec)[1]}x the useful")


def phase20a(fac, env, card: str, ptxas: dict, cases=K4S_MID,
             rtm: int = 64, phase: str = "20 (a)") -> list:
    """Phase 20 (a): each case forced on K4 under ``-skew`` (the stream
    arm) and under ``-no-skew`` (its two-phase twin), at its element
    size, one group of K = 2 from one seed with the counters zeroed just
    before each: the arm launches once and nothing else, the twin its
    three passes; the two bit-equal (``compare_data(epsilon=0)``) and the
    arm held to its plain version at ``field_epsilon`` (an ulp of
    bfloat16 at element size 2); one group of each timed; then, where
    ``rtm`` is nonzero, the RTM chain at ``rtm``³.  ``phase`` labels the
    lines.  Returns one row per case."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import plain_chunk, trapezoid_chunk
    rows = []

    def timed(label, ctx, twin_ctx, got, diff, eps=FIELD_EPS):
        kern, state, t = ctx._trapezoid_kernel(), ctx._state, ctx._cur_step
        ms = cuda_ms(lambda: trapezoid_chunk(kern, state, t, 2), 3)
        tk = twin_ctx._trapezoid_kernel()
        twin_ms = cuda_ms(lambda: trapezoid_chunk(tk, twin_ctx._state, t, 2),
                          3)
        plain_ms = cuda_ms(lambda: plain_chunk(kern.program, state, t, 2),
                           2)
        err, nbits, scale = k4_group_vs_plain(kern, state, t)
        bound_ms, bound_by, _nb = k4_bound(ctx, kern.spec)
        log(f"phase {phase}: {label}: K4's stream arm, one group (K=2): "
            f"launches {got}; bit-equal to its -no-skew twin (the two-phase "
            f"passes, compare_data(epsilon=0) = {diff[2]}); vs plain max|d|="
            f"{diff[0]:.3e} mismatches={diff[1]}; {ms:.3f} ms/group (CUDA "
            f"events) against the twin's {twin_ms:.3f} ({twin_ms / ms:.2f}x)"
            f", bound {bound_ms:.4f} ms ({bound_by}), share "
            f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms/group; a second "
            f"group vs plain max|d|={err:.3e} ({nbits} cells differ in "
            f"their bits); {k4s_plan(kern.spec)}; ptxas "
            f"{ptxas.get(kern.spec.name, 'not built by phase 1')} [{card}]")
        if not err <= eps * scale:
            raise RuntimeError(f"phase {phase}: {label}: K4's stream arm "
                               "and its plain version disagree")
        rows.append((label, ms, plain_ms, bound_ms, bound_by,
                     max(err, diff[0]), sum(got.values()), twin_ms))

    for label, st, r, eb, sizes in cases:
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        ctxs = {"k4s": k4_ctx(fac, env, st, r, eb, sizes, "fused", 2,
                              "-trapezoid -skew", force=True),
                "twin": k4_ctx(fac, env, st, r, eb, sizes, "fused", 2,
                               "-trapezoid", force=True),
                "plain": k4_ctx(fac, env, st, r, eb, sizes, "torch", 2)}
        for c in ctxs.values():
            seed_physical(c, 7)
        counts = {}
        for k, want in (("k4s", {"trapezoid_stream": 1}),
                        ("twin", {"trapezoid_phase1": 1,
                                  "trapezoid_diamond": 2})):
            zero_launch_counts()
            ctxs[k].run_solution(0, 1)
            torch.cuda.synchronize()
            counts[k] = {n: v for n, v in launch_counts().items() if v}
            if counts[k] != want:
                raise RuntimeError(f"phase {phase}: {label} {k}: launches "
                                   f"{counts[k]}, expected {want}")
        ctxs["plain"].run_solution(0, 1)
        twin_bad = ctxs["k4s"].compare_data(ctxs["twin"], epsilon=0.0,
                                            abs_epsilon=0.0)
        diff = (max_abs_diff(ctxs["k4s"], ctxs["plain"]),
                ctxs["k4s"].compare_data(ctxs["plain"], field_epsilon=eps),
                twin_bad)
        if twin_bad or diff[1] or not finite(ctxs["k4s"]):
            raise RuntimeError(f"phase {phase}: {label}: the stream arm "
                               f"differs from its twin ({twin_bad}) or its "
                               f"plain version ({diff[1]} mismatches)")
        timed(label, ctxs["k4s"], ctxs["twin"], counts["k4s"], diff, eps)
        del ctxs
        torch.cuda.empty_cache()
    if not rtm:
        return rows

    # the RTM chain merged by SolutionPipeline, prepare(fuse=True)
    g = (rtm,) * 3
    pipes = {"k4s": rtm_pipe(env, "-mode fused -wf_steps 2 -trapezoid", True,
                             g),
             "twin": rtm_pipe(env, "-mode fused -wf_steps 2 -trapezoid "
                                   "-no-skew", True, g),
             "plain": rtm_pipe(env, "-mode torch -wf_steps 2", True, g)}
    for k in ("k4s", "twin"):
        pipes[k].fused_ctx._trapezoid_arg = lambda: True
    for p in pipes.values():
        seed_chain(p, g, 7)
    zero_launch_counts()
    pipes["k4s"].run(0, 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != {"trapezoid_stream": 1}:
        raise RuntimeError(f"phase 20 (a): rtm chain: launches {got}")
    pipes["twin"].run(0, 1)
    pipes["plain"].run(0, 1)
    twin_bad = pipes["k4s"].compare(pipes["twin"])
    err, scale = pipe_diff(pipes["k4s"], pipes["plain"])
    if twin_bad or not err <= FIELD_EPS * scale:
        raise RuntimeError(f"phase 20 (a): rtm chain: the stream arm vs its "
                           f"twin {twin_bad} mismatches, vs plain "
                           f"max|d|={err:.3e}")
    timed(f"rtm chain r=2 {rtm}^3 (3 stages)", pipes["k4s"].fused_ctx,
          pipes["twin"].fused_ctx, got, (err, 0, twin_bad))
    for p in pipes.values():
        p.end()
    return rows


def phase20b(fac, env, card: str, ptxas: dict, label, st, r, g, K,
             warm: int = 1, trials: int = 3, groups: int = 3,
             sweep=(), eb: int = 4, phase: str = "20 (b)") -> dict:
    """Phase 20 (b): ``st`` at ``g``³ under forced ``-trapezoid`` with
    ``-skew`` (K4's stream arm) and with ``-no-skew`` (the two-phase
    passes) from one seed on the card: ``warm`` groups, then ``trials``
    runs of ``groups`` groups with the counters zeroed just before (one
    stream launch a group, or three passes), the final states bit-equal;
    ms per group and per step, one group by CUDA events against the
    bound, the plain version's group, one group against it, a profile
    of the arm's launches, ptxas's report, the rungs of ``sweep`` (each
    the arm's bits), and for iso3dfd what the auto gate chooses beside
    K1's stream arm (``-no-trapezoid``) from the same seed; at element
    size ``eb``, ``phase`` labelling the lines.  Returns the ``kernels``
    entry."""
    import torch
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import (
        TrapezoidKernel, plain_chunk, trapezoid_chunk)
    npts = g ** 3
    steps = groups * K
    out, ctxs = {}, {}
    torch.cuda.empty_cache()
    arms = [("stream", "-trapezoid -skew", True),
            ("two-phase", "-trapezoid", True)]
    if st == "iso3dfd":
        arms.append(("K1 stream arm", "-no-trapezoid -skew", False))
    for which, cli, force in arms:
        torch.cuda.empty_cache()
        ctx = k4_ctx(fac, env, st, r, eb, (g, g, g), "fused", K, cli,
                     force=force)
        seed_device(ctx, 11, physical=True)
        ctx.run_solution(0, warm * K - 1)
        t = warm * K
        zero_launch_counts()
        rates = []
        for _ in range(trials):
            ctx.clear_stats()
            ctx.run_solution(t, t + steps - 1)
            t += steps
            rates.append(ctx.get_stats().get_pts_per_sec())
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        ng = trials * groups
        want = ({"trapezoid_stream": ng} if which == "stream" else
                {"trapezoid_phase1": ng, "trapezoid_diamond": 2 * ng}
                if which == "two-phase" else
                {"stream_step": trials * steps})
        if got != want:
            raise RuntimeError(f"phase {phase}: {label} {which}: launches "
                               f"{got}, expected {want}")
        if not finite(ctx):
            raise RuntimeError(f"phase {phase}: {label} {which}: not "
                               "finite")
        til = ctx.get_stats().get_tiling()
        if which == "stream" and not (til.get("arm") == "trap_stream"
                                      and til["launches_per_group"] == 1):
            raise RuntimeError(f"phase {phase}: {label}: get_tiling() "
                               f"does not name K4's stream arm: {til}")
        rates.sort()
        out[which] = (npts / rates[len(rates) // 2] * 1e3, got,
                      til["name"])
        ctxs[which] = ctx
    bad = device_diff(ctxs["stream"], ctxs["two-phase"], exact=True)
    if bad[1]:
        raise RuntimeError(f"phase {phase}: {label}: the stream arm and its "
                           f"twin differ in {bad[1]} cells")
    ctx = ctxs["stream"]
    kern, prog, state = ctx._trapezoid_kernel(), ctx._program, ctx._state
    tk = ctxs["two-phase"]._trapezoid_kernel()
    spec = kern.spec
    t = warm * K + trials * steps
    ms = cuda_ms(lambda: trapezoid_chunk(kern, state, t, K), 5)
    twin_ms = cuda_ms(lambda: trapezoid_chunk(tk, ctxs["two-phase"]._state,
                                              t, K), 3)
    k1 = ""
    if "K1 stream arm" in ctxs:
        k1bad = device_diff(ctx, ctxs["K1 stream arm"], exact=True)
        k1 = (f"; K1's stream arm (-no-trapezoid, same seed) "
              f"{out['K1 stream arm'][0]:.3f} ms/step, launches "
              f"{out['K1 stream arm'][1]}, bit-equal: {k1bad[1]} cells "
              "differ")
        if k1bad[1]:
            raise RuntimeError(f"phase {phase}: {label}: the stream arm "
                               "differs from K1's")
        del ctxs["K1 stream arm"]
    del ctxs["two-phase"]
    torch.cuda.empty_cache()
    prof = profile_launches(lambda: trapezoid_chunk(kern, state, t, K), 3,
                            expect=("stream_stages_kernel",))
    plain_ms = cuda_ms(lambda: plain_chunk(prog, state, t, K), 1)
    err, nbits, scale = k4_group_vs_plain(kern, state, t)
    if not err <= (BF16_FIELD_EPS if eb == 2 else FIELD_EPS) * scale:
        raise RuntimeError(f"phase {phase}: {label}: the stream arm and its "
                           "plain version disagree")
    bound_ms, bound_by, nbytes = k4_bound(ctx, spec)
    rungs = []
    base = kern.chunk(dict(state), t, K)
    for rung in sweep:
        rs = cuda_emit.resolve_trapezoid(prog, K, True, skew=True,
                                         stream_tiles=(rung,))
        rk = TrapezoidKernel(prog, rs)
        rk.build()
        rms = cuda_ms(lambda: trapezoid_chunk(rk, state, t, K), 3)
        got = rk.chunk(dict(state), t, K)
        nb = sum(int((x != y).sum()) for n in set(spec.outputs)
                 for x, y in zip(got[n], base[n]))
        if nb:
            raise RuntimeError(f"phase {phase}: {label} at rung {rung}: "
                               f"{nb} cells differ from the planner's rung")
        rungs.append({"rung": list(rung), "ms": rms,
                      "computed_per_point": cuda_emit.trap_stream_cells(
                          rs)[1],
                      "smem_bytes": rs.stages_stream.smem_bytes,
                      "ptxas": ptxas.get(rs.name, "")})
        del rk, got
    del base
    auto = []
    if st == "iso3dfd":
        cuda_emit.resolve_trapezoid(prog, K, None, reasons=auto, skew=None)
    step_ms = out["stream"][0]
    twin_step = out["two-phase"][0]
    log(f"phase {phase}: {label} {g}^3 -mode fused -wf_steps {K} -trapezoid "
        f"(forced), K4's stream arm: {trials} trials x {groups} groups: "
        f"{step_ms:.3f} ms/step ({step_ms * K:.3f} per group), launches "
        f"{out['stream'][1]}, get_tiling() naming {out['stream'][2]}; its "
        f"-no-skew twin (the two-phase passes, same "
        f"seed) {twin_step:.3f} ms/step, launches {out['two-phase'][1]}, "
        f"bit-equal ({bad[1]} cells differ); one group {ms:.3f} ms (CUDA "
        f"events) against the twin's {twin_ms:.3f} ({twin_ms / ms:.2f}x), "
        f"bound {bound_ms:.3f} ms ({bound_by}: {nbytes / npts:.1f} B/pt per "
        f"group), share {bound_ms / ms:.3f}; plain {plain_ms:.3f} ms/group "
        f"(not a yardstick); a group vs plain max|d|={err:.3e} ({nbits} "
        f"cells differ in their bits){k1}; {k4s_plan(spec)}; ptxas "
        f"{ptxas.get(spec.name, 'not built by phase 1')}; profile {prof}; "
        f"rungs {rungs}; the auto gate: "
        f"{[(x['code'], x.get('kernel', '')) for x in auto]} [{card}]")
    entry = {"name": f"trapezoid_chunk, K4's stream arm ({label} {g}^3, "
                     f"K={K})", "route": "cuda", "source": SS_SOURCE,
             "replaces": K4S_REPLACES,
             "launches": out["stream"][1]["trapezoid_stream"],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
             "per": f"group of {K} steps (one launch)", "step_ms": step_ms,
             "twin": "two-phase K4 (-no-skew)", "twin_ms": twin_ms,
             "twin_step_ms": twin_step, "rungs": rungs,
             "idle_share": prof["idle_share"] if prof else None,
             "path": f"phase {phase}"}
    if "K1 stream arm" in out:
        entry["k1_stream_step_ms"] = out["K1 stream arm"][0]
        entry["auto_gate"] = [x["code"] for x in auto]
    del ctxs, ctx, kern, state
    torch.cuda.empty_cache()
    return entry


def phase20c(fac, env, card: str, nm: int = 8, g: int = 256,
             K: int = 4, groups: int = 2) -> dict:
    """Phase 20 (c): an ``EnsembleRun`` of ``nm`` members of iso3dfd r=2
    at ``g``³ under forced ``-trapezoid`` (``-skew``), each seeded on the
    card: ``groups`` groups with the counters zeroed just before (one
    launch of ``_trap_stream_batched`` a group and nothing else), each
    member bit-equal to its solo run on the arm; the batched group timed
    against ``nm`` solo groups and the two-phase batch (``-no-skew``) on
    the same stack, bit-equal to it.  Returns the ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import (
        batched_trapezoid_chunk, plain_batched_chunk, trapezoid_chunk)
    steps = groups * K
    ctx = k4_ctx(fac, env, "iso3dfd", 2, 4, (g, g, g), "fused", K,
                 "-trapezoid -skew", force=True)
    ens = ctx.new_ensemble(nm)
    for i in range(nm):
        with ens.member(i) as c:
            seed_device(c, 300 + i)
    zero_launch_counts()
    ens.run(0, steps - 1)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != {"batched_trapezoid_stream": groups}:
        raise RuntimeError(f"phase 20 (c): ensemble: launches {got}")
    solo = k4_ctx(fac, env, "iso3dfd", 2, 4, (g, g, g), "fused", K,
                  "-trapezoid -skew", force=True)
    for i in range(nm):
        seed_device(solo, 300 + i)
        solo.run_solution(0, steps - 1)
        with ens.member(i) as c:
            bad = device_diff(c, solo, exact=True)
        if bad[1]:
            raise RuntimeError(f"phase 20 (c): member {i} differs from its "
                               f"solo run in {bad[1]} cells")
    kern = ctx._trapezoid_kernel()
    twin = k4_ctx(fac, env, "iso3dfd", 2, 4, (g, g, g), "fused", K,
                  "-trapezoid", force=True)._trapezoid_kernel()
    twin.build()
    st = ens._stack_states()
    ms = cuda_ms(lambda: batched_trapezoid_chunk(kern, st, steps, K, nm), 3)
    twin_ms = cuda_ms(lambda: batched_trapezoid_chunk(twin, st, steps, K,
                                                      nm), 3)
    solo_ms = cuda_ms(lambda: trapezoid_chunk(kern, solo._state, steps, K),
                      3)
    plain_ms = cuda_ms(lambda: plain_batched_chunk(kern.program, st, steps,
                                                   K, nm), 1)
    a = kern.batched_chunk(dict(st), steps, K, nm)
    b = twin.batched_chunk(dict(st), steps, K, nm)
    nbits = sum(int((x != y).sum()) for n in set(kern.spec.outputs)
                for x, y in zip(a[n], b[n]))
    del b
    c = plain_batched_chunk(kern.program, dict(st), steps, K, nm)
    err = max(float((x - y).abs().max()) for n in set(kern.spec.outputs)
              for x, y in zip(a[n][-2:], c[n][-2:]))
    scale = max(float(y.abs().max()) for n in c for y in c[n])
    del a, c, st
    if nbits or not err <= FIELD_EPS * scale:
        raise RuntimeError(f"phase 20 (c): the batch differs from the "
                           f"two-phase batch ({nbits} cells) or its plain "
                           f"version (max|d|={err:.3e})")
    bound_ms, bound_by, _nb = k4_bound(ctx, kern.spec)
    bound_ms *= nm
    log(f"phase 20 (c): EnsembleRun {nm} x iso3dfd r=2 {g}^3 -wf_steps {K} "
        f"-trapezoid (forced, K4's stream arm): {steps} steps, launches "
        f"{got}; every member bit-equal to its solo run; one batched group "
        f"{ms:.3f} ms (CUDA events) against {nm} x {solo_ms:.3f} ms solo "
        f"({ms / (nm * solo_ms):.3f}x per point) and the two-phase batch's "
        f"{twin_ms:.3f} ({twin_ms / ms:.2f}x; bit-equal, {nbits} cells "
        f"differ); bound {bound_ms:.3f} ms ({bound_by}), share "
        f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; vs plain max|d|="
        f"{err:.3e} [{card}]")
    del ctx, ens, solo, kern, twin
    torch.cuda.empty_cache()
    return {"name": f"batched_trapezoid_chunk, K7 over K4's stream arm ({nm} "
                    f"x iso3dfd r=2 {g}^3, K={K})", "route": "cuda",
            "source": SS_SOURCE, "replaces": K4S_K7_REPLACES,
            "launches": got["batched_trapezoid_stream"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "per": f"group of {K} steps of {nm} members (one launch)",
            "solo_ms": solo_ms, "twin_ms": twin_ms, "path": "phase 20 (c)"}


def summed(rows, name: str, replaces: str, path: str, ms=1, plain=2,
           bound=3, by=4, err=5, launches=6, twin=7,
           source: str = None) -> dict:
    """A ``kernels`` entry summing a phase's mid-width rows (each one
    launch of a case): the columns of each quantity in the rows;
    ``source`` the kernel's header (K6's stream arm's by default)."""
    twins = [row[twin] for row in rows if row[twin] is not None]
    return {"name": name, "route": "cuda", "source": source or SS_SOURCE,
            "replaces": replaces,
            "launches": sum(row[launches] for row in rows),
            "max_abs_err": max(row[err] for row in rows),
            "ms": sum(row[ms] for row in rows),
            "plain_ms": sum(row[plain] for row in rows),
            "bound_ms": sum(row[bound] for row in rows),
            "bound_by": "bytes" if all(row[by] == "bytes" for row in rows)
            else "operations", "library_ms": None,
            "twin_ms": sum(twins) if twins else None,
            "per": "sum over the cases of one launch each: "
                   + ", ".join(row[0] for row in rows), "path": path}


#: the columns of :func:`phase13a`'s rows for :func:`summed`
K5_COLUMNS = dict(ms=2, plain=5, bound=3, by=4, err=6, launches=7, twin=8)


def phase20(fac, env, card: str, ptxas: dict) -> list:
    """K4's stream arm (see the module docstring).  Returns the
    ``kernels`` entries."""
    import torch
    t0 = time.perf_counter()
    rows = phase20a(fac, env, card, ptxas)
    entries = [summed(rows, "trapezoid_chunk, K4's stream arm (phase 20 "
                            "(a): stages, scratch, rewrite, the RTM chain)",
                      K4S_REPLACES, "phase 20 (a)")]
    torch.cuda.empty_cache()
    for label, st, r, g, K in K4S_FULL:
        entries.append(phase20b(fac, env, card, ptxas, label, st, r, g, K,
                                sweep=K4S_SWEEP if st == "iso3dfd" else ()))
    entries.append(phase20c(fac, env, card, *K4S_BATCH))
    log(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 21: the stream arm past three domain dims (K6, K7, K4) ------

#: Phase 21 (a): K6's stream arm at mid width on the 4-D and 5-D K6
#: solutions, solo and under K7: (label, solution, sizes per dim); the
#: outer dims split into windows, the last one partial
S4_MID = (("four_d_stages", "four_d_stages", (21, 40, 36, 70)),
          ("five_d", "five_d", (6, 7, 40, 20, 70)))
#: and K4's stream arm at K = 2 on a 4-D K1 and a 4-D K6 solution
S4_K4_MID = (("test_4d", "test_4d", (21, 40, 36, 70)),
             ("four_d_stages", "four_d_stages", (21, 40, 36, 70)))
#: the members of phase 21 (a)'s batches
S4_NM = 3
#: Phase 21 (b): (label, solution, edge, K, groups or steps) at full width
S4_FULL = (("test_4d", "test_4d", 128, 2, 3),
           ("four_d_stages", "four_d_stages", 128, 1, 10))
#: Phase 21 (b)'s rung sweep beside the planner's (T1, T2, threads, outer
#: windows): a narrower outer window keeps more rings in shared memory
S4_SWEEP = ((16, 32, 512, (8,)), (16, 32, 512, (4,)))
S4_REPLACES = ("yask_tpu/ops/pallas_stencil.py:1442 (the grid over every "
               "lead dim) with the stage loop :2058-2188, streamed along "
               "slot 0 (:1815-1854, :1955-2056)")
S4_K7_REPLACES = ("yask_tpu/runtime/ensemble.py:234-345 (jax.vmap of "
                  "build_pallas_chunk) over the 4-D stage loop "
                  "pallas_stencil.py:1442, :2058-2188")
S4_K4_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2312 (the trapezoid arm "
                  ":812-930 over every lead dim :1442; the K levels lagged "
                  "along slot 0 as its skewed-wavefront carry :306-441, "
                  ":1955-2056)")
#: phase 21 (a)'s row kinds: (kind, the entry's name, what it replaces)
S4_KINDS = (("K6", "stages_step, K6's 4-D stream arm", S4_REPLACES),
            ("K7", "batched_stages_step, K7 over K6's 4-D stream arm",
             S4_K7_REPLACES),
            ("K4", "trapezoid_chunk, K4's 4-D stream arm", S4_K4_REPLACES),
            ("K7/K4", "batched_trapezoid_chunk, K7 over K4's 4-D stream "
                      "arm", S4_K4_REPLACES))


def s4_specs(fac, env) -> dict:
    """Phase 21's sources (K6's 4-D sources carry the body and the stream
    arm's ``StreamSpec``; K4's stream arm and its two-phase twin per case;
    the full-width ones and the rungs of :data:`S4_SWEEP`, whose plans
    follow the size), for phase 1's parallel build."""
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    out = {}
    for label, st, sizes in S4_MID:
        ctx = a3_ctx(fac, env, st, None, 4, sizes, "fused")
        out[f"K6 4-D {label}"] = FusedKernel(ctx._program).spec
        del ctx
    for label, st, sizes in S4_K4_MID:
        for arm, cli in (("stream", "-trapezoid -skew"),
                         ("two-phase", "-trapezoid")):
            ctx = k4_ctx(fac, env, st, None, 4, sizes, "fused", 2, cli,
                         force=True)
            out[f"K4 4-D {arm} {label}"] = ctx._trapezoid_kernel().spec
            del ctx
    for label, st, g, K, _n in S4_FULL:
        if K > 1:
            ctx = k4_ctx(fac, env, st, None, 4, (g,) * 4, "fused", K,
                         "-trapezoid", force=True)
            out[f"K4 4-D two-phase {label} {g}^4"] = \
                ctx._trapezoid_kernel().spec
            del ctx
            ctx = k4_ctx(fac, env, st, None, 4, (g,) * 4, "fused", K,
                         "-trapezoid -skew", force=True)
            out[f"K4 4-D stream {label} {g}^4"] = \
                ctx._trapezoid_kernel().spec
            for rung in S4_SWEEP:
                out[f"K4 4-D stream {label} rung {rung}"] = \
                    cuda_emit.resolve_trapezoid(ctx._program, K, True,
                                                skew=True,
                                                stream_tiles=(rung,))
        else:
            ctx = a3_ctx(fac, env, st, None, 4, (g,) * 4, "fused")
            out[f"K6 4-D {label} {g}^4"] = FusedKernel(ctx._program).spec
            for rung in S4_SWEEP:
                out[f"K6 4-D {label} rung {rung}"] = cuda_emit.emit(
                    ctx._program, stream_tiles=(rung,))
        del ctx
    return out


def s4_plan(plan) -> str:
    """The 4-D stream arm's plan as phase 21 prints it."""
    rec = plan.record()
    return (f"outer window {rec.get('outer_window')}, plane tile "
            f"{rec['plane_tile']} by {rec['threads']} threads, lags "
            f"{rec['lags']}, rings {rec['ring_depths']} (computed "
            f"{rec['computed_ring_depths']}), {rec['smem_bytes']} B, places "
            f"{rec['ring_places']}/{rec['computed_ring_places']}, workspace "
            f"{rec['ws_block_bytes']} B per block, {rec['segments']} "
            f"segment(s) of {rec['segment_planes']} planes, "
            f"{rec['columns']} columns, computed cells per point "
            f"{rec['computed_per_point']}")


def s4_counts(run, want: dict, what: str) -> dict:
    """Zero every counter, ``run()``, read the counters: exactly
    ``want``, else raise."""
    import torch
    zero_launch_counts()
    run()
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    if got != want:
        raise RuntimeError(f"phase 21: {what}: launches {got}, expected "
                           f"{want}")
    return got


def phase21a(fac, env, card: str, ptxas: dict, steps: int = 5,
             nm: int = S4_NM, mid=S4_MID, k4_mid=S4_K4_MID, eb: int = 4,
             phase: str = "21 (a)") -> list:
    """Phase 21 (a): at mid width, from one seed, K6's 4-D (5-D) stream
    arm (the default ``-skew``) beside its ``-no-skew`` twin (K6's body
    with its outer copies) for ``steps`` steps, K7 over it (``nm``
    members, each bit-equal to its solo run), and K4's 4-D stream arm
    (forced ``-trapezoid``, K = 2, one group) beside its two-phase twin,
    and K7 over it; each with the counters zeroed just before and read
    just after (the expected launches and no others), bit-equal to its
    twin and held to its plain version; one launch of each timed.  The
    cases are ``mid`` (K6) and ``k4_mid`` (K4) at element size ``eb`` (an
    ulp of bfloat16 the plain version's tolerance at 2), ``phase``
    labelling the lines.  Returns rows (label, ms, plain ms, bound ms,
    bound by, max |d|, launches, twin ms, kind)."""
    import torch
    from yask_tpu_torch.ops import fused_stencil as fs
    rows = []
    eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
    for label, st, sizes in mid:
        ctxs = {"arm": a3_ctx(fac, env, st, None, eb, sizes, "fused"),
                "twin": a3_ctx(fac, env, st, None, eb, sizes, "fused", 1,
                               "-no-skew"),
                "plain": a3_ctx(fac, env, st, None, eb, sizes, "torch")}
        for c in ctxs.values():
            seed_case(c, 7)
        got = s4_counts(lambda: ctxs["arm"].run_solution(0, steps - 1),
                        {"stages_stream": steps}, f"{label} solo")
        s4_counts(lambda: ctxs["twin"].run_solution(0, steps - 1),
                  {"stages_step": steps}, f"{label} twin")
        ctxs["plain"].run_solution(0, steps - 1)
        _d, twin_bits = device_diff(ctxs["arm"], ctxs["twin"], exact=True)
        d = max_abs_diff(ctxs["arm"], ctxs["plain"])
        bad = ctxs["arm"].compare_data(ctxs["plain"],
                                       field_epsilon=eps)
        if twin_bits or bad or not finite(ctxs["arm"]):
            raise RuntimeError(f"phase {phase}: {label}: the stream arm "
                               f"differs from its twin in {twin_bits} cells "
                               f"or from its plain version ({bad} "
                               "mismatches)")
        kern, tk = ctxs["arm"]._fused, ctxs["twin"]._fused
        s0, s1 = dict(ctxs["arm"]._state), dict(ctxs["twin"]._state)
        ms = cuda_ms(lambda: fs.stages_step(kern, s0, steps), 3)
        twin_ms = cuda_ms(lambda: fs.stages_step(tk, s1, steps), 3)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(kern.program, s0, steps,
                                                  1), 2)
        bound_ms, bound_by, _nb = a3_bound(ctxs["arm"])
        log(f"phase {phase}: {label} {'x'.join(map(str, sizes))} K6's stream "
            f"arm, {steps} steps: launches {got}; bit-equal to its -no-skew "
            f"twin (K6's body, {tk.spec.stages} sub-stages with the outer "
            f"copies; {twin_bits} cells differ); vs plain max|d|={d:.3e} "
            f"mismatches={bad}; {ms:.3f} ms/launch (CUDA events) against "
            f"the twin's {twin_ms:.3f} ({twin_ms / ms:.2f}x), bound "
            f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.3f} ms; "
            f"{s4_plan(kern.spec.stages_stream)}; ptxas "
            f"{ptxas.get(kern.spec.name, 'not built by phase 1')} [{card}]")
        rows.append((label, ms, plain_ms, bound_ms, bound_by, d, steps,
                     twin_ms, "K6"))
        del ctxs
        # K7 over it: nm members, each bit-equal to its solo run
        ctx, ens = member_batch(fac, env, st, None, eb, sizes, nm,
                                lambda c, i: seed_case(c, 100 + i), K=1)
        got = s4_counts(lambda: ens.run(0, steps - 1),
                        {"batched_stages_stream": steps}, f"{label} K7")
        solo = a3_ctx(fac, env, st, None, eb, sizes, "fused")
        for i in range(nm):
            seed_case(solo, 100 + i)
            solo.run_solution(0, steps - 1)
            with ens.member(i) as c:
                _d, nb = device_diff(c, solo, exact=True)
            if nb:
                raise RuntimeError(f"phase {phase}: {label} K7: member {i} "
                                   f"differs from its solo run in {nb} "
                                   "cells")
        bk = ctx._batched_kernel()
        stack = ens._stack_states()
        ms7 = cuda_ms(lambda: fs.batched_stages_step(bk, stack, steps, nm), 3)
        err7, nbits7, scale7 = k7_chunk_vs_plain(ctx, ens, steps, 1)
        plain7 = cuda_ms(lambda: fs.plain_batched_chunk(bk.program, stack,
                                                        steps, 1, nm), 1)
        b7, by7, _nb = k7_bound(ctx, nm)
        if not err7 <= eps * scale7:
            raise RuntimeError(f"phase {phase}: {label} K7: the batch and its "
                               "plain version disagree")
        log(f"phase {phase}: {label} K7 over K6's stream arm, {nm} members: "
            f"launches {got}; every member bit-equal to its solo run; "
            f"{ms7:.3f} ms/launch against {nm} x {ms:.3f} solo "
            f"({ms7 / (nm * ms):.3f}x per point); vs plain_batched_chunk "
            f"max|d|={err7:.3e} ({nbits7} cells differ in their bits); "
            f"bound {b7:.4f} ms ({by7}); plain {plain7:.3f} ms [{card}]")
        rows.append((f"{label} K7 x{nm}", ms7, plain7, b7, by7, err7, steps,
                     None, "K7"))
        del ctx, ens, solo, stack
        torch.cuda.empty_cache()

    for label, st, sizes in k4_mid:
        ctxs = {"arm": k4_ctx(fac, env, st, None, eb, sizes, "fused", 2,
                              "-trapezoid -skew", force=True),
                "twin": k4_ctx(fac, env, st, None, eb, sizes, "fused", 2,
                               "-trapezoid", force=True),
                "plain": k4_ctx(fac, env, st, None, eb, sizes, "torch", 2)}
        for c in ctxs.values():
            seed_case(c, 7)
        got = s4_counts(lambda: ctxs["arm"].run_solution(0, 1),
                        {"trapezoid_stream": 1}, f"{label} K4")
        s4_counts(lambda: ctxs["twin"].run_solution(0, 1),
                  {"trapezoid_phase1": 1, "trapezoid_diamond": 2},
                  f"{label} K4 twin")
        ctxs["plain"].run_solution(0, 1)
        _d, twin_bits = device_diff(ctxs["arm"], ctxs["twin"], exact=True)
        d = max_abs_diff(ctxs["arm"], ctxs["plain"])
        bad = ctxs["arm"].compare_data(ctxs["plain"],
                                       field_epsilon=eps)
        if twin_bits or bad or not finite(ctxs["arm"]):
            raise RuntimeError(f"phase {phase}: {label} K4: the stream arm "
                               f"differs from its twin in {twin_bits} cells "
                               f"or from its plain version ({bad} "
                               "mismatches)")
        kern = ctxs["arm"]._trapezoid_kernel()
        tk = ctxs["twin"]._trapezoid_kernel()
        s0, s1 = dict(ctxs["arm"]._state), dict(ctxs["twin"]._state)
        ms = cuda_ms(lambda: fs.trapezoid_chunk(kern, s0, 2, 2), 3)
        twin_ms = cuda_ms(lambda: fs.trapezoid_chunk(tk, s1, 2, 2), 3)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(kern.program, s0, 2, 2),
                           2)
        bound_ms, bound_by, _nb = k4_bound(ctxs["arm"], kern.spec)
        log(f"phase {phase}: {label} {'x'.join(map(str, sizes))} K4's stream "
            f"arm, one group (K=2): launches {got}; bit-equal to its "
            f"-no-skew twin (the two-phase passes; {twin_bits} cells "
            f"differ); vs plain max|d|={d:.3e} mismatches={bad}; {ms:.3f} "
            f"ms/group (CUDA events) against the twin's {twin_ms:.3f} "
            f"({twin_ms / ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.3f} ms; {s4_plan(kern.spec.stages_stream)}; "
            f"ptxas {ptxas.get(kern.spec.name, 'not built by phase 1')} "
            f"[{card}]")
        rows.append((f"{label} K4 K=2", ms, plain_ms, bound_ms, bound_by, d,
                     1, twin_ms, "K4"))
        del ctxs
        if st != "test_4d":
            continue
        # K7 over K4's 4-D stream arm: one launch a group
        ctx = k4_ctx(fac, env, st, None, eb, sizes, "fused", 2,
                     "-trapezoid -skew", force=True)
        ens = ctx.new_ensemble(nm)
        for i in range(nm):
            with ens.member(i) as c:
                seed_case(c, 200 + i)
        got = s4_counts(lambda: ens.run(0, 1),
                        {"batched_trapezoid_stream": 1}, f"{label} K7/K4")
        solo = k4_ctx(fac, env, st, None, eb, sizes, "fused", 2,
                      "-trapezoid -skew", force=True)
        for i in range(nm):
            seed_case(solo, 200 + i)
            solo.run_solution(0, 1)
            with ens.member(i) as c:
                _d, nb = device_diff(c, solo, exact=True)
            if nb:
                raise RuntimeError(f"phase {phase}: {label} K7 over K4: "
                                   f"member {i} differs from its solo run "
                                   f"in {nb} cells")
        bk = ctx._trapezoid_kernel()
        stack = ens._stack_states()
        ms7 = cuda_ms(lambda: fs.batched_trapezoid_chunk(bk, stack, 2, 2,
                                                         nm), 3)
        a = bk.batched_chunk(dict(stack), 2, 2, nm)
        b = fs.plain_batched_chunk(bk.program, dict(stack), 2, 2, nm)
        err7 = max(float((x - y).abs().max()) for n in set(bk.spec.outputs)
                   for x, y in zip(a[n][-2:], b[n][-2:]))
        scale7 = max(float(y.abs().max()) for n in b for y in b[n])
        del a, b
        plain7 = cuda_ms(lambda: fs.plain_batched_chunk(bk.program, stack, 2,
                                                        2, nm), 1)
        b7, by7, _nb = k4_bound(ctx, bk.spec)
        if not err7 <= eps * scale7:
            raise RuntimeError(f"phase {phase}: {label} K7 over K4: the batch "
                               "and its plain version disagree")
        log(f"phase {phase}: {label} K7 over K4's stream arm, {nm} members, "
            f"one group (K=2): launches {got}; every member bit-equal to its "
            f"solo run; {ms7:.3f} ms/group against {nm} x {ms:.3f} solo "
            f"({ms7 / (nm * ms):.3f}x per point); vs plain max|d|="
            f"{err7:.3e}; bound {nm * b7:.4f} ms ({by7}); plain "
            f"{plain7:.3f} ms [{card}]")
        rows.append((f"{label} K7 x{nm} over K4", ms7, plain7, nm * b7, by7,
                     err7, 1, None, "K7/K4"))
        del ctx, ens, solo, stack
        torch.cuda.empty_cache()
    return rows


def phase21b(fac, env, card: str, ptxas: dict, label, st, g, K, n,
             warm: int = 1) -> dict:
    """Phase 21 (b): ``st`` at ``g``⁴ on the stream arm (K4's under forced
    ``-trapezoid`` with ``-skew`` where ``K`` > 1, ``n`` groups; K6's under
    ``-mode fused`` where ``K`` is 1, ``n`` steps) beside its ``-no-skew``
    twin from one seed (:func:`seed_device`), one trial with the counters
    zeroed just before (the expected launches and nothing else), the final
    states bit-equal; one launch of each by CUDA events against the bound,
    the plain version, one launch against it, a profile of the arm's
    launches, the rungs of :data:`S4_SWEEP` (each the arm's bits) and
    ptxas's report.  Returns the ``kernels`` entry."""
    import torch
    from yask_tpu_torch.ops import cuda_emit
    from yask_tpu_torch.ops import fused_stencil as fs
    npts = g ** 4
    trap = K > 1
    steps = n * K
    ctxs, per = {}, {}
    for which, cli in (("arm", "-trapezoid -skew" if trap else ""),
                       ("twin", "-trapezoid" if trap else "-no-skew")):
        torch.cuda.empty_cache()
        ctx = (k4_ctx(fac, env, st, None, 4, (g,) * 4, "fused", K, cli,
                      force=True) if trap else
               a3_ctx(fac, env, st, None, 4, (g,) * 4, "fused", K, cli))
        seed_device(ctx, 11, physical=True)
        ctx.run_solution(0, warm * K - 1)
        t = warm * K
        want = ({"trapezoid_stream": n} if trap and which == "arm" else
                {"trapezoid_phase1": n, "trapezoid_diamond": 2 * n} if trap
                else {"stages_stream": n} if which == "arm"
                else {"stages_step": n})
        ctx.clear_stats()
        got = s4_counts(lambda: ctx.run_solution(t, t + steps - 1), want,
                        f"{label} {g}^4 {which}")
        if not finite(ctx):
            raise RuntimeError(f"phase 21 (b): {label} {which}: not finite")
        per[which] = (npts / ctx.get_stats().get_pts_per_sec() * 1e3, got,
                      ctx.get_stats().get_tiling())
        ctxs[which] = ctx
    _d, nbits = device_diff(ctxs["arm"], ctxs["twin"], exact=True)
    if nbits:
        raise RuntimeError(f"phase 21 (b): {label}: the stream arm and its "
                           f"twin differ in {nbits} cells")
    t = warm * K + steps
    arm, twin = ctxs["arm"], ctxs["twin"]
    if trap:
        kern, tk = arm._trapezoid_kernel(), twin._trapezoid_kernel()

        def launch(k, s):
            return fs.trapezoid_chunk(k, s, t, K)
        plan = kern.spec.stages_stream
    else:
        kern, tk = arm._fused, twin._fused

        def launch(k, s):
            return fs.stages_step(k, s, t)
        plan = kern.spec.stages_stream
    s0, s1 = dict(arm._state), dict(twin._state)
    ms = cuda_ms(lambda: launch(kern, s0), 3)
    twin_ms = cuda_ms(lambda: launch(tk, s1), 2)
    del ctxs["twin"], twin, s1, tk
    torch.cuda.empty_cache()
    prof = profile_launches(lambda: launch(kern, s0), 3,
                            expect=("stream_stages_kernel",))
    plain_ms = cuda_ms(lambda: fs.plain_chunk(kern.program, s0, t, K), 1)
    if trap:
        err, nb, scale = k4_group_vs_plain(kern, s0, t)
        bound_ms, bound_by, nbytes = k4_bound(arm, kern.spec)
    else:
        a = kern.chunk(dict(s0), t, 1)
        b = fs.plain_chunk(kern.program, dict(s0), t, 1)
        err, nb, scale = 0.0, 0, 0.0
        for nme in kern.spec.outputs:
            x, y = a[nme][-1], b[nme][-1]
            err = max(err, float((x - y).abs().max()))
            nb += int((x != y).sum())
            scale = max(scale, float(y.abs().max()))
        del a, b
        bound_ms, bound_by, nbytes = a3_bound(arm)
    if not err <= FIELD_EPS * scale:
        raise RuntimeError(f"phase 21 (b): {label}: the stream arm and its "
                           "plain version disagree")
    rungs = []
    base = launch(kern, dict(s0))
    for rung in S4_SWEEP:
        if trap:
            rs = cuda_emit.resolve_trapezoid(kern.program, K, True, skew=True,
                                             stream_tiles=(rung,))
            rk = fs.TrapezoidKernel(kern.program, rs)
        else:
            rk = stream_kernel(kern.program, False, rung)
            rs = rk.spec
        rk.build()
        rms = cuda_ms(lambda: launch(rk, s0), 2)
        got = launch(rk, dict(s0))
        bad = sum(int((x != y).sum()) for nme in set(kern.spec.outputs)
                  for x, y in zip(got[nme], base[nme]))
        if bad:
            raise RuntimeError(f"phase 21 (b): {label} at rung {rung}: {bad} "
                               "cells differ from the planner's rung")
        rp = rs.stages_stream.record()
        rungs.append({"rung": [*rung[:3], list(rung[3])], "ms": rms,
                      "computed_per_point": rp["computed_per_point"],
                      "smem_bytes": rp["smem_bytes"],
                      "places": [rp["ring_places"],
                                 rp["computed_ring_places"]],
                      "ptxas": ptxas.get(rs.name, "")})
        del rk, got
    del base
    what = "group" if trap else "launch"
    arm_step = per["arm"][0]
    twin_step = per["twin"][0]
    old = {"test_4d": 79.331, "four_d_stages": 73.458}.get(st)
    log(f"phase 21 (b): {label} {g}^4 -mode fused -wf_steps {K}"
        f"{' -trapezoid (forced)' if trap else ''}, the stream arm: one "
        f"trial of {steps} steps: {arm_step:.3f} ms/step, launches "
        f"{per['arm'][1]}, get_tiling() {per['arm'][2].get('name')}; its "
        f"-no-skew twin ({'the two-phase passes' if trap else 'K6 body'}, "
        f"same seed) {twin_step:.3f} ms/step, launches {per['twin'][1]}, "
        f"bit-equal ({nbits} cells differ); one {what} {ms:.3f} ms (CUDA "
        f"events) against the twin's {twin_ms:.3f} ({twin_ms / ms:.2f}x; "
        f"PERF.md's twin rows {old}), bound {bound_ms:.3f} ms ({bound_by}: "
        f"{nbytes / npts:.1f} B/pt), share {bound_ms / ms:.3f}; plain "
        f"{plain_ms:.3f} ms (not a yardstick); one {what} vs plain max|d|="
        f"{err:.3e} ({nb} cells differ in their bits); {s4_plan(plan)}; "
        f"ptxas {ptxas.get(kern.spec.name, 'not built by phase 1')}; "
        f"profile {prof}; rungs {rungs} [{card}]")
    entry = {"name": (f"trapezoid_chunk, K4's 4-D stream arm ({label} "
                      f"{g}^4, K={K})" if trap else
                      f"stages_step, K6's 4-D stream arm ({label} {g}^4)"),
             "route": "cuda", "source": SS_SOURCE,
             "replaces": S4_K4_REPLACES if trap else S4_REPLACES,
             "launches": sum(per["arm"][1].values()), "max_abs_err": err,
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None,
             "per": (f"group of {K} steps (one launch)" if trap
                     else "launch (one sub-step)"),
             "step_ms": arm_step, "twin": ("two-phase K4 (-no-skew)" if trap
                                           else "K6's body (-no-skew)"),
             "twin_ms": twin_ms, "twin_step_ms": twin_step, "rungs": rungs,
             "outer_window": list(plan.outer_tile),
             "idle_share": prof["idle_share"] if prof else None,
             "path": "phase 21 (b)"}
    del ctxs, arm, kern, s0
    torch.cuda.empty_cache()
    return entry


def phase21(fac, env, card: str, ptxas: dict) -> list:
    """The stream arm past three domain dims (see the module docstring).
    Returns the ``kernels`` entries."""
    import torch
    t0 = time.perf_counter()
    rows = phase21a(fac, env, card, ptxas)
    entries = [summed([row for row in rows if row[8] == kind],
                      f"{name} (phase 21 (a), mid width)", rep,
                      "phase 21 (a)") for kind, name, rep in S4_KINDS]
    torch.cuda.empty_cache()
    for label, st, g, K, n in S4_FULL:
        entries.append(phase21b(fac, env, card, ptxas, label, st, g, K, n))
    log(f"phase 21 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 22: K6's stream arm at element size 2 (bfloat16 rings) -------

#: Phase 22 (a): the solutions of the CPU tests in bfloat16 at
#: :data:`SS_MID_SIZES`, solo on K6's stream arm beside its ``-no-skew``
#: twin and as a K7 batch of 3 (:func:`phase17a`): tti r=2 (scratch
#: sub-stages), awp (rewrites), ssg, tti r=8 (staged inputs read from
#: their allocations)
SS22_MID = (("tti", 2, 2), ("awp", None, 2), ("ssg", None, 2),
            ("tti", 8, 2))
#: the RTM chains in bfloat16: the image pushed and ``-push off``
SS22_RTM = (("pure, image pushed", 2, False, "", SS_MID_SIZES),
            ("pure, -push off", 2, False, "-push off", SS_MID_SIZES))
#: K5 over the arm on 2x2 shards (:data:`K5_CASES`' shape)
K5SS22_MID = (("tti r=2 bf16 K=2", "tti", 2, 2, (64, 64, 64), 2, X2Y2, ""),
              ("awp bf16", "awp", None, 2, (64, 64, 64), 1, X2Y2, ""))
#: K4's stream arm, one group of K = 2 (:data:`K4S_MID`'s shape)
K4S22_MID = (("iso3dfd r=2 bf16", "iso3dfd", 2, 2, (64, 64, 64)),
             ("tti r=2 bf16", "tti", 2, 2, (64, 64, 64)))
#: past three dims: K6's 4-D arm and K4's (:data:`S4_MID`'s shapes)
S422_MID = (("four_d_stages bf16", "four_d_stages", (21, 40, 36, 70)),)
S422_K4_MID = (("test_4d bf16", "test_4d", (21, 40, 36, 70)),)
#: Phase 22 (c): K4's stream arm at full width (label, stencil, radius,
#: edge, K): phase 14 (b)'s bfloat16 cell
K4S22_FULL = ("iso3dfd r=2 bf16", "iso3dfd", 2, 512, 4)
SS22_REPLACES = ("yask_tpu/ops/pallas_stencil.py:2058-2188 (the stage "
                 "loop) with its VMEM tiles in the program dtype "
                 ":2264-2289, under the prefetch :1815-1854 and the carry "
                 ":1955-2056")


def s22_specs(fac, env) -> dict:
    """Phase 22's sources, for phase 1's parallel build: each bfloat16 K6
    solution's (its body and stream arm in one source), the RTM chains'
    (and their K7 batches'), K5's over the shards, K4's stream arm and
    its two-phase twin per case, at full width and past three dims, and
    K1's stream arm beside (c)."""
    from yask_tpu_torch.compiler.lowering import BFLOAT16
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    # at element size 2 a source follows the parity of the minor extent
    # (the context pads it to even): each is emitted at its run's sizes
    out = {}
    for st, r, eb in SS22_MID:
        ctx = a3_ctx(fac, env, st, r, eb, SS_MID_SIZES, "fused")
        out[f"{st} r={r} bf16 (phase 22)"] = FusedKernel(ctx._program).spec
    for label, r, acc, cli, g in SS22_RTM:
        for gg in (g, (16, 16, 16)):
            pipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True,
                            gg, r, acc, BFLOAT16)
            out[f"rtm r={r} {label} bf16 {gg}"] = \
                pipe.fused_ctx._fused_spec_kernel().spec
            out[f"rtm r={r} {label} bf16 {gg} (K7)"] = \
                pipe.fused_ctx._batched_kernel().spec
            pipe.end()
    for label, st, r, eb, sizes, K, ranks, cli in K5SS22_MID:
        small = tuple(max(16, 2 * 8 * K) for _ in sizes)
        ctx = k5_ctx(fac, st, r, eb, small, K, ranks, cli)
        out[f"K5 {label}"] = shard_pallas_plan(ctx).kernel.spec
    flabel, fst, fr, g, fK = K4S22_FULL
    for label, st, r, eb, sizes, K in (
            [c + (2,) for c in K4S22_MID]
            + [(flabel, fst, fr, 2, (g, g, g), fK)]
            + [(lab, s_, None, 2, sz, 2) for lab, s_, sz in S422_K4_MID]):
        for arm, cli in (("stream", "-trapezoid -skew"),
                         ("two-phase", "-trapezoid")):
            ctx = k4_ctx(fac, env, st, r, eb, sizes, "fused", K, cli,
                         force=True)
            out[f"K4 {arm} {label} {'x'.join(map(str, sizes))} K={K}"] = \
                ctx._trapezoid_kernel().spec
            del ctx
    ctx = k4_ctx(fac, env, fst, fr, 2, (g, g, g), "fused", fK,
                 "-no-trapezoid -skew")
    out[f"K1 {flabel} {g}^3"] = FusedKernel(ctx._program).spec
    del ctx
    for label, st, sizes in S422_MID:
        ctx = a3_ctx(fac, env, st, None, 2, sizes, "fused")
        out[f"K6 4-D {label}"] = FusedKernel(ctx._program).spec
    return out


def phase22(fac, env, card: str, ptxas: dict, twins: dict,
            full: int = 512) -> list:
    """K6's stream arm at element size 2 (see the module docstring): (a)
    at mid width the bfloat16 solutions of the CPU tests solo and as K7
    x3 (:func:`phase17a`, the RTM chains included), K5 over the arm on
    2x2 shards (:func:`phase13a`), K4's stream arm at K = 2
    (:func:`phase20a`) and the 4-D arms (:func:`phase21a`), each beside
    its ``-no-skew`` twin from one seed, bit-equal; (b) tti r=2 and the
    RTM chain (image pushed) at ``full``³ from the seeds and steps of
    their ``-no-skew`` twins (``twins``: phase 11 (c)'s and phase 12
    (d)'s rows on K6's body, with their final states' digests), the final
    states bit-equal, ptxas's report and a profile window of each; (c)
    iso3dfd r=2 at ``full``³ K = 4 on K4's stream arm beside its
    two-phase twin and K1's stream arm (:func:`phase20b`).  Returns the
    ``kernels`` entries."""
    import torch
    from yask_tpu_torch.compiler.lowering import BFLOAT16
    t0 = time.perf_counter()
    what = "K6 stream arm, element size 2"
    entries = phase17a(fac, env, card, cases=SS22_MID, rtm=SS22_RTM,
                       rtm_dtype=BFLOAT16, phase="22 (a)", what=what)
    entries[0].update(replaces=SS22_REPLACES)
    torch.cuda.empty_cache()
    rows = phase13a(fac, card, cases=K5SS22_MID, stream=True,
                    phase="22 (a)")
    entries.append(summed(
        rows, "shard_step (K5 over K6's stream arm, element size 2, phase "
        "22 (a): 2x2 shards at mid width)", K5SS_REPLACES, "phase 22 (a)",
        **K5_COLUMNS))
    torch.cuda.empty_cache()
    rows = phase20a(fac, env, card, ptxas, cases=K4S22_MID, rtm=0,
                    phase="22 (a)")
    entries.append(summed(
        rows, "trapezoid_chunk (K4's stream arm, element size 2, phase 22 "
        "(a): one group of K=2 each)", K4S_REPLACES, "phase 22 (a)"))
    torch.cuda.empty_cache()
    rows = phase21a(fac, env, card, ptxas, mid=S422_MID,
                    k4_mid=S422_K4_MID, eb=2, phase="22 (a)")
    entries += [summed([row for row in rows if row[8] == kind],
                       f"{name} (element size 2, phase 22 (a))", rep,
                       "phase 22 (a)") for kind, name, rep in S4_KINDS]
    log(f"phase 22 (a) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (b) tti r=2 and the RTM chain at full width, beside their twins
    probe = a3_ctx(fac, env, "tti", 2, 2, (16, 16, 16), "fused")
    tti_name = probe._fused_spec_kernel().spec.name
    del probe
    e = family_full(fac, env, card, "tti", 2, what, full, eb=2, sweep=False,
                    digest=True, profile=True)
    digest, prof = e.pop("state_digest"), e.pop("profile")
    twin = twins["tti"]
    same = digest == twin["state_digest"]
    log(f"phase 22 (b): tti r=2 {full}^3 bf16: the stream arm "
        f"{e['ms']:.3f} ms/launch, {e['step_ms']:.3f} ms/step, share "
        f"{e['bound_ms'] / e['ms']:.3f} of {e['bound_ms']:.3f} ms; its "
        f"-no-skew twin (phase 11 (c), K6's body, the same seed and steps) "
        f"{twin['ms']:.3f} ms/launch, {twin['step_ms']:.3f} ms/step: "
        f"{twin['ms'] / e['ms']:.2f}x per launch; final states bit-equal: "
        f"{same}; ptxas {ptxas.get(tti_name, 'not built by phase 1')}; 3 "
        f"launches of each from one state under torch.profiler: "
        f"{json.dumps(prof)} [{card}]")
    if not same:
        raise RuntimeError(f"phase 22 (b): tti r=2 bf16 at {full}^3: the "
                           "stream arm and its -no-skew twin end in other "
                           "states")
    e.update(name=f"stages_step ({what}: tti r=2 {full}^3 bf16)",
             replaces=SS22_REPLACES, path="phase 22 (b)",
             body_ms=twin["ms"], body_step_ms=twin["step_ms"],
             profile=prof, ptxas=ptxas.get(tti_name))
    entries.append(e)
    torch.cuda.empty_cache()
    pipe = rtm_pipe(env, "-mode fused -wf_steps 1", True, (16, 16, 16),
                    dtype=BFLOAT16)
    rtm_name = pipe.fused_ctx._fused_spec_kernel().spec.name
    pipe.end()
    e = rtm_full(env, full, "push, the stream arm", "", {"img__img"},
                 dtype=BFLOAT16, phase="22 (b)", digest=True, profile=True)
    twin = twins["rtm"]
    same = e.pop("state_digest") == twin["state_digest"]
    log(f"phase 22 (b): rtm chain r=2 pure {full}^3 bf16, image pushed: "
        f"the stream arm {e['ms']:.3f} ms/launch, {e['step_ms']:.3f} "
        f"ms/step, share {e['bound_ms'] / e['ms']:.3f} of "
        f"{e['bound_ms']:.3f} ms; its -no-skew twin (phase 12 (d), K6's "
        f"body) {twin['ms']:.3f} ms/launch, {twin['step_ms']:.3f} ms/step: "
        f"{twin['ms'] / e['ms']:.2f}x per launch; final states bit-equal: "
        f"{same}; ptxas {ptxas.get(rtm_name, 'not built by phase 1')} "
        f"[{card}]")
    if not same:
        raise RuntimeError(f"phase 22 (b): the bf16 rtm chain at {full}^3: "
                           "the stream arm and its -no-skew twin end in "
                           "other states")
    e.update(name=f"stages_step ({what}, the push arm: rtm chain r=2 "
                  f"{full}^3 bf16)",
             replaces="yask_tpu/ops/pallas_stencil.py:2312 (push= arm, "
                      "VMEM tiles in the program dtype :2264-2289) under "
                      "the prefetch :1815-1854 and the carry :1955-2056",
             path="phase 22 (b)", body_ms=twin["ms"],
             body_step_ms=twin["step_ms"], ptxas=ptxas.get(rtm_name))
    entries.append(e)
    torch.cuda.empty_cache()

    # (c) K4's stream arm at full width in bfloat16
    label, st, r, _g, K = K4S22_FULL
    e = phase20b(fac, env, card, ptxas, label, st, r, full, K, eb=2,
                 phase="22 (c)")
    e.update(name=f"trapezoid_chunk, K4's stream arm, element size 2 "
                  f"({label} {full}^3, K={K})")
    entries.append(e)
    log(f"phase 22 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 23: K7 and K5 over K1's stream arm ---------------------------

#: Phase 23 (a): K5 over the arm at mid width, phase 8 (a)'s iso3dfd r=8
#: cases (96³ on 2x2 shards, K=1 and K=2 with the overlap off, on and on
#: with the packed exchange) in phase 13 (a)'s shape
K1S_K5_MID = tuple((label, st, r, 4, (g,) * 3, K, ranks, cli)
                   for label, st, r, g, ranks, K, cli in SHARD_CASES
                   if st == "iso3dfd")
#: and K7 x3 over it: (label, radius, element bytes, sizes), slot 0 and
#: slot 1 ragged against the plane tiles
K1S_K7_MID = (("iso3dfd r=2 fp32", 2, 4, (67, 45, 130)),
              ("iso3dfd r=8 fp32", 8, 4, (67, 45, 130)),
              ("iso3dfd r=2 bf16", 2, 2, (67, 45, 130)),
              ("iso3dfd r=8 bf16", 8, 2, (67, 45, 130)))
#: Phase 23 (b): K5 at full width (phase 8 (b)'s fp32 cell, phase 13
#: (b)'s bf16 one): (label, stencil, radius, element bytes, edge, K)
K1S_K5_FULL = (("iso3dfd r=8 fp32", "iso3dfd", 8, 4, 512, 2),
               ("iso3dfd r=8 bf16", "iso3dfd", 8, 2, 512, 2))
#: and K7 (phase 5's 8 x 256³ in fp32, phase 12 (b)'s bf16 cell), as
#: :data:`K7_FULL` lists its cells
K1S_K7_FULL = (("element size 4", "iso3dfd", 8, 4, 8, (256,) * 3,
                "batched_step", "iso3dfd"),
               ("element size 2", "iso3dfd", 8, 2, 8, (256,) * 3,
                "batched_step", "iso3dfd bf16"))


def k1s_specs(fac, env) -> dict:
    """Phase 23's sources not built for an earlier phase, for phase 1's
    parallel build: (a)'s K7 cells at their sizes (at element size 2 a
    source may follow its minor extent's parity)."""
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    out = {}
    for label, r, eb, sizes in K1S_K7_MID:
        ctx = a3_ctx(fac, env, "iso3dfd", r, eb, sizes, "fused")
        out[f"{label} (phase 23)"] = FusedKernel(ctx._program).spec
        del ctx
    return out


def phase23a_k7(fac, env, card: str, cases=K1S_K7_MID, nm: int = 3,
                steps: int = 5, st: str = "iso3dfd",
                phase: str = "23 (a)") -> list:
    """Phase 23 (a)'s member batches (phase 24 (a)'s of test_4d, ``st``):
    each case as K7 x ``nm`` over K1's
    stream arm (``-skew``, the default) and its ``-no-skew`` twin (K7 over
    K1's body) from one seed, ``steps`` steps at K = 2 with the counters
    zeroed just before (the arm alone launches), every member bit-equal
    to the twin's, one 2-step chunk held to ``plain_batched_chunk`` on the
    card, one launch of each timed.  Returns rows for :func:`summed`
    (label, ms, plain ms, bound, bound_by, max |d|, launches, twin ms)."""
    from yask_tpu_torch.ops import fused_stencil as fs
    rows = []
    for label, r, eb, sizes in cases:
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        ctx, ens = member_batch(fac, env, st, r, eb, sizes, nm,
                                lambda c, i: seed_case(c, 100 + i))
        twin, tens = member_batch(fac, env, st, r, eb, sizes, nm,
                                  lambda c, i: seed_case(c, 100 + i),
                                  cli="-no-skew")
        zero_launch_counts()
        ens.run(0, steps - 1)
        got = {k: v for k, v in launch_counts().items() if v}
        tens.run(0, steps - 1)
        til = ens.tiling
        if got != {"batched_step_stream": steps} or not til["skew"] \
                or not til["name"].endswith("_stream_batched"):
            raise RuntimeError(f"phase {phase}: K7 {label}: launches {got}, "
                               f"tiling {til['name']} {til['skew_reasons']}")
        nbad = 0
        for i in range(nm):
            with ens.member(i) as c, tens.member(i) as c2:
                nbad += device_diff(c, c2, exact=True)[1]
                ok = finite(c)
            if not ok:
                raise RuntimeError(f"phase {phase}: K7 {label}: member {i} is "
                                   "not finite")
        err, nbits, scale = k7_chunk_vs_plain(ctx, ens, steps, 2)
        state = ens._stack_states()
        kern, tkern = ctx._batched_kernel(), twin._batched_kernel()
        ms = cuda_ms(lambda: fs.batched_step(kern, state, steps, nm), 5)
        twin_ms = cuda_ms(lambda: fs.batched_step(tkern, state, steps, nm),
                          5)
        plain_ms = cuda_ms(lambda: fs.plain_batched_chunk(
            ctx._program, state, steps, 1, nm), 2)
        del state
        bound_ms, bound_by, _nb = k7_bound(ctx, nm)
        seg = kern.batch_segment(nm)
        log(f"phase {phase}: K7 over K1's stream arm, {label}, {nm} x "
            f"{'x'.join(map(str, sizes))} K=2 {steps} steps: launches {got} "
            f"({til['name']}, {seg['segments']} segment(s) of "
            f"{seg['segment_planes']} planes); vs the -no-skew twin (K7 over "
            f"K1's body, the same seeds) {nbad} cells differ (epsilon 0); "
            f"one 2-step chunk vs plain (plain_batched_chunk on the card) "
            f"max|d|={err:.3e} (field max {scale:.3e}), {nbits} cells "
            f"differ in their bits; {ms:.4f} ms/launch, the twin's "
            f"{twin_ms:.4f}, bound {bound_ms:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.3f} ms [{card}]")
        if nbad or not err <= eps * scale:
            raise RuntimeError(f"phase {phase}: K7 {label}: {nbad} cells "
                               "differ from the twin, or the batch and its "
                               "plain version disagree")
        rows.append((label, ms, plain_ms, bound_ms, bound_by, err,
                     got["batched_step_stream"], twin_ms))
        del ctx, ens, twin, tens, kern, tkern
        release()
    return rows


def phase23(fac, env, card: str, ptxas: dict, twins: dict) -> list:
    """K7 and K5 over K1's stream arm (see the module docstring): (a) at
    mid width :data:`K1S_K5_MID` through :func:`phase13a` with ``stream``
    and :data:`K1S_K7_MID` through :func:`phase23a_k7`, each beside its
    ``-no-skew`` twin from one seed, bit-equal; (b) at full width
    :data:`K1S_K5_FULL` through :func:`phase13b` and :data:`K1S_K7_FULL`
    through :func:`phase12b`, each from the seed and steps of its
    ``-no-skew`` twin, the final states bit-equal: the fp32 twins run
    here, the bf16 ones are phase 13 (b)'s and phase 12 (b)'s (``twins``:
    ``"k5 bf16"`` and ``"k7 bf16"``, with their digests; ``"solo"``: the
    solo rows phase 12 (b) puts beside a batch).  Returns the ``kernels``
    entries."""
    import torch
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    t0 = time.perf_counter()
    entries = []
    rows = phase13a(fac, card, cases=K1S_K5_MID, stream=True,
                    phase="23 (a)")
    entries.append(summed(
        rows, "shard_step (K5 over K1's stream arm, phase 23 (a): iso3dfd "
        "r=8 96^3 on 2x2 shards, K=1 and K=2 with the overlap off, on and "
        "on with the packed exchange, one launch each over shard 0's "
        "sub-step-0 box)", K1S_K5_REPLACES, "phase 23 (a)",
        source=K1S_SOURCE, **K5_COLUMNS))
    torch.cuda.empty_cache()
    rows = phase23a_k7(fac, env, card)
    entries.append(summed(
        rows, "batched_step (K7 over K1's stream arm, phase 23 (a): 3 "
        "members of iso3dfd r=2 and r=8, fp32 and bf16, at 67x45x130)",
        K1S_K7_REPLACES, "phase 23 (a)", source=K1S_SOURCE))
    log(f"phase 23 (a) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (b) K5 at full width beside its -no-skew twin
    for label, st, r, eb, g, K in K1S_K5_FULL:
        if eb == 2:
            twin = twins["k5 bf16"]
        else:
            twin = phase13b(fac, card, label, st, r, eb, g, K,
                            phase="23 (b)")
            twin = {"state_digest": twin["state_digest"], "ms": twin["ms"],
                    "step_ms": twin["step_ms"], "box_ms": twin["box_ms"],
                    "what": f"its -no-skew twin ({label} {g}^3 on K5's "
                            "body, phase 23 (b))"}
            torch.cuda.empty_cache()
        e = phase13b(fac, card, label, st, r, eb, g, K, stream=True,
                     twin=twin, phase="23 (b)", profile=True)
        e.pop("state_digest")
        name = shard_pallas_plan(k5_ctx(fac, st, r, eb, (64, 64, 64), K,
                                        X2Y2)).kernel.spec.name
        log(f"phase 23 (b): {label} {g}^3 on 2x2 shards: K5 over K1's "
            f"stream arm {', '.join(f'{m:.3f}' for m in e['box_ms'])} ms "
            f"per launch over the grown and the interior box (segments "
            f"{[b['segment_planes'] for b in e['box_segments']]}), "
            f"{e['step_ms']:.3f} ms/step, share {e['bound_ms'] / e['ms']:.3f}"
            f" of {e['bound_ms']:.4f} ms; its -no-skew twin (K5 over K1's "
            f"body) {', '.join(f'{m:.3f}' for m in twin['box_ms'])} ms per "
            f"launch, {twin['step_ms']:.3f} ms/step: "
            f"{twin['ms'] / e['ms']:.2f}x per launch; final shards bit-equal;"
            f" ptxas ({name}): {ptxas.get(name, 'not built by phase 1')} "
            f"[{card}]")
        e.update(name=f"shard_step (K5 over K1's stream arm: {label} "
                      f"{g}^3 on 2x2 shards, K={K})",
                 replaces=K1S_K5_REPLACES, path="phase 23 (b)",
                 body_ms=twin["ms"], body_step_ms=twin["step_ms"],
                 ptxas=ptxas.get(name))
        entries.append(e)
        torch.cuda.empty_cache()

    # (b) K7 at full width beside its -no-skew twin
    for cell in K1S_K7_FULL:
        eb = cell[3]
        if eb == 2:
            twin = twins["k7 bf16"]
        else:
            twin = phase12b(fac, env, card, twins["solo"], cells=(cell,),
                            cli="-no-skew", phase="23 (b)", digest=True)[0]
            torch.cuda.empty_cache()
        e = phase12b(fac, env, card, twins["solo"], cells=(cell,), cli="",
                     phase="23 (b)", digest=True, profile=True)[0]
        same = e.pop("state_digest") == twin["state_digest"]
        name = FusedKernel(a3_ctx(fac, env, "iso3dfd", 8, eb, (16, 16, 16),
                                  "fused")._program).spec.name
        nm, shape = cell[4], "x".join(map(str, cell[5]))
        log(f"phase 23 (b): iso3dfd r=8 {eb} B, {nm} x {shape}: K7 over K1's "
            f"stream arm {e['ms']:.3f} ms/launch, {e['step_ms']:.3f} "
            f"ms/step, share {e['bound_ms'] / e['ms']:.3f} of "
            f"{e['bound_ms']:.3f} ms; its -no-skew twin (K7 over K1's body, "
            f"the same seeds and steps) {twin['ms']:.3f} ms/launch, "
            f"{twin['step_ms']:.3f} ms/step: {twin['ms'] / e['ms']:.2f}x "
            f"per launch; final states bit-equal: {same}; ptxas ({name}): "
            f"{ptxas.get(name, 'not built by phase 1')} [{card}]")
        if not same:
            raise RuntimeError(f"phase 23 (b): K7 iso3dfd r=8 {eb} B: the "
                               "stream arm and its -no-skew twin end in "
                               "other states")
        e.update(name=f"batched_step (K7 over K1's stream arm: {nm} x "
                      f"iso3dfd r=8 {shape}, {eb} B)",
                 replaces=K1S_K7_REPLACES, path="phase 23 (b)",
                 body_ms=twin["ms"], body_step_ms=twin["step_ms"],
                 ptxas=ptxas.get(name))
        entries.append(e)
        torch.cuda.empty_cache()
    log(f"phase 23 took {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 24: K1's stream arm past three domain dims --------------------

#: Phase 24 (a): test_4d at mid width, (label, element bytes, sizes w, x,
#: y, z): 5 outer cells, slot 0 and both plane slots ragged against the
#: 16x64 plane tile, solo and as K7 x3
S24_MID = (("test_4d fp32", 4, (5, 67, 45, 130)),
           ("test_4d bf16", 2, (5, 67, 45, 130)))
#: Phase 24 (b): test_4d at 128⁴ solo, fp32 (phase 11 (c)'s run, its
#: -no-skew twin) and bf16 (one trial of 10 steps, its twin run here),
#: and K7 over 8 x 64⁴ fp32 (phase 12 (b)'s 4-D cell, its twin)
S24_FULL = 128
S24_K7 = next(c for c in K7_FULL if c[1] == "test_4d")
#: the plane tiles of tile_planner.STREAM_TILES the 128⁴ fp32 run is also
#: timed at (each the same bits; the plan takes 16x32 by 3 blocks an SM,
#: 40 registers a thread), a third entry the least registers a thread
#: keeps in place of tile_planner.STREAM_OUTER_MIN_REGS: 16x64 by two
#: blocks at 32 registers (the 3-D arm's rule), by one at 64, and 8x64 by
#: three at 40; few, as each is a source phase 1 builds
S24_SWEEP = ((16, 64, 32), (16, 64), (8, 64))
#: what the arm replaces: the reference's grid over every lead dim under
#: K2's prefetch and K3's slot-0 carry (and its vmap, K7)
S24_REPLACES = ("yask_tpu/ops/pallas_stencil.py:1442 (the grid over every "
                "lead dim; test_4d in tests/test_pallas.py:135) with the "
                "skewed carry :306-441, :1955-2056 and the prefetch "
                ":1668-1854")
S24_K7_REPLACES = K1S_K7_REPLACES + " (over every lead dim :1442)"


def k1_stream_kernel(program, rung):
    """K1's stream arm for ``program`` at plane tile ``rung`` (T1, T2) in
    place of ``tile_planner.STREAM_TILES`` (and, with a third entry, that
    many registers a thread at least in place of
    ``tile_planner.STREAM_OUTER_MIN_REGS``: the blocks per SM follow),
    emitted at the program's size (the segment length follows it)."""
    from yask_tpu_torch.ops import cuda_emit, tile_planner
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    kern = FusedKernel(program)
    orig = tile_planner.STREAM_TILES, tile_planner.STREAM_OUTER_MIN_REGS
    tile_planner.STREAM_TILES = (tuple(rung[:2]),)
    tile_planner.STREAM_OUTER_MIN_REGS = (rung[2] if len(rung) > 2
                                          else orig[1])
    try:
        kern.spec = cuda_emit.emit(program)
    finally:
        tile_planner.STREAM_TILES, tile_planner.STREAM_OUTER_MIN_REGS = orig
    kern.skew_dims = cuda_emit.skew_engaged_dims(program, None, 2, [],
                                                 kern.spec)
    return kern


def s24_specs(fac, env) -> dict:
    """Phase 24's sources, for phase 1's parallel build: test_4d at each
    element size at the phase's sizes (at element size 2 a source follows
    its minor extent's parity), and the 128⁴ fp32 source at each rung of
    :data:`S24_SWEEP`."""
    from yask_tpu_torch.ops.fused_stencil import FusedKernel
    out = {}
    for label, eb, sizes in S24_MID:
        ctx = a3_ctx(fac, env, "test_4d", None, eb, sizes, "torch")
        out[f"{label} (phase 24)"] = FusedKernel(ctx._program).spec
    ctx = a3_ctx(fac, env, "test_4d", None, 4, (S24_FULL,) * 4, "torch")
    for rung in S24_SWEEP:
        out[f"test_4d at {rung} (phase 24)"] = k1_stream_kernel(
            ctx._program, rung).spec
    del ctx
    return out


def phase24a(fac, env, card: str, cases=S24_MID, steps: int = 5) -> list:
    """Phase 24 (a): each case on K1's stream arm (``-skew``, the
    default) beside its ``-no-skew`` twin (K1's body) and its plain
    version (``-mode torch``) from one seed, ``steps`` steps at K = 2 with
    the counters zeroed just before (the arm alone launches): bit-equal
    to the twin, held to the plain version, one launch of each timed.
    Returns rows for :func:`summed` (label, ms, plain ms, bound, bound_by,
    max |d|, launches, twin ms)."""
    from yask_tpu_torch.ops import fused_stencil as fs
    rows = []
    for label, eb, sizes in cases:
        eps = BF16_FIELD_EPS if eb == 2 else FIELD_EPS
        ctxs = {"arm": a3_ctx(fac, env, "test_4d", None, eb, sizes, "fused",
                              2),
                "twin": a3_ctx(fac, env, "test_4d", None, eb, sizes,
                               "fused", 2, "-no-skew"),
                "plain": a3_ctx(fac, env, "test_4d", None, eb, sizes,
                                "torch", 2)}
        for c in ctxs.values():
            seed_case(c, 7)
        got = {}
        for key, want in (("arm", "stream_step"), ("twin", "fused_step")):
            zero_launch_counts()
            ctxs[key].run_solution(0, steps - 1)
            got[key] = {k: v for k, v in launch_counts().items() if v}
            if got[key] != {want: steps}:
                raise RuntimeError(f"phase 24 (a): {label} {key}: launches "
                                   f"{got[key]}, expected {steps} of {want}")
        ctxs["plain"].run_solution(0, steps - 1)
        til = ctxs["arm"].get_stats().get_tiling()
        if not til["name"].endswith("_stream") or not til["skew"]:
            raise RuntimeError(f"phase 24 (a): {label} ran {til['name']}")
        _d, twin_bits = device_diff(ctxs["arm"], ctxs["twin"], exact=True)
        d = max_abs_diff(ctxs["arm"], ctxs["plain"])
        bad = ctxs["arm"].compare_data(ctxs["plain"], field_epsilon=eps)
        if twin_bits or bad or not finite(ctxs["arm"]):
            raise RuntimeError(f"phase 24 (a): {label}: the stream arm "
                               f"differs from its twin in {twin_bits} cells "
                               f"or from its plain version ({bad} "
                               "mismatches)")
        kern, tk = ctxs["arm"]._fused, ctxs["twin"]._fused
        s0 = dict(ctxs["arm"]._state)
        ms = cuda_ms(lambda: fs.stream_step(kern, s0, steps), 5)
        twin_ms = cuda_ms(lambda: fs.fused_step(tk, s0, steps), 5)
        plain_ms = cuda_ms(lambda: fs.plain_chunk(kern.program, s0, steps,
                                                  1), 2)
        bound_ms, bound_by, _nb = a3_bound(ctxs["arm"])
        log(f"phase 24 (a): {label} {'x'.join(map(str, sizes))} K1's 4-D "
            f"stream arm, K=2 {steps} steps: launches {got['arm']} "
            f"({til['name']}, {til['stream']['outer_cells']} outer cells, "
            f"{til['stream']['segments']} segment(s) of "
            f"{til['stream']['segment_planes']} planes); bit-equal to its "
            f"-no-skew twin (K1's body; {twin_bits} cells differ); vs plain "
            f"max|d|={d:.3e} mismatches={bad} (field_epsilon={eps}); "
            f"{ms:.4f} ms/launch against the twin's {twin_ms:.4f} "
            f"({twin_ms / ms:.2f}x), bound {bound_ms:.4f} ms ({bound_by}), "
            f"plain {plain_ms:.3f} ms [{card}]")
        rows.append((label, ms, plain_ms, bound_ms, bound_by, d, steps,
                     twin_ms))
        del ctxs, kern, tk, s0
        release()
    return rows


def phase24b_solo(fac, env, card: str, ptxas: dict, eb: int, twin: dict,
                  trials: int, steps: int, sweep=()) -> dict:
    """Phase 24 (b)'s solo run: test_4d at :data:`S24_FULL`⁴ and element
    size ``eb`` on K1's stream arm through :func:`a3_full` (its seed,
    ``trials`` x ``steps`` steps), its final state's digest held to its
    ``-no-skew`` twin's (``twin``: its ``state_digest``, ``ms`` and
    ``step_ms``), ptxas's report, 3 launches of the arm and 3 of the
    twin's body under ``torch.profiler``, and the arm at the plane tiles
    of ``sweep`` (each the same bits as the planned one).  Returns the
    ``kernels`` entry."""
    from yask_tpu_torch.ops import fused_stencil as fs
    g = S24_FULL
    label = (f"K1's 4-D stream arm: test_4d {g}^4 "
             f"{'bf16' if eb == 2 else 'fp32'}")
    e = a3_full(fac, env, card, "test_4d", None, eb, (g,) * 4, "stream_step",
                label, trials=trials, steps=steps)
    ctx = e.pop("ctx")
    same = state_digest(ctx) == twin["state_digest"]
    kern = ctx._fused
    til = ctx.get_stats().get_tiling()
    t = 2 + trials * steps   # a3_full's warm-up and trials
    s0 = dict(ctx._state)
    body = fs.FusedKernel(ctx._program)
    body.build()
    prof = profile_launches(lambda: fs.stream_step(kern, s0, t), 3,
                            expect=("stream_step_kernel",))
    prof_twin = profile_launches(lambda: fs.fused_step(body, s0, t), 3,
                                 expect=("fused_step_kernel",))
    rungs = []
    if sweep:
        ref = fs.stream_step(kern, dict(s0), t)
        out = kern.spec.outputs[0]
        for rung in sweep:
            rk = k1_stream_kernel(ctx._program, rung)
            rk.build()
            got = fs.stream_step(rk, dict(s0), t)
            nbits = int((got[out][-1] != ref[out][-1]).sum())
            rms = cuda_ms(lambda: fs.stream_step(rk, s0, t), 5)
            rec = rk.spec.stream.record()
            rungs.append({"plane_tile": list(rung[:2]), "ms": rms,
                          "segment_planes": rec["segment_planes"],
                          "blocks_per_sm": rec["blocks_per_sm"],
                          "staged_per_point": rec["staged_per_point"],
                          "smem_bytes": rec["smem_bytes"],
                          "ptxas": ptxas.get(rk.spec.name),
                          "bits_differ": nbits})
            del got, rk
            if nbits:
                raise RuntimeError(f"phase 24 (b): test_4d at {rung}: "
                                   f"{nbits} cells differ from the planned "
                                   "rung")
        del ref
    name = kern.spec.name
    log(f"phase 24 (b): {label}: {e['ms']:.3f} ms/launch, "
        f"{e['step_ms']:.3f} ms/step, share {e['bound_ms'] / e['ms']:.3f} of "
        f"{e['bound_ms']:.4f} ms; its -no-skew twin (K1's body, the same seed and steps) "
        f"{twin['ms']:.3f} ms/launch, {twin['step_ms']:.3f} ms/step: "
        f"{twin['ms'] / e['ms']:.2f}x per launch; final states bit-equal: "
        f"{same}; plan {til['stream']}; profile (arm) {prof}; profile "
        f"(twin) {prof_twin}; rungs {rungs}; ptxas ({name}): "
        f"{ptxas.get(name, 'not built by phase 1')} [{card}]")
    if not same:
        raise RuntimeError(f"phase 24 (b): {label}: the stream arm and its "
                           "-no-skew twin end in other states")
    e.update(name=f"stream_step ({label})", source=K1S_SOURCE,
             replaces=S24_REPLACES, path="phase 24 (b)",
             body_ms=twin["ms"], body_step_ms=twin["step_ms"],
             ptxas=ptxas.get(name), profile=prof, twin_profile=prof_twin,
             plan=til["stream"], **({"sweep": rungs} if sweep else {}))
    del ctx, kern, body, s0
    release()
    return e


def phase24(fac, env, card: str, ptxas: dict, twins: dict) -> list:
    """K1's stream arm past three domain dims (see the module docstring):
    (a) :data:`S24_MID` solo through :func:`phase24a` and as K7 x3
    through :func:`phase23a_k7`, each beside its ``-no-skew`` twin from
    one seed, bit-equal; (b) test_4d at :data:`S24_FULL`⁴ solo in fp32
    (``twins["solo"]``: phase 11 (c)'s run, with its digest) and bf16 (its
    twin run here) and :data:`S24_K7` through :func:`phase12b` (its twin
    ``twins["k7"]``, phase 12 (b)'s 4-D cell), each from its twin's seed
    and steps, the final states bit-equal.  Returns the ``kernels``
    entries."""
    import torch
    t0 = time.perf_counter()
    entries = []
    rows = phase24a(fac, env, card)
    mid = "x".join(map(str, S24_MID[0][2]))
    entries.append(summed(
        rows, "stream_step (K1's stream arm past three domain dims, phase "
        f"24 (a): test_4d fp32 and bf16 at {mid})", S24_REPLACES,
        "phase 24 (a)", source=K1S_SOURCE))
    rows = phase23a_k7(fac, env, card,
                       cases=tuple((label, None, eb, sizes)
                                   for label, eb, sizes in S24_MID),
                       st="test_4d", phase="24 (a)")
    entries.append(summed(
        rows, "batched_step (K7 over K1's 4-D stream arm, phase 24 (a): 3 "
        f"members of test_4d fp32 and bf16 at {mid})",
        S24_K7_REPLACES, "phase 24 (a)", source=K1S_SOURCE))
    log(f"phase 24 (a) took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (b) solo at full width, fp32 beside phase 11 (c)'s twin
    entries.append(phase24b_solo(fac, env, card, ptxas, 4, twins["solo"],
                                 3, 20, sweep=S24_SWEEP))
    # bf16: its -no-skew twin here, one trial of 10 steps
    g = S24_FULL
    tw = a3_full(fac, env, card, "test_4d", None, 2, (g,) * 4, "fused_step",
                 f"K1's body: test_4d {g}^4 bf16 (-no-skew, phase 24 (b)'s "
                 "twin)", trials=1, steps=10, cli="-no-skew")
    tw["state_digest"] = state_digest(tw.pop("ctx"))
    release()
    entries.append(phase24b_solo(fac, env, card, ptxas, 2, tw, 1, 10))
    # K7 over the arm beside phase 12 (b)'s 4-D cell
    twin = twins["k7"]
    e = phase12b(fac, env, card, {"test_4d": entries[2] | {
        "label": "phase 24 (b), K1's 4-D stream arm, 128^4",
        "points": g ** 4}}, cells=(S24_K7,), cli="", phase="24 (b)",
        digest=True, profile=True)[0]
    same = e.pop("state_digest") == twin["state_digest"]
    nm, shape = S24_K7[4], "x".join(map(str, S24_K7[5]))
    log(f"phase 24 (b): test_4d fp32, {nm} x {shape}: K7 over K1's 4-D "
        f"stream arm {e['ms']:.3f} ms/launch, {e['step_ms']:.3f} ms/step, "
        f"share {e['bound_ms'] / e['ms']:.3f} of {e['bound_ms']:.4f} ms; its "
        f"-no-skew twin (K7 over K1's body, the same seeds and steps) "
        f"{twin['ms']:.3f} ms/launch, {twin['step_ms']:.3f} ms/step: "
        f"{twin['ms'] / e['ms']:.2f}x per launch; final states bit-equal: "
        f"{same}; profile {e.get('profile')} [{card}]")
    if not same:
        raise RuntimeError("phase 24 (b): K7 test_4d: the stream arm and its "
                           "-no-skew twin end in other states")
    e.update(name=f"batched_step (K7 over K1's 4-D stream arm: {nm} x "
                  f"test_4d {shape} fp32)",
             replaces=S24_K7_REPLACES, path="phase 24 (b)",
             body_ms=twin["ms"], body_step_ms=twin["step_ms"],
             ptxas=entries[2]["ptxas"])
    entries.append(e)
    torch.cuda.empty_cache()
    log(f"phase 24 took {time.perf_counter() - t0:.1f} s")
    return entries


def phase1(fac, env, cases: dict) -> dict:
    """Build every kernel of the path, one ``nvcc`` per source, each group
    of sources started as soon as it is emitted, so the compilers run
    while the later groups' contexts are made (``cases``: phase 2's
    solutions and radii).  Returns ptxas's registers and spills per
    kernel, by source name."""
    from yask_tpu_torch.ops import _build, cuda_emit, fused_stencil
    t0 = time.perf_counter()
    specs, procs, started = {}, [], set()

    def start(more: dict) -> None:
        """Add ``more`` to the specs and start the sources not started
        (two solutions' sources may share a name and differ in their
        header comment: each is its own library)."""
        specs.update(more)
        new = {(s.name, s.source) for s in more.values()} - started
        started.update(new)
        procs.extend(_build.start_builds(sorted(new), ptxas_info=True))
    for st, r in cases.items():
        ctx = make_ctx(fac, env, st, r, 64, "fused")
        specs[st] = fused_stencil.FusedKernel(ctx._program).spec
    # phase 6's and 17 (a)'s: the merged RTM chains (K6; -push off is K7's
    # batch of a pushing chain) and the chained arm's stages
    for label, r, acc, cli in (("rtm r=2 pure", 2, False, ""),
                               ("rtm r=2 pure -push off", 2, False,
                                "-push off"),
                               ("rtm r=2 accumulating", 2, True, ""),
                               ("rtm r=8 pure", 8, False, ""),
                               ("rtm r=8 pure -push off", 8, False,
                                "-push off")):
        pipe = rtm_pipe(env, f"-mode fused -wf_steps 1 {cli}", True,
                        (16, 16, 16), r, acc)
        specs[label] = pipe.fused_ctx._fused_spec_kernel().spec
        pipe.end()
    chained = rtm_pipe(env, "-mode fused -wf_steps 1", False, (16, 16, 16))
    for s in chained.stage_names:
        specs[f"rtm stage {s}"] = \
            chained.stage_ctx(s)._fused_spec_kernel().spec
    chained.end()
    start(dict(specs))
    for group in (trap_specs, family_specs, a3_specs, a3b_specs, k7_specs,
                  k4_specs, ws_specs, flat_specs, ss_specs, ss18_specs,
                  k4s_specs, s4_specs, s22_specs, k1s_specs, s24_specs):
        start(group(fac, env))
    start(shard_specs(fac))
    start(k5_specs(fac))
    emit_secs = time.perf_counter() - t0
    logs = _build.wait_builds(procs)
    build_secs = time.perf_counter() - t0
    for st, s in specs.items():
        entries = (f"entries {s.name}_trap_stream and _trap_stream_batched "
                   f"(K4's stream arm and K7 over it: "
                   f"{cuda_emit.trap_stream_detail(s)})"
                   if s.trap.get("arm") == "stream" else
                   f"entries {s.name} (K4: trapezoid_kernel, then "
                   f"diamond_kernel per dim; {s.trap['sub_stages']} "
                   f"sub-stage(s) per level; passes (tile, smem B, workspace"
                   f" B per block) "
                   f"{[(pp['tile'], pp['smem_bytes'], pp['ws_block_bytes']) for pp in s.trap['passes']]})"
                   ", _trap_batched (K7 over K4)"
                   if s.trap else
                   f"entries {s.name} (K1), _batched (K7), _region (K5)"
                   + (f", _stream and _stream_batched (the 4-D stream arm "
                      f"and K7 over it: {s.stream.record()})"
                      if s.stream is not None and s.outer else
                      f", _stream, _stream_batched and _stream_region (the "
                      f"stream arm, K7 and K5 over it: "
                      f"{s.stream.record()})"
                      if s.stream is not None else "")
                   if s.stages == 1 and not s.workspace else
                   f"entries {s.name} (K6, {s.stages} sub-stages, "
                   f"{s.scratch_stages} of scratch vars, pushed "
                   f"{s.push_vars}), _batched (K7), _region (K5)"
                   + (f", _resident (workspace arm: "
                      f"{s.workspace['ws_block_bytes']} B per block)"
                      if s.workspace else "")
                   + (f", _stages_stream and _stages_stream_batched (K6's "
                      f"and K7's stream arm: "
                      f"{s.stages_stream.record()})"
                      if s.stages_stream is not None else ""))
        log(f"phase 1: built {s.name} ({st}): {entries}, tile "
            f"{list(s.tile)}, smem {s.smem_bytes} B; ptxas: "
            f"{ptxas_summary(logs.get(s.name, ''))}")
    log(f"phase 1: kernel build {build_secs:.1f} s ({len(logs)} nvcc "
        f"run(s) in parallel, started as their sources were emitted over "
        f"the first {emit_secs:.1f} s)")
    return {name: ptxas_summary(text) for name, text in logs.items()}


def release() -> None:
    """Free what the last phase left: its contexts (some in reference
    cycles, which only the collector frees) and the allocator's cache."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from yask_tpu_torch import yk_factory

    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    card = card_line()
    log(f"card: {card}")
    fac = yk_factory()
    env = fac.new_env()
    dev_name = torch.cuda.get_device_name(0)

    cases = {"iso3dfd": 8, "3axis": 1}
    ptxas = phase1(fac, env, cases)

    t = time.perf_counter()

    def took(phase: str) -> None:
        nonlocal t
        log(f"phase {phase} took {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
    phase2(fac, env, cases)
    phase3(fac, env, cases)
    took("2 and 3")
    _step_ms, k1, k_stream = phase4(fac, env, card)
    took("4")
    k7 = phase5(fac, env, k1["step_ms"])
    release()
    took("5")
    k6 = phase6(env)
    release()
    took("6")
    k4 = phase7(fac, env, card)
    release()
    took("7")
    k5 = phase8(fac, card, k1["step_ms"])
    release()
    k6_arms = phase9(fac, env, card)
    awp_twin = {"state_digest": k6_arms[1].pop("state_digest")}
    # phase 18 (b)'s twins: phase 9 (c)'s tti and phase 15 (a)'s r=8 rows
    twins = {"tti2": dict(k6_arms[0],
                          state_digest=k6_arms[0].pop("state_digest"))}
    release()
    a3_arms = phase10(fac, env, card)
    release()
    last_arms = phase11(fac, env, card, k6_arms[0])
    # phase 22 (b)'s twins: phase 11 (c)'s tti bf16 and phase 12 (d)'s rows
    bf16_twins = {"tti": dict(
        last_arms[2], state_digest=last_arms[2].pop("state_digest"))}
    # phase 24 (b)'s: phase 11 (c)'s test_4d and phase 12 (b)'s 4-D rows
    s24_twins = {"solo": dict(
        last_arms[0], state_digest=last_arms[0].pop("state_digest"))}
    release()
    # the solo rows of the same points beside phase 12 (b)'s member batches
    solo = {key: dict(e, label=label, points=pts) for key, e, label, pts in (
        ("tti", k6_arms[0], "phase 9 (c), K6, 512^3", 512 ** 3),
        ("awp", k6_arms[1], "phase 9 (c), K6's body (-no-skew), 512^3",
         512 ** 3),
        ("iso3dfd bf16", a3_arms[3], "phase 10 (c), K1 -no-skew, 512^3",
         512 ** 3),
        ("test_4d", last_arms[0], "phase 11 (c), K1's body (-no-skew), "
         "128^4", 128 ** 4),
        ("gaussian", a3_arms[0], "phase 10 (c), K6, 8192^2", 8192 ** 2))}
    k7_arms = phase12(fac, env, card, solo, k6)
    rtm_bf16 = next(e for e in k7_arms if e.get("path") == "phase 12 (d)")
    bf16_twins["rtm"] = dict(rtm_bf16,
                             state_digest=rtm_bf16.pop("state_digest"))
    # phase 23 (b)'s twins: phase 12 (b)'s and phase 13 (b)'s bf16
    # iso3dfd rows (K7 and K5 over K1's body), and the solo rows beside
    # the batches
    k1s_twins = {"solo": {
        "iso3dfd": dict(k_stream, label="phase 4, K1's stream arm, 512^3",
                        points=512 ** 3),
        "iso3dfd bf16": solo["iso3dfd bf16"]}}
    for e in k7_arms:
        if e.get("path") == "phase 12 (b)":
            digest = e.pop("state_digest")
            if "element size 2 arm: iso3dfd" in e["name"]:
                k1s_twins["k7 bf16"] = dict(e, state_digest=digest)
            if "4-D arm: test_4d" in e["name"]:
                s24_twins["k7"] = dict(e, state_digest=digest)
    release()
    k5_arms, k5_twins = phase13(fac, card)
    k1s_twins["k5 bf16"] = k5_twins["iso3dfd r=8 bf16"]
    release()
    k4_arms = phase14(fac, env, card)
    release()
    ws_arms = phase15(fac, env, card)
    for key, e in zip(("tti8", "ssg8"), ws_arms):
        twins[key] = dict(e, state_digest=e.pop("state_digest"))
    release()
    flat_arms = phase16(fac, env, card, a3_arms[0])
    release()
    k7_awp = next(e for e in k7_arms if e.get("path") == "phase 12 (b)"
                  and "rewrite arm: awp" in e["name"])
    ss_arms = phase17(fac, env, card, ptxas, k6_arms[1], awp_twin, k7_awp,
                      k6)
    release()
    k7_tti = next(e for e in k7_arms if e.get("path") == "phase 12 (b)"
                  and "scratch arm: tti" in e["name"])
    ss18_arms = phase18(fac, env, card, twins, k7_tti)
    release()
    k5_ss_arms = phase19(fac, card, k5_twins)
    release()
    k4_stream_arms = phase20(fac, env, card, ptxas)
    release()
    s4_arms = phase21(fac, env, card, ptxas)
    release()
    bf16_arms = phase22(fac, env, card, ptxas, bf16_twins)
    release()
    k1s_arms = phase23(fac, env, card, ptxas, k1s_twins)
    release()
    s24_arms = phase24(fac, env, card, ptxas, s24_twins)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [k1, k_stream, k4, k5, k6, k7]
                      + k6_arms + a3_arms + last_arms + k7_arms
                      + k5_arms + k4_arms + ws_arms + flat_arms
                      + ss_arms + ss18_arms + k5_ss_arms
                      + k4_stream_arms + s4_arms + bf16_arms
                      + k1s_arms + s24_arms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
