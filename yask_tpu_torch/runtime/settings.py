"""Runtime settings: every knob the port's kernel runtime accepts.

Counterpart of ``yask_tpu/runtime/settings.py`` (the reference's
``KernelSettings``, ``src/kernel/lib/settings.hpp:200-327``) with the
port's execution modes and a ``-device`` option.  It keeps the domain
geometry, tiling and decomposition knobs, the exchange scheduling of the
shard modes (``-overlap_comms``, ``-overlap_x``, ``-comm_order``,
``-coalesce``), the parity no-ops, and the knobs of paths still to port
(auto-tuner, supervised runs, halo calibration): those are parsed so
reference command lines keep working, and the context raises when one is
set (``StencilContext._check_carried``).  ``-ensemble`` sets the default
size of ``new_ensemble()``.  ``-skew`` and ``-skew_dims`` keep the
reference's names: they select K1's stream arm (the port's design for the
skewed wavefront and the DMA prefetch, ROADMAP.md A4a and C11).  The
TPU-only knobs of the reference (VMEM budgets, checker preflight,
serving) come with the ROADMAP.md items that port their paths.
"""

from __future__ import annotations

from typing import List

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.idx_tuple import IdxTuple
from yask_tpu_torch.utils.cli import CommandLineParser


#: Execution modes for run_solution.
MODES = ("auto",       # resolves to "torch" (as "auto" resolves to "jit")
         "torch",      # StepProgram.step on tensors, K steps per chunk
         #               (the counterpart of yask_tpu's "jit")
         "fused",      # the hand-written CUDA kernel, one launch per
         #               sub-step (the counterpart of "pallas")
         "ref",        # eager numpy oracle (the reference's run_ref)
         "sharded",    # the per-shard torch step and exchange of
         #               shard_map, the resting state kept per shard (the
         #               reference's XLA-inserted collectives, ROADMAP.md C9)
         "shard_map",  # per-shard torch step + ghost exchange before each
         #               stage that reads at an offset
         "shard_pallas",  # per-shard K5 sub-steps + one exchange per group
         #                  of wf_steps steps (the scaling path)
         )

#: The modes that run over a mesh of devices.
SHARD_MODES = ("sharded", "shard_map", "shard_pallas")


class KernelSettings:
    """All runtime knobs for one solution instance."""

    def __init__(self, domain_dims: List[str]):
        self.domain_dims = list(domain_dims)
        z = {d: 0 for d in domain_dims}
        # Geometry (reference -g / -d / -b … options).
        self.global_domain_sizes = IdxTuple(z)   # -g* (0 = derive from rank)
        self.rank_domain_sizes = IdxTuple(z)     # -d* (0 = derive from global)
        self.block_sizes = IdxTuple(z)           # -b* tile hints (0 = auto)
        self.min_pad_sizes = IdxTuple(z)         # -mp* extra pad per dim
        self.num_ranks = IdxTuple(z)             # -nr* rank grid (0 = auto)
        # Steps per chunk (reference wave-front option, context.hpp:331).
        self.wf_steps = 0          # 0 = the whole run in one chunk
        self.mode = "auto"
        self.device = ""           # torch device ("" = the env's device)
        self.force_scalar = False  # run the numpy oracle path
        # Shard modes: split each stage (shard_map, sharded) into a core
        # on the pre-exchange state and shells on the post-exchange state.
        self.overlap_comms = True
        # shard_pallas: the core/shell split of each K-group with the
        # exchange on a second CUDA stream: auto|on|off (on raises where
        # the split is infeasible).
        self.overlap_exchange = "auto"
        # Mesh-axis exchange order ("" = the CommPlan's cost model) and
        # message coalescing (auto|on|off) of the shard modes.
        self.comm_order = ""
        self.coalesce = "auto"
        # Halo-time calibration: not ported (ROADMAP.md A11); raises.
        self.measure_halo_time = False
        self.use_shm = True
        self.use_device_mpi = True
        self.max_threads = 0
        self.numa_pref = -1
        # Paths still to port: setting any of these raises at prepare/run.
        self.do_auto_tune = False        # ROADMAP.md A6
        self.ensemble = 1                # new_ensemble()'s default size
        self.push_memory = "auto"        # auto|on|force|off (K6's push)
        self.ckpt_every = 0              # A10 (supervised runs)
        self.ckpt_dir = ""
        self.watchdog_every = 0
        self.run_deadline_secs = 0
        # Trapezoid/diamond temporal tiling of -mode fused (K4): True =
        # auto, engaged where the TilePlan gate picks it (the reference's
        # -trapezoid).  The remainder steps of a run run on K1.
        self.trapezoid_tiling = False
        # K1's stream arm of -mode fused (the reference's -skew): True =
        # auto, engaged wherever it can run (a single-stage 3-D solution
        # read at a slot-0 offset whose plane rings fit shared memory),
        # False = K1's 3-D tiles.
        self.skew_wavefront = True
        # How many grid dims the skew may take (the reference's window):
        # the port streams one dim, slot 0, so 0 leaves it out and any
        # value >= 1 allows it.
        self.skew_dims_max = 2

    # ------------------------------------------------------------------

    def add_options(self, parser: CommandLineParser) -> None:
        """Register every option (reference ``KernelSettings::add_options``).
        Option names follow the reference CLI (``-g``, ``-d``, ``-b``,
        ``-nr``, ``-wf_steps``…), with per-dim forms like ``-d_x``."""
        dd = self.domain_dims
        parser.add_idx_option(
            "g", "Global (overall) domain size in each dim.", self,
            "global_domain_sizes", dd)
        parser.add_idx_option(
            "d", "Per-rank domain size in each dim.", self,
            "rank_domain_sizes", dd)
        parser.add_idx_option(
            "b", "Block (tile) size hint in each dim.", self,
            "block_sizes", dd)
        parser.add_idx_option(
            "mp", "Minimum extra pad in each dim.", self,
            "min_pad_sizes", dd)
        parser.add_idx_option(
            "nr", "Number of ranks (mesh extent) in each dim; -1 factors "
            "the env's devices into a grid.", self, "num_ranks", dd)
        parser.add_int_option(
            "wf_steps", "Steps per chunk (K of the fused kernel's "
            "chunks).", self, "wf_steps")
        parser.add_string_option(
            "mode", f"Execution mode, one of {MODES}.", self, "mode")
        parser.add_string_option(
            "device", "torch device to run on, e.g. 'cuda:0' or 'cpu' "
            "(empty = the env's device).", self, "device")
        parser.add_bool_option(
            "force_scalar", "Use the eager numpy oracle instead of the "
            "compiled path.", self, "force_scalar")
        parser.add_bool_option(
            "overlap_comms", "Shard modes: compute each stage's core on the "
            "pre-exchange state and its shells after the exchange.", self,
            "overlap_comms")
        parser.add_bool_option(
            "measure_halo", "Measure halo-exchange time (not ported yet: "
            "ROADMAP.md A11).", self, "measure_halo_time")
        parser.add_string_option(
            "overlap_x", "shard_pallas overlapped exchange: auto|on|off "
            "(the core of each K-group runs while the exchange copies on a "
            "second CUDA stream, then the shell slabs; auto declines it "
            "when every shard sits on one card).", self,
            "overlap_exchange")
        parser.add_string_option(
            "comm_order", "Mesh-axis ghost-exchange order for the shard "
            "modes, e.g. 'y,x' (empty = the CommPlan's cost model).", self,
            "comm_order")
        parser.add_string_option(
            "coalesce", "Ghost-exchange message coalescing: auto|on|off "
            "(one packed copy per mesh axis, direction and neighbour pair "
            "instead of one per buffer; auto declines it when every shard "
            "sits on one card).", self, "coalesce")
        for name, attr in (("use_shm", "use_shm"),
                           ("use_device_mpi", "use_device_mpi")):
            parser.add_bool_option(
                name, "Accepted for reference parity (no effect).", self,
                attr)
        parser.add_int_option(
            "max_threads", "Accepted for reference parity.", self,
            "max_threads")
        parser.add_bool_option(
            "auto_tune", "Auto-tune tile sizes (not ported yet: "
            "ROADMAP.md A6).", self, "do_auto_tune")
        parser.add_int_option(
            "ensemble", "Batch N independent solution instances "
            "(the default size of new_ensemble(); modes torch and fused "
            "batch).  1 = off.", self, "ensemble")
        parser.add_string_option(
            "push", "Push-memory fusion of -mode fused (K6): auto (a "
            "pipeline's fused chain only), on (any fused context), force "
            "(raise when no var can be pushed) or off.", self,
            "push_memory")
        parser.add_int_option(
            "ckpt_every", "Checkpoint every N steps (not ported yet: "
            "ROADMAP.md A10).", self, "ckpt_every")
        parser.add_string_option(
            "ckpt_dir", "Directory for checkpoints (ROADMAP.md A10).", self,
            "ckpt_dir")
        parser.add_int_option(
            "watchdog_every", "Scan written state every M steps (not "
            "ported yet: ROADMAP.md A10).", self, "watchdog_every")
        parser.add_int_option(
            "run_deadline", "Per-chunk deadline in seconds (not ported "
            "yet: ROADMAP.md A10).", self, "run_deadline_secs")
        parser.add_bool_option(
            "trapezoid", "Trapezoid/diamond temporal tiling of -mode fused "
            "(K4: under -skew, on a 3-D solution K6's stream arm takes, "
            "one streamed launch per group of K steps; else K steps per "
            "phase-1 launch plus the diamond fill launches), engaged where "
            "the TilePlan gate picks it; pads are planned for it.  The gate "
            "costs the reference's TPU variants and does not predict the "
            "card's speed: on iso3dfd r=2 K=4 K4 is today about 1.6x "
            "slower per step than K1's stream arm (ROADMAP.md C7).", self,
            "trapezoid_tiling")
        parser.add_bool_option(
            "skew", "K1's stream arm on -mode fused (auto-on where it can "
            "run: each block walks slot 0 through a ring of planes carried "
            "from plane to plane, the next planes fetched under the "
            "current one's compute; the reference's skewed wavefront), "
            "K6's, and under -trapezoid K4's (the K levels of a group "
            "lagged along slot 0 in one launch).",
            self, "skew_wavefront")
        parser.add_int_option(
            "skew_dims", "Max grid dims the skew may engage (the port "
            "streams slot 0 only: 0 = off, >= 1 = the stream dim).", self,
            "skew_dims_max")

    # ------------------------------------------------------------------

    def adjust_settings(self, num_devices: int = 1) -> None:
        """Derive unset values (reference ``adjust_settings``,
        ``settings.cpp``): rank grid and global↔rank domain sizes."""
        if self.mode not in MODES:
            raise YaskException(f"unknown mode '{self.mode}'; one of {MODES}")

        # Rank grid: like the reference, one rank unless the user asks for
        # decomposition (-nr, or a shard mode).  -1 in any dim factors all
        # devices over the grid, keeping the minor-most dim whole.
        nr = self.num_ranks
        if any(v < 0 for v in nr.get_vals()):
            from yask_tpu_torch.parallel.decomp import factorize_rank_grid
            auto = factorize_rank_grid(max(num_devices, 1), self.domain_dims)
            for d in self.domain_dims:
                nr[d] = auto[d]
        elif all(v == 0 for v in nr.get_vals()) and num_devices > 1 \
                and self.mode in SHARD_MODES:
            # distribution requested by the mode but no grid given: split
            # the outer-most dim
            for d in self.domain_dims:
                nr[d] = 1
            nr[self.domain_dims[0]] = num_devices
        else:
            for d in self.domain_dims:
                if nr[d] == 0:
                    nr[d] = 1
        if nr.product() > max(num_devices, 1):
            raise YaskException(
                f"rank grid {nr} needs {nr.product()} devices, "
                f"only {num_devices} available")

        # Domain sizes: global ⇄ rank.
        for d in self.domain_dims:
            g, r, n = self.global_domain_sizes[d], self.rank_domain_sizes[d], nr[d]
            if g == 0 and r == 0:
                raise YaskException(f"domain size for dim '{d}' not set")
            if g == 0:
                self.global_domain_sizes[d] = r * n
            elif r == 0:
                if g % n != 0:
                    raise YaskException(
                        f"global size {g} in dim '{d}' not divisible by "
                        f"{n} ranks")
                self.rank_domain_sizes[d] = g // n
            elif r * n != g:
                raise YaskException(
                    f"inconsistent sizes in dim '{d}': global {g} != "
                    f"rank {r} × {n} ranks")
