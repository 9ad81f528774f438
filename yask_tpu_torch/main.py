"""Performance & validation harness CLI of the port.

Counterpart of ``yask_tpu/main.py`` (the reference's ``yask_main.cpp``
trial protocol, ``src/kernel/yask_main.cpp:53-66``): pick a registered
stencil, set sizes, warm up (builds the fused kernel — excluded from
timing), run N timed trials, report best/mid/ave statistics in the
reference's log-key format, or validate against the eager-numpy oracle
(``-validate``).  ``-device`` picks the torch device (default
``cuda:0``; ``-device cpu`` is the only way onto the CPU); ``-devices``
gives the env a device list instead (repeats allowed), over which the
shard modes decompose the domain by ``-nr_*``.

Usage::

    python -m yask_tpu_torch.main -stencil iso3dfd -radius 8 -g 512 \
        -mode fused -wf_steps 2 -num_trials 3 -trial_steps 20
    python -m yask_tpu_torch.main -stencil 3axis -g 32 -validate
    python -m yask_tpu_torch.main -stencil iso3dfd -radius 8 -g 512 \
        -devices cuda:0,cuda:0,cuda:0,cuda:0 -nr_x 2 -nr_y 2 \
        -mode shard_pallas -wf_steps 2
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import List, Optional

from yask_tpu_torch.utils.cli import CommandLineParser
from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.runtime.init_utils import init_solution_vars as _init_vars


class HarnessSettings:
    def __init__(self):
        self.stencil = ""
        self.radius = 0
        self.num_trials = 3
        self.trial_steps = 10
        self.warmup_steps = 0     # 0 → same as trial_steps
        self.validate = False
        self.validate_steps = 2   # short, like the reference's validation
        self.init_seed = 0.1
        self.device = ""          # "" → cuda:0
        self.devices = ""         # comma list → the env's device list
        self.trace = False
        self.list_stencils = False
        self.help = False

    def add_options(self, p: CommandLineParser) -> None:
        p.add_string_option("stencil", "Registered stencil name.",
                            self, "stencil")
        p.add_int_option("radius", "Stencil radius (0 = default).",
                         self, "radius")
        p.add_int_option("num_trials", "Number of timed trials.",
                         self, "num_trials")
        p.add_int_option("trial_steps", "Steps per trial.",
                         self, "trial_steps")
        p.add_int_option("warmup_steps", "Warmup steps (0 = trial_steps).",
                         self, "warmup_steps")
        p.add_bool_option("validate", "Compare vs the numpy oracle instead "
                          "of timing.", self, "validate")
        p.add_int_option("validate_steps", "Steps for -validate (short, "
                         "like the reference's '-trial_steps 2' validation "
                         "runs: fp32 noise compounds per step).",
                         self, "validate_steps")
        p.add_float_option("init_seed", "Per-var init sequence seed.",
                           self, "init_seed")
        p.add_string_option("device", "torch device (default cuda:0; "
                            "'cpu' runs on the CPU).", self, "device")
        p.add_string_option("devices", "Comma-separated torch devices of "
                            "the env, repeats allowed (e.g. cuda:0,cuda:0); "
                            "the shard modes decompose over them.", self,
                            "devices")
        p.add_bool_option("trace", "Enable trace messages.", self, "trace")
        p.add_bool_option("list", "List registered stencils.",
                          self, "list_stencils")
        p.add_bool_option("help", "Print help.", self, "help")


def _build(opts: HarnessSettings, extra_args: List[str]):
    from yask_tpu_torch import yk_factory
    fac = yk_factory()
    devices = [d for d in opts.devices.split(",") if d] or None
    env = fac.new_env(device=opts.device or None, devices=devices)
    env.set_trace_enabled(opts.trace)
    ctx = fac.new_solution(env, stencil=opts.stencil,
                           radius=opts.radius or None)
    rest = ctx.apply_command_line_options(extra_args)
    if rest:
        raise YaskException(f"unrecognized options: {' '.join(rest)}")
    return env, ctx


def run_harness(argv: Optional[List[str]] = None, out=None) -> int:
    out = out or sys.stdout
    opts = HarnessSettings()
    p = CommandLineParser()
    opts.add_options(p)
    rest = p.parse_args(list(argv if argv is not None else sys.argv[1:]))

    if opts.help:
        out.write("yask_tpu_torch harness options:\n")
        p.print_help(out)
        out.write("\nplus all kernel options (-g, -d, -b, -mode, "
                  "-wf_steps, ...):\n")
        return 0
    from yask_tpu_torch.compiler.solution_base import get_registered_solutions
    if opts.list_stencils:
        out.write("\n".join(get_registered_solutions()) + "\n")
        return 0
    if not opts.stencil:
        out.write("error: -stencil <name> required; -list to enumerate.\n")
        return 2

    env, ctx = _build(opts, rest)
    out.write(f"YASK-TORCH harness: stencil '{opts.stencil}' on "
              f"{env.get_device()} ({env.get_device_name()})\n")
    ctx.prepare_solution()
    if ctx._mesh is not None:
        out.write(f"mode {ctx._mode}: mesh {ctx._mesh.shape} on "
                  f"{env.get_num_ranks()} device(s), "
                  f"{env.get_num_cards()} distinct\n")
    _init_vars(ctx, opts.init_seed)
    soln_ana = ctx._ana
    npts = ctx.get_settings().global_domain_sizes.product()
    out.write(f"domain: "
              f"{ctx.get_settings().global_domain_sizes.make_dim_val_str()}"
              f" ({npts} points); {soln_ana.summary()}\n")

    if opts.validate:
        # -validate flow: run both engines on identical state, compare.
        steps = max(opts.validate_steps, 1)
        ctx.run_solution(0, steps - 1)
        _env2, ref = _build(opts, rest)
        ref.get_settings().mode = "ref"
        ref.prepare_solution()
        _init_vars(ref, opts.init_seed)
        ref.run_solution(0, steps - 1)
        bad = ctx.compare_data(ref, epsilon=1e-3, abs_epsilon=1e-4)
        if bad:
            out.write(f"VALIDATION FAILED: {bad} mismatching point(s) "
                      f"after {steps} step(s).\n")
            return 1
        out.write(f"validation passed after {steps} step(s) "
                  "(optimized vs numpy oracle).\n")
        return 0

    # Warmup (includes the kernel build; excluded from trials).
    warm = opts.warmup_steps or opts.trial_steps
    t = 0
    ctx.run_solution(t, t + warm - 1)
    t += warm
    out.write(f"warmup done ({warm} step(s); build "
              f"{ctx.get_stats().get_compile_secs():.3g} s).\n")

    rates = []
    for trial in range(opts.num_trials):
        ctx.clear_stats()
        t0 = time.perf_counter()
        ctx.run_solution(t, t + opts.trial_steps - 1)
        dt = time.perf_counter() - t0
        t += opts.trial_steps
        pts_ps = npts * opts.trial_steps / dt
        rates.append(pts_ps)
        out.write(f"trial {trial + 1}/{opts.num_trials}:\n")
        out.write(f"  num-steps-done: {opts.trial_steps}\n")
        out.write(f"  elapsed-time (sec): {dt:.6g}\n")
        out.write(f"  throughput (num-points/sec): {pts_ps:.6g}\n")
        out.write(f"  throughput (est-FLOPS): "
                  f"{pts_ps * soln_ana.counters.num_ops:.6g}\n")

    rates.sort()
    mid = rates[len(rates) // 2]
    out.write("summary:\n")
    out.write(f"  best-throughput (num-points/sec): {rates[-1]:.6g}\n")
    out.write(f"  mid-throughput (num-points/sec): {mid:.6g}\n")
    out.write(f"  min-throughput (num-points/sec): {rates[0]:.6g}\n")
    out.write(f"  ave-throughput (num-points/sec): "
              f"{statistics.fmean(rates):.6g}\n")
    if len(rates) > 1:
        out.write(f"  stddev-throughput (num-points/sec): "
                  f"{statistics.stdev(rates):.6g}\n")
    out.write(f"  mid-throughput (GPts/s): {mid / 1e9:.6g}\n")
    st = ctx.get_stats()
    bpp = st.get_hbm_bytes_per_point()
    peak = env.get_hbm_peak_bytes_per_sec()
    out.write(f"  hbm-bytes-per-point (model): {bpp:.6g}\n")
    if peak > 0:
        out.write(f"  hbm-roofline-fraction (%): "
                  f"{100.0 * mid * bpp / peak:.4g}\n")
    if st.get_tiling():
        out.write(f"  fused-tiling: {st.get_tiling()}\n")
        if st.get_tiling().get("reasons"):
            out.write(f"  trapezoid reasons: "
                      f"{st.get_tiling()['reasons']}\n")
    return 0


def main() -> None:  # pragma: no cover - thin wrapper
    try:
        sys.exit(run_harness())
    except YaskException as e:
        sys.stderr.write(f"error: {e}\n")
        sys.exit(2)


if __name__ == "__main__":
    main()
