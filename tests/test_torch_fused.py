"""K1's port (``-mode fused``) against yask_tpu's ``-mode pallas``.

* On the CPU the fused wrapper takes its plain version (K calls of the
  port's StepProgram.step plus the pad re-zeroing); it must match the
  Pallas kernel run as tests/test_pallas.py runs it on the CPU (interpret
  mode) at the same K, remainder included.  Tolerance: compare_data's
  defaults plus ``field_epsilon=1e-4`` — the repo's policy for a fused
  in-tile evaluation against an unfused one (the Pallas tile reassociates
  sums, so a point near cancellation carries ulps of the field scale).
* The emitted point function is compiled by the host g++ (it is
  ``__host__ __device__``) through the same entry point nvcc builds, and
  held against the plain version on a small array: this is how the CPU
  checks the emitter's arithmetic and the kernel's indexing before the
  card.  Tolerance: rtol 1e-5, atol 1e-6 (float32 ulps of libm functions).
* Requests the emitter does not take raise; a CUDA-only test runs the
  real kernel where there is a card.
"""

import ctypes
import importlib
import os
import shutil
import subprocess

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)

CSRC = os.path.join(os.path.dirname(fused_stencil.__file__), "..", "csrc")


def cond_funcs(pkg: str, with_ly=True):
    """A single-stage 3-D solution with partial-dim read-only vars,
    domain and step conditions, index values, functions of data and of
    constants, min/max/pow/mod — the emitter's typing in one equation.
    ``ly`` (a var over y alone) is one Pallas cannot take (its lane dim is
    not the minor), so the Pallas comparison leaves it out."""
    E = importlib.import_module(pkg + ".compiler.expr")
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution("cond_funcs")
    t = soln.new_step_index("t")
    x = soln.new_domain_index("x")
    y = soln.new_domain_index("y")
    z = soln.new_domain_index("z")
    u = soln.new_var("u", [t, x, y, z])
    c = soln.new_var("c", [x, z])
    p = u(t, x, y, z)
    lap = (u(t, x - 1, y, z) + u(t, x + 1, y, z) + u(t, x, y - 1, z)
           + u(t, x, y + 1, z) + u(t, x, y, z - 1) + u(t, x, y, z + 1)
           - 6.0 * p)
    val = (p + 0.1 * c(x, z) * lap
           + 0.01 * E.sqrt(E.fabs(p)) * E.sqrt(2.0)
           + 0.001 * (x % 3) + (y + 1) / 64.0
           + 0.02 * E.max_fn(p, 0.5) - 0.01 * E.min_fn(p, c(x, z))
           + 0.001 * E.pow_fn(E.fabs(p), 1.5) + 0.01 * E.exp(-p)
           - 0.01 * E.cos(p) + 0.01 * E.sin(p))
    if with_ly:
        val = val + soln.new_var("ly", [y])(y)
    cond = (x > 1) & (y < 9) | (z == 4)
    u(t + 1, x, y, z).EQUALS(val).IF_DOMAIN(cond).IF_STEP(t % 3 != 1)
    return soln


def port_ctx(source, g, mode, wf=1, **kw):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), source, **kw)
    ctx.apply_command_line_options(f"-g {g} -mode {mode} -wf_steps {wf}")
    ctx.prepare_solution()
    return ctx


def tpu_ctx(source, g, mode, wf=1, **kw):
    fac = yask_tpu.yk_factory()
    ctx = fac.new_solution(fac.new_env(), source, **kw)
    ctx.apply_command_line_options(f"-g {g} -wf_steps {wf}")
    ctx.get_settings().mode = mode
    ctx.prepare_solution()
    return ctx


# ---------------------------------------------------------------------------
# the plain version against Pallas (interpret) at the same K
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,steps", [(1, 3), (2, 4), (3, 4)])
@pytest.mark.parametrize("name,r", [("3axis", 1), ("iso3dfd", 2)])
def test_fused_plain_matches_pallas_interpret(name, r, K, steps):
    g = 16
    mine = port_ctx(None, g, "fused", K, stencil=name, radius=r)
    theirs = tpu_ctx(None, g, "pallas", K, stencil=name, radius=r)
    state = seeded_interiors(mine, 21)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
    tiling = mine.get_stats().get_tiling()
    # -skew's default: the stream arm (K2's prefetch, K3's slot-0 carry)
    assert tiling["kernel"] == "stream_step"
    assert tiling["pipeline_dmas"] is True and tiling["skew_dims"] == ["x"]


@pytest.mark.parametrize("with_ly,tpu_mode", [(False, "pallas"),
                                              (True, "jit")])
def test_fused_conditions_and_functions_match_yask_tpu(with_ly, tpu_mode):
    g, steps = 12, 4
    mine = port_ctx(cond_funcs("yask_tpu_torch", with_ly), g, "fused", 2)
    theirs = tpu_ctx(cond_funcs("yask_tpu", with_ly), g, tpu_mode, 2)
    state = seeded_interiors(mine, 3)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0


# ---------------------------------------------------------------------------
# the emitted point function, compiled by g++
# ---------------------------------------------------------------------------


def host_kernel(spec, tmp_path, entry=None):
    """Build the emitted source for the host with g++ (the entry points
    then run yt::host_step) and bind one like the CUDA library: K1's
    (``spec.name``, the default) or K7's (``spec.name + "_batched"``)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test the emitted point function"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    entry = entry or spec.name
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = (fused_stencil.batched_argtypes(spec.walks)
                   if entry.endswith("_batched")
                   else fused_stencil.entry_argtypes(spec.walks))
    fn.restype = ctypes.c_int
    return fn


def host_launch(fn, prog, spec, state, t):
    """One sub-step through the C entry point on CPU tensors, marshalled
    by the same call_entry that fused_step uses for CUDA tensors."""
    import torch
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.zeros(tuple(prog.geoms[n].shape), dtype=ins[0].dtype)
            for n in spec.outputs]
    assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t, None) == 0
    return dict(zip(spec.outputs, outs))


@pytest.mark.parametrize("name,r", [("iso3dfd", 2), ("iso3dfd_sponge", 1),
                                    ("3axis", 1), ("cube", 1),
                                    ("3plane", 2), ("cond_funcs", 0),
                                    ("two_stage", 0)])
def test_emitted_point_function_matches_plain_gxx(name, r, tmp_path):
    import torch
    if name == "cond_funcs":
        ctx = port_ctx(cond_funcs("yask_tpu_torch"), 10, "fused")
    elif name == "two_stage":    # K6's entry: two stages per launch
        ctx = port_ctx(_two_stage_chain(), 70, "fused")
    else:
        ctx = port_ctx(None, 10, "fused", stencil=name, radius=r)
    import_interiors(ctx, seeded_interiors(ctx, 13))
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    fn = host_kernel(spec, tmp_path)
    for t in (0, 1):   # t % 3 != 1 selects, then masks, cond_funcs
        got = host_launch(fn, prog, spec, ctx._state, t)
        want = prog.step(ctx._state, t)
        for n, a in got.items():
            np.testing.assert_allclose(a.numpy(), want[n][-1].numpy(),
                                       rtol=1e-5, atol=1e-6)
            outside = a.clone()
            outside[ctx._interior_idx(n)] = 0
            assert not outside.any() and a.dtype == torch.float32


def test_emitter_cse_prints_each_term_once():
    ctx = port_ctx(None, 8, "fused", stencil="iso3dfd", radius=2)
    spec = cuda_emit.emit(ctx._program)
    body = spec.source
    # 6·r + 1 distinct pressure reads at t, one at t−1, one vel read
    assert body.count("rd.template at<") == 6 * 2 + 1 + 2
    assert spec.tiled == [spec.inputs.index(("pressure", 1))]
    assert spec.halos[spec.tiled[0]] == ((2, 2), (2, 2), (2, 2))
    assert spec.tile == (8, 8, 64) and spec.smem_bytes \
        == (8 + 4) * (8 + 4) * (64 + 4) * 4


def test_emitter_shrinks_tiles_to_fit_shared_memory():
    ctx = port_ctx(None, 8, "fused", stencil="iso3dfd", radius=8)
    spec = cuda_emit.emit(ctx._program)
    assert spec.tile == (8, 8, 64)
    assert spec.smem_bytes == 24 * 24 * 80 * 4 <= cuda_emit.SMEM_LIMIT
    fac = yask_tpu_torch.yk_factory()
    big = fac.new_solution(fac.new_env(device="cpu"), stencil="3axis",
                           radius=12)
    big.apply_command_line_options("-g 40 -mode fused")
    big.prepare_solution()
    s2 = cuda_emit.emit(big._program)
    assert s2.smem_bytes <= cuda_emit.SMEM_LIMIT and s2.tile != (8, 8, 64)


# ---------------------------------------------------------------------------
# what the emitter and the wrapper refuse
# ---------------------------------------------------------------------------


def _two_stage_chain(pkg="yask_tpu_torch"):
    """Two stages: b reads the a this step computes, one point over."""
    s = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution("two_stage")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    a = s.new_var("a", [t, x])
    b = s.new_var("b", [t, x])
    a(t + 1, x).EQUALS(a(t, x - 1) + b(t, x))
    b(t + 1, x).EQUALS(a(t + 1, x + 1) * 0.5)
    return s


def _multi_stage():
    """A var written in two stages: a bulk update, then an override that
    the write-after-write order puts in a later stage, reading this
    step's values of its neighbours (K6's rewrite arm)."""
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("rewrite")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    a = s.new_var("a", [t, x])
    a(t + 1, x).EQUALS(a(t, x - 1) * 0.5)
    a(t + 1, x).EQUALS(a(t + 1, x - 1) * 0.25 + a(t, x + 1)).IF_DOMAIN(
        x > 2)
    return s


def _scratch():
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("with_scratch")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    a = s.new_var("a", [t, x])
    tmp = s.new_scratch_var("tmp", [x])
    tmp(x).EQUALS(a(t, x - 1) + a(t, x + 1))
    a(t + 1, x).EQUALS(tmp(x - 1) * 0.25)
    return s


def _misc():
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("with_misc")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    m = s.new_misc_index("m")
    a = s.new_var("a", [t, x])
    w = s.new_var("w", [m])
    a(t + 1, x).EQUALS(a(t, x - 1) * w(0) + a(t, x + 1) * w(1))
    return s


def _four_d():
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("four_d")
    t = s.new_step_index("t")
    w, x, y, z = (s.new_domain_index(d) for d in "wxyz")
    a = s.new_var("a", [t, w, x, y, z])
    a(t + 1, w, x, y, z).EQUALS(a(t, w - 1, x, y, z) * 0.5)
    return s


def _bf16():
    s = _scratch()
    s.set_element_bytes(2)
    return s


@pytest.mark.parametrize("build,refusal", [
    (_four_d, "4-D.*ROADMAP.md A3 \\(4-D\\)"),
    (_bf16, "element size 2.*ROADMAP.md A3 \\(element size 2 on K6\\)")])
def test_fused_mode_refuses_what_the_emitter_does_not_take(build, refusal,
                                                           tmp_path):
    """What the emitter refused before its 4-D arm and K6's element-size-2
    arm (``refusal``, the message these cases pinned then): ``-mode
    fused`` prepares and runs it (K1 for the 4-D solution, K6 for the
    bfloat16 one with a scratch var), bit-equal to ``-mode torch`` from
    the same state, and the emitted source built by g++ gives the plain
    version's bits."""
    import re
    import torch
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = fac.new_solution(fac.new_env(device="cpu"), build())
        ctx.apply_command_line_options(
            f"-g {6 if build is _four_d else 16} -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 8))
        ctxs[mode] = ctx
    prog = ctxs["fused"]._program
    ok, why = cuda_emit.fused_applicable(prog)
    assert ok and not re.search(refusal, why)
    spec = cuda_emit.emit(prog)
    fn = host_kernel(spec, tmp_path)
    got = host_launch(fn, prog, spec, ctxs["fused"]._state, 0)
    want = prog.step(ctxs["fused"]._state, 0)
    assert torch.equal(got["a"], want["a"][-1])
    for ctx in ctxs.values():
        ctx.run_solution(0, 2)
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0
    til = ctxs["fused"].get_stats().get_tiling()
    assert til["kernel"] == ("fused_step" if build is _four_d
                             else "stages_step")


def test_fused_mode_runs_a_misc_only_var(tmp_path):
    """What the emitter refused before its misc arm: a misc-only
    coefficient var ``w[m]`` (stride 0 in every slot, one input per misc
    index read).  K1's g++ build gives the plain version's bits; fused
    matches torch."""
    import torch
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = fac.new_solution(fac.new_env(device="cpu"), _misc())
        ctx.apply_command_line_options(f"-g 40 -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 8))
        ctxs[mode] = ctx
    spec = cuda_emit.emit(ctxs["fused"]._program)
    assert spec.in_misc[spec.inputs.index(("w", 0))] == (("m", 0),)
    fn = host_kernel(spec, tmp_path)
    got = host_launch(fn, ctxs["fused"]._program, spec,
                      ctxs["fused"]._state, 0)
    want = ctxs["fused"]._program.step(ctxs["fused"]._state, 0)
    torch.testing.assert_close(got["a"], want["a"][-1], rtol=0, atol=0)
    for ctx in ctxs.values():
        ctx.run_solution(0, 4)
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0


@pytest.mark.parametrize("build", [_multi_stage, _scratch])
def test_fused_mode_runs_rewrites_and_scratch(build, tmp_path):
    """What the emitter refused before its scratch and rewrite arms: K6
    runs it, and its emitted sub-stages (g++'s host path) give the plain
    version's bits; fused matches torch."""
    import torch
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = fac.new_solution(fac.new_env(device="cpu"), build())
        ctx.apply_command_line_options(f"-g 40 -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 8))
        ctxs[mode] = ctx
    spec = cuda_emit.emit(ctxs["fused"]._program)
    assert spec.stages > 1 and spec.name.startswith("fused_stages_")
    fn = host_kernel(spec, tmp_path)
    got = host_launch(fn, ctxs["fused"]._program, spec,
                      ctxs["fused"]._state, 0)
    want = ctxs["fused"]._program.step(ctxs["fused"]._state, 0)
    torch.testing.assert_close(got["a"], want["a"][-1], rtol=0, atol=0)
    for ctx in ctxs.values():
        ctx.run_solution(0, 4)
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0
    til = ctxs["fused"].get_stats().get_tiling()
    assert til["kernel"] == "stages_step"


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    import torch
    ctx = port_ctx(None, 8, "fused", stencil="3axis", radius=1)
    kern = fused_stencil.FusedKernel(ctx._program)
    n0 = fused_stencil.fused_step.launches
    kern.chunk(ctx._state, 0, 2)            # CPU: plain version
    assert fused_stencil.fused_step.launches == n0
    assert kern.fn is None                  # nothing was built
    meta = {n: [a.to("meta") for a in ring]
            for n, ring in ctx._state.items()}
    with pytest.raises(YaskException, match="CUDA or CPU"):
        kern.chunk(meta, 0, 1)
    # the launch path itself never takes a CPU tensor
    kern.dtype = torch.float32
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.fused_step(kern, ctx._state, 0)
    assert fused_stencil.fused_step.launches == n0


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from yask_tpu_torch.ops import _build
    monkeypatch.setattr(_build.shutil, "which", lambda _n: None)
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False if p.endswith("nvcc") else
                        os.path.isfile(p))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(YaskException, match="nvcc not found"):
        _build.build_many([("k_missing", "// nothing\n")])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name,r", [("iso3dfd", 8), ("3axis", 1)])
def test_fused_kernel_matches_plain_on_card(cuda_device, name, r):
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    ctxs = {}
    for mode in ("torch", "fused"):
        ctx = fac.new_solution(env, stencil=name, radius=r)
        ctx.apply_command_line_options(
            f"-g 48 -mode {mode} -wf_steps 2 -no-skew")
        ctx.prepare_solution()
        ctxs[mode] = ctx
    state = seeded_interiors(ctxs["torch"], 4)
    for ctx in ctxs.values():
        import_interiors(ctx, state)
    n0 = fused_stencil.fused_step.launches
    for ctx in ctxs.values():
        ctx.run_solution(0, 4)
    assert fused_stencil.fused_step.launches - n0 == 5
    # nvcc contracts multiply-adds into FMAs: field-scale tolerance
    assert ctxs["fused"].compare_data(ctxs["torch"], field_epsilon=1e-4) \
        == 0
