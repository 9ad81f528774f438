"""K4 on every registered solution, on the CPU, through its own code.

Each registered solution, at element sizes 4 and 2, is prepared under
``-mode fused -wf_steps 2 -trapezoid`` with its request forced
(``build_pallas_chunk(trapezoid=True)``'s counterpart) on a small grid:
each trapezoid dim twice the band floor ``2·(K−1)·r + 1`` of its fused
radius ``r`` (so the plan's block divides it and the pads hold the
diamond windows), every other dim 8.  The only refusals allowed are the
reference's own: no eligible dim (K < 2, radius 0, a written var lacking
a domain dim: ``trapezoid_eligible_dims`` is empty).  Every other
solution's emitted
K4 source is built with g++ (all of one element size in one translation
unit, the two built side by side, ``-O0``) and one group of its host path
(NaN-filled level buffers and outputs) is held against ``plain_chunk``:
bit-equal, except where a point function calls a libm function whose
g++ and PyTorch versions differ by an ulp (rtol 1e-5, atol 1e-6; at
element size 2 that ulp may move the bfloat16 result by one of its own:
rtol 1e-2).
"""

import ctypes
import os
import re
import shutil
import subprocess

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import (create_solution,
                                                   get_registered_solutions)
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.transfer import import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import CSRC
from test_torch_k4_arms import seeded_physical
from test_torch_k4_host import assert_states, host_group

K = 2
#: libm functions whose g++ and PyTorch CPU results may differ by an ulp
LIBM = re.compile(r"yt::f_(sin|cos|tan|asin|acos|atan|exp|log|pow|erf|"
                  r"cbrt)\(")


def sweep_ctx(name, eb):
    fac = yask_tpu_torch.yk_factory()
    probe = fac.new_solution(fac.new_env(device="cpu"),
                             create_solution(name))
    dims = probe._ana.domain_dims
    rad = probe._ana.fused_step_radius()
    sizes = {d: max(8, 2 * (2 * (K - 1) * rad.get(d, 0) + 1))
             if d in dims[:-1][-2:] else 8 for d in dims}
    src = create_solution(name)
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    ctx._trapezoid_arg = lambda: True
    ctx.apply_command_line_options(
        " ".join(f"-g_{d} {n}" for d, n in sizes.items())
        + f" -mode fused -wf_steps {K} -trapezoid")
    ctx.prepare_solution()
    return ctx


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Per (solution, element size): (context, spec or the refusal), and
    per element size the library every spec of it is built into."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test K4's host path"
    tmp = tmp_path_factory.mktemp("k4_sweep")
    cases, procs, libs = {}, {}, {}
    for eb in (4, 2):
        sources = {}
        for name in get_registered_solutions():
            ctx = sweep_ctx(name, eb)
            try:
                spec = cuda_emit.resolve_trapezoid(ctx._program, K, True)
            except YaskException as e:
                cases[name, eb] = (ctx, e)
                continue
            cases[name, eb] = (ctx, spec)
            sources[spec.name] = spec.source
        body = ['#include "trapezoid.cuh"']
        for i, src in enumerate(sources.values()):
            body.append(f"namespace k{i} {{\n"
                        + src.replace('#include "trapezoid.cuh"', "")
                        + "\n}")
        cpp = tmp / f"k4_sweep_{eb}.cpp"
        cpp.write_text("\n".join(body))
        so = tmp / f"k4_sweep_{eb}.so"
        procs[eb] = subprocess.Popen(
            [gxx, "-std=c++17", "-O0", "-shared", "-fPIC", "-I", CSRC,
             "-o", str(so), str(cpp)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
        libs[eb] = so
    for eb, proc in procs.items():
        _out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err.decode()[-3000:]
        libs[eb] = ctypes.CDLL(str(libs[eb]))
    return cases, libs


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", get_registered_solutions())
def test_k4_runs_every_registered_solution(sweep, name, eb):
    cases, libs = sweep
    ctx, spec = cases[name, eb]
    prog = ctx._program
    if isinstance(spec, YaskException):
        assert cuda_emit.trapezoid_eligible_dims(prog, K) == []
        assert "trapezoid tiling needs K >= 2" in str(spec)
        return
    assert spec.trap["trap_dims"] == prog.ana.domain_dims[:-1][-2:]
    fn = getattr(libs[eb], spec.name)
    fn.argtypes = fused_stencil.trapezoid_argtypes()
    fn.restype = ctypes.c_int
    import_interiors(ctx, seeded_physical(ctx, 5))
    got = host_group(fn, prog, spec, ctx._state, 0)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    if not LIBM.search(spec.source):
        assert_states(got, want)
    elif eb == 4:
        assert_states(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert_states(got, want, rtol=1e-2, atol=1e-5)
