"""Element size 2 (bfloat16) on K6: multi-stage solutions and scratch vars
in ``-mode fused``, their stage and scratch tiles held in bfloat16 as
``yask_tpu`` stores them (each value rounded once).

* ``-mode fused`` (the plain version on CPU tensors) on tti r=2 (scratch
  vars), ssg (2 stages) and awp (4 stages, rewrites) at element size 2,
  with ``ml_dtypes`` hidden from the port, against ``yask_tpu`` jit at
  element size 2 as tests/test_config_matrix.py runs it: g = 24,
  ``init_solution_vars``, 2 steps, tolerance (3e-2, 3e-2) (its line 66:
  the two packages may round bfloat16 at other places).  The cells whose
  bits differ are counted too: 0 for all three, asserted.
* The emitted K6 sources built by g++ (``host_stages``, the host bf16_t)
  and K6's device code emulated on the CPU (tests/test_torch_kernel_
  emulation.py's shim) against the plain version, from states whose
  read-only inputs carry nonzero pads, into NaN-filled outputs:
  bit-equal, tti's ``sinf``/``cosf`` included (rounded to bfloat16, the
  ulp by which libm and PyTorch's vectorized CPU functions may differ in
  float does not reach these bits).
* The RTM pipeline's push arm at element size 2 (``dtype=BFLOAT16``): the
  image pushed, emulated K6 against the plain version to the bit, and
  fused against host-chained.
"""

import sys

import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.compiler.lowering import BFLOAT16
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_bf16 import BF16_EPS, bf16_source, port_ctx
from test_torch_fused import host_kernel
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_scratch import with_pads
from test_torch_stencils import tpu_interiors

#: ragged sizes for K6's bfloat16 tiles (several blocks in every tiled
#: slot, a partial last one)
RAGGED = {"tti": "-g_x 11 -g_y 19 -g_z 70", "ssg": "-g_x 6 -g_y 9 -g_z 70",
          "awp": "-g_x 6 -g_y 9 -g_z 70", "fsg": "-g_x 6 -g_y 9 -g_z 70",
          "gaussian": "-g_x 11 -g_y 70", "swe2d": "-g_x 19 -g_y 70"}
RADIUS = {"tti": 2, "ssg": 2, "fsg": 2, "gaussian": 2}


@pytest.mark.parametrize("name", ["tti", "ssg", "awp"])
def test_bf16_k6_matches_yask_tpu_jit_without_ml_dtypes(name, monkeypatch):
    import torch
    r = RADIUS.get(name)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(),
                               bf16_source("yask_tpu", name, r))
    theirs.apply_command_line_options("-g 24")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    theirs.run_solution(0, 1)
    want = tpu_interiors(theirs)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    mine = port_ctx(name, r, "-g 24 -mode fused -wf_steps 2")
    port_init(mine)
    mine.run_solution(0, 1)
    assert all(a.dtype == torch.bfloat16 for ring in mine._state.values()
               for a in ring)
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["stages"] > 1
    got = export_interiors(mine)
    assert mismatches(got, want, BF16_EPS, BF16_EPS) == 0
    assert sum(int((a != b).sum()) for n in got
               for a, b in zip(got[n], want[n])) == 0


def k6_steps(fn, ctx, spec, steps=2):
    """``steps`` sub-steps of a K6 entry on CPU bfloat16 tensors from the
    plain version's states, into NaN-filled outputs (one resident block
    walking every tile where the flat arm runs emulated); yields
    (outputs, the plain version's)."""
    import torch
    prog, state = ctx._program, ctx._state
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                           dtype=torch.bfloat16) for n in spec.outputs]
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t,
                                        None, nres=1) == 0
        want = prog.step(state, t)
        yield outs, [want[n][-1] for n in spec.outputs]
        state = want


def same_bits(ctx, spec, fn):
    import torch
    for outs, want in k6_steps(fn, ctx, spec):
        for n, a, w in zip(spec.outputs, outs, want):
            idx = ctx._interior_idx(n)
            assert torch.equal(a[idx], w[idx]), n
            if spec.flat:   # the flat arm writes its pads too: zeros
                assert int((a != 0).sum()) == int((a[idx] != 0).sum())
            else:
                assert int(torch.isnan(a).sum()) == a.numel() - a[idx].numel()


@pytest.mark.parametrize("name", ["tti", "ssg", "awp", "fsg", "gaussian",
                                  "swe2d"])
def test_bf16_k6_emitted_matches_plain_gxx(name, tmp_path):
    ctx = port_ctx(name, RADIUS.get(name), f"{RAGGED[name]} -mode fused")
    with_pads(ctx, 13)
    spec = cuda_emit.emit(ctx._program)
    assert spec.stages > 1 and "yt::bf16_t real_t" in spec.source
    same_bits(ctx, spec, host_kernel(spec, tmp_path))


@pytest.mark.parametrize("name", ["tti", "awp", "gaussian"])
def test_bf16_k6_device_code_emulated_matches_plain(name, tmp_path):
    """K6's shared-memory tiles in bfloat16: staged inputs with their
    pads, scratch tiles past the domain (tti), a tile per rewriting stage
    (awp), misc slices (gaussian)."""
    ctx = port_ctx(name, RADIUS.get(name), f"{RAGGED[name]} -mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)
    same_bits(ctx, spec, emulated_kernel(spec, tmp_path))


@pytest.mark.parametrize("name,tile32,tile16", [
    ("tti", (2, 8, 64), (8, 8, 64)), ("awp", (1, 4, 64), (4, 8, 64))])
def test_bf16_k6_tiles_take_two_bytes(name, tile32, tile16):
    """The ladder counts K6's staged and computed tiles at 2 bytes, so
    the bfloat16 solution gets a larger tile than the float32 one."""
    fac = yask_tpu_torch.yk_factory()
    specs = {}
    for eb in (4, 2):
        src = bf16_source("yask_tpu_torch", name, RADIUS.get(name))
        src.get_soln().set_element_bytes(eb)
        ctx = fac.new_solution(fac.new_env(device="cpu"), src)
        ctx.apply_command_line_options("-g 64 -mode fused")
        ctx.prepare_solution()
        specs[eb] = cuda_emit.emit(ctx._program)
    assert specs[4].tile == tile32 and specs[2].tile == tile16
    elems = int(specs[2].source.split("SMEM_ELEMS = ")[1].split(",")[0])
    assert specs[2].smem_bytes == 2 * elems <= cuda_emit.SMEM_LIMIT


def rtm_pipe(fuse, g=20):
    import numpy as np
    fac = yask_tpu_torch.yk_factory()
    pipe = SolutionPipeline(fac.new_env(device="cpu"),
                            *rtm_chain(radius=2, accumulate=False),
                            dtype=BFLOAT16)
    pipe.apply_command_line_options(f"-g {g} -mode fused -wf_steps 1")
    pipe.prepare(fuse=fuse)
    rng = np.random.RandomState(7)
    v = pipe.get_var("fwd", "pressure")
    arr = (rng.rand(g, g, g) - 0.5) * 0.1
    for t in range(v.get_first_valid_step_index(),
                   v.get_last_valid_step_index() + 1):
        v.set_elements_in_slice(arr, [t, 0, 0, 0], [t] + [g - 1] * 3)
    pipe.get_var("fwd", "vel").set_elements_in_slice(
        0.05 + 0.01 * rng.rand(g, g, g), [0, 0, 0], [g - 1] * 3)
    return pipe


def test_bf16_push_arm_of_the_rtm_pipeline(tmp_path):
    """The merged RTM chain at element size 2 pushes its image (a bfloat16
    tile that never leaves shared memory): K6's device code emulated
    against the plain version to the bit, and the fused pipeline against
    the host-chained one."""
    fused = rtm_pipe(True)
    assert fused.pushed_vars() == {"img__img"}
    ctx = fused._fused_ctx
    assert ctx.get_element_bytes() == 2
    spec = cuda_emit.emit(ctx._program, True)
    assert spec.push_vars == ["img__img"]
    fn = emulated_kernel(spec, tmp_path)
    for outs, want in k6_steps(fn, ctx, spec):
        for n, a, w in zip(spec.outputs, outs, want):
            idx = ctx._interior_idx(n)
            assert bool((a[idx] == w[idx]).all()), n
    chained = rtm_pipe(False)
    for p in (fused, chained):
        p.run(0, 3)
    assert fused.compare(chained) == 0


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
@pytest.mark.parametrize("name", ["tti", "ssg", "awp"])
def test_bf16_k6_matches_plain_on_card(cuda_device, name):
    """K6 at element size 2 against the plain version on CUDA tensors from
    one seeded state, K = 2, 4 steps: 0 mismatches at field_epsilon 1e-2
    (an ulp of bfloat16), one launch per step."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    ctxs = {}
    for mode in ("torch", "fused"):
        ctx = fac.new_solution(env, bf16_source("yask_tpu_torch", name,
                                                RADIUS.get(name)))
        ctx.apply_command_line_options(f"-g 37 -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        ctxs[mode] = ctx
    state = seeded_interiors(ctxs["torch"], 6)
    for ctx in ctxs.values():
        import_interiors(ctx, state)
    n0 = fused_stencil.stages_step.launches
    for ctx in ctxs.values():
        ctx.run_solution(0, 3)
    assert fused_stencil.stages_step.launches - n0 == 4
    assert ctxs["fused"].compare_data(ctxs["torch"],
                                      field_epsilon=1e-2) == 0
