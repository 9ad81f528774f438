"""K6's scratch and rewrite arms as device code, run on the CPU block by
block (the g++ shim of tests/test_torch_kernel_emulation.py: one thread
per CUDA thread, a fixed order between barriers, NaN-filled shared
memory).  The host path (``host_stages``) reads global memory only, so it
cannot see what these arms add to the kernel: the staged pads, the grown
and clipped sub-stage regions, and a tile per rewriting stage.

Each case runs from a random state whose read-only inputs carry nonzero
pads, into NaN-filled outputs, at sizes that leave a partial last block
in every tiled slot.  Tolerance: none against the g++ host path (both
built by g++, the same operations in the same order); against the plain
version bit-equal too, except tti, whose ``sinf``/``cosf`` differ from
PyTorch's vectorized CPU ``sin``/``cos`` by an ulp (rtol 1e-5, atol
1e-6)."""

import dataclasses
import re

import pytest

from yask_tpu_torch.ops import cuda_emit

from test_torch_fused import _multi_stage, host_kernel
from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import k6_launch, port_ctx, ragged, with_pads


def build_dir(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    return d


def run_both(ctx, spec, emu, host, steps=2):
    """``steps`` sub-steps of the emulated kernel and the host path from
    the same states (the plain version's), into NaN-filled outputs;
    yields (output names, emulated, host, plain) per step."""
    state = ctx._state
    for t in range(steps):
        a = k6_launch(emu, ctx, spec, state, t, float("nan"))
        b = k6_launch(host, ctx, spec, state, t, float("nan"))
        want = ctx._program.step(state, t)
        yield a, b, [want[n][-1] for n in spec.outputs]
        state = want


@pytest.mark.parametrize("name,r", [("tti", 2), ("test_scratch_3d", None),
                                    ("swe2d", None), ("awp", None)])
def test_k6_arms_emulated_match_host_path(name, r, tmp_path):
    import torch
    ctx = port_ctx(name, r, f"{ragged(name)} -mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)
    emu = emulated_kernel(spec, build_dir(tmp_path, "emu"))
    host = host_kernel(spec, tmp_path)
    tol = dict(rtol=1e-5, atol=1e-6) if name == "tti" else \
        dict(rtol=0, atol=0)
    for got, host_out, want in run_both(ctx, spec, emu, host):
        for n, a, b, w in zip(spec.outputs, got, host_out, want):
            # every interior cell written, the pads untouched (NaN)
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx], w[idx], **tol)


def test_emulation_fails_when_scratch_past_the_domain_is_zeroed(tmp_path):
    """A kernel that computes scratch cells inside the domain only (and
    zeroes the rest, as it does for written vars) gives tti's Hz at the
    domain's faces from zeros: the emulation sees it."""
    import torch
    ctx = port_ctx("tti", 2, f"{ragged('tti')} -mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)

    def domain_only(fn, text):
        if fn != "fused_step.cuh":
            return text
        text, n = re.subn(r"S::clip_(lo|hi)([012])\(K\)", "0", text)
        assert n >= 6
        return text
    emu = emulated_kernel(spec, build_dir(tmp_path, "emu"),
                          edit=domain_only)
    host = host_kernel(spec, tmp_path)
    got, host_out, _want = next(run_both(ctx, spec, emu, host, steps=1))
    assert not all(torch.equal(a, b) for a, b in zip(got, host_out))


def test_emulation_fails_with_one_tile_for_a_rewrite(tmp_path):
    """A rewrite that reads this step's value of its neighbour (x - 1)
    and writes the tile it reads from races with its neighbours' reads;
    K6 gives each writing stage a tile of its own.  Folding the rewrite's
    writes into the first stage's tile shows in the emulation."""
    import torch
    import yask_tpu_torch
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), _multi_stage())
    ctx.apply_command_line_options("-g 150 -mode fused")
    ctx.prepare_solution()
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)
    assert spec.computed == ["a"] and spec.stages == 2
    emu = emulated_kernel(spec, build_dir(tmp_path, "emu"))
    host = host_kernel(spec, tmp_path)
    got, host_out, want = next(run_both(ctx, spec, emu, host, steps=1))
    torch.testing.assert_close(got[0], host_out[0], rtol=0, atol=0,
                               equal_nan=True)
    # the rewrite (sub-stage 1) stores into sub-stage 0's tile, over that
    # tile's region
    shared, n = re.subn(r"(k == 1 && j == 0 \? )-1", r"\g<1>0",
                        spec.source)
    shared, m = re.subn(r"(sub_(lo|hi)2\(int k\) \{ return k == 0 \? 1 : "
                        r"k == 1 \? )0", r"\g<1>1", shared)
    assert (n, m) == (1, 2)
    bad = dataclasses.replace(spec, source=shared,
                              name=spec.name + "_shared")
    bad.source = bad.source.replace(spec.name, bad.name)
    emu = emulated_kernel(bad, build_dir(tmp_path, "bad"))
    got, _h, _w = next(run_both(ctx, bad, emu, host, steps=1))
    assert not torch.equal(got[0][ctx._interior_idx("a")],
                           want[0][ctx._interior_idx("a")])


def test_ssg_r4_runs_on_the_ladders_last_rungs_when_emulated(tmp_path):
    """ROADMAP.md C17: ssg r=4's tiles fit no rung down to 1×1×32 (251084
    B); the 1×1×16 rung (16 threads a block) takes them, and the emulated
    K6 matches the g++ host path and the plain version to the bit, every
    interior cell written and the pads untouched."""
    import torch
    ctx = port_ctx("ssg", 4, "-g_x 5 -g_y 4 -g_z 37 -mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)
    assert spec.tile == (1, 1, 16) and spec.smem_bytes <= cuda_emit.SMEM_LIMIT
    emu = emulated_kernel(spec, build_dir(tmp_path, "emu"))
    host = host_kernel(spec, tmp_path)
    for got, host_out, want in run_both(ctx, spec, emu, host):
        for n, a, b, w in zip(spec.outputs, got, host_out, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx], w[idx], rtol=0, atol=0)
