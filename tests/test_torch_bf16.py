"""Element size 2 (bfloat16) in the port: the program dtype without
``ml_dtypes``, the bfloat16 arithmetic of the plain version, and the
element-size-2 arm of K1 and of its stream arm.

* ``-mode torch`` and ``-mode fused`` (the plain version on CPU tensors)
  on iso3dfd r=2 and 3axis at element size 2, with ``ml_dtypes`` hidden
  from the port, against ``yask_tpu`` jit at element size 2 as
  tests/test_config_matrix.py runs it: g = 24, ``init_solution_vars``, 2
  steps, tolerance (3e-2, 3e-2) (its line 66: the two packages round bf16
  at other places).
* The emitted source built by g++ (the host bf16_t of
  ``csrc/fused_step.cuh``) against the plain version: bit-equal, K1's
  entry and the stream arm's, and a solution whose constants round
  differently in float and in bfloat16 (they round to bfloat16 first).
* The stream arm's device code emulated on the CPU (see
  tests/test_torch_kernel_emulation.py): two points a thread, its rings
  filled with 16-byte units from the unit holding each row's first cell,
  at row shifts 0 and 1, against the plain version to the bit
  (tests/test_torch_pair_emulation.py covers all 8 shifts).
"""

import importlib
import sys

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.compiler import lowering
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import host_kernel
from test_torch_ensemble import members_match_solo
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_stencils import tpu_interiors

#: tests/test_config_matrix.py:66
BF16_EPS = 3e-2


def bf16_source(pkg, name, r):
    sb = importlib.import_module(
        pkg + ".compiler.solution_base").create_solution(name, radius=r)
    sb.get_soln().set_element_bytes(2)
    return sb


def port_ctx(name, r, cli):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"),
                           bf16_source("yask_tpu_torch", name, r))
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("mode", ["torch", "fused"])
@pytest.mark.parametrize("name,r", [("iso3dfd", 2), ("3axis", 1)])
def test_bf16_matches_yask_tpu_jit_without_ml_dtypes(name, r, mode,
                                                     monkeypatch):
    import torch
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
    mine = port_ctx(name, r, f"-g 24 -mode {mode} -wf_steps 2")
    assert mine.get_element_bytes() == 2
    port_init(mine)
    mine.run_solution(0, 1)
    assert all(a.dtype == torch.bfloat16 for ring in mine._state.values()
               for a in ring)
    got = export_interiors(mine)
    assert all(a.dtype == np.float32 for s in got.values() for a in s)
    assert mismatches(got, want, BF16_EPS, BF16_EPS) == 0
    if mode == "fused":
        assert mine.get_stats().get_tiling()["kernel"] == "stream_step"


def test_plain_version_and_oracle_agree_to_the_bit():
    """The torch plain version and the numpy oracle share bfloat16's
    arithmetic (each op in float, rounded once; scalars rounded first):
    the same bits."""
    ctxs = {}
    for mode in ("torch", "ref"):
        ctxs[mode] = port_ctx("iso3dfd", 2, f"-g 12 -mode {mode}")
        import_interiors(ctxs[mode], seeded_interiors(ctxs[mode], 2))
        ctxs[mode].run_solution(0, 2)
    assert ctxs["torch"].compare_data(ctxs["ref"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0


def test_the_program_dtype_is_a_tagged_numpy_dtype(monkeypatch):
    import torch
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    ctx = port_ctx("3axis", 1, "-g 8 -mode torch")
    dt = ctx._program.dtype
    assert lowering.is_bfloat16(dt) and lowering.dtype_name(dt) == \
        "bfloat16" and np.dtype(dt).itemsize == 2
    assert lowering.torch_dtype(dt) == torch.bfloat16
    assert not lowering.is_bfloat16(np.float32)
    # the padded minor extent is even at element size 2
    assert ctx._program.geoms["A"].shape[-1] % 2 == 0


def test_round_bf16_matches_torch():
    """numpy's rounding (the oracle's, without a bfloat16 dtype) against
    torch's float32 -> bfloat16: ties to even, overflow to inf, NaN."""
    import torch
    rng = np.random.RandomState(0)
    x = np.concatenate([
        (rng.randn(20000) * 10.0 ** rng.randint(-30, 30, 20000)),
        np.arange(1, 2000), [0.0, -0.0, np.inf, -np.inf, 3.4e38,
                             1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]])
    x = x.astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(lowering.round_bf16(x), want)
    assert np.isnan(lowering.round_bf16(np.float32("nan")))


@pytest.mark.parametrize("name,r", [("iso3dfd", 2), ("3axis", 1)])
def test_emitted_bf16_kernels_match_plain_gxx(name, r, tmp_path):
    """K1's entry and the stream arm's (``host_stream``: K1's host loop,
    then zero pads) against the plain version, bit-equal, into NaN-filled
    outputs."""
    import torch
    ctx = port_ctx(name, r, "-g 13 -mode fused")
    import_interiors(ctx, seeded_interiors(ctx, 11))
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    assert "typedef yt::bf16_t real_t;" in spec.source
    assert spec.stream is not None
    state = ctx._state
    for entry in (spec.name, spec.name + "_stream"):
        (tmp_path / entry).mkdir()
        fn = host_kernel(spec, tmp_path / entry, entry)
        if entry.endswith("_stream"):
            fn.argtypes = fused_stencil.stream_argtypes()
        for t in (0, 1):
            ins = [state[n][s] for n, s in spec.inputs]
            outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                               dtype=torch.bfloat16) for n in spec.outputs]
            call = (fused_stencil.call_stream_entry if entry.endswith(
                "_stream") else fused_stencil.call_entry)
            assert call(fn, prog, spec, ins, outs, t, None) == 0
            want = fused_stencil.plain_chunk(prog, state, t, 1)
            for n, a in zip(spec.outputs, outs):
                idx = ctx._interior_idx(n)
                assert torch.equal(a[idx], want[n][-1][idx])
                if entry.endswith("_stream"):   # it zeroes the pads too
                    assert torch.equal(a, want[n][-1])


def consts():
    """``a(t+1, x) = a(t, x) * 0.1 + a(t, x - 1) * 0.3 + 0.7`` at element
    size 2: none of the constants is a bfloat16 value."""
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("bf16_consts")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    a = s.new_var("a", [t, x])
    a(t + 1, x).EQUALS(a(t, x) * 0.1 + a(t, x - 1) * 0.3 + 0.7)
    s.set_element_bytes(2)
    return s


def test_constants_round_to_bf16_first(tmp_path):
    """Over the values 1..1999 the kernel (g++) gives the plain version's
    bits, and those are the rule's: each constant rounded to bfloat16
    before its op (``yask_tpu``'s weak scalars), each op rounded once.
    Keeping the constants in float, as PyTorch's own bf16 multiply does,
    gives other bits on many cells."""
    import torch
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), consts())
    ctx.apply_command_line_options("-g 1999 -mode fused")
    ctx.prepare_solution()
    vals = np.arange(1, 2000, dtype=np.float64)
    import_interiors(ctx, {"a": [vals, vals]})
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    assert "yt::rbf(v0 * yt::rbf((float)((0x1.999999999999ap-4))))" \
        in spec.source
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms["a"].shape), float("nan"),
                       dtype=torch.bfloat16)]
    assert fused_stencil.call_entry(fn, prog, spec, ins, outs, 0, None) == 0
    idx = ctx._interior_idx("a")
    want = fused_stencil.plain_chunk(prog, state, 0, 1)["a"][-1][idx]
    assert torch.equal(outs[0][idx], want)

    def rule(c):
        def rb(v):
            return v.to(torch.bfloat16).float()
        a = state["a"][-1][idx].float()
        am = torch.cat([torch.zeros(1), a[:-1]])     # x - 1, 0 in the pad
        return rb(rb(rb(a * c(0.1)) + rb(am * c(0.3))) + c(0.7))
    bf16_rule = rule(lambda v: float(lowering.round_bf16(v)))
    float_rule = rule(lambda v: float(np.float32(v)))
    assert torch.equal(bf16_rule.to(torch.bfloat16), want)
    assert int((float_rule.to(torch.bfloat16) != want).sum()) > 100


def test_index_values_and_functions_in_bf16_match_plain_gxx(tmp_path):
    """cond_funcs at element size 2: domain indices with float constants
    give float32 (unrounded, as PyTorch and JAX promote them), which wins
    over bfloat16; functions of bfloat16 values round once.  Tolerance:
    one bfloat16 ulp, where g++'s libm and PyTorch's vectorized
    ``sin``/``cos``/``exp`` differ in float by an ulp (as in
    test_torch_fused's fp32 case)."""
    import torch
    from test_torch_fused import cond_funcs
    s = cond_funcs("yask_tpu_torch")
    s.set_element_bytes(2)
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), s)
    ctx.apply_command_line_options("-g 12 -mode fused")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 3))
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    assert "const float v25 = v24 * (float)(" in spec.source   # an F op
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    for t in (0, 1, 2):
        ins = [state[n][s_] for n, s_ in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                           dtype=torch.bfloat16) for n in spec.outputs]
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t,
                                        None) == 0
        want = prog.step(state, t)
        for n, a in zip(spec.outputs, outs):
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx].float(),
                                       want[n][-1][idx].float(),
                                       rtol=2 ** -8, atol=1e-6)


def stream_bf16(r, cli):
    ctx = port_ctx("iso3dfd", r, f"-g_x 9 -g_y 19 -g_z 70 -mode fused "
                   f"-skew {cli}")
    import_interiors(ctx, seeded_interiors(ctx, 7))
    assert ctx._fused_spec_kernel().skew_dims == ["x"]
    return ctx


def emulated_stream_steps(ctx, fn, seg=4, steps=2):
    import torch
    prog = ctx._program
    spec = ctx._fused_spec_kernel().spec
    state = ctx._state
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        fused_stencil.check_pair_strides(prog, spec, ins)
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                           dtype=torch.bfloat16) for n in spec.outputs]
        assert fused_stencil.call_stream_entry(fn, prog, spec, ins, outs, t,
                                               None, seg=seg) == 0
        state = fused_stencil._rotated(prog, spec, state, outs)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, steps)
    return all(torch.equal(state[n][-1], want[n][-1]) for n in spec.outputs)


@pytest.mark.parametrize("cli,shift", [("", 0), ("-mp_z 1", 1)])
def test_stream_arm_pairs_match_plain_when_emulated(cli, shift, tmp_path):
    """The stream arm's device code at element size 2 (threads, NaN-filled
    shared memory, deferred cp.async), its rings filled with 16-byte
    units from the unit that holds each row's first cell, which is one
    cell into its unit when the pads put the interior at an odd element
    (z pad 3 with a halo of 2)."""
    ctx = stream_bf16(2, cli)
    g = ctx._program.geoms["pressure"]
    assert (g.pads["z"][0] - 2) % 2 == shift
    spec = ctx._fused_spec_kernel().spec
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream")
    assert emulated_stream_steps(ctx, fn)


def test_stream_emulation_fails_with_the_wrong_pair_shift(tmp_path):
    """Taking every row as starting at the row's first cell where that
    cell lies one cell into its 16-byte unit misaligns every 16-byte
    copy, which faults on the card (the emulation never completes it)."""
    ctx = stream_bf16(2, "-mp_z 1")
    spec = ctx._fused_spec_kernel().spec

    def no_shift(name, text):
        if name != "stream_step.cuh":
            return text
        old = ("return int((reinterpret_cast<unsigned long long>(p.in[a] "
               "+ x) >> 1) & 7);")
        assert old in text
        return text.replace(old, "return 0;")
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stream",
                         edit=no_shift)
    assert not emulated_stream_steps(ctx, fn)


def test_k1_device_code_at_bf16_matches_plain_when_emulated(tmp_path):
    import torch
    ctx = port_ctx("iso3dfd", 2, "-g_x 11 -g_y 19 -g_z 70 -mode fused "
                   "-no-skew")
    import_interiors(ctx, seeded_interiors(ctx, 5))
    prog = ctx._program
    spec = ctx._fused_spec_kernel().spec
    fn = emulated_kernel(spec, tmp_path)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.zeros(tuple(prog.geoms[n].shape), dtype=torch.bfloat16)
            for n in spec.outputs]
    assert fused_stencil.call_entry(fn, prog, spec, ins, outs, 0, None) == 0
    want = fused_stencil.plain_chunk(prog, state, 0, 1)
    assert torch.equal(outs[0], want["pressure"][-1])


def test_pair_copies_need_even_row_strides():
    import torch
    ctx = port_ctx("iso3dfd", 2, "-g 12 -mode fused")
    spec = ctx._fused_spec_kernel().spec
    ins = [ctx._state[n][s] for n, s in spec.inputs]
    fused_stencil.check_pair_strides(ctx._program, spec, ins)
    a = spec.tiled[0]
    ins[a] = torch.zeros(ins[a].shape[:-1] + (ins[a].shape[-1] + 1,),
                         dtype=torch.bfloat16)
    with pytest.raises(YaskException, match="even row and plane strides"):
        fused_stencil.check_pair_strides(ctx._program, spec, ins)


def test_bf16_on_k6_refuses_naming_its_item():
    """What K6 refused before its element-size-2 arm ("element size 2 on
    K6", no longer raised anywhere): tti r=2 in bfloat16 prepares under
    ``-mode fused`` and runs on K6 (its plain version on CPU tensors),
    bit-equal to ``-mode torch`` from the same state."""
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = fac.new_solution(fac.new_env(device="cpu"),
                               bf16_source("yask_tpu_torch", "tti", 2))
        ctx.apply_command_line_options(f"-g 12 -mode {mode}")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 4))
        ctx.run_solution(0, 1)
        ctxs[mode] = ctx
    assert cuda_emit.fused_applicable(ctxs["fused"]._program) == (True, "ok")
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0
    til = ctxs["fused"].get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["scratch_stages"] > 0


def test_bf16_refuses_k5_k7_and_falls_back_from_k4():
    """What this test pinned before K5 took the A3 arms (the refusal
    "element size 2 ... ROADMAP.md A11 (A3 arms on K5)") is gone:
    shard_pallas runs iso3dfd in bfloat16, bit-equal to shard_map; K7
    takes element size 2; what it pinned of K4 (the fallback naming
    ROADMAP.md A12 (A3 arms on K4)) is gone too: K4 runs in bfloat16,
    bit-equal to the K1 path."""
    from test_torch_k5_arms import shard_pallas_matches_shard_map
    outs = shard_pallas_matches_shard_map(
        lambda: bf16_source("yask_tpu_torch", "iso3dfd", 2),
        "-g 16 -nr_x 2 -wf_steps 2")
    assert all(a.dtype == np.float32 for ring in outs["shard_pallas"].values()
               for a in ring)
    # K7 takes element size 2 (ROADMAP.md A9 is done): each member of a
    # batch bit-equal to its solo run
    members_match_solo(lambda: port_ctx("iso3dfd", 2, "-g 16 -mode fused "
                                        "-wf_steps 2 -ensemble 2"))
    ctxs = {}
    for cli in ("-trapezoid", "-no-trapezoid"):
        ctx = port_ctx("iso3dfd", 2, "-g 24 -mode fused -wf_steps 4 " + cli)
        if cli == "-trapezoid":
            ctx._trapezoid_arg = lambda: True
        import_interiors(ctx, seeded_interiors(ctx, 3))
        ctx.run_solution(0, 3)
        ctxs[cli] = ctx
    spec = ctxs["-trapezoid"]._trapezoid_kernel().spec
    assert "typedef yt::bf16_t real_t;" in spec.source
    assert ctxs["-trapezoid"].compare_data(
        ctxs["-no-trapezoid"], epsilon=0.0, abs_epsilon=0.0) == 0


def test_transfer_carries_bf16_interiors_both_ways():
    """Export widens to float32 exactly; import of float32 bf16 values,
    or of a bfloat16 numpy array of another package, is exact."""
    ctx = port_ctx("3axis", 1, "-g 10 -mode torch")
    vals = lowering.round_bf16(np.random.RandomState(1).rand(10, 10, 10))
    import_interiors(ctx, {"A": [vals, vals * 2]})
    out = export_interiors(ctx)["A"]
    np.testing.assert_array_equal(out[0], vals)
    np.testing.assert_array_equal(out[1], vals * 2)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(),
                               bf16_source("yask_tpu", "3axis", 1))
    theirs.apply_command_line_options("-g 10")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    theirs.run_solution(0, 0)
    src = tpu_interiors(theirs)
    assert src["A"][0].dtype.name == "bfloat16"
    import_interiors(ctx, src)
    for a, b in zip(src["A"], export_interiors(ctx)["A"]):
        np.testing.assert_array_equal(a.astype(np.float32), b)


def test_checkpoint_names_the_bf16_dtype(tmp_path):
    from yask_tpu_torch.resilience.checkpoint import (apply_snapshot,
                                                      extract_snapshot)
    ctx = port_ctx("3axis", 1, "-g 10 -mode torch")
    import_interiors(ctx, seeded_interiors(ctx, 1))
    snap = extract_snapshot(ctx)
    assert snap["meta"]["dtype"] == "bfloat16"
    other = port_ctx("3axis", 1, "-g 10 -mode ref")
    assert apply_snapshot(other, snap)
    assert other.compare_data(ctx, epsilon=0.0, abs_epsilon=0.0) == 0

