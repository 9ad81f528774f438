"""More than three domain dims in the port's fused kernels: K1's 4-D arm
(test_4d, and a written var lacking the outer dim) and K6's (a two-stage
solution with a scratch var, read at outer offsets, and a domain
condition on the outer dim; the same over two outer dims, 5-D).

The outer dim folds into the grid (one outer index per block); a read at
an outer offset is an input of its own; K6 computes what a later stage
reads at an outer offset in outer copies of the earlier sub-stages
(``cuda_emit._outer_copies``).

* ``-mode fused`` (the plain version on CPU tensors) against
  ``yask_tpu`` jit on the same numpy-seeded interiors, carried with
  ``transfer.py``: K ∈ {1, 2}, 3 steps, ``field_epsilon=1e-4`` (the
  repo's tolerance for a fused path against another evaluation order).
* The emitted sources built by g++ (the host paths ``host_step`` and
  ``host_stages``) and the kernels' device code emulated on the CPU
  (tests/test_torch_kernel_emulation.py's shim) against the plain
  version, from states whose read-only inputs carry nonzero pads, into
  NaN-filled outputs: bit-equal (``rtol=0, atol=0``); the pads stay NaN.
* The paths that do not take the arm: ``-trapezoid`` falls back to K1
  (A12) and ``shard_pallas`` raises (A11); a member batch (``-ensemble
  2``, K7) takes it, each member bit-equal to its solo run.
* Under ``-skew`` (the default) K6's stream arm takes four_d_stages and
  five_d (tests/test_torch_stream_4d_emulation.py holds its code) and
  K1's stream arm takes test_4d, solo and as a 3-member ``EnsembleRun``
  against ``yask_tpu``'s (tests/test_torch_stream_k1_4d_*.py hold its
  code); four_d_partial keeps K1 with its partial-dim reason.
* K1 folds the outer cells into the grid's z cells: past CUDA's limit of
  65535 the launch code walks them in several launches, which the
  emulated device code runs at a cap of 2.
"""

import importlib
import re

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import host_kernel
from test_torch_kernel_emulation import emulated_kernel
from test_torch_ensemble import members_match_solo
from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)
from test_torch_scratch import k6_launch, with_pads

#: small sizes with a partial last block in every tiled slot
SIZES = {"test_4d": "-g_w 4 -g_x 9 -g_y 11 -g_z 70",
         "four_d_stages": "-g_w 5 -g_x 5 -g_y 9 -g_z 70"}


def four_d_stages(pkg: str):
    """A 4-D solution on K6: a scratch var ``s`` read at outer offsets
    (w ± 1) by a conditional write of ``a`` whose domain condition takes
    the outer dim, and a second stage ``b`` that reads this step's ``a``
    at outer offsets, so that stage 1 is computed in outer copies."""
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution(
            "four_d_stages")
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


def five_d(pkg: str):
    """Two outer dims (v, w): a scratch var and a second stage read at
    offsets in both, so K6's outer copies span a 2-D range of offsets."""
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution("five_d")
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


def four_d_partial(pkg: str):
    """A written var lacking the outer dim (``p`` over x, y, z) beside a
    4-D one, on K1: only the blocks at outer index 0 store ``p``."""
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution(
            "four_d_partial")
    t = soln.new_step_index("t")
    w, x, y, z = (soln.new_domain_index(d) for d in "wxyz")
    a = soln.new_var("a", [t, w, x, y, z])
    p = soln.new_var("p", [t, x, y, z])
    p(t + 1, x, y, z).EQUALS(p(t, x, y + 1, z) * 0.5 + p(t, x, y, z) * 0.25
                             + 0.1)
    a(t + 1, w, x, y, z).EQUALS(a(t, w + 1, x, y, z) * 0.5
                                + a(t, w, x - 1, y, z) * 0.25
                                + p(t, x, y, z) * 0.1)
    return soln


BUILDERS = {"four_d_stages": four_d_stages, "five_d": five_d,
            "four_d_partial": four_d_partial}
SIZES.update({"five_d": "-g_v 3 -g_w 3 -g_x 3 -g_y 9 -g_z 70",
              "four_d_partial": "-g_w 4 -g_x 9 -g_y 11 -g_z 70"})
CASES = ["test_4d", "four_d_stages", "five_d", "four_d_partial"]


def source(pkg: str, case: str):
    """``(source, kwargs)`` for ``new_solution``."""
    if case in BUILDERS:
        return BUILDERS[case](pkg), {}
    return None, {"stencil": case}


def port_ctx(case, cli, env=None):
    fac = yask_tpu_torch.yk_factory()
    src, kw = source("yask_tpu_torch", case)
    ctx = fac.new_solution(env or fac.new_env(device="cpu"), src, **kw)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_fused_4d_matches_yask_tpu_jit(case, K):
    mine = port_ctx(case, f"{SIZES[case]} -mode fused -wf_steps {K}")
    tfac = yask_tpu.yk_factory()
    src, kw = source("yask_tpu", case)
    theirs = tfac.new_solution(tfac.new_env(), src, **kw)
    theirs.apply_command_line_options(SIZES[case])
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    state = seeded_interiors(mine, 17)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, 2)
    theirs.run_solution(0, 2)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == {"test_4d": "stream_step",
                             "four_d_partial": "fused_step"}.get(
                                 case, "stages_step")
    codes = {r["code"] for r in til["skew_reasons"]}
    if case == "four_d_partial":
        # the stream arm writes whole outputs: the partial-dim one keeps K1
        assert codes == {"skew_ineligible"}
        assert "partial-dim" in til["skew_reasons"][0]["detail"]
    elif case == "test_4d":
        # K1's stream arm walks slot 0 (x), each outer cell (w) a
        # coordinate of its work items
        assert codes == {"skew_engaged", "skew_ineligible"}
        assert til["skew_dims"] == ["x"]
        assert til["name"] == mine._fused_spec_kernel().spec.name + "_stream"
        assert til["stream"]["outer_cells"] == 4
        assert til["stream"]["segment_planes"] >= 1
    else:
        # K6's stream arm takes the outer dims as windows of its work
        # items, streaming slot 0 (x)
        assert codes == {"skew_engaged", "skew_ineligible"}
        assert til["skew_dims"] == ["x"]
        assert til["stages_stream"]["outer_window"]


def test_fused_4d_ensemble_matches_yask_tpu_ensemble():
    """A 3-member test_4d ``EnsembleRun`` under ``-mode fused`` (K7 over
    K1's stream arm, ``_stream_batched``; its plain version here) against
    ``yask_tpu``'s jit ensemble from the same numpy-seeded members:
    ``field_epsilon=1e-4``, 0 mismatches per member."""
    from yask_tpu.runtime.ensemble import EnsembleRun as TpuEnsembleRun
    cli = f"{SIZES['test_4d']} -wf_steps 2"
    mine = port_ctx("test_4d", f"{cli} -mode fused")
    ens = mine.new_ensemble(3)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil="test_4d")
    theirs.apply_command_line_options(cli)
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tens = TpuEnsembleRun(theirs, 3)
    for i in range(3):
        with ens.member(i) as c, tens.member(i) as tc:
            state = seeded_interiors(c, 30 + i)
            import_interiors(c, state)
            tpu_import(tc, state)
    ens.run(0, 2)
    tens.run(0, 2)
    til = ens.tiling
    assert til["kernel"] == "batched_step" and til["skew"] is True
    assert til["name"] == \
        mine._fused_spec_kernel().spec.name + "_stream_batched"
    for i in range(3):
        with ens.member(i) as c, tens.member(i) as tc:
            assert mismatches(export_interiors(c), tpu_export(tc),
                              field_epsilon=1e-4) == 0, i


def launches(fn, ctx, spec, steps=2):
    """``steps`` sub-steps of an entry from the plain version's states,
    into NaN-filled outputs; yields (outputs, the plain version's)."""
    state = ctx._state
    for t in range(steps):
        outs = k6_launch(fn, ctx, spec, state, t, float("nan"))
        want = ctx._program.step(state, t)
        yield outs, [want[n][-1] for n in spec.outputs]
        state = want


def same_as_plain(ctx, spec, fn):
    import torch
    for outs, want in launches(fn, ctx, spec):
        for n, a, w in zip(spec.outputs, outs, want):
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx], w[idx], rtol=0, atol=0)
            # every interior cell written, the pads untouched
            assert int(torch.isnan(a).sum()) == a.numel() - a[idx].numel()


@pytest.mark.parametrize("case", CASES)
def test_emitted_4d_matches_plain_gxx(case, tmp_path):
    ctx = port_ctx(case, f"{SIZES[case]} -mode fused")
    with_pads(ctx, 13)
    spec = cuda_emit.emit(ctx._program)
    assert spec.outer == len(ctx._ana.domain_dims) - 3
    same_as_plain(ctx, spec, host_kernel(spec, tmp_path))


@pytest.mark.parametrize("case", CASES)
def test_4d_device_code_emulated_matches_plain(case, tmp_path):
    ctx = port_ctx(case, f"{SIZES[case].replace('-g_w 5', '-g_w 3')} "
                         "-mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)
    same_as_plain(ctx, spec, emulated_kernel(spec, tmp_path))


def test_emulation_fails_without_the_outer_copy_offset(tmp_path):
    """K6 with every outer copy computed at the block's own outer index
    (its offset dropped) reads the wrong planes of the scratch var and of
    ``a``: the emulation sees it."""
    import torch
    ctx = port_ctx("four_d_stages", "-g_w 3 -g_x 5 -g_y 9 -g_z 70 "
                   "-mode fused")
    with_pads(ctx, 21)
    spec = cuda_emit.emit(ctx._program)

    def no_offset(fn, text):
        if fn != "fused_step.cuh":
            return text
        text, n = re.subn(r"\+ S::sub_dw\(K, j\)", "+ 0", text)
        assert n == 1
        return text
    fn = emulated_kernel(spec, tmp_path, edit=no_offset)
    outs, want = next(launches(fn, ctx, spec, steps=1))
    idx = ctx._interior_idx("b")
    b = spec.outputs.index("b")
    assert not torch.equal(outs[b][idx], want[b][idx])


def test_outer_copies_cover_the_reads_at_outer_offsets():
    """Stage 1 is read at w ± 1 by stage 2, and ``s`` at w ± 1 by ``a``:
    ``a`` is computed in 3 outer copies, ``s`` in 5 (its write halo on
    top), ``b`` in 1; only the copies at offset 0 store, and each input
    read at an outer offset is its own table entry."""
    ctx = port_ctx("four_d_stages", "-g_w 5 -g_x 5 -g_y 9 -g_z 70 "
                   "-mode fused")
    spec = cuda_emit.emit(ctx._program)
    dws = [int(m.group(2)) for m in re.finditer(
        r"k == (\d+) && j == 0 \? (-?\d+)",
        re.search(r"sub_dw\(int k, int j\) \{([^}]*)\}",
                  spec.source).group(1))]
    assert spec.stages == 9 and spec.scratch_stages == 5
    assert dws == [-2, -1, 0, 1, 2, -1, 0, 1, 0]
    assert spec.computed == ["s"] * 5 + ["a"] * 2
    assert ("a", 1) in spec.inputs and len(spec.in_outer) == \
        len(spec.inputs)
    assert sorted({o for (o,) in spec.in_outer}) == [-3, -2, -1, 0, 1, 2]
    assert cuda_emit.slot_map(["w", "x", "y", "z"]) == \
        {"w": 3, "x": 0, "y": 1, "z": 2}


def test_4d_trapezoid_falls_back_and_k5_k7_refuse():
    # what this test pinned before K4 took the 4-D arm (the fallback "4-D
    # ... ROADMAP.md A12 (4-D K4)") is gone: auto -trapezoid records the
    # gate's decision and K4 runs where it engages
    # (tests/test_torch_k4_4d.py holds K4's 4-D code)
    ctx = port_ctx("test_4d", "-g 8 -mode fused -wf_steps 2 -trapezoid")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    ctx.run_solution(0, 3)
    assert not [r for r in ctx._trap[1]
                if r["code"] == "trapezoid_fallback"]
    assert {r["code"] for r in ctx._trap[1]} & {"trapezoid_engaged",
                                                "trapezoid_gate_rejected"}
    # what this test pinned before K5 took the A3 arms (the refusal "4-D
    # ... ROADMAP.md A11 (A3 arms on K5)") is gone: shard_pallas runs
    # test_4d with the outer dim w sharded, bit-equal to shard_map
    from test_torch_k5_arms import shard_pallas_matches_shard_map
    shard_pallas_matches_shard_map(lambda: "test_4d", "-g 8 -nr_w 2")
    # K7 takes the 4-D arm (ROADMAP.md A9 is done)
    members_match_solo(lambda: port_ctx("test_4d", "-g 6 -mode fused "
                                        "-wf_steps 2 -ensemble 2"))


def test_transfer_round_trips_a_4d_interior():
    """A 4-D interior crosses into the port and back unchanged, its pads
    zero, and into ``yask_tpu`` the same."""
    ctx = port_ctx("test_4d", "-g_w 3 -g_x 4 -g_y 5 -g_z 6 -mode torch")
    state = {n: [np.asarray(a) for a in ring]
             for n, ring in seeded_interiors(ctx, 9).items()}
    assert state["u"][0].shape == (3, 4, 5, 6)
    import_interiors(ctx, state)
    back = export_interiors(ctx)
    for a, b in zip(state["u"], back["u"]):
        np.testing.assert_array_equal(a.astype(np.float32), b)
    for a in ctx._state["u"]:
        outside = a.clone()
        outside[ctx._interior_idx("u")] = 0
        assert not outside.any()
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil="test_4d")
    theirs.apply_command_line_options("-g_w 3 -g_x 4 -g_y 5 -g_z 6")
    theirs.prepare_solution()
    tpu_import(theirs, back)
    for a, b in zip(back["u"], tpu_export(theirs)["u"]):
        np.testing.assert_array_equal(a, b)


def test_a_grid_past_the_z_limit_raises():
    """K1 folds the outer cells into gridDim.z: more than 65535 of them
    times the slot-0 blocks no longer raise (ROADMAP.md C15; the launch
    code walks them in chunks): the wrapper's marshalling goes through,
    and on CPU tensors the only refusal left is the device's."""
    import torch
    ctx = port_ctx("test_4d", "-g_w 70000 -g_x 2 -g_y 2 -g_z 2 "
                   "-mode fused")
    kern = fused_stencil.FusedKernel(ctx._program)
    assert fused_stencil.grid_z(ctx._program, kern.spec) == 70000
    ins = [ctx._state[n][s] for n, s in kern.spec.inputs]
    outs = fused_stencil.copy_base(kern, ctx._state, "cpu")
    tabs = fused_stencil._arg_tables(ctx._program, kern.spec, ins, outs)
    assert list(tabs[-1]) == [2, 2, 2, 70000]
    kern.dtype = torch.float32
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.fused_step(kern, ctx._state, 0)


def test_a_grid_past_the_z_limit_runs_in_chunks_when_emulated(tmp_path):
    """The twin of the test above at a cap of 2 z cells per launch
    (``YT_MAX_GRID_Z``): K1's and K6's device code over 3 outer cells x
    2 slot-0 blocks, launched in three chunks, against the plain version
    to the bit."""
    for case, sizes in (("test_4d", "-g_w 3 -g_x 9 -g_y 11 -g_z 70"),
                        ("four_d_stages", "-g_w 3 -g_x 5 -g_y 9 -g_z 70")):
        ctx = port_ctx(case, f"{sizes} -mode fused")
        with_pads(ctx, 23)
        spec = cuda_emit.emit(ctx._program)
        assert fused_stencil.grid_z(ctx._program, spec) > 2
        (tmp_path / case).mkdir()
        same_as_plain(ctx, spec, emulated_kernel(
            spec, tmp_path / case, defines={"YT_MAX_GRID_Z": 2}))


def test_emit_digest_covers_every_registered_solution(tmp_path):
    """``python -m yask_tpu_torch.ops.emit_digest`` (the tool that holds
    an emitter change's sources against the parent's): one entry per
    registered solution and element size; since the last A3 arms, every
    solution emits at 2, 4 and 8 bytes (test_4d and bf16 tti among them),
    and the empty ones have no kernel (ROADMAP.md C14); a second run
    gives the same digests."""
    import json
    from yask_tpu_torch.compiler.solution_base import \
        get_registered_solutions
    from yask_tpu_torch.ops import emit_digest
    out = tmp_path / "digests.json"
    assert emit_digest.main([str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got) == {f"{n} {eb}" for n in get_registered_solutions()
                        for eb in emit_digest.ELEMENT_BYTES}
    assert not [k for k, v in got.items() if v.startswith("refused")]
    assert {k.split()[0] for k, v in got.items() if v == "no kernel"} == \
        {"test_empty", "test_empty_2d"}
    for k in ("test_4d 4", "test_4d 2", "tti 2", "awp 2"):
        assert re.fullmatch("[0-9a-f]{64}", got[k])
    assert emit_digest.digests(["test_4d", "tti"]) == {
        k: got[k] for k in got if k.split()[0] in ("test_4d", "tti")}


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
@pytest.mark.parametrize("case", ["test_4d", "four_d_stages"])
def test_4d_kernels_match_plain_on_card(cuda_device, case):
    """K1's stream arm (test_4d) and K6's (four_d_stages) at 4-D against
    the plain version on CUDA tensors from one seeded state, K = 2, 4
    steps: 0 mismatches at field_epsilon 1e-4, one launch per step."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    ctxs = {}
    for mode in ("torch", "fused"):
        ctxs[mode] = port_ctx(case, f"{SIZES[case]} -mode {mode} "
                              "-wf_steps 2", env=env)
    state = seeded_interiors(ctxs["torch"], 6)
    for ctx in ctxs.values():
        import_interiors(ctx, state)
    def counter():
        return (fused_stencil.stream_step.launches if case == "test_4d"
                else fused_stencil.stages_step.stream_launches)
    n0 = counter()
    for ctx in ctxs.values():
        ctx.run_solution(0, 3)
    assert counter() - n0 == 4
    assert ctxs["fused"].compare_data(ctxs["torch"],
                                      field_epsilon=1e-4) == 0
