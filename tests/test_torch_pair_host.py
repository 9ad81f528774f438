"""The pair flavour of K1's stream arm at element size 2 on the host: its
entries built by g++ (``host_pairs``: the lane pairs of every member's
interior, or of the box at global coordinates, each lane's op computed
in float and rounded once, which is ROADMAP.md C13's rule) against the
plain versions, and against ``yask_tpu``.

* Solo (``<name>_stream``) and K7 x3 (``_stream_batched``) for iso3dfd
  r=2 and r=8, 3axis r=1, test_4d and cond_funcs (functions, index
  values, partial-dim reads, conditions) at an odd interior minor
  extent, into NaN-filled outputs, slot 0 in two segments: bit-equal to
  ``plain_chunk`` and ``plain_batched_chunk``, pads included (cond_funcs:
  to the one-point host entry's bits, and to the plain version within a
  bfloat16 ulp, where g++'s libm and PyTorch's ``sin``/``cos``/``exp``
  differ by an ulp in float).
* K5 (``_stream_region``) over boxes of a 2x2 shard layout: the group's
  full boxes, a ragged one, and boxes whose minor origin is odd and
  whose minor extent is odd (3axis r=1 grows its boxes by one), into
  NaN-filled outputs: inside the box the bits of ``plain_shard_step``,
  outside it NaN.
* ``yask_tpu``'s jit at element size 2 from the same seeded interiors:
  iso3dfd r=2 in 0 differing bits (C13), iso3dfd r=8 and 3axis within
  the repo's fused-against-unfused bfloat16 tolerance (3e-2, 3e-2,
  tests/test_config_matrix.py:66).
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors

from test_torch_bf16 import BF16_EPS, bf16_source
from test_torch_fused import cond_funcs, host_kernel
from test_torch_lowering import mismatches
from test_torch_stencils import tpu_interiors
from test_torch_stream_k1_4d_host import (batch_steps, ctx_4d, host_entry,
                                          nan_like, slot0_extent,
                                          solo_steps)
from test_torch_stream_k5k7_host import (bind, host_lib, member_states,
                                         new_ctx, region_steps,
                                         two_segments)

#: the solo and K7 cases: (stencil, radius, sizes), the minor extent odd
SOLO = {"iso3dfd_r2": ("iso3dfd", 2, "-g_x 10 -g_y 9 -g_z 37"),
        "iso3dfd_r8": ("iso3dfd", 8, "-g_x 18 -g_y 9 -g_z 37"),
        "3axis_r1": ("3axis", 1, "-g_x 10 -g_y 9 -g_z 37"),
        "test_4d": ("test_4d", None, "-g_w 3 -g_x 10 -g_y 6 -g_z 37")}


def case_ctx(case):
    st, r, sizes = SOLO[case]
    if st == "test_4d":
        return ctx_4d(2, f"{sizes} -mode fused")
    return new_ctx(yask_tpu_torch.yk_factory().new_env(device="cpu"), st,
                   r, 2, f"{sizes} -mode fused")


def pair_spec(ctx):
    spec = ctx._fused_spec_kernel().spec
    assert spec.stream is not None and " point2(const RD& rd" in spec.source
    return spec


@pytest.mark.parametrize("entry", ["_stream", "_stream_batched"])
@pytest.mark.parametrize("case", list(SOLO))
def test_pair_entries_match_plain(case, entry, tmp_path):
    ctx = case_ctx(case)
    prog = ctx._program
    spec = pair_spec(ctx)
    assert prog.sizes[prog.ana.domain_dims[-1]] % 2 == 1
    fn = host_entry(spec, tmp_path, entry)
    (batch_steps if entry.endswith("_batched") else solo_steps)(
        fn, prog, spec)


def test_cond_funcs_pairs_match_the_one_point_entry(tmp_path):
    """Every kind the pair flavour prints per lane (functions, index
    values, ``%``, partial-dim reads, domain and step conditions): the
    stream entry's pairs give the one-point entry's bits (both g++), and
    the plain version's within a bfloat16 ulp."""
    import torch
    s = cond_funcs("yask_tpu_torch")
    s.set_element_bytes(2)
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), s)
    ctx.apply_command_line_options("-g_x 10 -g_y 11 -g_z 37 -mode fused")
    ctx.prepare_solution()
    prog = ctx._program
    spec = pair_spec(ctx)
    (tmp_path / "one").mkdir()
    one = host_kernel(spec, tmp_path / "one")
    lib = host_lib(spec, tmp_path)
    pairs = getattr(lib, spec.name + "_stream")
    pairs.argtypes = fused_stencil.stream_argtypes()
    state = member_states(prog, 1, 5)
    state = {n: [a[0] for a in ring] for n, ring in state.items()}
    seg = two_segments(slot0_extent(prog))
    for t in range(4):      # the step condition's t % 3 != 1 both ways
        ins = [state[n][k] for n, k in spec.inputs]
        got = nan_like(prog, spec, ins[0].dtype)
        assert fused_stencil.call_stream_entry(pairs, prog, spec, ins, got,
                                               t, None, seg) == 0
        ref = [torch.zeros(tuple(prog.geoms[n].shape), dtype=ins[0].dtype)
               for n in spec.outputs]
        assert fused_stencil.call_entry(one, prog, spec, ins, ref, t,
                                        None) == 0
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a, b in zip(spec.outputs, got, ref):
            assert torch.equal(a, b), n
            torch.testing.assert_close(a.float(), want[n][-1].float(),
                                       rtol=2 ** -8, atol=1e-6)
        state = fused_stencil._rotated(prog, spec, state, got)


#: K5 cases: (stencil, radius, sizes and ranks); a group of 2 on 2x2
#: shards
REGION = {"iso3dfd_r2": ("iso3dfd", 2,
                         "-g_x 24 -g_y 18 -g_z 37 -nr_x 2 -nr_y 2"),
          "iso3dfd_r8": ("iso3dfd", 8, "-g_x 32 -g_y 16 -g_z 37 -nr_x 2"),
          "3axis_r1": ("3axis", 1, "-g_x 24 -g_y 18 -g_z 37 -nr_x 2 "
                       "-nr_y 2")}


def odd_boxes(boxes, n_of, minor):
    """The group's boxes with the minor dim cut to an odd origin and an
    odd extent (1 .. n - 2, and 3 .. n - 1 where n - 4 is odd)."""
    n = n_of[minor]
    out = []
    for b in boxes:
        for lo, hi in ((1, n - 2), (3, n - 1)):
            c = dict(b)
            c[minor] = (lo, hi)
            assert lo % 2 == 1
            out.append(c)
    return out


@pytest.mark.parametrize("case", list(REGION))
def test_pair_region_entry_matches_plain_shard_step(case, tmp_path):
    from yask_tpu_torch.parallel.shard_step import _full_box, \
        shard_pallas_plan
    from test_torch_k5_host import ragged
    st, r, sizes = REGION[case]
    n = 4 if "-nr_y" in sizes else 2
    ctx = new_ctx(yask_tpu_torch.yk_factory().new_env(devices=["cpu"] * n),
                  st, r, 2, f"{sizes} -mode shard_pallas -wf_steps 2")
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    prog = kern.program
    spec = pair_spec_of(kern)
    off = sp.layout.offsets[sp.layout.mesh.index(
        {d: 0 for d in prog.ana.domain_dims})]
    boxes = [_full_box(sp, 2, s) for s in range(2)]
    boxes.append(ragged(boxes[0], prog.sizes))
    minor = prog.ana.domain_dims[-1]
    boxes += odd_boxes(boxes[:1], prog.sizes, minor)
    if st == "3axis":
        # the grown box of sub-step 0 starts at an odd index in x and y
        assert boxes[0]["x"][0] % 2 == 1
    fn = bind(host_lib(spec, tmp_path), spec, "_stream_region")
    region_steps(fn, kern, spec, off, boxes)


def pair_spec_of(kern):
    assert kern.skew_dims == ["x"]
    spec = kern.spec
    assert spec.stream is not None and " point2(const RD& rd" in spec.source
    return spec


@pytest.mark.parametrize("name,r,exact", [("iso3dfd", 2, True),
                                          ("iso3dfd", 8, False),
                                          ("3axis", 1, False)])
def test_pair_entry_against_yask_tpu_jit(name, r, exact, tmp_path,
                                         monkeypatch):
    """Two steps of ``run_solution`` through the host-built pair entry
    (``FusedKernel.chunk`` launching it step by step on the CPU tensors,
    as it launches the kernel on CUDA ones) from ``init_solution_vars``'s
    interiors, against ``yask_tpu`` jit at element size 2: C13's 0
    differing bits on iso3dfd r=2, the fused-against-unfused tolerance
    elsewhere."""
    g = "-g_x 17 -g_y 16 -g_z 21"
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(),
                               bf16_source("yask_tpu", name, r))
    theirs.apply_command_line_options(g)
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    theirs.run_solution(0, 1)
    want = tpu_interiors(theirs)
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"),
                            bf16_source("yask_tpu_torch", name, r))
    mine.apply_command_line_options(f"{g} -mode fused")
    mine.prepare_solution()
    port_init(mine)
    kern = mine._fused_spec_kernel()
    prog, spec = kern.program, pair_spec(mine)
    fn = host_entry(spec, tmp_path, "_stream")
    launched = []

    def chunk(self, state, t0, k):
        for i in range(k):
            ins = [state[n][s] for n, s in spec.inputs]
            outs = nan_like(prog, spec, ins[0].dtype)
            assert fused_stencil.call_stream_entry(
                fn, prog, spec, ins, outs, t0 + i, None) == 0
            state = fused_stencil._rotated(prog, spec, state, outs)
            launched.append(t0 + i)
        return state
    monkeypatch.setattr(fused_stencil.FusedKernel, "chunk", chunk)
    mine.run_solution(0, 1)
    assert launched == [0, 1]
    got = export_interiors(mine)
    if exact:
        for v in want:
            for a, b in zip(got[v], want[v]):
                assert np.array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32)), v
    else:
        assert mismatches(got, want, BF16_EPS, BF16_EPS) == 0
