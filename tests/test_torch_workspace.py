"""The workspace arm of K1 and K6 (and through them K7 and K5): solutions
whose tiles fit no rung of the emitter's shared-memory ladder.

At r=8 the staged and computed tiles of tti, the ssg and fsg families,
test_scratch_3d and test_stages_3d pass 227 KB at every tile; the emitter
then prints K6's body with the tiles past shared memory in a
device-memory workspace of the card's resident blocks, which walk the
tiles.

* Every such solution emits and prepares under ``-mode fused`` and
  reports the arm in ``get_tiling()``.
* The device code, built with g++ against the CUDA shim of
  tests/test_torch_kernel_emulation.py (one thread per CUDA thread,
  NaN-filled shared memory) with a NaN-filled workspace, once with one
  block walking every tile and once with a block per tile: against
  the g++ host path (``host_stages``, the same libm) to the bit, and
  against the plain version to the bit (tti by rtol 1e-5, atol 1e-6:
  g++'s ``sinf``/``cosf`` and PyTorch's differ by an ulp); the same
  through K7's (``_batched``) and K5's (``_region``) entries.
* The port's runs on the CPU (the plain versions that ``-mode fused``, a
  member batch and ``-mode shard_pallas`` take on CPU tensors) against
  ``yask_tpu``'s ``-mode jit`` and ``-mode pallas`` (interpret) at
  ``-g_x 5 -g_y 4 -g_z 37``: ``compare_data``'s rule with
  ``field_epsilon=1e-4`` (the Pallas tile contracts multiply-adds).
* The sources ``emit_digest`` prints at the registered radii (none takes
  the arm) are byte-identical to ``tests/emit_digests.json``; after a
  deliberate emitter change, regenerate it with ``python -m
  yask_tpu_torch.ops.emit_digest tests/emit_digests.json``.
"""

import ctypes
import json
import math
import os

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_fused import host_kernel
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_stencils import tpu_interiors

#: the solutions whose tiles fit no rung of the ladder at r=8
PAST_SMEM = ["tti", "ssg", "ssg2", "ssg_merged", "fsg", "fsg2",
             "fsg_merged", "fsg_abc", "fsg2_abc", "fsg_merged_abc",
             "test_scratch_3d", "test_stages_3d"]
#: two tiles in x at 8×8×64, every slot ragged
RAGGED = "-g_x 9 -g_y 4 -g_z 37"
SMALL = "-g_x 5 -g_y 4 -g_z 37"
#: two shards of 20 in x: each holds the fused ghost width (16 for ssg)
SHARDED = "-g_x 40 -g_y 4 -g_z 37"
LIBM_TOL = dict(rtol=1e-5, atol=1e-6)


def port_ctx(name, cli, r=8, devices=("cpu",)):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=list(devices)), stencil=name,
                           radius=r)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


def tol(name):
    return LIBM_TOL if name == "tti" else dict(rtol=0, atol=0)


def ws_fn(spec, tmp_path, entry="", host=False):
    """An entry of the workspace arm's source, built for the host path
    (g++) or as emulated device code, bound with the workspace
    arguments."""
    name = spec.name + entry
    if host:
        (tmp_path / "host").mkdir(exist_ok=True)
        fn = host_kernel(spec, tmp_path / "host", entry=name)
    else:
        fn = emulated_kernel(spec, tmp_path, entry=name)
    fn.argtypes = {"": fused_stencil.entry_argtypes,
                   "_batched": fused_stencil.batched_argtypes,
                   "_region": fused_stencil.region_argtypes}[entry](True)
    return fn


def small_spec(prog, monkeypatch):
    """The workspace arm forced at a 2×4×16 tile (a 16 KB shared-memory
    limit): cheap to emulate, several tiles on a small grid."""
    with monkeypatch.context() as m:
        m.setattr(cuda_emit, "SMEM_LIMIT", 16384)
        spec = cuda_emit.emit(prog, ladder=((2, 4, 16),))
    assert spec.workspace and spec.tile == (2, 4, 16)
    return spec


def nan_ws(spec, nres, dtype):
    import torch
    return torch.full((nres * spec.workspace["ws_elems"],), float("nan"),
                      dtype=dtype)


def tiles(prog, spec, nm=1, box=None):
    """The tiles of one launch (over ``box``'s extents for K5)."""
    slot = cuda_emit.slot_map(prog.ana.domain_dims)
    n = [1] * max(3, len(slot))
    for d, s_ in slot.items():
        n[s_] = (box[d][1] - box[d][0]) if box else prog.sizes[d]
    return nm * math.prod(-(-n[s_] // spec.tile[s_]) if s_ < 3 else n[s_]
                          for s_ in range(len(n)))


@pytest.mark.parametrize("name", PAST_SMEM)
def test_r8_solutions_past_shared_memory_emit_and_prepare(name):
    ctx = port_ctx(name, f"{SMALL} -mode fused")
    kern = ctx._fused_spec_kernel()
    w = kern.spec.workspace
    assert w["code"] == "workspace_engaged"
    assert w["smem_bytes"] <= cuda_emit.SMEM_LIMIT
    assert 0 < w["ws_block_bytes"] <= cuda_emit.WS_STAGES_BLOCK_BYTES
    assert w["ws_block_bytes"] % 16 == 0
    assert "WS_ELEMS = " in kern.spec.source
    assert "YT_FUSED_WS_ENTRIES(" in kern.spec.source
    til = ctx.get_stats().get_tiling()
    assert til["workspace"]["tile"] == list(kern.spec.tile)
    assert til["workspace"]["cells_per_point"] == w["cells_per_point"]
    assert til["skew_dims"] == []


def test_workspace_tile_has_the_fewest_cells_under_the_cap():
    """tti r=8: 8×8×64 (23.5 computed cells per useful point) beats the
    smaller rungs, whose margins recompute more (38.5 at 4×8×64)."""
    ctx = port_ctx("tti", f"{SMALL} -mode fused")
    spec = ctx._fused_spec_kernel().spec
    assert spec.tile == (8, 8, 64) and spec.stages == 3
    assert spec.workspace["cells_per_point"] == pytest.approx(23.5)
    tight = cuda_emit._workspace_plan(
        [(4, 8, 64), (8, 8, 64)], lambda t3: [1 << 17, 1 << 17],
        lambda t3: 38 * math.prod(t3) if t3[0] == 4 else 20 * math.prod(t3),
        4)
    assert tight["tile"] == (8, 8, 64)       # fewer cells, both under 4 MB
    over = cuda_emit._workspace_plan(
        [(8, 8, 64), (4, 8, 64)],
        lambda t3: [1 << 20] * (6 if t3[0] == 8 else 5), lambda t3: 1, 4)
    assert over["tile"] == (4, 8, 64)        # 8×8×64 passes the cap


@pytest.mark.parametrize("name,r", [("tti", 8), ("ssg", 8), ("test_3d", 16)])
def test_workspace_arm_emulated_matches_host_path_and_plain(name, r,
                                                            tmp_path):
    """test_3d r=16: a single-stage solution past shared memory takes the
    arm as K6's body with one sub-stage (K1's wrapper launches it)."""
    import torch
    ctx = port_ctx(name, f"{RAGGED} -mode fused", r=r)
    import_interiors(ctx, seeded_interiors(ctx, 5))
    prog, spec = ctx._program, ctx._fused_spec_kernel().spec
    assert spec.workspace and spec.tile == (8, 8, 64)
    assert (spec.stages == 1) == (name == "test_3d")
    assert ctx.get_stats().get_tiling()["kernel"] == (
        "fused_step" if name == "test_3d" else "stages_step")
    emu, host = ws_fn(spec, tmp_path), ws_fn(spec, tmp_path, host=True)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    want = fused_stencil.plain_chunk(prog, state, 0, 1)

    def run(fn, nres):
        outs = [torch.zeros(tuple(prog.geoms[n].shape)) for n in
                spec.outputs]
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, 0, None,
                                        nan_ws(spec, nres, torch.float32),
                                        nres) == 0
        return outs
    # one block walks both tiles (the first sees a NaN workspace, the
    # second the first's leftovers), then a block per tile
    assert tiles(prog, spec) == 2
    hosted = run(host, 1)
    for nres in (1, 2):
        for n, a, h in zip(spec.outputs, run(emu, nres), hosted):
            torch.testing.assert_close(a, h, rtol=0, atol=0)
            torch.testing.assert_close(a, want[n][-1], **tol(name))


def test_workspace_arm_emulation_fails_without_the_barrier_between_tiles(
        tmp_path):
    """A mutation check: without the barrier between two tiles of a walk,
    a thread stages the next tile while the others still read the last."""
    import torch
    ctx = port_ctx("ssg", f"{RAGGED} -mode fused")
    import_interiors(ctx, seeded_interiors(ctx, 5))
    prog, spec = ctx._program, ctx._fused_spec_kernel().spec

    def drop(fn, text):
        old = "if (i != (long long)blockIdx.x) __syncthreads();"
        if fn == "fused_step.cuh":
            assert text.count(old) == 1
            text = text.replace(old, "")
        return text
    fn = emulated_kernel(spec, tmp_path, edit=drop)
    fn.argtypes = fused_stencil.entry_argtypes(True)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.zeros(tuple(prog.geoms[n].shape)) for n in spec.outputs]
    assert fused_stencil.call_entry(fn, prog, spec, ins, outs, 0, None,
                                    nan_ws(spec, 1, torch.float32), 1) == 0
    want = fused_stencil.plain_chunk(prog, state, 0, 1)
    assert not all(torch.equal(a, want[n][-1])
                   for n, a in zip(spec.outputs, outs))


@pytest.mark.parametrize("name", ["tti", "ssg"])
def test_workspace_arm_k7_entry_matches_each_members_plain(name, tmp_path,
                                                          monkeypatch):
    import torch
    nm = 2
    ctx = port_ctx(name, f"{SMALL} -mode fused")
    prog = ctx._program
    spec = small_spec(prog, monkeypatch)
    members = []
    for i in range(nm):
        import_interiors(ctx, seeded_interiors(ctx, 7 + i))
        members.append({n: [a.clone() for a in ring]
                        for n, ring in ctx._state.items()})
    stack = {n: [torch.stack([m[n][s] for m in members])
                 for s in range(len(members[0][n]))] for n in members[0]}
    ins = [stack[n][s] for n, s in spec.inputs]
    fn = ws_fn(spec, tmp_path, "_batched")
    for nres in (tiles(prog, spec, nm), 2):
        outs = [torch.zeros((nm,) + tuple(prog.geoms[n].shape))
                for n in spec.outputs]
        assert fused_stencil.call_batched_entry(
            fn, prog, spec, ins, outs, nm, 0, None,
            nan_ws(spec, nres, torch.float32), nres) == 0
        for i, m in enumerate(members):
            want = fused_stencil.plain_chunk(prog, m, 0, 1)
            for n, a in zip(spec.outputs, outs):
                torch.testing.assert_close(a[i], want[n][-1], **tol(name))


@pytest.mark.parametrize("name", ["tti", "ssg"])
def test_workspace_arm_k5_entry_matches_plain_shard_chunk(name, tmp_path,
                                                          monkeypatch):
    """K5 over a core box of the second of two shards (``-mode
    shard_pallas -nr_x 2``; 10 tiles, two blocks walking five each), from
    random inputs over the whole padded arrays."""
    import torch
    from yask_tpu_torch.parallel.shard_step import shard_pallas_plan
    ctx = port_ctx(name, f"{SHARDED} -mode shard_pallas -nr_x 2",
                   devices=["cpu"] * 2)
    sp = shard_pallas_plan(ctx)
    kern, off = sp.kernel, sp.layout.offsets[1]
    prog = kern.program
    assert kern.spec.workspace and off["x"] == 20
    spec = small_spec(prog, monkeypatch)
    fn = ws_fn(spec, tmp_path, "_region")
    rng = np.random.RandomState(5)
    state = {n: [torch.tensor(rng.rand(*g.shape).astype(np.float32))
                 for _ in range(g.num_slots)]
             for n, g in prog.geoms.items()}
    shifted = fused_stencil._with_offset(prog, off, torch.device("cpu"))
    box = {"x": (2, 11), "y": (1, 3), "z": (2, 30)}
    fused_stencil.check_box(prog, spec, box)
    assert tiles(prog, spec, box=box) == 10
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.zeros(tuple(prog.geoms[n].shape)) for n in spec.outputs]
    assert fused_stencil.call_region_entry(
        fn, prog, spec, ins, outs, box, off, 0, None,
        nan_ws(spec, 2, torch.float32), 2) == 0
    want = fused_stencil.plain_shard_chunk(shifted, state, 0, box)
    for n, a in zip(spec.outputs, outs):
        torch.testing.assert_close(a, want[n][-1], **tol(name))


def tpu_run(name, mode, steps):
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=8)
    theirs.apply_command_line_options(SMALL)
    theirs.get_settings().mode = mode
    theirs.prepare_solution()
    tpu_init(theirs)
    theirs.run_solution(0, steps - 1)
    return tpu_interiors(theirs)


@pytest.mark.parametrize("name", ["tti", "ssg"])
def test_fused_batch_and_shards_match_yask_tpu_jit_and_pallas(name):
    """The port's fused run, a member of a fused batch and a 2-shard
    ``-mode shard_pallas`` run on the CPU, against ``yask_tpu``'s jit and
    pallas (interpret) runs of the same seeded state."""
    steps = 2
    runs = {}
    fused = port_ctx(name, f"{SMALL} -mode fused")
    port_init(fused)
    fused.run_solution(0, steps - 1)
    runs["fused"] = export_interiors(fused)
    assert fused.get_stats().get_tiling()["workspace"]
    ens = port_ctx(name, f"{SMALL} -mode fused").new_ensemble(2)
    for i in range(2):
        with ens.member(i) as c:
            port_init(c)
    ens.run(0, steps - 1)
    with ens.member(1) as c:
        runs["batch"] = export_interiors(c)
    shard = port_ctx(name, f"{SHARDED} -mode shard_pallas -nr_x 2",
                     devices=["cpu"] * 2)
    twin = port_ctx(name, f"{SHARDED} -mode fused")
    for c in (shard, twin):
        port_init(c)
        c.run_solution(0, steps - 1)
    assert shard._shard.kernel.spec.workspace
    assert mismatches(export_interiors(shard), export_interiors(twin),
                      epsilon=0.0, abs_epsilon=0.0) == 0
    for mode in ("jit", "pallas"):
        theirs = tpu_run(name, mode, steps)
        for run in ("fused", "batch"):
            assert mismatches(runs[run], theirs, field_epsilon=1e-4) == 0, \
                (run, mode)


def test_emit_digests_are_unchanged():
    from yask_tpu_torch.ops.emit_digest import digests
    path = os.path.join(os.path.dirname(__file__), "emit_digests.json")
    with open(path) as f:
        want = json.load(f)
    got = digests()
    assert sum(not v.startswith(("refused", "no kernel"))
               for v in want.values()) == 159
    assert got == want
