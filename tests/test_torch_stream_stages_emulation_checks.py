"""K6's stream arm as device code on the CPU (the shim and helpers of
tests/test_torch_stream_stages_emulation.py): K7 over the arm with its
member stacks a padded stride apart, the mutations the emulation must
catch (a ring one plane short, a lag one plane short, no barrier between
dependent sub-stages, no wait for the copies), and the 16-byte copies
where a ring's rows line up with their source.  Tolerance: none."""

import dataclasses
import re

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner

from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import with_pads
from test_torch_stream_stages_emulation import (RUNG, SEG, launch, plain,
                                                same, stream_ctx)


def member_stacks(ctx, spec, seeds, pad=5):
    """Each input's ring slot for every member (its own seeded state) in
    one (nm, *shape) view of a buffer whose members sit ``pad`` cells more
    than a member apart, and NaN-filled output stacks laid out alike;
    returns (member states, inputs, outputs)."""
    import torch
    prog = ctx._program
    states = []
    for s in seeds:
        with_pads(ctx, s)
        states.append({n: [a.clone() for a in ring]
                       for n, ring in ctx._state.items()})

    def stack(shape):
        numel = 1
        for x in shape:
            numel *= x
        buf = torch.full((len(seeds), numel + pad), float("nan"))
        return buf[:, :numel].view(len(seeds), *shape)
    ins = []
    for n, s in spec.inputs:
        a = stack(prog.geoms[n].shape)
        for i, st in enumerate(states):
            a[i] = st[n][s]
        ins.append(a)
    outs = [stack(prog.geoms[n].shape) for n in spec.outputs]
    assert all(o.stride(0) > o[0].numel() for o in outs)
    return states, ins, outs


@pytest.mark.parametrize("name", ["awp", "ssg", "test_stages_3d"])
def test_k7_over_the_stream_arm_matches_each_member_when_emulated(
        name, tmp_path):
    """K7 over the arm: 3 members whose stacks sit a padded stride apart,
    each member's outputs equal to its solo plain step."""
    ctx, spec = stream_ctx(name)
    prog = ctx._program
    fn = emulated_kernel(spec, tmp_path,
                         entry=spec.name + "_stages_stream_batched")
    states, ins, outs = member_stacks(ctx, spec, (31, 32, 33))
    assert fused_stencil.call_batched_stages_stream_entry(
        fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=5) == 0
    for i, st in enumerate(states):
        _w, want = plain(ctx, spec, st, 0)
        assert same([o[i] for o in outs], want), (name, i)



# ---- the checks the emulation must fail ---------------------------------

def one_step(ctx, spec, tmp_path, sub, edit=None, nres=3):
    """One sub-step of ``spec`` built into ``tmp_path / sub`` (its header
    rewritten by ``edit``): equal to the plain version?"""
    (tmp_path / sub).mkdir()
    fn = emulated_kernel(spec, tmp_path / sub,
                         entry=spec.name + "_stages_stream", edit=edit)
    got = launch(fn, ctx, spec, ctx._state, 0, nres)
    return same(got, plain(ctx, spec, ctx._state, 0)[1])


def renamed(spec, source, tag):
    """``spec`` with another source under another name."""
    return dataclasses.replace(spec, name=spec.name + tag,
                               source=source.replace(spec.name,
                                                     spec.name + tag))


def test_emulation_fails_with_a_ring_one_plane_short(tmp_path, monkeypatch):
    """A ring of one plane fewer than its readers, the prefetch and the
    one-barrier rule need lets the prefetch land in a plane still read:
    ssg's stresses, its last sub-stage, read their own old values at the
    rings' lowest plane."""
    ctx, spec = stream_ctx("ssg")
    assert one_step(ctx, spec, tmp_path, "good")
    depth = tile_planner.ring_depth
    monkeypatch.setattr(tile_planner, "ring_depth",
                        lambda lo, hi, pf: depth(lo, hi, pf) - 1)
    short = cuda_emit.emit(ctx._program, stream_tiles=(RUNG,))
    assert all(short.stages_stream.in_depths[a] + 1
               == spec.stages_stream.in_depths[a] for a in spec.tiled)
    assert not one_step(ctx, short, tmp_path, "short")


def test_emulation_fails_with_a_lag_one_plane_short(tmp_path):
    """awp's velocities at z + 1 instead of z + 2: the stresses read a
    velocity plane not computed yet."""
    ctx, spec = stream_ctx("awp")
    assert spec.stages_stream.lags == [2, 0, 0, 0]
    src, n = re.subn(r"(ss_lag\(int k\) \{ return k == 0 \? )2", r"\g<1>1",
                     spec.source)
    assert n == 1
    assert not one_step(ctx, renamed(spec, src, "_lag"), tmp_path, "lag")


def test_emulation_fails_without_the_barrier_between_sub_stages(tmp_path):
    """The stresses read velocities other threads compute in the same
    plane: without the barrier between sub-stages they read NaN."""
    ctx, spec = stream_ctx("awp")

    def drop_barrier(fn, text):
        if fn != "stream_stages.cuh":
            return text
        text, n = re.subn(r"__syncthreads\(\);\n(\s*stream_sub<S, K \+ 1)",
                          r"\1", text)
        assert n == 1
        return text
    assert not one_step(ctx, spec, tmp_path, "nobar", drop_barrier)


def test_emulation_fails_without_the_copy_wait(tmp_path):
    """Computing a plane before cp.async.wait_group reads planes still in
    flight."""
    ctx, spec = stream_ctx("awp")

    def drop_wait(fn, text):
        if fn != "stream_stages.cuh":
            return text
        text, n = re.subn(r"\n\s*cp_async_wait<S::SS_P>\(\);", "", text)
        assert n == 1
        return text
    assert not one_step(ctx, spec, tmp_path, "nowait", drop_wait)


def lined_up(ctx, spec, state):
    """Each input copied into a view whose rows (and so planes) are whole
    16-byte units apart and whose staged rows start on one: the interior
    origin's minor index is its minor pad, so the view starts (halo_lo2 -
    pad) mod 4 cells into a 64-byte aligned buffer.  Every ring whose
    rows are whole units then takes the 16-byte copies."""
    import torch
    prog = ctx._program
    out = []
    for a, (n, s) in enumerate(spec.inputs):
        src = state[n][s]
        g = prog.geoms[n]
        shape = tuple(src.shape)
        if len(g.domain_dims) < 3:
            out.append(src)
            continue
        row = -(-shape[-1] // 4) * 4 + 4
        h2 = spec.halos[a][2][0] if a in spec.tiled else 0
        shift = (h2 - g.origin[g.domain_dims[-1]]) % 4
        lead = src.numel() // shape[-1]
        buf = torch.full((lead * row + 4,), float("nan"))
        view = buf[shift:shift + lead * row].view(*shape[:-1], row)
        view = view[..., :shape[-1]]
        view.copy_(src)
        out.append(view)
    return out


def test_sixteen_byte_copies_where_the_rows_line_up(tmp_path):
    """Inputs laid out so that every ring whose rows are whole 16-byte
    units lines up (awp's 36-cell rows) take 16-byte copies and the rest
    (39-cell rows) 4-byte ones, to the same bits; breaking the 16-byte
    copies' source shows that they ran."""
    ctx, spec = stream_ctx("awp")
    t2 = spec.stages_stream.tile[1]
    rows = {sum(spec.halos[a][2]) + t2 for a in spec.tiled}
    assert any(r % 4 == 0 for r in rows) and any(r % 4 for r in rows)
    ins = lined_up(ctx, spec, ctx._state)
    _w, want = plain(ctx, spec, ctx._state, 0)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    assert same(launch(fn, ctx, spec, ctx._state, 0, 3, ins=ins), want)

    def zero16(fn, text):
        if fn != "stream_stages.cuh":
            return text
        text, n = re.subn(r"cp_async<16>\(d, s, true\);",
                          "cp_async<16>(d, zero16, false);", text)
        assert n == 1
        return text
    (tmp_path / "zero16").mkdir()
    bad = emulated_kernel(spec, tmp_path / "zero16",
                          entry=spec.name + "_stages_stream", edit=zero16)
    assert not same(launch(bad, ctx, spec, ctx._state, 0, 3, ins=ins), want)
    # the inputs as the context lays them out: 4-byte copies only
    assert same(launch(bad, ctx, spec, ctx._state, 0, 3), want)
