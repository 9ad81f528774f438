"""K4's stream arm as device code on the CPU (the shim and helpers of
tests/test_torch_k4_stream_emulation.py): the mutations the emulation
must catch, and one group against ``yask_tpu``.

* A level's lag one plane short (level 1 of iso3dfd r=2 K=2 at z + 1
  instead of z + 2: level 2 reads a plane of level 1 not computed yet)
  and a computed ring one plane short (level 1's ring of 4 planes, not
  5: the newest plane lands in the slot of the oldest, which level 2
  still reads) must each make the emulation differ from ``plain_chunk``,
  while the unmutated source matches it to the bit.
* The emulated entry's group on iso3dfd r=2 K=2 against ``yask_tpu``'s
  forced trapezoid chunk (``-mode pallas`` in interpret mode, as
  tests/test_torch_trapezoid.py runs it) from one seeded state, at
  ``field_epsilon=1e-4``: the repo's tolerance for a fused in-tile
  evaluation against another (the Pallas tile contracts multiply-adds).
"""

import dataclasses
import re

import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_k4_stream_emulation import (entry, group, k4_stream_ctx,
                                            stream_spec)
from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)
from test_torch_trapezoid import (force, tpu_ctx,  # noqa: F401
                                  tpu_forced_trapezoid)


def same(got, want):
    import torch
    return all(torch.equal(a, b) for n in want
               for a, b in zip(got[n], want[n]))


def renamed(spec, source, tag):
    """``spec`` with another source under another name."""
    return dataclasses.replace(spec, name=spec.name + tag,
                               source=source.replace(spec.name,
                                                     spec.name + tag))


def mutated(spec, table, old, new, tag):
    """``spec`` with entry 0 of its ``table`` (``ss_lag``, ``ss_cdepth``)
    changed from ``old`` to ``new``."""
    src, n = re.subn(rf"({table}\(int k\) \{{ return k == 0 \? ){old}\b",
                     rf"\g<1>{new}", spec.source)
    assert n == 1
    return renamed(spec, src, tag)


@pytest.mark.parametrize("mutation", ["none", "lag", "ring"])
def test_emulation_fails_with_a_level_lag_or_a_ring_one_plane_short(
        mutation, tmp_path):
    ctx = k4_stream_ctx("iso3dfd", 2, 2)
    prog = ctx._program
    spec = stream_spec(ctx, 2)
    plan = spec.stages_stream
    assert plan.lags == [2, 0] and plan.cmp_depths == [5]
    if mutation == "lag":
        spec = mutated(spec, "ss_lag", 2, 1, "_lag")
    elif mutation == "ring":
        spec = mutated(spec, "ss_cdepth", 5, 4, "_ring")
    got = group(entry(spec, tmp_path), ctx, spec, ctx._state, 0, 3)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, 2)
    assert same(got, want) is (mutation == "none")


def test_emulated_group_matches_yask_tpu_interpret(tpu_forced_trapezoid,
                                                   tmp_path):
    g, K = 32, 2
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                            radius=2)
    force(mine)
    mine.apply_command_line_options(f"-g {g} -mode fused -wf_steps {K} "
                                    "-trapezoid")
    mine.prepare_solution()
    theirs = tpu_ctx("iso3dfd", 2, g, "pallas", K)
    state = seeded_interiors(mine, 3)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    kern = mine._trapezoid_kernel()
    assert kern.stream and mine._trap[1][-1]["code"] == "trapezoid_stream"
    spec = stream_spec(mine, K, rung=(16, 32, 64))
    fn = entry(spec, tmp_path)
    mine._state = group(fn, mine, spec, mine._state, 0, 3, seg=16)
    theirs.run_solution(0, K - 1)
    assert theirs.get_stats().get_tiling()["trapezoid"] is True
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
