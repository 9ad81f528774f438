"""K5 on every arm of the reference's shard_pallas, on the CPU.

``yask_tpu``'s shard_pallas builds its per-shard chunk with every arm the
single-domain chunk takes (``build_pallas_chunk(..., distributed=True)``,
yask_tpu/parallel/shard_step.py:1093): several stages, scratch
sub-stages, a later stage's rewrite, misc dims, partial-dim written vars,
element size 2 and more than three domain dims.  The port's
``-mode shard_pallas`` runs K5 over K1's body or K6's; on CPU tensors
(``devices=["cpu"] * n``) its plain version, ``plain_shard_chunk``, which
evaluates each stage over the box grown by what the later stages read of
it.  Every mesh below has an inner shard face in each sharded dim.

Per case, two checks:

* against ``yask_tpu``'s ``-mode shard_pallas`` (interpret mode, the
  virtual devices of tests/conftest.py), both seeded by their
  ``init_solution_vars``: ``field_epsilon=1e-4`` (ROADMAP.md C2); tti at
  the scratch tolerance of tests/test_torch_scratch.py (``compare_data``'s
  defaults); element size 2 at (3e-2, 3e-2), as tests/test_torch_bf16.py;
* against the port's single-domain ``-mode fused`` at the same K from a
  numpy-seeded random state: bit-equal (the same operations on the same
  values), and finite.

Then ssg, tti and test_misc_2d with ``-overlap_x on`` and ``-coalesce
on`` (a core box and shells per sub-step, each recomputing the earlier
stages over its own grown box) bit-equal to ``-overlap_x off``.  The reference's runs are
shared per case through a module-scoped cache.
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_4d import source as source_4d
from test_torch_bf16 import BF16_EPS, bf16_source
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_partial import SOLUTIONS as PARTIAL
from test_torch_stencils import tpu_interiors

C2 = 1e-4
X2 = [("x", 2)]
X2Y2 = [("x", 2), ("y", 2)]

#: id → (solution, radius, sizes, K, ranks, steps, the body K5 runs on)
CASES = {
    "ssg-K1": ("ssg", None, "-g 16", 1, X2Y2, 3, "stages"),
    "ssg-K2": ("ssg", None, "-g 16", 2, X2Y2, 3, "stages"),
    "tti-K1-x2": ("tti", 2, "-g 16", 1, X2, 3, "stages"),
    "tti-K2-x2y2": ("tti", 2, "-g 16", 2, X2Y2, 3, "stages"),
    "awp-x2": ("awp", None, "-g 24", 1, X2, 2, "stages"),
    "swe2d-K2": ("swe2d", None, "-g 16", 2, X2, 3, "stages"),
    "test_scratch_3d": ("test_scratch_3d", None, "-g 16", 1, X2Y2, 3,
                        "stages"),
    "test_boundary_3d": ("test_boundary_3d", None, "-g 16", 1, X2Y2, 3,
                         "stages"),
    "gaussian-x2": ("gaussian", 2, "-g 24", 2, X2, 3, "stages"),
    "test_misc_2d-x2": ("test_misc_2d", None, "-g 16", 2, X2, 3, "step"),
    "test_step_cond_1d": ("test_step_cond_1d", None, "-g 24", 1, X2, 4,
                          "stages"),
    "partial_written-x2": ("partial_written", None, "-g 16", 2, X2, 3,
                           "stages"),
    "iso3dfd_bf16-K2": ("iso3dfd_bf16", 2, "-g 16", 2, X2Y2, 3, "step"),
    "test_4d-w2": ("test_4d", None, "-g_w 12 -g_x 6 -g_y 5 -g_z 9", 2,
                   [("w", 2)], 3, "step"),
    "test_4d-x2": ("test_4d", None, "-g_w 4 -g_x 12 -g_y 5 -g_z 9", 2,
                   X2, 3, "step"),
}


def source(pkg, key, r):
    """``(source, kwargs)`` for either package's ``new_solution``."""
    if key in PARTIAL:
        return PARTIAL[key](pkg), {}
    if key.endswith("_bf16"):
        return bf16_source(pkg, key[:-len("_bf16")], r), {}
    if key == "test_4d":
        return source_4d(pkg, key)
    return None, {"stencil": key, "radius": r}


def port_ctx(case, mode, cli=""):
    key, r, sizes, K, ranks, _steps, _body = CASES[case]
    n = int(np.prod([k for _d, k in ranks])) if mode == "shard_pallas" \
        else 1
    fac = yask_tpu_torch.yk_factory()
    src, kw = source("yask_tpu_torch", key, r)
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * n), src, **kw)
    nr = " ".join(f"-nr_{d} {k}" for d, k in ranks) \
        if mode == "shard_pallas" else ""
    ctx.apply_command_line_options(f"{sizes} -mode {mode} -wf_steps {K} "
                                   f"{nr} {cli}")
    ctx.prepare_solution()
    return ctx


_THEIRS = {}


def theirs(case):
    """``yask_tpu``'s shard_pallas interiors after the case's steps from
    ``init_solution_vars`` (one run per case per module)."""
    if case not in _THEIRS:
        key, r, sizes, K, ranks, steps, _body = CASES[case]
        tfac = yask_tpu.yk_factory()
        src, kw = source("yask_tpu", key, r)
        ctx = tfac.new_solution(tfac.new_env(), src, **kw)
        ctx.apply_command_line_options(f"{sizes} -wf_steps {K}")
        ctx.get_settings().mode = "shard_pallas"
        for d, k in ranks:
            ctx.set_num_ranks(d, k)
        ctx.prepare_solution()
        tpu_init(ctx)
        ctx.run_solution(0, steps - 1)
        ctx._materialize_state()    # the resident shards, gathered
        _THEIRS[case] = tpu_interiors(ctx)
    return _THEIRS[case]


def finite(out):
    return all(np.isfinite(a).all() for ring in out.values() for a in ring)


def bit_equal(a, b):
    return mismatches(a, b, epsilon=0.0, abs_epsilon=0.0) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_k5_arm_matches_yask_tpu_shard_pallas(case):
    key, _r, _g, K, ranks, steps, body = CASES[case]
    mine = port_ctx(case, "shard_pallas")
    port_init(mine)
    n0 = fused_stencil.shard_step.launches
    mine.run_solution(0, steps - 1)
    assert fused_stencil.shard_step.launches == n0   # plain on the CPU
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "shard_step" and til["distributed"]
    assert (til["stages"] > 1 or til["scratch_stages"] > 0) \
        is (body == "stages")
    got = export_interiors(mine)
    assert finite(got)
    if key.endswith("_bf16"):
        tol = dict(epsilon=BF16_EPS, abs_epsilon=BF16_EPS)
    elif key == "tti":
        tol = {}
    else:
        tol = dict(field_epsilon=C2)
    assert mismatches(got, theirs(case), **tol) == 0


@pytest.mark.parametrize("case", list(CASES))
def test_k5_arm_is_bit_equal_to_single_domain_fused(case):
    steps = CASES[case][5]
    outs = {}
    for mode in ("shard_pallas", "fused"):
        ctx = port_ctx(case, mode)
        state = seeded_interiors(ctx, 21)
        import_interiors(ctx, state)
        ctx.run_solution(0, steps + 1)
        outs[mode] = export_interiors(ctx)
    assert finite(outs["fused"])
    assert bit_equal(outs["shard_pallas"], outs["fused"])


#: (solution, radius, sizes, K, ranks, steps), under their test ids
OVERLAP = {
    "ssg-None": ("ssg", None, "-g_x 40 -g_y 40 -g_z 12", 2, X2Y2, 5),
    "tti-2": ("tti", 2, "-g_x 40 -g_y 40 -g_z 12", 2, X2Y2, 5),
    "test_misc_2d-K2": ("test_misc_2d", None, "-g_x 48 -g_y 12", 2, X2, 5),
    "test_misc_2d-K3": ("test_misc_2d", None, "-g_x 48 -g_y 12", 3, X2, 8),
}


@pytest.mark.parametrize("case", list(OVERLAP), ids=list(OVERLAP))
def test_k5_overlap_and_coalesce_are_bit_equal_to_off(case):
    """Overlap on splits every group after the first into a core box and
    shells, each of which recomputes the earlier stages (and scratch
    sub-stages) over its own grown box: the bits of ``-overlap_x off``,
    packed or not.  5 steps at K=2 leave a one-step remainder.
    test_misc_2d's ``A`` starts from a copy of its evicted slot (unwritten
    misc slices) and has a ring of 2: a 2-step group splits, a 3-step
    group runs whole (``overlap_base_ring_short``); 8 steps at K=3 run
    one of each after the first group."""
    stencil, r, sizes, K, ranks, steps = OVERLAP[case]
    n = int(np.prod([k for _d, k in ranks]))
    nr = " ".join(f"-nr_{d} {k}" for d, k in ranks)
    fac = yask_tpu_torch.yk_factory()
    outs = {}
    for cli in ("-overlap_x off -coalesce off", "-overlap_x on -coalesce on",
                "-overlap_x on -coalesce off"):
        ctx = fac.new_solution(fac.new_env(devices=["cpu"] * n),
                               stencil=stencil, radius=r)
        ctx.apply_command_line_options(
            f"{sizes} -mode shard_pallas -wf_steps {K} {nr} {cli}")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 9))
        ctx.run_solution(0, steps - 1)
        til = ctx.get_stats().get_tiling()
        assert til["overlap_exchange"] is ("-overlap_x on" in cli)
        codes = {x["code"] for x in til["overlap_reasons"]}
        assert ("overlap_base_ring_short" in codes) is (
            case == "test_misc_2d-K3" and til["overlap_exchange"])
        outs[cli] = export_interiors(ctx)
    vals = list(outs.values())
    assert finite(vals[0])
    assert bit_equal(vals[0], vals[1]) and bit_equal(vals[0], vals[2])


def shard_pallas_matches_shard_map(solution, cli, ndev=2, steps=3):
    """``-mode shard_pallas`` of ``solution()`` (a source or a registered
    name) over ``ndev`` CPU devices, with ``cli`` (sizes and ranks),
    bit-equal to ``-mode shard_map`` from one numpy-seeded state (what
    the tests that pinned K5's refusals hold now)."""
    fac = yask_tpu_torch.yk_factory()
    outs = {}
    for mode in ("shard_pallas", "shard_map"):
        src = solution()
        env = fac.new_env(devices=["cpu"] * ndev)
        ctx = (fac.new_solution(env, stencil=src) if isinstance(src, str)
               else fac.new_solution(env, src))
        ctx.apply_command_line_options(f"{cli} -mode {mode}")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 17))
        ctx.run_solution(0, steps - 1)
        outs[mode] = export_interiors(ctx)
    assert finite(outs["shard_map"])
    assert bit_equal(outs["shard_pallas"], outs["shard_map"])
    return outs
