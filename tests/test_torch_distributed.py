"""The port's shard modes (``shard_map``, ``sharded``, ``shard_pallas``)
against ``yask_tpu``'s, on the CPU.

The port runs one controller over a mesh of ``torch.device``s; here
``devices=["cpu"] * n``, each shard with tensors of its own.  ``yask_tpu``
runs on the 8 virtual CPU devices that tests/conftest.py sets, with
``shard_pallas`` in interpret mode, as its own tests run it.  Both start
from the same numpy-seeded interiors and are compared as numpy
interiors (``yask_tpu_torch.transfer``).

Tolerances:
* against ``yask_tpu``: ``field_epsilon=1e-4`` (ROADMAP.md C2: XLA
  contracts and reorders sums that eager PyTorch rounds one op at a time);
* the port's schedule pairs — overlap on/off, coalesce on/off, a shard
  mode against the single-domain run of the same function (``torch`` for
  shard_map/sharded, ``fused`` at the same K for shard_pallas) and a
  checkpoint restored across modes — bit-equal (``epsilon=0``): the same
  operations on the same values.

Every case that reads a domain condition or the index (the sponge, swe2d's
``IF_DOMAIN`` walls) shards the dim it reads, so a wrong shard origin
shows (ROADMAP.md C9 names the trouble spot).
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)

C2 = 1e-4


def _sizes(ctx, g):
    if isinstance(g, int):
        return f"-g {g}"
    return " ".join(f"-g_{d} {n}"
                    for d, n in zip(ctx.get_domain_dim_names(), g))


#: Eight distinct CPU devices: a mesh whose shards sit on different
#: devices, as the reference's eight virtual devices are (torch runs
#: ``cpu:i`` tensors on the one CPU; the port tells its devices apart).
CARDS = [f"cpu:{i}" for i in range(8)]


def port_ctx(stencil, r, g, mode, K=1, ranks=(), cli="", ndev=8,
             devices=None):
    """A prepared port context over ``ndev`` CPU devices (one device
    repeated), or over ``devices``."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=devices or ["cpu"] * ndev),
                           stencil=stencil, radius=r)
    nr = " ".join(f"-nr_{d} {n}" for d, n in ranks)
    ctx.apply_command_line_options(
        f"{_sizes(ctx, g)} -mode {mode} -wf_steps {K} {nr} {cli}")
    ctx.prepare_solution()
    return ctx


def tpu_ctx(stencil, r, g, mode, K=1, ranks=(), **settings):
    fac = yask_tpu.yk_factory()
    env = fac.new_env()
    assert env.get_num_ranks() >= 8, "tests/conftest.py sets 8 devices"
    ctx = fac.new_solution(env, stencil=stencil, radius=r)
    ctx.apply_command_line_options(f"{_sizes(ctx, g)} -wf_steps {K}")
    s = ctx.get_settings()
    s.mode = mode
    for k, v in settings.items():
        setattr(s, k, v)
    for d, n in ranks:
        ctx.set_num_ranks(d, n)
    ctx.prepare_solution()
    return ctx


def run(ctx, state, steps):
    if isinstance(ctx, yask_tpu_torch.runtime.context.StencilContext):
        import_interiors(ctx, state)
        ctx.run_solution(0, steps - 1)
        return export_interiors(ctx)
    tpu_import(ctx, state)
    ctx.run_solution(0, steps - 1)
    return tpu_export(ctx)


def bit_equal(a, b):
    return mismatches(a, b, epsilon=0.0, abs_epsilon=0.0) == 0


# ---------------------------------------------------------------------------
# shard_map and sharded: per-shard torch steps
# ---------------------------------------------------------------------------

MESHES = [("x4", [("x", 4)]), ("x2y2", [("x", 2), ("y", 2)]),
          ("x2y2z2", [("x", 2), ("y", 2), ("z", 2)])]


@pytest.mark.parametrize("mode", ["shard_map", "sharded"])
@pytest.mark.parametrize("mesh", [m for _n, m in MESHES],
                         ids=[n for n, _m in MESHES])
def test_shard_map_iso3dfd_matches_yask_tpu_and_torch(mode, mesh):
    steps = 3
    torch_ctx = port_ctx("iso3dfd", 2, 16, "torch")
    state = seeded_interiors(torch_ctx, 11)
    want = run(torch_ctx, state, steps)
    outs = {}
    for ov in ("", "-no-overlap_comms"):
        outs[ov] = run(port_ctx("iso3dfd", 2, 16, mode, ranks=mesh,
                                cli=ov), state, steps)
        assert bit_equal(outs[ov], want)
    assert bit_equal(outs[""], outs["-no-overlap_comms"])
    theirs = run(tpu_ctx("iso3dfd", 2, 16, mode, ranks=mesh), state, steps)
    assert mismatches(outs[""], theirs, field_epsilon=C2) == 0


@pytest.mark.parametrize("coalesce", ["on", "off"])
def test_shard_map_cube_coalesce_matches_yask_tpu(coalesce):
    """cube reads the 26 diagonal neighbours: its corner ghosts are
    composed axis exchanges, packed or not."""
    ranks = [("x", 2), ("y", 2)]
    steps = 3
    ctx = port_ctx("cube", 1, 12, "shard_map", ranks=ranks,
                   cli=f"-coalesce {coalesce}")
    assert ctx.comm_plan().coalesce is (coalesce == "on")
    state = seeded_interiors(ctx, 3)
    mine = run(ctx, state, steps)
    other = "off" if coalesce == "on" else "on"
    assert bit_equal(mine, run(port_ctx("cube", 1, 12, "shard_map",
                                        ranks=ranks,
                                        cli=f"-coalesce {other}"),
                               state, steps))
    assert bit_equal(mine, run(port_ctx("cube", 1, 12, "torch"), state,
                               steps))
    theirs = run(tpu_ctx("cube", 1, 12, "shard_map", ranks=ranks,
                         coalesce=coalesce), state, steps)
    assert mismatches(mine, theirs, field_epsilon=C2) == 0


def _swe2d(ctx, tpu=False):
    """tests/test_modes.py:137-158's initial state."""
    h0 = np.ones((24, 24), dtype=np.float32)
    h0[8:16, 8:16] = 2.0
    ctx.get_var("h").set_elements_in_slice(h0, [0, 0, 0], [0, 23, 23])
    ctx.get_var("hu").set_all_elements_same(0.0)
    ctx.get_var("hv").set_all_elements_same(0.0)
    ctx.get_var("lam").set_element(0.2, [])
    ctx.get_var("grav").set_element(1.0, [])
    ctx.run_solution(0, 3)
    return ctx


@pytest.mark.parametrize("ov", ["", "-no-overlap_comms"])
def test_shard_map_swe2d_scratch_and_domain_walls(ov):
    """Scratch flux chains and ``IF_DOMAIN`` walls over a mesh of 4 in x,
    the dim the walls read."""
    mine = _swe2d(port_ctx("swe2d", None, 24, "shard_map",
                           ranks=[("x", 4)], cli=ov))
    plain = _swe2d(port_ctx("swe2d", None, 24, "torch"))
    assert mine.compare_data(plain, epsilon=0.0, abs_epsilon=0.0) == 0
    theirs = _swe2d(tpu_ctx("swe2d", None, 24, "shard_map",
                            ranks=[("x", 4)]))
    a = export_interiors(mine)
    assert mismatches(a, tpu_export(theirs), field_epsilon=C2) == 0


def test_auto_mode_with_ranks_resolves_to_sharded_and_keeps_shards():
    ctx = port_ctx("3axis", 1, 12, "auto", ranks=[("x", 2)])
    assert ctx._mode == "sharded"
    import_interiors(ctx, seeded_interiors(ctx, 1))
    ctx.run_solution(0, 1)
    assert ctx._run.resident is not None and ctx._run.state is None
    assert len(ctx._run.resident[1]) == 2
    v = ctx.get_var("A").get_element([2, 5, 5, 5])   # gathers
    assert ctx._run.resident is None and np.isfinite(v)


# ---------------------------------------------------------------------------
# shard_pallas: K5's plain version on the CPU
# ---------------------------------------------------------------------------

PALLAS = [
    # stencil, r, g, ranks, K, steps, options
    ("iso3dfd", 2, 32, [("x", 2), ("y", 2)], 2, 5, "-skew"),
    ("iso3dfd_sponge", 2, (32, 12, 16), [("x", 4)], 2, 3, ""),
    ("wave2d", 2, (32, 16), [("x", 2)], 2, 3, ""),
]


@pytest.mark.parametrize("stencil,r,g,ranks,K,steps,cli", PALLAS,
                         ids=[p[0] for p in PALLAS])
def test_shard_pallas_matches_yask_tpu_and_single_domain_fused(
        stencil, r, g, ranks, K, steps, cli):
    """5 steps at K=2 run a remainder group.  The port's shard_pallas
    (K5's plain version on CPU tensors) is bit-equal to its own
    single-domain ``-mode fused`` (K1's plain version) at the same K, and
    within C2 of yask_tpu's shard_pallas in interpret mode.  Under
    ``-skew`` (the default) a 3-D solution's boxes run K1's stream arm
    (``_stream_region``); a 2-D one keeps the body with its reason
    (tests/test_torch_skew.py holds ``-no-skew`` to K1's body)."""
    ctx = port_ctx(stencil, r, g, "shard_pallas", K, ranks, cli)
    state = seeded_interiors(ctx, 7)
    n0 = fused_stencil.shard_step.launches
    s0 = fused_stencil.shard_step.stream_launches
    mine = run(ctx, state, steps)
    assert fused_stencil.shard_step.launches == n0   # plain on the CPU
    assert fused_stencil.shard_step.stream_launches == s0
    til = ctx.get_stats().get_tiling()
    kern = ctx._shard.kernel
    three_d = len(ctx._ana.domain_dims) == 3
    assert til["distributed"] and til["skew"] is three_d
    code = til["skew_reasons"][0]["code"]
    if three_d:
        assert til["name"] == kern.spec.name + "_stream_region"
        assert code == "skew_engaged"
        assert til["skew_reasons"][0]["kernel"] == "stream_region"
        assert til["stream"]["box_segments"]
    else:
        assert til["name"] == kern.spec.name + "_region"
        assert code == "skew_ineligible"
    assert til["comm"]["mesh"] == {d: n for d, n in ranks}
    fused = run(port_ctx(stencil, r, g, "fused", K), state, steps)
    assert bit_equal(mine, fused)
    theirs = run(tpu_ctx(stencil, r, g, "shard_pallas", K, ranks), state,
                 steps)
    assert mismatches(mine, theirs, field_epsilon=C2) == 0


@pytest.mark.parametrize("K,steps", [(2, 5), (3, 5)])
def test_shard_pallas_overlap_and_coalesce_are_bit_equal(K, steps):
    """Overlap on (the core on the pre-exchange state, shells after) and
    off, coalesce on and off: the same bits.  K=2 with 5 steps leaves a
    one-step remainder group (run whole after the exchange), K=3 a
    two-step one (split again)."""
    g, ranks = (40, 40, 16), [("x", 2), ("y", 2)]
    outs = {}
    for cli in ("-overlap_x off -coalesce off", "-overlap_x on -coalesce on",
                "-overlap_x on -coalesce off"):
        ctx = port_ctx("iso3dfd", 2, g, "shard_pallas", K, ranks, cli)
        state = seeded_interiors(ctx, 9)
        outs[cli] = run(ctx, state, steps)
        til = ctx.get_stats().get_tiling()
        codes = [rr["code"] for rr in til["overlap_reasons"]]
        if "on" in cli.split()[1]:
            assert til["overlap_exchange"] is True
            assert til["overlap_core"] == {"x": [2 * K, 20 - 2 * K],
                                           "y": [2 * K, 20 - 2 * K]}
            assert ("overlap_rem_unsplit" in codes) is (steps % K == 1)
        else:
            assert til["overlap_exchange"] is False
    vals = list(outs.values())
    assert bit_equal(vals[0], vals[1]) and bit_equal(vals[0], vals[2])
    fused = run(port_ctx("iso3dfd", 2, g, "fused", K), state, steps)
    assert bit_equal(vals[0], fused)


def test_shard_pallas_runs_resume_across_calls_and_var_access():
    """Two runs with a var read between them (a gather, then a scatter)
    give the bits of one run."""
    g, ranks = (24, 24, 12), [("x", 2), ("y", 2)]
    ctx = port_ctx("iso3dfd", 2, g, "shard_pallas", 2, ranks)
    state = seeded_interiors(ctx, 4)
    import_interiors(ctx, state)
    ctx.run_solution(0, 2)
    ctx.get_var("pressure").get_element([3, 1, 2, 3])
    ctx.run_solution(3, 5)
    whole = port_ctx("iso3dfd", 2, g, "fused", 2)
    import_interiors(whole, state)
    whole.run_solution(0, 5)
    assert ctx.compare_data(whole, epsilon=0.0, abs_epsilon=0.0) == 0


def test_checkpoint_restores_across_torch_and_shard_pallas():
    from yask_tpu_torch.resilience.checkpoint import (apply_snapshot,
                                                      extract_snapshot)
    g, ranks = (24, 24, 12), [("x", 2), ("y", 2)]
    a = port_ctx("iso3dfd", 2, g, "torch", 2)
    import_interiors(a, seeded_interiors(a, 2))
    a.run_solution(0, 1)
    b = port_ctx("iso3dfd", 2, g, "shard_pallas", 2, ranks)
    assert apply_snapshot(b, extract_snapshot(a))
    a.run_solution(2, 5)
    b.run_solution(2, 5)
    # and back: the shard-resident state is gathered into the snapshot
    assert b._run.resident is not None
    c = port_ctx("iso3dfd", 2, g, "torch", 2)
    assert apply_snapshot(c, extract_snapshot(b))
    assert b.compare_data(a, epsilon=0.0, abs_epsilon=0.0) == 0
    assert c.compare_data(a, epsilon=0.0, abs_epsilon=0.0) == 0
    assert c._cur_step == a._cur_step == 6


def test_degradation_ladder_sheds_k5_then_the_mesh():
    from yask_tpu_torch.resilience.checkpoint import degradation_ladder
    assert degradation_ladder("shard_pallas") == ["shard_map", "torch"]
    assert degradation_ladder("shard_map") == ["torch"]
    assert degradation_ladder("sharded") == ["torch"]
    assert degradation_ladder("shard_pallas", on_card=True) == []


# ---------------------------------------------------------------------------
# the decisions against yask_tpu's
# ---------------------------------------------------------------------------

GEOMS = [
    # stencil, r, g, ranks, K, overlap setting
    ("iso3dfd", 2, (32, 8, 16), [("x", 2)], 2, "auto"),
    ("iso3dfd", 2, (32, 48, 16), [("x", 2), ("y", 2)], 2, "on"),
    ("iso3dfd", 2, (32, 40, 16), [("x", 2), ("y", 2)], 2, "on"),
    ("iso3dfd", 2, (16, 8, 16), [("x", 2)], 2, "auto"),
    ("iso3dfd", 2, (32, 8, 16), [("x", 2)], 1, "auto"),
    ("iso3dfd", 2, (32, 8, 16), [("x", 2)], 3, "off"),
    ("iso3dfd", 1, (16, 16, 16), [("x", 2), ("y", 2), ("z", 2)], 1, "on"),
    ("iso3dfd", 1, (16, 16, 16), [("z", 2)], 2, "auto"),
]


@pytest.mark.parametrize("stencil,r,g,ranks,K,ovx", GEOMS)
def test_overlap_decision_matches_yask_tpu_at_unit_sub_t(stencil, r, g,
                                                        ranks, K, ovx):
    """At ``unit=8`` (the reference's fp32 sublane tile), with the shards
    on distinct devices as the reference's are, every answer is the
    reference's: engaged, reasons, core and shells."""
    from yask_tpu.parallel.shard_step import overlap_decision as theirs
    from yask_tpu_torch.parallel.shard_step import overlap_decision
    mine_ctx = port_ctx(stencil, r, g, "shard_pallas", K, ranks,
                        f"-overlap_x {ovx}", devices=CARDS)
    tpu = tpu_ctx(stencil, r, g, "shard_pallas", K, ranks,
                  overlap_exchange=ovx)
    a = overlap_decision(mine_ctx, K, unit=8)
    b = theirs(tpu, K)
    assert a == b


@pytest.mark.parametrize("mode,K,ranks,cli", [
    ("shard_map", 1, [("x", 2), ("y", 2)], ""),
    ("shard_map", 1, [("x", 2), ("y", 2), ("z", 2)], "-coalesce on"),
    ("shard_pallas", 2, [("x", 2), ("y", 2)], ""),
    ("shard_pallas", 2, [("x", 4)], "-coalesce off"),
    ("shard_map", 1, [("x", 2), ("y", 2)], "-comm_order y"),
])
def test_comm_plan_matches_yask_tpu(mode, K, ranks, cli):
    """With the shards on distinct devices, as the reference's are:
    order, coalescing, items and bytes per axis, round counts and reason
    codes are the reference's; only the link model (hbm/peer in place of
    ici/dcn) differs."""
    from yask_tpu.parallel.comm_plan import build_comm_plan as theirs
    mine_ctx = port_ctx("iso3dfd", 2, 24, mode, K, ranks, cli,
                        devices=CARDS)
    tpu = yask_tpu.yk_factory()
    tctx = tpu.new_solution(tpu.new_env(), stencil="iso3dfd", radius=2)
    tctx.apply_command_line_options(f"-g 24 -wf_steps {K} {cli}")
    tctx.get_settings().mode = mode
    for d, n in ranks:
        tctx.set_num_ranks(d, n)
    tctx.prepare_solution()
    a = mine_ctx.comm_plan(K)
    b = theirs(tctx, K=K)
    assert (a.order, a.coalesce, a.rounds, a.rounds_serial, a.mesh_shape) \
        == (b.order, b.coalesce, b.rounds, b.rounds_serial, b.mesh_shape)
    for d in b.axes:
        assert (a.axes[d]["items"], a.axes[d]["bytes"]) \
            == (b.axes[d]["items"], b.axes[d]["bytes"])
        assert a.axes[d]["kind"] == "peer"
    assert [r["code"] for r in a.reasons] == [r["code"] for r in b.reasons]
    assert a.errors == b.errors == []


@pytest.mark.parametrize("mode,K", [("shard_pallas", 2), ("shard_map", 1)])
def test_auto_declines_overlap_and_coalescing_on_one_card(mode, K):
    """With every shard on one device, ``auto`` declines the core/shell
    split and the packed exchange, each with its reason code; on distinct
    devices the same geometry engages both, and ``on`` forces both on one
    device."""
    from yask_tpu_torch.parallel.shard_step import overlap_decision
    g, ranks = (32, 48, 16), [("x", 2), ("y", 2)]
    one = port_ctx("iso3dfd", 2, g, mode, K, ranks, ndev=4)
    many = port_ctx("iso3dfd", 2, g, mode, K, ranks, devices=CARDS[:4])
    forced = port_ctx("iso3dfd", 2, g, mode, K, ranks,
                      "-overlap_x on -coalesce on", ndev=4)
    assert one.comm_plan(K).coalesce is False
    assert one.comm_plan(K).reasons[-1]["code"] == "comm_coalesce_one_card"
    assert one.comm_plan(K).axes["x"]["kind"] == "hbm"
    assert many.comm_plan(K).coalesce is True
    assert forced.comm_plan(K).coalesce is True
    if mode != "shard_pallas":
        return
    engaged, core, _sh, reasons = overlap_decision(one, K)
    assert not engaged and core is None
    assert reasons[-1]["code"] == "overlap_one_card"
    assert reasons[-1]["core"] == {"x": [4, 12], "y": [4, 20]}
    assert overlap_decision(many, K)[0] is True
    assert overlap_decision(forced, K)[0] is True
    state = seeded_interiors(one, 3)
    outs = [run(c, state, 5) for c in (one, forced)]
    assert bit_equal(*outs)
    til = one.get_stats().get_tiling()
    assert til["overlap_exchange"] is False
    assert til["comm"]["coalesce"] is False
    assert forced.get_stats().get_tiling()["overlap_exchange"] is True


# ---------------------------------------------------------------------------
# rejections, as the reference's
# ---------------------------------------------------------------------------


def test_shard_pallas_rejects_the_minor_dim_at_k_above_1():
    ctx = port_ctx("iso3dfd", 2, 16, "shard_pallas", 2, [("z", 2)])
    import_interiors(ctx, seeded_interiors(ctx, 1))
    with pytest.raises(YaskException, match="cannot shard the minor dim"):
        ctx.run_solution(0, 3)


def test_shard_pallas_rejects_a_rank_domain_under_hk():
    ctx = port_ctx("iso3dfd", 2, (12, 8, 8), "shard_pallas", 4, [("x", 4)])
    with pytest.raises(YaskException, match="smaller than the fused ghost "
                                            "width 8"):
        ctx.run_solution(0, 3)


def test_forced_overlap_on_an_infeasible_geometry_raises():
    ctx = port_ctx("iso3dfd", 2, (16, 8, 8), "shard_pallas", 2, [("x", 2)],
                   "-overlap_x on")
    with pytest.raises(YaskException, match="overlap_exchange=on but the "
                                            "core/shell split is "
                                            "infeasible"):
        ctx.run_solution(0, 3)


def test_shard_pallas_rejects_a_multi_stage_solution():
    """What this test pinned before K5 took several stages (the refusal
    "ROADMAP.md A11 (multi-stage K5)") is gone: shard_pallas runs the
    two-stage chain (K5 over K6's body; its plain version here, each stage
    over the box grown by what the later stage reads of it, across the
    inner shard face of the 1-D domain's minor dim, so K=1), bit-equal to
    shard_map's per-shard torch step and to the single-domain fused
    run."""
    from test_torch_fused import _two_stage_chain
    fac = yask_tpu_torch.yk_factory()
    outs = {}
    for mode, nr in (("shard_pallas", "-nr_x 2"), ("shard_map", "-nr_x 2"),
                     ("fused", "")):
        ctx = fac.new_solution(
            fac.new_env(devices=["cpu"] * (2 if nr else 1)),
            _two_stage_chain())
        ctx.apply_command_line_options(f"-g 16 -mode {mode} {nr}")
        ctx.prepare_solution()
        outs[mode] = run(ctx, seeded_interiors(ctx, 12), 5)
        if mode == "shard_pallas":
            til = ctx.get_stats().get_tiling()
            assert til["kernel"] == "shard_step" and til["stages"] == 2
    assert bit_equal(outs["shard_pallas"], outs["shard_map"])
    assert bit_equal(outs["shard_pallas"], outs["fused"])


def test_settings_env_and_rank_grid():
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env(devices=["cpu"] * 4)
    assert env.get_num_ranks() == 4 and env.get_num_cards() == 1
    assert env.get_device().type == "cpu"
    with pytest.raises(YaskException, match="not both"):
        fac.new_env(device="cpu", devices=["cpu"])
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options("-g 16 -nr -1 -mode shard_map")
    ctx.prepare_solution()
    # the reference's factorization: the minor dim stays whole
    assert [ctx.get_num_ranks(d) for d in "xyz"] == [2, 2, 1]
    assert ctx._mesh.shape == {"x": 2, "y": 2, "z": 1}
    from yask_tpu_torch.parallel import comm_ledger_fields, state_shardings
    specs = state_shardings(ctx._mesh, ctx._program, ctx.get_settings())
    assert specs == {"pressure": ("x", "y", None), "vel": ("x", "y", None)}
    fields = comm_ledger_fields(ctx)
    assert fields["mesh"] == {"x": 2, "y": 2}
    assert fields["comm_axis_kind"] == {"x": "hbm", "y": "hbm"}
    assert fields["comm_rounds"] <= fields["comm_rounds_serial"]
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options("-g 16 -mode shard_pallas")
    ctx.prepare_solution()
    assert [ctx.get_num_ranks(d) for d in "xyz"] == [4, 1, 1]
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options("-g 16 -nr_x 8 -mode shard_map")
    with pytest.raises(YaskException, match="needs 8 devices"):
        ctx.prepare_solution()
    ctx = fac.new_solution(env, stencil="iso3dfd", radius=2)
    ctx.apply_command_line_options("-g 16 -nr_x 2 -mode shard_map "
                                   "-comm_order q")
    ctx.prepare_solution()
    with pytest.raises(YaskException, match="-comm_order names 'q'"):
        ctx.run_solution(0, 0)


def test_harness_devices_and_ranks():
    import io
    from yask_tpu_torch.main import run_harness
    out = io.StringIO()
    assert run_harness(["-stencil", "iso3dfd", "-radius", "2", "-g", "16",
                        "-devices", "cpu,cpu,cpu,cpu", "-nr_x", "2",
                        "-nr_y", "2", "-mode", "shard_pallas", "-wf_steps",
                        "2", "-validate"], out=out) == 0
    assert "validation passed" in out.getvalue()
    assert "mesh {'x': 2, 'y': 2, 'z': 1} on 4 device(s)" in out.getvalue()


def test_stats_count_global_points_and_cards():
    ctx = port_ctx("3axis", 1, 12, "shard_map", ranks=[("x", 2)])
    import_interiors(ctx, seeded_interiors(ctx, 1))
    ctx.run_solution(0, 1)
    st = ctx.get_stats()
    assert st.get_num_elements() == 12 ** 3
    assert st.get_num_steps_done() == 2
    assert ctx._mesh.num_cards() == 1


@pytest.mark.cuda
def test_shard_pallas_on_card_matches_plain_and_fused():
    """On the card: 4 shards on cuda:0, K5 bit-equal to single-domain K1
    and within field_epsilon of K5's plain version."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    fac = yask_tpu_torch.yk_factory()
    g, steps = (48, 40, 24), 5

    def mk(mode, devs, ranks=""):
        ctx = fac.new_solution(fac.new_env(devices=devs),
                               stencil="iso3dfd", radius=2)
        ctx.apply_command_line_options(
            f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} -mode {mode} "
            f"-wf_steps 2 {ranks}")
        ctx.prepare_solution()
        return ctx
    k5 = mk("shard_pallas", ["cuda:0"] * 4, "-nr_x 2 -nr_y 2")
    k1 = mk("fused", ["cuda:0"])
    state = seeded_interiors(k1, 3)
    n0 = fused_stencil.shard_step.launches
    a, b = run(k5, state, steps), run(k1, state, steps)
    assert fused_stencil.shard_step.launches > n0
    assert bit_equal(a, b)
