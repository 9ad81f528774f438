"""The pair flavour of K1's stream arm at element size 2: its rounding rule,
the emitter's classification of the ops it packs, and the plans.

* The rule (ROADMAP.md C13): each op on bfloat16 values is computed in
  float and rounded once.  Hopper's ``add.rn.bf16x2``, ``sub.rn.bf16x2``
  and ``mul.rn.bf16x2`` round the exact result once, so the packed
  kernel keeps the bits where float32-then-round equals the correctly
  rounded result.  Checked here on 10^5 random bfloat16 pairs over
  exponent gaps 0-40, subnormals, +-0 and +-inf, against the exact sum,
  difference and product (``fractions.Fraction``) rounded to nearest
  even.  Tolerance: none.
* ``cuda_emit``'s pair flavour (``Spec::point2``) packs only +, - and x
  of bfloat16 values (kind R) and their negation; division, functions,
  float32 values (kind F), indices and comparisons run per lane.  Value
  ``vN`` is the same node in both flavours, so each of ``point2``'s
  statements is held to ``point``'s.
* The plans: at element size 2 two points a thread, at least
  ``STREAM_PAIR_MIN_REGS`` (64) registers, rings of whole 16-byte rows;
  the fp32 plans as before.
"""

import re
from fractions import Fraction

import numpy as np
import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler import lowering
from yask_tpu_torch.ops import cuda_emit, tile_planner

from test_torch_bf16 import port_ctx

# ---------------------------------------------------------------------------
# the rounding rule
# ---------------------------------------------------------------------------

#: bfloat16: 8 significant bits, normal exponents -126..127
MIN_EXP, MAX_EXP, DIGITS = -126, 127, 8
MAX_FINITE = Fraction((1 << DIGITS) - 1, 1 << (DIGITS - 1)) * 2 ** MAX_EXP


def bits_to_f32(bits):
    """bfloat16 bit patterns (uint16) as float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def round_f32_to_bf16(x):
    """float32 -> bfloat16 to nearest even, as float32 (NaN kept NaN)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7fff + ((u >> 16) & 1)) >> 16).astype(np.uint32)
    out = (r << 16).view(np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), out)


def exact_to_bf16(v: Fraction) -> float:
    """The exact value ``v`` rounded once to bfloat16, to nearest even
    (past the largest finite value to infinity)."""
    if v == 0:
        return 0.0
    sign = -1.0 if v < 0 else 1.0
    a = abs(v)
    if a < Fraction(1, 2 ** 134):   # below half the least subnormal
        return sign * 0.0
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    q = Fraction(2) ** (max(e, MIN_EXP) - (DIGITS - 1))
    r = round(a / q) * q          # round() on a Fraction: half to even
    if r > MAX_FINITE:
        return sign * float("inf")
    return sign * float(r)        # an underflow to zero keeps its sign


def random_pairs(n: int, seed: int):
    """``n`` pairs of finite bfloat16 values: signs and mantissas at
    random, the exponent gap between the two 0-40, exponents from
    subnormal to the largest."""
    rng = np.random.RandomState(seed)
    ea = rng.randint(-133, 128, n)
    eb = np.clip(ea - rng.randint(0, 41, n) * rng.choice([-1, 1], n),
                 -133, 127)

    def make(e):
        m = rng.randint(0, 128, len(e)).astype(np.uint32)
        sign = rng.randint(0, 2, len(e)).astype(np.uint32) << 15
        sub = e < -126           # subnormal: 2^(e + 133) ulps of 2^-133
        exp = np.where(sub, 0, e + 127).astype(np.uint32)
        mant = np.where(sub, (1 << np.clip(e + 133, 0, 6)).astype(np.uint32)
                        | (m >> (7 - np.clip(e + 133, 0, 6))), m)
        return (sign | (exp << 7) | (mant & 0x7f)).astype(np.uint16)
    return make(ea), make(eb)


SPECIALS = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007f, 0x0080,
                     0x00ff, 0x7f7f, 0xff7f, 0x7f80, 0xff80, 0x3f80,
                     0xbf80, 0x0040, 0x8040, 0x7f00], np.uint16)


@pytest.mark.parametrize("op", ["+", "-", "*"])
def test_float_then_round_is_the_correctly_rounded_result(op):
    fn = {"+": np.add, "-": np.subtract, "*": np.multiply}[op]
    a, b = random_pairs(100_000, {"+": 1, "-": 2, "*": 3}[op])
    xa, xb = bits_to_f32(a), bits_to_f32(b)
    with np.errstate(over="ignore"):
        got = round_f32_to_bf16(fn(xa, xb))
    exact = {"+": lambda p, q: p + q, "-": lambda p, q: p - q,
             "*": lambda p, q: p * q}[op]
    want = np.array([exact_to_bf16(exact(Fraction(float(p)),
                                         Fraction(float(q))))
                     for p, q in zip(xa, xb)], np.float32)
    bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    # -0 and +0: an exact zero result is +0 in round to nearest (x - x,
    # x + -x), which the Fraction reference gives as +0 too
    assert len(bad) == 0, (op, bad[:5], xa[bad[:5]], xb[bad[:5]])
    # the draw covers what it claims: subnormal operands and gaps to 40
    assert (np.abs(xa) < 2 ** -126).sum() > 100
    gaps = np.abs(np.floor(np.log2(np.abs(xa.astype(np.float64))))
                  - np.floor(np.log2(np.abs(xb.astype(np.float64)))))
    assert gaps.max() >= 40 and (gaps <= 15).sum() > 1000


@pytest.mark.parametrize("op", ["+", "-", "*"])
def test_specials_follow_ieee(op):
    """Zeros, subnormals, the largest finite values and infinities, every
    pair of them: float32-then-round gives the float64 IEEE result
    rounded once (exact for these operands), NaN where IEEE says NaN."""
    fn = {"+": np.add, "-": np.subtract, "*": np.multiply}[op]
    a, b = np.meshgrid(SPECIALS, SPECIALS)
    xa, xb = bits_to_f32(a.ravel()), bits_to_f32(b.ravel())
    with np.errstate(invalid="ignore", over="ignore"):
        got = round_f32_to_bf16(fn(xa, xb))
        wide = fn(xa.astype(np.float64), xb.astype(np.float64))
        finite = np.isfinite(wide)
        want = np.array([exact_to_bf16(Fraction(float(w))) if f and w else w
                         for w, f in zip(wide, finite)], np.float32)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        keep = ~np.isnan(want)
        assert np.array_equal(got[keep].view(np.uint32),
                              want[keep].view(np.uint32))
        # the port's oracle rounds as this test does
        np.testing.assert_array_equal(lowering.round_bf16(fn(xa, xb)), got)


def test_exact_rounding_reference_itself():
    """The reference on known cases: ties to even, the subnormal step,
    overflow to infinity."""
    one = Fraction(1)
    assert exact_to_bf16(one + Fraction(1, 256)) == 1.0       # tie, even
    assert exact_to_bf16(one + Fraction(3, 256)) == 1.0 + 2 ** -6
    assert exact_to_bf16(Fraction(1, 2 ** 134)) == 0.0        # half, even
    assert exact_to_bf16(Fraction(3, 2 ** 134)) == 2.0 ** -132
    assert exact_to_bf16(MAX_FINITE) == float(MAX_FINITE)
    assert exact_to_bf16(MAX_FINITE + 2 ** 119) == float("inf")


# ---------------------------------------------------------------------------
# the emitter's classification
# ---------------------------------------------------------------------------

_STMT = re.compile(r"^\s*const (\S+) (v\d+)(\[2\])? = (.*);$")


def statements(source: str, fn: str):
    """``{vN: (type, lanes, text)}`` of point function ``fn``."""
    body = source[source.index(f" {fn}(const RD& rd"):]
    body = body[:body.index("\n    }")]
    out = {}
    for line in body.splitlines():
        m = _STMT.match(line)
        if m:
            out[m.group(2)] = (m.group(1), bool(m.group(3)), m.group(4))
    return out


def pair_of(program) -> str:
    """Both flavours of a single-stage program's point function, as the
    stream arm's source prints them."""
    pt = cuda_emit._print(program, [])
    lines = cuda_emit._print_pairs(pt)
    one = "\n".join(pt.stage_lines[0])
    two = "\n".join(lines)
    return (f" point(const RD& rd\n{one}\n    }}\n"
            f" point2(const RD& rd\n{two}\n    }}\n")


def op_kind(text: str) -> str:
    """What ``point``'s statement computes: a bfloat16 op rounded once
    (``R+`` and kin), a read, a float32 value (``F``), or another."""
    m = re.match(r"^yt::rbf\((v\d+) ([-+*/]) (.+)\)$", text)
    if m:
        return "R" + m.group(2)
    if text.startswith("yt::rbf(yt::f_"):
        return "Rf"
    if text.startswith("yt::to_f("):
        return "read"
    if text.startswith("-("):
        return "neg"
    return "other"


def check_flavours(src: str) -> dict:
    one, two = statements(src, "point"), statements(src, "point2")
    assert one.keys() == two.keys()
    seen = {}
    for v, (ty, lanes, text) in one.items():
        ty2, lanes2, text2 = two[v]
        kind = op_kind(text)
        seen[kind] = seen.get(kind, 0) + 1
        packed = re.match(r"^yt::(add2|sub2|mul2|neg2)\(", text2)
        if kind in ("R+", "R-", "R*"):
            assert packed and packed.group(1) == \
                {"R+": "add2", "R-": "sub2", "R*": "mul2"}[kind], (v, text2)
        elif kind == "neg" and ty2 == "yt::bf2":
            assert packed and packed.group(1) == "neg2", (v, text2)
        else:
            assert not packed, (v, text, text2)
        if kind in ("R/", "Rf"):
            # per lane in float, rounded once per lane
            assert text2.startswith("yt::pack(") and "yt::lane1(" in text2
        assert ty2 != "float" or lanes2, \
            f"{v}: a float32 value is per lane: {text2}"
        if ty == "float" and kind == "other" and lanes2:
            assert ty2 in ("float", "int", "bool") and "," in text2
        if kind == "read":
            assert text2.startswith("rd.template at<") and ty2 == "yt::bf2"
    return seen


@pytest.mark.parametrize("name,r,want", [
    ("iso3dfd", 2, {"R+", "R-", "R*"}), ("3axis", 1, {"R+", "R/"})])
def test_registered_solutions_pack_their_ops(name, r, want):
    ctx = port_ctx(name, r, "-g 12 -mode fused")
    seen = check_flavours(pair_of(ctx._program))
    assert want <= set(seen)
    src = ctx._fused_spec_kernel().spec.source
    assert " point2(const RD& rd" in src


def test_functions_float32_values_and_conditions_per_lane():
    """cond_funcs (tests/test_torch_fused.py) at element size 2: index
    values with float constants (float32, lane arrays), ``%`` on
    indices, functions of bfloat16 values (per lane, rounded once), a
    negation inside a function (packed), partial-dim reads, and domain
    and step conditions (the write selects per lane)."""
    from test_torch_fused import cond_funcs
    s = cond_funcs("yask_tpu_torch")
    s.set_element_bytes(2)
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), s)
    ctx.apply_command_line_options("-g 12 -mode fused")
    ctx.prepare_solution()
    src = pair_of(ctx._program)
    seen = check_flavours(src)
    assert {"neg", "R-", "R*", "R+", "Rf"} <= set(seen), seen
    two = statements(src, "point2")
    assert any(ty == "float" and lanes for ty, lanes, _ in two.values())
    assert any(ty == "bool" and lanes for ty, lanes, _ in two.values())
    assert "yt::select2(" in src and "(g[2] + 1)" in src
    assert ctx._fused_spec_kernel().spec.stream is not None


def test_constants_are_bfloat16_pairs():
    """A constant meeting a bfloat16 value is the pair of its bfloat16
    rounding, as ``yt::rbf((float)(c))`` rounds it in ``point``."""
    ctx = port_ctx("iso3dfd", 2, "-g 12 -mode fused")
    src = pair_of(ctx._program)
    consts = re.findall(r"yt::rbf\(\(float\)\(\((-?0x[0-9a-f.]+p[+-]\d+)\)\)\)",
                        "\n".join(statements(src, "point")[v][2]
                                  for v in statements(src, "point")))
    pairs = re.findall(r"yt::bf2_bits\((0x[0-9a-f]{4})\)", src)
    assert consts and len(consts) == len(pairs)
    for c, p in zip(consts, pairs):
        want = lowering.round_bf16(np.float32(float.fromhex(c)))
        assert int(p, 16) == int(np.float32(want).view(np.uint32) >> 16)
        assert cuda_emit.bf16_bits(float.fromhex(c)) == int(p, 16)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

R8 = {0: ((8, 8), (8, 8), (8, 8))}
R2 = {0: ((2, 2), (2, 2), (2, 2))}


@pytest.mark.parametrize("halos", [R8, R2], ids=["r8", "r2"])
def test_pair_plans_keep_64_registers_and_16_byte_rows(halos):
    plan = tile_planner.stream_plan(halos, (512, 512, 512), 2)
    nt = tile_planner.stream_threads(*plan.tile, 2)
    assert nt * 2 == plan.tile[0] * plan.tile[1]
    regs = tile_planner.thread_registers(nt, plan.per_sm)
    assert regs % 8 == 0
    assert regs >= tile_planner.STREAM_PAIR_MIN_REGS >= \
        tile_planner.STREAM_OUTER_MIN_REGS
    assert plan.queue == 3
    rec = plan.record()["pairs"]
    assert rec == {"flavour": "bfloat16x2", "points_per_thread": 2,
                   "threads": nt, "registers": regs, "row_unit_bytes": 16}
    for a, h in halos.items():
        e2 = plan.tile[1] + sum(h[2])
        row = tile_planner.pair_row(e2)
        assert row % 8 == 0 and e2 + 7 <= row < e2 + 15
    assert plan.smem_bytes == 2 * tile_planner.ring_cells(
        halos, plan.depths, *plan.tile, 2)
    assert plan.smem_bytes <= cuda_emit.SMEM_LIMIT
    if halos is R8:
        # the flagship: 16x64 by 512 threads, two blocks an SM, 64
        # registers and a queue of 3
        assert plan.tile == (16, 64) and plan.per_sm == 2
        assert plan.queue == 3 and plan.smem_bytes == 2 * (20 * 32 * 88 + 8)


def test_fp32_plans_are_unchanged():
    """The flagship's fp32 plan as before (tests/test_torch_skew.py holds
    it too), and no pair record."""
    plan = tile_planner.stream_plan(R8, (512, 512, 512), 4)
    assert plan.tile == (16, 64) and plan.smem_bytes == 204800
    assert plan.per_sm == 1 and plan.queue == 3
    assert "pairs" not in plan.record()
    assert tile_planner.stream_row(80, 4) == 80
    assert tile_planner.stream_row(80, 2) == 82      # K6's pair rows


def test_the_context_pads_the_minor_extent_to_16_bytes():
    """A single-stage solution at element size 2 pads its minor extent to
    a multiple of 8 cells (K1's stream arm's units); a solution on K6
    keeps even extents (its sources hold the pads)."""
    ctx = port_ctx("iso3dfd", 2, "-g 13 -mode fused")
    assert all(g.shape[-1] % 8 == 0 for g in ctx._program.geoms.values())
    k6 = port_ctx("tti", 2, "-g 13 -mode fused")
    assert all(g.shape[-1] % 2 == 0 for g in k6._program.geoms.values())
    assert any(g.shape[-1] % 8 for g in k6._program.geoms.values())
