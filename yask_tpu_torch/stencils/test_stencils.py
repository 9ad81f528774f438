"""Feature-coverage test stencils.

Counterpart of the reference's ``src/stencils/TestStencils.cpp:200-1035``:
one small solution per DSL feature, used as the primary correctness
fixtures (dimensionality 1-D…4-D, misc dims, scratch chains, multi-stage
dependencies, sub-domain boundaries, step conditions, reverse time,
memory-bound streams, math functions).
"""

from __future__ import annotations

from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_base,
    yc_solution_with_radius_base,
)


def _def_t1d(r, V, t0, x, off, le, re):
    """Radius-sized 1-D sample at step t0, extended per side (reference
    ``TestBase::def_t1d``): left/right halos differ, pinning asymmetric
    halo analysis. ``off`` shifts the whole neighborhood."""
    v = None
    for i in range(-r - le, r + re + 1):
        term = V(t0, x + (off + i))
        v = term if v is None else v + term
    return 2.0 + v


def _def_1d(r, V, x, off, le, re):
    v = None
    for i in range(-r - le, r + re + 1):
        term = V(x + (off + i))
        v = term if v is None else v + term
    return 3.0 + v


def _def_t2d(r, V, t0, x, xle, xre, y, yle, yre):
    v = None
    for i in (-r - xle, 0, r + xre):
        for j in (-r - yle, 0, r + yre):
            term = V(t0, x + i, y + j)
            v = term if v is None else v + term
    return 4.0 + v


def _def_2d(r, V, x, xle, xre, y, yle, yre):
    v = None
    for i in (-r - xle, 0, r + xre):
        for j in (-r - yle, 0, r + yre):
            term = V(x + i, y + j)
            v = term if v is None else v + term
    return 5.0 + v


def _def_t3d(r, V, t0, x, xle, xre, y, yle, yre, z, zle, zre):
    v = V(t0, x, y, z)
    for i in (-r - xle, r + xre):
        for j in (-r - yle, r + yre):
            for k in (-r - zle, r + zre):
                v = v + V(t0, x + i, y + j, z + k)
    return v


def _def_3d(r, V, x, xle, xre, y, yle, yre, z, zle, zre):
    v = V(x, y, z)
    for i in (-r - xle, r + xre):
        for j in (-r - yle, r + yre):
            for k in (-r - zle, r + zre):
                v = v + V(x + i, y + j, z + k)
    return v


class _NdTest(yc_solution_with_radius_base):
    """N-D sum over an asymmetric neighborhood (reference
    ``Test1dStencil…Test4dStencil``, ``TestStencils.cpp:177-280``: the
    per-side extents make left/right halos differ per dim)."""

    DIMS = ("x",)
    EXTS = {"x": (0, 2)}    # per-dim (left_ext, right_ext)

    def define(self):
        t = self.new_step_index("t")
        idxs = [self.new_domain_index(d) for d in self.DIMS]
        u = self.new_var("u", [t] + idxs)
        r = self.get_radius()
        if len(idxs) == 1:
            le, re = self.EXTS["x"]
            expr = _def_t1d(r, u, t, idxs[0], 0, le, re)
        else:
            # center plus the corners of the extended polytope
            expr = u(t, *idxs)
            ranges = [(-r - self.EXTS[d][0], r + self.EXTS[d][1])
                      for d in self.DIMS]
            import itertools
            for corner in itertools.product(*ranges):
                pt = [idx + off for idx, off in zip(idxs, corner)]
                expr = expr + u(t, *pt)
        n = float(1 + 2 ** len(idxs)) if len(idxs) > 1 \
            else float(1 + 2 * r + self.EXTS["x"][0] + self.EXTS["x"][1])
        u(t + 1, *idxs).EQUALS(expr / n)


@register_solution
class Test1d(_NdTest):
    DIMS = ("x",)
    EXTS = {"x": (0, 2)}

    def __init__(self):
        super().__init__("test_1d", radius=1)


@register_solution
class Test2d(_NdTest):
    DIMS = ("x", "y")
    EXTS = {"x": (0, 2), "y": (4, 3)}

    def __init__(self):
        super().__init__("test_2d", radius=1)


@register_solution
class Test3d(_NdTest):
    DIMS = ("x", "y", "z")
    EXTS = {"x": (0, 2), "y": (4, 3), "z": (2, 1)}

    def __init__(self):
        super().__init__("test_3d", radius=1)


@register_solution
class Test4d(_NdTest):
    DIMS = ("w", "x", "y", "z")
    EXTS = {"w": (1, 2), "x": (0, 2), "y": (2, 1), "z": (1, 0)}

    def __init__(self):
        super().__init__("test_4d", radius=1)


@register_solution
class TestMisc2d(yc_solution_with_radius_base):
    """Misc indices interleaved between domain dims, negative misc
    values, misc-only and step+misc vars (reference
    ``TestMisc2dStencil``, ``TestStencils.cpp:330``)."""

    def __init__(self):
        super().__init__("test_misc_2d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        am = self.new_misc_index("a")
        bm = self.new_misc_index("b")
        cm = self.new_misc_index("c")
        r = self.get_radius()
        a = self.new_var("A", [t, x, am, y, bm, cm])
        b = self.new_var("B", [cm, bm])
        c = self.new_var("C", [t, bm, am])
        v = a(t, x, 0, y, 1, 2) + 1.0
        for i in range(1, r + 1):
            v = v + a(t, x + i, 3, y, 0, 3)
        for i in range(1, r + 2):
            v = v + a(t, x - i, 4, y, 2, 2)
        for i in range(1, r + 3):
            v = v + a(t, x, -2, y + i, 2, 2)
        for i in range(1, r + 4):
            v = v + a(t, x, 0, y - i, 0, 3)
        v = v + c(t, 1, 2)
        a(t + 1, x, 1, y, 2, 3).EQUALS(v + b(-2, 3) - b(4, -2))


@register_solution
class TestMiscValue2d(yc_solution_with_radius_base):
    """Misc index used as a VALUE (test_misc_value_2d): each equation's
    RHS reads the misc index it pins on the LHS — the per-equation
    constant the reference's generated code inlines. Exercises the
    per-equation eval-memo scoping in every backend (a shared memo
    would leak one equation's binding into its siblings)."""

    def __init__(self):
        super().__init__("test_misc_value_2d", radius=1)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        im = self.new_misc_index("i")
        r = self.get_radius()
        a = self.new_var("A", [t, x, y, im])
        for i in range(3):
            v = a(t, x, y, i) * 0.5 + im * 0.25
            for k in range(1, r + 1):
                v = v + (a(t, x + k, y, i) - a(t, x - k, y, i)) \
                    * (im + 1.0)
            a(t + 1, x, y, i).EQUALS(v)


@register_solution
class TestScratch1d(yc_solution_with_radius_base):
    """Scratch var read at far offsets from the write point (reference
    ``TestScratchStencil1``, ``TestStencils.cpp:626``: reads around
    ``x-4`` and ``x+6`` force a wide, asymmetric scratch halo)."""

    def __init__(self):
        super().__init__("test_scratch_1d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        r = self.get_radius()
        a = self.new_var("A", [t, x])
        b = self.new_scratch_var("B", [x])
        b(x).EQUALS(_def_t1d(r, a, t, x, 0, 1, 0))
        a(t + 1, x).EQUALS(_def_1d(r, b, x, -4, 2, 3)
                           + _def_1d(r, b, x, 6, 0, 1))


@register_solution
class TestStages2d(yc_solution_with_radius_base):
    """Three-stage dependency chain: B(t+1) reads A(t+1), C(t+1) reads
    B(t+1) at an offset (reference ``TestDepStencil2``,
    ``TestStencils.cpp:560``)."""

    def __init__(self):
        super().__init__("test_stages_2d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        r = self.get_radius()
        a = self.new_var("A", [t, x, y])
        b = self.new_var("B", [t, x, y])
        c = self.new_var("C", [t, x, y])
        a(t + 1, x, y).EQUALS(
            a(t, x, y) - _def_t2d(r, b, t, x, 0, 1, y, 2, 1))
        b(t + 1, x, y).EQUALS(
            b(t, x, y) - _def_t2d(r, a, t + 1, x, 3, 2, y, 0, 1))
        c(t + 1, x, y).EQUALS(b(t + 1, x - 1, y + 2))


@register_solution
class TestBoundary1d(yc_solution_base):
    """Sub-domain conditions with first/last_domain_index
    (test_boundary_*)."""

    def __init__(self):
        super().__init__("test_boundary_1d")

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        u = self.new_var("A", [t, x])
        first = self.first_domain_index(x)
        last = self.last_domain_index(x)
        sd0 = (x >= first + 5) & (x <= last - 3)
        v = _def_t1d(2, u, t, x, 0, 0, 1)
        u(t + 1, x).EQUALS(v).IF_DOMAIN(sd0)
        u(t + 1, x).EQUALS(-v).IF_DOMAIN(~sd0)


@register_solution
class TestStepCond1d(yc_solution_base):
    """Step conditions: different update on even/odd steps
    (test_step_cond_1d)."""

    def __init__(self):
        super().__init__("test_step_cond_1d")

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        b_ = self.new_misc_index("b")
        r = 2
        a = self.new_var("A", [t, x])
        bv = self.new_var("B", [b_])
        # step-parity condition and a condition on misc-var CONTENTS
        # (reference ``TestStepCondStencil1``, ``TestStencils.cpp:874``)
        tc0 = (t % 2) == 0
        vc0 = bv(0) > bv(1)
        a(t + 1, x).EQUALS(_def_t1d(r, a, t, x, 0, 0, 0)).IF_STEP(tc0)
        a(t + 1, x).EQUALS(
            _def_t1d(r, a, t, x, 0, 1, 2)).IF_STEP(~tc0 & vc0)
        # combined step + domain condition on one equation
        a(t + 1, x).EQUALS(
            _def_t1d(r, a, t, x, 0, 2, 0)).IF_STEP(~tc0 & ~vc0).IF_DOMAIN(
                x > self.first_domain_index(x) + 5)


@register_solution
class TestReverse2d(yc_solution_base):
    """Reverse-time stepping (test_reverse_2d): writes t-1 from t."""

    def __init__(self):
        super().__init__("test_reverse_2d")

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        u = self.new_var("A", [t, x, y])
        u(t - 1, x, y).EQUALS(
            _def_t2d(2, u, t, x, 0, 2, y, 4, 3) / 10.0)


class _StreamNd(yc_solution_with_radius_base):
    """Memory-bound stream reading ``radius`` past steps (reference
    ``StreamStencil1/2/3``, ``TestStencils.cpp:387-477``): exercises
    ring allocations deeper than 2."""

    DIMS = ("x",)

    def define(self):
        t = self.new_step_index("t")
        idxs = [self.new_domain_index(d) for d in self.DIMS]
        a = self.new_var("A", [t] + idxs)
        v = None
        for r in range(self.get_radius()):
            term = a(t - r, *idxs)
            v = term if v is None else v + term
        a(t + 1, *idxs).EQUALS(v + 1.0)


@register_solution
class TestStream3d(_StreamNd):
    """Memory-bound stream reading ``radius`` past steps (reference
    ``StreamStencil3``, ``TestStencils.cpp:461``)."""

    DIMS = ("x", "y", "z")

    def __init__(self):
        super().__init__("test_stream_3d", radius=2)


@register_solution
class TestFunc1d(yc_solution_base):
    """Math-function nodes (test_func_1d)."""

    def __init__(self):
        super().__init__("test_func_1d")

    def define(self):
        from yask_tpu_torch.compiler.expr import sin, cos, atan, cbrt, max_fn
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        r = 1
        a = self.new_var("A", [t, x])
        b = self.new_var("B", [t, x])
        c = self.new_var("C", [t, x])
        a(t + 1, x).EQUALS(cos(a(t, x)) - 2.0 * sin(a(t, x)))
        b(t + 1, x).EQUALS(max_fn(_def_t1d(r, b, t, x, 0, 0, 1), 2.5))
        # C depends on A(t+1): math funcs ACROSS a stage boundary
        # (reference ``TestFuncStencil1``, ``TestStencils.cpp:967``)
        # +2 keeps the denominator away from cbrt(0) under zero-filled
        # boundary ghosts (0/0 → nan would poison the comparison)
        c(t + 1, x).EQUALS(
            atan(_def_t1d(r, a, t + 1, x, 0, 1, 0)
                 / cbrt(c(t, x + 1) + 2.0)))


@register_solution
class TestPartial3d(yc_solution_base):
    """Vars spanning subsets of the domain dims, in different orders
    (test_partial_3d): exercises axis alignment in lowering."""

    def __init__(self):
        super().__init__("test_partial_3d")

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        r = 2
        a = self.new_var("A", [t, x, y, z])
        b = self.new_var("B", [x])
        c = self.new_var("C", [y])
        d = self.new_var("D", [z])
        e = self.new_var("E", [x, y])
        f = self.new_var("F", [y, z])
        g = self.new_var("G", [z, y])       # reversed declaration order
        h = self.new_var("H", [y, z, x])    # 3-D in different order
        i_ = self.new_var("I", [])          # scalar
        j = self.new_var("J", [t])          # step-only
        k = self.new_var("K", [t, y])       # step + 1-D
        el = self.new_var("L", [t, y, z])   # step + 2-D
        a(t + 1, x, y, z).EQUALS(
            _def_t3d(r, a, t, x, 0, 2, y, 4, 3, z, 2, 1)
            + _def_1d(r, b, x, 0, 0, 1)
            + _def_1d(r, c, y, 0, 1, 0)
            + _def_1d(r, d, z, 0, 0, 0)
            + _def_2d(r, e, x, 0, 0, y, 1, 0)
            + _def_2d(r, f, y, 0, 1, z, 0, 0)
            + _def_2d(r, g, z, 1, 0, y, 0, 1)
            + _def_3d(r, h, y, 1, 0, z, 0, 1, x, 1, 0)
            + i_()
            + j(t)
            + _def_t1d(r, k, t, y, 0, 0, 1)
            + _def_t2d(r, el, t, y, 1, 0, z, 0, 1))


class _TestHelpers(yc_solution_with_radius_base):
    """Asymmetric-extent stencil builders shared by the fixture family.

    Counterpart of the reference ``TestBase`` helpers
    (``TestStencils.cpp:38-176``): each samples a radius-sized
    neighborhood extended by per-side ``*_ext`` amounts, so left/right
    halos differ — the corner the dependency/halo analysis must pin.
    ``off`` shifts the whole neighborhood (the reference passes shifted
    index expressions like ``x-4`` directly).
    """

    def def_t1d(self, V, t0, x, off, le, re):
        return _def_t1d(self.get_radius(), V, t0, x, off, le, re)

    def def_1d(self, V, x, off, le, re):
        return _def_1d(self.get_radius(), V, x, off, le, re)

    def def_t2d(self, V, t0, x, xle, xre, y, yle, yre):
        return _def_t2d(self.get_radius(), V, t0, x, xle, xre, y, yle, yre)

    def def_2d(self, V, x, xle, xre, y, yle, yre):
        return _def_2d(self.get_radius(), V, x, xle, xre, y, yle, yre)

    def def_t3d(self, V, t0, x, xle, xre, y, yle, yre, z, zle, zre):
        return _def_t3d(self.get_radius(), V, t0, x, xle, xre,
                        y, yle, yre, z, zle, zre)

    def def_3d(self, V, x, xle, xre, y, yle, yre, z, zle, zre):
        return _def_3d(self.get_radius(), V, x, xle, xre,
                       y, yle, yre, z, zle, zre)


@register_solution
class TestStages1d(_TestHelpers):
    """1-D dependency chain: C(t+1) reads A(t+1) → a 2nd stage
    (reference ``TestDepStencil1``, ``TestStencils.cpp:529``)."""

    def __init__(self):
        super().__init__("test_stages_1d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        a = self.new_var("A", [t, x])
        b = self.new_var("B", [t, x])
        c = self.new_var("C", [t, x])
        a(t + 1, x).EQUALS(-2.0 * a(t, x))
        b(t + 1, x).EQUALS(self.def_t1d(b, t, x, 0, 0, 1))
        c(t + 1, x).EQUALS(self.def_t1d(a, t + 1, x, 0, 1, 0) + c(t, x + 1))


@register_solution
class TestStages3d(_TestHelpers):
    """3-D two-stage chain: B(t+1) reads A(t+1) with its own asymmetric
    halo (reference ``TestDepStencil3``, ``TestStencils.cpp:593``)."""

    def __init__(self):
        super().__init__("test_stages_3d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        a = self.new_var("A", [t, x, y, z])
        b = self.new_var("B", [t, x, y, z])
        a(t + 1, x, y, z).EQUALS(
            a(t, x, y, z) - self.def_t3d(b, t, x, 0, 1, y, 2, 1, z, 1, 0))
        b(t + 1, x, y, z).EQUALS(
            b(t, x, y, z) - self.def_t3d(a, t + 1, x, 1, 0, y, 0, 1,
                                         z, 2, 1))


@register_solution
class TestScratch2d(_TestHelpers):
    """Three-level scratch chain with slot reuse potential (reference
    ``TestScratchStencil2``, ``TestStencils.cpp:657``)."""

    def __init__(self):
        super().__init__("test_scratch_2d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        a = self.new_var("A", [t, x, y])
        t1 = self.new_scratch_var("t1", [x, y])
        t2 = self.new_scratch_var("t2", [x, y])
        t3 = self.new_scratch_var("t3", [x, y])
        t1(x, y).EQUALS(self.def_t2d(a, t, x, 0, 1, y, 2, 1))
        t2(x, y).EQUALS(t1(x, y + 1))
        t3(x, y).EQUALS(t2(x + 1, y))
        a(t + 1, x, y).EQUALS(
            a(t, x, y) + self.def_2d(t2, x, 2, 0, y, 1, 0)
            + self.def_2d(t3, x, 1, 0, y, 0, 1))


@register_solution
class TestScratch3d(_TestHelpers):
    """Diamond scratch dependencies: t3 reads two independent scratch
    vars (reference ``TestScratchStencil3``, ``TestStencils.cpp:699``)."""

    def __init__(self):
        super().__init__("test_scratch_3d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        a = self.new_var("A", [t, x, y, z])
        t1 = self.new_scratch_var("t1", [x, y, z])
        t2 = self.new_scratch_var("t2", [x, y, z])
        t3 = self.new_scratch_var("t3", [x, y, z])
        t1(x, y, z).EQUALS(self.def_t3d(a, t, x, 0, 1, y, 2, 1, z, 1, 0))
        t2(x, y, z).EQUALS(self.def_t3d(a, t, x, 1, 0, y, 0, 2, z, 0, 1))
        t3(x, y, z).EQUALS(t1(x - 1, y + 1, z) + t2(x, y, z - 1))
        a(t + 1, x, y, z).EQUALS(
            a(t, x, y, z) + self.def_3d(t1, x, 2, 0, y, 0, 1, z, 1, 0)
            + self.def_3d(t3, x, 1, 0, y, 0, 1, z, 0, 2))


@register_solution
class TestScratchStages1d(_TestHelpers):
    """Scratch vars split across stages, defined out of assignment
    order; C carries a large one-sided scratch halo and D reads another
    stage's t+1 output (reference ``TestScratchStagesStencil1``,
    ``TestStencils.cpp:740``)."""

    def __init__(self):
        super().__init__("test_scratch_stages_1d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        a = self.new_var("A", [t, x])
        b = self.new_var("B", [t, x])
        c = self.new_scratch_var("C", [x])
        d = self.new_scratch_var("D", [x])
        e = self.new_scratch_var("E", [x])
        a(t + 1, x).EQUALS(self.def_1d(c, x, 0, 1, 0))
        c(x).EQUALS(self.def_1d(d, x, 0, 0, 8))   # large RHS scratch halo
        d(x).EQUALS(self.def_t1d(b, t + 1, x, 0, 1, 0))
        b(t + 1, x).EQUALS(self.def_1d(e, x, 0, 0, 1))
        e(x).EQUALS(self.def_t1d(a, t, x, 0, 1, 0))


@register_solution
class TestBoundary2d(_TestHelpers):
    """Rectangle-interior sub-domain with different stencils inside and
    outside (reference ``TestBoundaryStencil2``,
    ``TestStencils.cpp:810``)."""

    def __init__(self):
        super().__init__("test_boundary_2d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        a = self.new_var("A", [t, x, y])
        sd0 = ((x >= self.first_domain_index(x) + 5)
               & (x <= self.last_domain_index(x) - 3)
               & (y >= self.first_domain_index(y) + 4)
               & (y <= self.last_domain_index(y) - 6))
        a(t + 1, x, y).EQUALS(
            self.def_t2d(a, t, x, 0, 2, y, 1, 0)).IF_DOMAIN(sd0)
        a(t + 1, x, y).EQUALS(
            self.def_t2d(a, t, x, 1, 0, y, 0, 2)).IF_DOMAIN(~sd0)


@register_solution
class TestBoundary3d(_TestHelpers):
    """3-D box-interior sub-domain (reference ``TestBoundaryStencil3``,
    ``TestStencils.cpp:841``)."""

    def __init__(self):
        super().__init__("test_boundary_3d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        a = self.new_var("A", [t, x, y, z])
        sd0 = ((x >= self.first_domain_index(x) + 5)
               & (x <= self.last_domain_index(x) - 3)
               & (y >= self.first_domain_index(y) + 4)
               & (y <= self.last_domain_index(y) - 6)
               & (z >= self.first_domain_index(z) + 6)
               & (z <= self.last_domain_index(z) - 4))
        a(t + 1, x, y, z).EQUALS(
            self.def_t3d(a, t, x, 0, 2, y, 1, 0, z, 0, 1)).IF_DOMAIN(sd0)
        a(t + 1, x, y, z).EQUALS(
            self.def_t3d(a, t, x, 1, 0, y, 0, 2, z, 1, 0)).IF_DOMAIN(~sd0)


@register_solution
class TestScratchBoundary1d(_TestHelpers):
    """Conditional scratch writes + far-offset scratch reads (reference
    ``TestScratchBoundaryStencil1``, ``TestStencils.cpp:925``)."""

    def __init__(self):
        super().__init__("test_scratch_boundary_1d", radius=2)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        a = self.new_var("A", [t, x])
        t1 = self.new_scratch_var("T1", [x])
        sd0 = ((x >= self.first_domain_index(x) + 5)
               & (x <= self.last_domain_index(x) - 3))
        sd1 = ((x >= self.first_domain_index(x) + 3)
               & (x <= self.last_domain_index(x) - 2))
        b0 = self.def_t1d(a, t, x, 0, 1, 0)
        t1(x).EQUALS(b0).IF_DOMAIN(sd0)
        t1(x).EQUALS(-b0).IF_DOMAIN(~sd0)
        a1 = (self.def_1d(t1, x, -6, 2, 3)
              - self.def_1d(t1, x, 7, 0, 2))
        a(t + 1, x).EQUALS(a1).IF_DOMAIN(sd1)
        a(t + 1, x).EQUALS(-a1).IF_DOMAIN(~sd1)


@register_solution
class TestEmpty(_TestHelpers):
    """No vars, no equations (reference ``TestEmptyStencil0``,
    ``TestStencils.cpp:999``): the runtime must prepare and step a
    solution that does nothing."""

    def __init__(self):
        super().__init__("test_empty", radius=1)

    def define(self):
        self.new_step_index("t")
        self.new_domain_index("x")


@register_solution
class TestEmpty2d(_TestHelpers):
    """Vars but no equations (reference ``TestEmptyStencil2``)."""

    def __init__(self):
        super().__init__("test_empty_2d", radius=1)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        self.new_var("A", [t, x, y])


@register_solution
class TestStream1d(_StreamNd):
    DIMS = ("x",)

    def __init__(self):
        super().__init__("test_stream_1d", radius=2)


@register_solution
class TestStream2d(_StreamNd):
    DIMS = ("x", "y")

    def __init__(self):
        super().__init__("test_stream_2d", radius=2)
