"""Simple axis/plane/cube stencils.

Counterpart of the reference's ``src/stencils/SimpleStencils.cpp:115-267``:
MiniGhost-style radius-parameterized averages over neighbor sets. Same
solution names and equation shapes; equations are built through the DSL,
not copied — the reference file documents WHAT each stencil averages.
"""

from __future__ import annotations

from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_with_radius_base,
)


@register_solution
class AxisStencil(yc_solution_with_radius_base):
    """'3axis': average of the center point and its neighbors out to
    ``radius`` along each axis (a (6r+1)-point star; r=1 is the classic
    7-point heat stencil)."""

    def __init__(self, name: str = "3axis", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        A = self.new_var("A", [t, x, y, z])
        r = self.get_radius()
        terms = [A(t, x, y, z)]
        for i in range(1, r + 1):
            terms += [A(t, x - i, y, z), A(t, x + i, y, z),
                      A(t, x, y - i, z), A(t, x, y + i, z),
                      A(t, x, y, z - i), A(t, x, y, z + i)]
        npts = float(len(terms))
        expr = terms[0]
        for term in terms[1:]:
            expr = expr + term
        A(t + 1, x, y, z).EQUALS(expr / npts)


@register_solution
class DiagStencil(yc_solution_with_radius_base):
    """'3axis_with_diags': the 3axis star plus corner-diagonal neighbors
    (reference ``DiagStencil``)."""

    def __init__(self, name: str = "3axis_with_diags", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        A = self.new_var("A", [t, x, y, z])
        r = self.get_radius()
        terms = [A(t, x, y, z)]
        for i in range(1, r + 1):
            terms += [A(t, x - i, y, z), A(t, x + i, y, z),
                      A(t, x, y - i, z), A(t, x, y + i, z),
                      A(t, x, y, z - i), A(t, x, y, z + i)]
            # 12 in-plane diagonals at distance i: 4 per coordinate plane
            # (the reference's DiagStencil adds x-y, x-z, and y-z plane
            # diagonals, not space corners).
            for si, sj in ((-i, -i), (-i, i), (i, -i), (i, i)):
                terms.append(A(t, x + si, y + sj, z))
                terms.append(A(t, x + si, y, z + sj))
                terms.append(A(t, x, y + si, z + sj))
        expr = terms[0]
        for term in terms[1:]:
            expr = expr + term
        A(t + 1, x, y, z).EQUALS(expr / float(len(terms)))


@register_solution
class PlaneStencil(yc_solution_with_radius_base):
    """'3plane': average over in-plane neighbors of the three coordinate
    planes (reference ``PlaneStencil``)."""

    def __init__(self, name: str = "3plane", radius: int = 1):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        A = self.new_var("A", [t, x, y, z])
        r = self.get_radius()
        # Distinct points of the union of the xy, xz, and yz planes within
        # radius r (center and on-axis points appear once each).
        offsets = set()
        for i in range(-r, r + 1):
            for j in range(-r, r + 1):
                offsets.add((i, j, 0))
                offsets.add((i, 0, j))
                offsets.add((0, i, j))
        terms = [A(t, x + dx, y + dy, z + dz)
                 for dx, dy, dz in sorted(offsets)]
        expr = terms[0]
        for term in terms[1:]:
            expr = expr + term
        A(t + 1, x, y, z).EQUALS(expr / float(len(terms)))


@register_solution
class CubeStencil(yc_solution_with_radius_base):
    """'cube': average over the full (2r+1)³ box (reference
    ``CubeStencil``; r=1 is the 27-point stencil)."""

    def __init__(self, name: str = "cube", radius: int = 1):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        A = self.new_var("A", [t, x, y, z])
        r = self.get_radius()
        terms = []
        for i in range(-r, r + 1):
            for j in range(-r, r + 1):
                for k in range(-r, r + 1):
                    terms.append(A(t, x + i, y + j, z + k))
        expr = terms[0]
        for term in terms[1:]:
            expr = expr + term
        A(t + 1, x, y, z).EQUALS(expr / float(len(terms)))


@register_solution
class NineAxisStencil(yc_solution_with_radius_base):
    """'9axis': average along the 3 axes and 6 space diagonals out to
    ``radius`` (reference ``...`` 9-axis variant of the Simple family)."""

    def __init__(self, name: str = "9axis", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        A = self.new_var("A", [t, x, y, z])
        r = self.get_radius()
        terms = [A(t, x, y, z)]
        dirs = [(1, 0, 0), (0, 1, 0), (0, 0, 1),
                (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1)]
        for i in range(1, r + 1):
            for dx, dy, dz in dirs:
                terms.append(A(t, x + i * dx, y + i * dy, z + i * dz))
                terms.append(A(t, x - i * dx, y - i * dy, z - i * dz))
        expr = terms[0]
        for term in terms[1:]:
            expr = expr + term
        A(t + 1, x, y, z).EQUALS(expr / float(len(terms)))
