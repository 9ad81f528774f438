"""Image filters with a misc (channel) dim.

Counterpart of the reference's ``box``/``gaussian`` stencils
(``src/stencils/ImageFilters.cpp:76,123``), which exist to exercise
misc-dim (channel) indexing in the DSL: the image is ``(t, c, x, y)`` with
``c`` a misc dim indexed by constants.
"""

from __future__ import annotations

import math

from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_with_radius_base,
)

NUM_CHANNELS = 3


@register_solution
class BoxFilter(yc_solution_with_radius_base):
    """'box': per-channel (2r+1)² moving average, repeated each step."""

    def __init__(self, name: str = "box", radius: int = 1):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        c = self.new_misc_index("c")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        img = self.new_var("img", [t, c, x, y])
        r = self.get_radius()
        n = float((2 * r + 1) ** 2)
        for ch in range(NUM_CHANNELS):
            expr = None
            for i in range(-r, r + 1):
                for j in range(-r, r + 1):
                    term = img(t, ch, x + i, y + j)
                    expr = term if expr is None else expr + term
            img(t + 1, ch, x, y).EQUALS(expr / n)


@register_solution
class GaussianFilter(yc_solution_with_radius_base):
    """'gaussian': separable-weight Gaussian blur per channel."""

    def __init__(self, name: str = "gaussian", radius: int = 1):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        c = self.new_misc_index("c")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        img = self.new_var("img", [t, c, x, y])
        r = self.get_radius()
        sigma = max(r / 2.0, 0.5)
        w1 = [math.exp(-(i * i) / (2 * sigma * sigma))
              for i in range(-r, r + 1)]
        s = sum(w1)
        w1 = [w / s for w in w1]
        for ch in range(NUM_CHANNELS):
            expr = None
            for i in range(-r, r + 1):
                for j in range(-r, r + 1):
                    term = (w1[i + r] * w1[j + r]) * img(t, ch, x + i, y + j)
                    expr = term if expr is None else expr + term
            img(t + 1, ch, x, y).EQUALS(expr)
