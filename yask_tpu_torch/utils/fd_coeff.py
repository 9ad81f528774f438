"""Finite-difference coefficient generation.

Counterpart of the reference's public FD-coefficient API
(``include/yask_common_api.hpp:282-320``, impl ``src/common/fd_coeff2.cpp`` /
``src/contrib/coefficients/fd_coeff.cpp``, which solves a Vandermonde-style
system). Here we use Fornberg's recursive algorithm (Fornberg 1988, public
domain mathematics) which is numerically stabler than an explicit Vandermonde
solve and yields identical coefficients on uniform grids.

Signatures mirror the reference exactly:

* ``get_center_fd_coefficients(d, radius)`` → 2*radius+1 coefficients
* ``get_forward_fd_coefficients(d, accuracy_order)`` → accuracy_order+1
* ``get_backward_fd_coefficients(d, accuracy_order)`` → accuracy_order+1
* ``get_arbitrary_fd_coefficients(d, eval_point, sample_points)``
"""

from __future__ import annotations

from typing import List, Sequence

from yask_tpu_torch.utils.exceptions import YaskException


def _fornberg_weights(d: int, x0: float, xs: Sequence[float]) -> List[float]:
    """Fornberg finite-difference weights for the d-th derivative at x0
    given sample points xs. Returns one weight per sample point."""
    n = len(xs)
    if n < 2:
        raise YaskException("need at least 2 sample points for FD coefficients")
    if d < 1:
        raise YaskException("derivative_order must be >= 1")
    if d >= n:
        raise YaskException(
            f"derivative order {d} needs more than {n} sample points")
    # c[k][j]: weight of xs[j] for the k-th derivative using points xs[0..i].
    c = [[0.0] * n for _ in range(d + 1)]
    c[0][0] = 1.0
    c1 = 1.0
    c4 = xs[0] - x0
    for i in range(1, n):
        mn = min(i, d)
        c2 = 1.0
        c5 = c4
        c4 = xs[i] - x0
        for j in range(i):
            c3 = xs[i] - xs[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[k][i] = c1 * (k * c[k - 1][i - 1]
                                    - c5 * c[k][i - 1]) / c2
                c[0][i] = -c1 * c5 * c[0][i - 1] / c2
            for k in range(mn, 0, -1):
                c[k][j] = (c4 * c[k][j] - k * c[k - 1][j]) / c3
            c[0][j] = c4 * c[0][j] / c3
        c1 = c2
    return c[d]


def get_arbitrary_fd_coefficients(derivative_order: int, eval_point: float,
                                  sample_points: Sequence[float]) -> List[float]:
    """FD coefficients at arbitrary evaluation and sample points
    (``yask_common_api.hpp:316``)."""
    return _fornberg_weights(derivative_order, eval_point,
                             list(map(float, sample_points)))


def get_center_fd_coefficients(derivative_order: int, radius: int) -> List[float]:
    """Center-form FD coefficients: ``radius`` points on each side, returning
    ``2*radius+1`` coefficients with ``2*radius``-order accuracy
    (``yask_common_api.hpp:282``)."""
    if radius < 1:
        raise YaskException("radius must be >= 1")
    pts = [float(i) for i in range(-radius, radius + 1)]
    return _fornberg_weights(derivative_order, 0.0, pts)


def get_forward_fd_coefficients(derivative_order: int,
                                accuracy_order: int) -> List[float]:
    """Forward-form FD coefficients: ``accuracy_order`` points to the right,
    returning ``accuracy_order+1`` coefficients (``yask_common_api.hpp:294``)."""
    if accuracy_order < 1:
        raise YaskException("accuracy_order must be >= 1")
    pts = [float(i) for i in range(0, accuracy_order + 1)]
    return _fornberg_weights(derivative_order, 0.0, pts)


def get_backward_fd_coefficients(derivative_order: int,
                                 accuracy_order: int) -> List[float]:
    """Backward-form FD coefficients: ``accuracy_order`` points to the left
    (``yask_common_api.hpp:306``)."""
    if accuracy_order < 1:
        raise YaskException("accuracy_order must be >= 1")
    pts = [float(i) for i in range(-accuracy_order, 1)]
    return _fornberg_weights(derivative_order, 0.0, pts)
