"""The port's copied DSL and analysis (yask_tpu_torch.compiler) against
yask_tpu's: for the same registered stencil both packages must build the
same equations and derive the same stages, halos, read widths and fused
step radius.  Structural comparisons, so the tolerance is exact."""

import pytest

from yask_tpu.compiler.solution_base import create_solution as tpu_create
from yask_tpu_torch.compiler.solution_base import (
    create_solution as port_create,
)

CASES = [("iso3dfd", 2), ("iso3dfd", 8), ("iso3dfd_sponge", 2),
         ("3axis", 1), ("3axis", 2), ("cube", 1)]


def analyses(name, r):
    a = tpu_create(name, radius=r).get_soln()
    b = port_create(name, radius=r).get_soln()
    return a, b, a.analyze(), b.analyze()


@pytest.mark.parametrize("name,r", CASES)
def test_equation_skeys_match(name, r):
    a, b, _, _ = analyses(name, r)
    assert [e.skey() for e in b.get_equations()] \
        == [e.skey() for e in a.get_equations()]


@pytest.mark.parametrize("name,r", CASES)
def test_stage_read_widths_and_radius_match(name, r):
    _, _, ta, pa = analyses(name, r)
    assert pa.stage_read_widths() == ta.stage_read_widths()
    assert pa.stage_read_widths_split() == ta.stage_read_widths_split()
    assert pa.fused_step_radius() == ta.fused_step_radius()
    assert pa.max_halos() == ta.max_halos()


@pytest.mark.parametrize("name,r", CASES)
def test_stages_counters_and_allocs_match(name, r):
    a, b, ta, pa = analyses(name, r)
    assert pa.summary() == ta.summary()
    assert (pa.counters.num_ops, pa.counters.num_reads,
            pa.counters.num_writes) == (ta.counters.num_ops,
                                        ta.counters.num_reads,
                                        ta.counters.num_writes)
    assert pa.domain_dims == ta.domain_dims and pa.step_dir == ta.step_dir
    va = {v.get_name(): (v.get_step_alloc_size() if v.step_dim() else 0,
                         dict(v.halo)) for v in a.get_vars()}
    vb = {v.get_name(): (v.get_step_alloc_size() if v.step_dim() else 0,
                         dict(v.halo)) for v in b.get_vars()}
    assert vb == va


def test_fd_coefficients_match_without_native_path():
    from yask_tpu.utils import fd_coeff as tpu_fd
    from yask_tpu_torch.utils import fd_coeff as port_fd
    for r in (1, 2, 4, 8):
        assert port_fd.get_center_fd_coefficients(2, r) == pytest.approx(
            tpu_fd.get_center_fd_coefficients(2, r), rel=1e-12, abs=1e-15)
