"""The port's stencil library against ``yask_tpu``'s: every solution
``yask_tpu`` registers is registered by the port, and runs ``-mode
torch`` (the port's plain version) to the interiors ``yask_tpu``'s
``jit`` gives, from the shared ``init_solution_vars`` law (values by
interior coordinate) over 2 steps at g = 12.

Tolerance, the repo's policy (ROADMAP.md C2): ``compare_data``'s
defaults (relative 1e-4, absolute 1e-7), and ``field_epsilon=1e-4`` on
top for the elastic families (ssg, fsg, awp and their variants), whose
long staggered sums XLA's CPU fusion contracts into multiply-adds that
eager PyTorch does not (``_FP_REASSOC`` of tests/test_pallas.py): they
differ at 7 to 47 points at the defaults.  The sweep takes about 30 s
on one CPU.
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu.stencils  # noqa: F401  (registers yask_tpu's library)
import yask_tpu_torch
from yask_tpu.compiler.solution_base import \
    get_registered_solutions as tpu_solutions
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.compiler.solution_base import \
    get_registered_solutions as port_solutions
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors

from test_torch_lowering import mismatches

G, STEPS = 12, 2
RADII = {"iso3dfd": 2, "iso3dfd_sponge": 2, "3axis": 1, "3axis_with_diags": 1,
         "3plane": 1, "cube": 1, "9axis": 1, "ssg": 2, "fsg": 2}
#: field_epsilon 1e-4: reassociated staggered sums
FIELD_EPS = {"awp", "awp_abc", "awp_elastic", "awp_elastic_abc", "fsg",
             "fsg2", "fsg2_abc", "fsg_abc", "fsg_merged", "fsg_merged_abc",
             "ssg", "ssg2", "ssg_merged"}



def tpu_interiors(ctx):
    """A yask_tpu context's ring slots cut to their interiors (misc axes
    to their declared extent), in the layout the port keeps."""
    out = {}
    for name, ring in ctx._state.items():
        g = ctx._program.geoms[name]
        idx = tuple(slice(g.origin[dn], g.origin[dn] + ctx._program.sizes[dn])
                    if kind == "domain" else slice(0, g.misc_ext[dn])
                    for dn, kind in g.axes)
        out[name] = [np.asarray(a)[idx] for a in ring]
    return out


def torch_vs_jit(name):
    """Interiors of the port's torch run and yask_tpu's jit run."""
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"), stencil=name,
                            radius=RADII.get(name))
    mine.apply_command_line_options(f"-g {G} -mode torch")
    mine.prepare_solution()
    port_init(mine)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name,
                               radius=RADII.get(name))
    theirs.apply_command_line_options(f"-g {G}")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    mine.run_solution(0, STEPS - 1)
    theirs.run_solution(0, STEPS - 1)
    return export_interiors(mine), tpu_interiors(theirs)


def test_every_solution_of_yask_tpu_is_registered():
    assert len(tpu_solutions()) == 55
    assert sorted(port_solutions()) == sorted(tpu_solutions())


@pytest.mark.parametrize("name", sorted(tpu_solutions()))
def test_torch_mode_matches_yask_tpu_jit(name):
    mine, theirs = torch_vs_jit(name)
    assert set(mine) == set(theirs)
    fe = 1e-4 if name in FIELD_EPS else 0.0
    assert mismatches(mine, theirs, field_epsilon=fe) == 0
