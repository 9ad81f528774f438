"""Distribution: device-mesh decomposition and ghost-cell exchange.

The port's counterpart of ``yask_tpu/parallel`` (the reference's MPI
layer: ``src/kernel/lib/setup.cpp`` rank topology, ``halo.cpp``
exchange).  One controller process drives a :class:`Mesh` of
``torch.device``s whose axes are the domain dims; ghost exchange is slab
copies between neighbour shards' tensors (:mod:`.shard_step`), scheduled
by the :class:`CommPlan`.
"""

from yask_tpu_torch.parallel.mesh import (Mesh, build_mesh, make_mesh,
                                          state_shardings)
from yask_tpu_torch.parallel.comm_plan import (
    CommPlan,
    build_comm_plan,
    comm_ledger_fields,
)
from yask_tpu_torch.parallel.decomp import (
    factorize_rank_grid,
    validate_shard_geometry,
)

__all__ = ["Mesh", "build_mesh", "make_mesh", "state_shardings",
           "CommPlan", "build_comm_plan", "comm_ledger_fields",
           "factorize_rank_grid", "validate_shard_geometry"]
