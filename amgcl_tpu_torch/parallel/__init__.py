"""The distributed layer: a mesh of shards driven by one process.

Counterpart of ``amgcl_tpu/parallel/`` (reference: amgcl/mpi/). So far
the sharded stencil path: the mesh, the DIA halo SpMV and the
distributed inner product, and the stencil hierarchy built and solved
over z-slabs (``DistStencilSolver``).
"""

from amgcl_tpu_torch.parallel.dist_matrix import (dia_halo_mv,
                                                  dist_inner_product)
from amgcl_tpu_torch.parallel.dist_stencil import (DistStencilSolver,
                                                   dist_stencil_build)
from amgcl_tpu_torch.parallel.mesh import (Mesh, host_full, make_mesh,
                                           put_sharded)

__all__ = ["Mesh", "make_mesh", "put_sharded", "host_full",
           "dia_halo_mv", "dist_inner_product", "DistStencilSolver",
           "dist_stencil_build"]
