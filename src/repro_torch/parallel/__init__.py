"""Meshes in the port: `mesh` (the grid of ranks and its arithmetic),
`sharding` (the JAX package's spec rules), `comm` (collectives over
`torch.distributed` and the tensor-parallel Functions)."""
from repro_torch.parallel.mesh import Mesh, make_test_mesh
from repro_torch.parallel.sharding import (MeshAxes, batch_specs,
                                           cache_specs, param_specs)

__all__ = ["Mesh", "MeshAxes", "batch_specs", "cache_specs",
           "make_test_mesh", "param_specs"]
