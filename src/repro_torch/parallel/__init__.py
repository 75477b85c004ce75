"""Meshes in the port: `mesh` (the grid of ranks and its arithmetic),
`sharding` (the JAX package's spec rules), `comm` (collectives over
`torch.distributed` and the tensor-parallel Functions), `pipeline` (the
GPipe schedule over a "pipe" axis) and `compress` (the int8
error-feedback dp mean)."""
from repro_torch.parallel.compress import (compressed_mean_grads,
                                           exact_mean_grads,
                                           init_error_state)
from repro_torch.parallel.mesh import Mesh, make_test_mesh
from repro_torch.parallel.pipeline import pipeline_apply, pipeline_loss_fn
from repro_torch.parallel.sharding import (MeshAxes, batch_specs,
                                           cache_specs, param_specs)

__all__ = ["Mesh", "MeshAxes", "batch_specs", "cache_specs",
           "compressed_mean_grads", "exact_mean_grads", "init_error_state",
           "make_test_mesh", "param_specs", "pipeline_apply",
           "pipeline_loss_fn"]
