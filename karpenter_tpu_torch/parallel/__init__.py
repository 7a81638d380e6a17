from .mesh import pod_sharding, replicated, solver_mesh, type_sharding
from .sharded import sharded_solve_step

__all__ = ["solver_mesh", "pod_sharding", "type_sharding", "replicated", "sharded_solve_step"]
