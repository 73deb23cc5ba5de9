"""The fused training step's parallel core.

Counterpart of ``mxnet_tpu/parallel/`` (``mesh.py``, ``sharding.py``,
``optim.py``, ``trainer.py``): forward, backward, the gradient sum over the
mesh and the optimizer update as one step over flat buffers, on the card
one CUDA graph a batch shape (``trainer.py``). ``module/spmd_adapter.py``
puts ``Module.fit`` on it. ``autoplan.py`` searches dp × tp × pp plans
over the graph-lint passes' cost model (``plan_parallel``, ``ParallelPlan``,
``PlanError``); ``module.PipelineExecutorGroup`` runs a pipeline plan. Ring
attention comes with ROADMAP.md section 1.8.
"""
from .mesh import make_mesh, local_mesh, MeshSpec, parse_mesh_spec
from .sharding import ShardingRules, param_pspec, shardable_dims
from .optim import make_functional_optimizer
from .trainer import SPMDTrainer
from .autoplan import ParallelPlan, PlanError, plan_parallel

__all__ = [
    "make_mesh",
    "local_mesh",
    "MeshSpec",
    "parse_mesh_spec",
    "ShardingRules",
    "param_pspec",
    "shardable_dims",
    "make_functional_optimizer",
    "SPMDTrainer",
    "ParallelPlan",
    "PlanError",
    "plan_parallel",
]
