"""Distributed / sharded execution layer (no reference counterpart).

The reference is single-process, single-env (SURVEY.md §2.5: globals at
games/*/coinrun.cpp:15-21 and ecs.cpp:97 make even two envs per process
impossible). The entire scaling story here is new design:
env batches sharded over a `jax.sharding.Mesh`, XLA collectives for
metric reductions, multi-host init via `jax.distributed`.
"""
from .vec import ShardedEnv, make_vec, local_slice
from .rollout import rollout, RolloutBuffer

__all__ = ["ShardedEnv", "make_vec", "local_slice", "rollout", "RolloutBuffer"]
