"""Sharded vectorized environments over a device mesh.

Design (SURVEY.md §2.5 / §7.5): the env batch is data-parallel over a
1-D `env` mesh axis; the level bank is replicated (it is read-only and
every lane gathers random rows from it each auto-reset). Actions are
produced and observations consumed on-device by a co-located learner, so
steady state requires zero host<->device transfer; only scalar metrics
cross, reduced with XLA collectives.

Nothing here hand-schedules communication: shardings are annotated and
XLA inserts the collectives (NCCL over NVLink between the cards of one
host). The mesh is 1-D over `jax.devices()`: every card reaches every
other at the same rate, so no axis order matters.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.env import Environment, TimeStep


def _mesh_from(devices=None, axis_name: str = "env") -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def local_slice(global_array, mesh: Mesh | None = None, axis_name: str = "env"):
    """The rows of a batch-sharded global array owned by this host.

    Multi-host helper: with N hosts each holding D local devices, host k
    owns rows [k*B/N, (k+1)*B/N) of a batch sharded over `env`. Works on
    non-fully-addressable global arrays (reads only addressable shards).

    Returns `(rows, start)`: the host-local rows as numpy, and their
    global row offset.
    """
    shards = sorted(
        global_array.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    rows = np.concatenate([np.asarray(s.data) for s in shards], axis=0)
    start = shards[0].index[0].start or 0
    return rows, start


class ShardedEnv:
    """An Environment bound to a mesh: batch sharded, bank replicated.

    Usage:
        env = make_vec("maze", num_envs=65536, num_levels=4096)
        state, ts = env.reset(jax.random.key(0))
        state, ts = env.step(state, actions)       # all sharded, all jit
        metrics = env.metrics(ts)                  # psum-reduced scalars
    """

    def __init__(self, env: Environment, num_envs: int, num_levels: int,
                 mesh: Mesh | None = None, axis_name: str = "env",
                 start_level: int = 0):
        self.env = env
        self.num_envs = num_envs
        self.num_levels = num_levels
        self.start_level = start_level
        self.mesh = mesh or _mesh_from(axis_name=axis_name)
        self.axis = axis_name
        if num_envs % self.mesh.devices.size:
            raise ValueError(
                f"num_envs={num_envs} must divide over "
                f"{self.mesh.devices.size} devices"
            )
        self.repl = NamedSharding(self.mesh, P())
        self.shard = NamedSharding(self.mesh, P(axis_name))
        self._bank = None

        self._step = jax.jit(
            self.env._step,
            in_shardings=(self.repl, self.shard, self.shard),
            out_shardings=(self.shard, self.shard),
        )
        self._reset = jax.jit(
            functools.partial(self.env._reset, num_envs=num_envs),
            in_shardings=(self.repl, self.repl),
            out_shardings=(self.shard, self.shard),
        )

    # ------------------------------------------------------------------
    @property
    def bank(self):
        if self._bank is None:
            raise RuntimeError("call reset(key) first (generates the bank)")
        return self._bank

    def reset(self, key, bank_key=None):
        """Generate the replicated bank (once) and the sharded env state."""
        if self._bank is None:
            bk = bank_key if bank_key is not None else jax.random.fold_in(key, 17)
            bank = self.env.generate_bank(
                bk, num_levels=self.num_levels, start_level=self.start_level
            )
            self._bank = jax.device_put(bank, self.repl)
        return self._reset(self._bank, key)

    def step(self, state, actions):
        return self._step(self._bank, state, actions)

    # ------------------------------------------------------------------
    def metrics(self, ts: TimeStep):
        """Cross-device scalar metrics (mean reward, episodes done, mean
        episode return over finished episodes) — one fused reduction, the
        XLA-collective analogue of a NCCL all-reduce."""

        @functools.partial(jax.jit, out_shardings=self.repl)
        def compute(ts):
            done = ts.terminated
            n_done = done.sum()
            ep_ret = ts.info["returned_episode_return"]
            return dict(
                reward_mean=ts.reward.mean(),
                episodes_done=n_done,
                episode_return_mean=jnp.where(
                    n_done > 0, (ep_ret * done).sum() / jnp.maximum(n_done, 1), 0.0
                ),
            )

        return compute(ts)


def make_vec(game: str, num_envs: int, num_levels: int = 1024,
             mesh: Mesh | None = None, start_level: int = 0,
             **config) -> ShardedEnv:
    """Create a mesh-sharded batched env (cf. `procgen2_tpu.make`).

    `num_levels`/`start_level` select a portable level set: level `i` is
    derived as `fold_in(bank_key, start_level + i)` (procgen's level-set
    restriction semantics; see Environment._generate_bank)."""
    from .. import make

    return ShardedEnv(make(game, **config), num_envs, num_levels, mesh=mesh,
                      start_level=start_level)


def init_multihost(coordinator_address: str | None = None, **kwargs):
    """Initialize the JAX distributed runtime for multi-host meshes.

    Thin wrapper over `jax.distributed.initialize` — env vars
    (JAX_COORDINATOR_ADDRESS etc.) configure the pod slice; explicit
    `num_processes`/`process_id` kwargs pass through (used by
    tests/test_multihost.py's 2-process CPU harness). Call before any
    other JAX API on every host.
    """
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    jax.distributed.initialize(**kwargs)
