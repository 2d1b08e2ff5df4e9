"""On-device rollout collection: `lax.scan` over time, sharded over envs.

The on-device replacement for the reference's Python stepping loop
(`game_test.py:17-30` steps one env at a time across the ctypes FFI): a
single jit program advances the whole sharded batch T steps and
materializes a [T, N, ...] trajectory buffer in device memory, ready for a
co-located PPO/IMPALA learner — observations never touch the host.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from ..utils import struct


@struct.dataclass
class RolloutBuffer:
    obs: jnp.ndarray  # uint8 [T, N, 64, 64, 3]
    actions: jnp.ndarray  # i32 [T, N]
    rewards: jnp.ndarray  # f32 [T, N]
    dones: jnp.ndarray  # bool [T, N]
    ep_returns: jnp.ndarray  # f32 [T, N] (valid where dones)
    ep_lengths: jnp.ndarray  # i32 [T, N]


def rollout(env, state, key, num_steps: int,
            policy: Callable[[Any, jnp.ndarray], jnp.ndarray] | None = None,
            policy_state: Any = None):
    """Collect `num_steps` of experience from a ShardedEnv (or any object
    with `.bank` and `.env`). `policy(policy_state, obs_or_key) -> actions`;
    defaults to uniform-random on-device actions.

    Returns (final_state, RolloutBuffer). Jit-compiled once per
    (env, num_steps) pair.
    """
    bank = env.bank
    inner = env.env  # Environment
    num_envs = jax.tree.leaves(state)[0].shape[0]

    @functools.partial(jax.jit, static_argnames="T")
    def run(bank, state, key, T):
        def scan_step(carry, _):
            state, key = carry
            key, k_act = jax.random.split(key)
            if policy is None:
                n = inner.game.action_space(inner.cfg).nvec[0]
                actions = jax.random.randint(k_act, (num_envs,), 0, n)
            else:
                actions = policy(policy_state, k_act)
            state, ts = inner._step(bank, state, actions)
            out = (ts.obs, actions, ts.reward, ts.terminated,
                   ts.info["returned_episode_return"],
                   ts.info["returned_episode_length"])
            return (state, key), out

        (state, key), (obs, acts, rews, dones, rets, lens) = jax.lax.scan(
            scan_step, (state, key), None, length=T
        )
        return state, RolloutBuffer(
            obs=obs, actions=acts, rewards=rews, dones=dones,
            ep_returns=rets, ep_lengths=lens,
        )

    return run(bank, state, key, num_steps)
