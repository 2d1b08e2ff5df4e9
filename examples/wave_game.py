"""Minimal custom game module: the protocol-conformance "hello world".

The reference ships a 135-line pure-C example env (`cenv/test_env.c`)
proving that *anything* implementing the CEnv ABI can be driven by the
Python binding: its observation is a 16-float cosine wave
``obs[i] = cos(t + 0.5 * i)``, its reward is ``sin(t)``, time advances
by 0.25 per step, and it terminates once ``t >= 10`` (test_env.c:85-105).

This module is the JAX counterpart: the same behavior expressed
through the game-module protocol (`procgen2_tpu/core/env.py:16-24`).
Implement these nine names and every framework facility — batching,
auto-reset level banks, mesh sharding, checkpointing, the Gymnasium
adapter — works on your game unchanged:

    Config      frozen dataclass (hashable; static jit argument)
    Level       struct.dataclass pytree of per-episode static data
    State       struct.dataclass pytree of dynamic state (holds its Level)
    generate(cfg, key) -> Level
    reset(cfg, level, key) -> State
    step(cfg, state, action) -> (State, reward, terminated, info)
    observe(cfg, state) -> uint8[RES, RES, 3]
    obs_space(cfg) / action_space(cfg)

Run it through the standard machinery::

    import jax, procgen2_tpu as pg
    from examples import wave_game
    env = pg.make(wave_game)          # modules are accepted, not just names
    bank = env.generate_bank(jax.random.key(0), num_levels=8)
    state, ts = env.reset(bank, jax.random.key(1), num_envs=32)
    state, ts = env.step(bank, state, jnp.zeros(32, jnp.int32))

`tests/test_protocol.py` runs the generic conformance checker over this
module; point the same checker at your own module to validate it.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from procgen2_tpu.core import spaces
from procgen2_tpu.utils import struct

NAME = "wave"
RES = 64  # framework obs resolution (the C example renders 8x8 gray)
WAVE_N = 16  # cos-wave taps, as in test_env.c's 16-float observation


@dataclasses.dataclass(frozen=True)
class Config:
    dt: float = 0.25  # test_env.c:102 `t += 0.25f`
    horizon: float = 10.0  # test_env.c:104 `terminated = t >= 10.0f`


@struct.dataclass
class Level:
    phase: jnp.ndarray  # f32 scalar — per-level phase offset (the one
    #                     bit of procedural generation in this toy)


@struct.dataclass
class State:
    level: Level
    t: jnp.ndarray  # f32 scalar sim clock (test_env.c:80 `t = 0.0f`)


def generate(cfg: Config, key) -> Level:
    import jax

    return Level(phase=jax.random.uniform(key, (), jnp.float32, 0.0, 0.0))


def reset(cfg: Config, level: Level, key) -> State:
    return State(level=level, t=jnp.float32(0.0))


def wave(cfg: Config, state: State) -> jnp.ndarray:
    """The 16-float cosine observation: obs[i] = cos(t + 0.5 i + phase)."""
    i = jnp.arange(WAVE_N, dtype=jnp.float32)
    return jnp.cos(state.t + 0.5 * i + state.level.phase)


def step(cfg: Config, state: State, action):
    # Reward uses the PRE-advance clock, like test_env.c:94 (sin of the
    # t the observation was computed at); the action is accepted and
    # ignored, like the C example.
    reward = jnp.sin(state.t).astype(jnp.float32)
    t = state.t + jnp.float32(cfg.dt)
    terminated = t >= cfg.horizon
    return State(level=state.level, t=t), reward, terminated, {}


def observe(cfg: Config, state: State) -> jnp.ndarray:
    """Render the wave as a 64x64 RGB plot (the framework obs contract).

    Column x shows tap i = x * WAVE_N / RES; rows where the wave's
    amplitude reaches are lit. Gray background nods to the C example's
    all-(64,64,64) render (test_env.c:109-114).
    """
    vals = wave(cfg, state)  # [WAVE_N] in [-1, 1]
    col = jnp.repeat(vals, RES // WAVE_N)  # [RES]
    # map amplitude -> row: +1 at top (row 0), -1 at bottom
    rows = jnp.round((1.0 - col) * 0.5 * (RES - 1)).astype(jnp.int32)
    y = jnp.arange(RES)[:, None]
    lit = y == rows[None, :]
    bg = jnp.full((RES, RES, 3), 64, jnp.uint8)
    fg = jnp.array([80, 220, 120], jnp.uint8)
    return jnp.where(lit[..., None], fg, bg)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (RES, RES, 3), jnp.uint8)


def action_space(cfg: Config):
    return spaces.MultiDiscrete((15,))
