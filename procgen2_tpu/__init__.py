"""procgen2_tpu: procedurally-generated RL environment suite in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
Farama-Foundation/Procgen2 (reference mounted read-only at /root/reference):
the 7 games (coinrun, maze, chaser, jumper, climber, caveflyer, bossfight),
their seeded level generators, physics, rewards, terminations, 64x64 RGB
observations and the Gymnasium-style API surface — redesigned as pure,
batched, jit-compiled state transitions over device-resident level banks,
sharded across device meshes (one GPU or several).

Quick start:
    import jax, procgen2_tpu as pg
    env = pg.make("maze")
    bank = env.generate_bank(jax.random.key(0), num_levels=1024)
    state, ts = env.reset(bank, jax.random.key(1), num_envs=4096)
    step = jax.jit(env.step)
    state, ts = step(bank, state, actions)   # ts.obs: uint8[4096, 64, 64, 3]
"""
from __future__ import annotations

import importlib

from .core.env import Environment, EnvState, TimeStep
from .core.gym_adapter import GymEnv

__version__ = "0.1.0"

GAMES = (
    "maze",
    "coinrun",
    "chaser",
    "jumper",
    "climber",
    "caveflyer",
    "bossfight",
)


def _game_module(name: str):
    if name not in GAMES:
        raise ValueError(f"unknown game {name!r}; available: {GAMES}")
    return importlib.import_module(f".games.{name}", __name__)


def make(game, **config) -> Environment:
    """Create an Environment for `game`, forwarding config kwargs.

    The counterpart of loading a per-game shared library through the CEnv
    ABI (`cenv/cenv.py:152-209`) — except config here maps to each game's
    frozen Config dataclass (runtime-selectable difficulty modes that the
    reference left compile-time only, SURVEY.md §5 "Config / flag system").

    `game` is a built-in name from GAMES *or any module* implementing the
    game-module protocol (`core/env.py:16-24`) — the ABI let users load
    arbitrary conforming .so files (`cenv/test_env.c`); here arbitrary
    conforming modules plug in the same way (see `examples/wave_game.py`).

    `obs_format` ("hwc" default, or "chw" for planar [N, 3, 64, 64]
    observations that skip the per-step HWC transpose) is consumed by
    the Environment wrapper, not the game Config.
    """
    obs_format = config.pop("obs_format", "hwc")
    mod = game if not isinstance(game, str) else _game_module(game)
    cfg = mod.Config(**config)
    return Environment(mod, cfg, obs_format=obs_format)


__all__ = [
    "make", "Environment", "EnvState", "TimeStep", "GymEnv", "GAMES",
    "__version__",
]
