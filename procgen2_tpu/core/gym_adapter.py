"""Gymnasium adapter: single-env drop-in matching the reference surface.

The reference exposes each game as a `gymnasium.Env` via ctypes
(`cenv/cenv.py:152-380`): obs dict {"screen": Box[0,255, 64x64x3 u8]},
action dict key "action" MultiDiscrete([15]), `reset(seed=...)`
reseeding, manual episode resets. This adapter reproduces that interface
over the batched JAX engine with num_envs=1, so reference users can
switch by replacing `CEnv("libMaze.so")` with `GymEnv("maze")`.

It is intentionally a *compatibility shim*: training at batch scale should
use `procgen2_tpu.make` / `procgen2_tpu.dist.make_vec` directly.
"""
from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium as gym

    _BASE = gym.Env
except ImportError:  # pragma: no cover - gymnasium is baked in
    gym = None
    _BASE = object


class GymEnv(_BASE):
    """Single-env Gymnasium view of a game (cf. cenv.py:152).

    Args:
        game: one of procgen2_tpu.GAMES.
        num_levels: size of the pre-generated level bank (level-set
            restriction the original procgen exposed; the reference
            dropped it — SURVEY.md §5 "Config / flag system").
        seed: bank + episode seed (reference: `options={"seed": ...}`,
            games/*/coinrun.cpp:130-151).
        **config: forwarded to the game's Config dataclass.
    """

    metadata = {"render_modes": ["rgb_array"]}

    def __init__(self, game: str, num_levels: int = 256,
                 seed: Optional[int] = None, render_mode: str = "rgb_array",
                 start_level: int = 0, **config):
        from .. import make

        self._env = make(game, **config)
        self._num_levels = num_levels
        self.render_mode = render_mode
        seed = np.random.randint(2**31) if seed is None else seed
        self._key = jax.random.key(seed)
        self._key, bk = jax.random.split(self._key)
        self._bank = self._env.generate_bank(
            bk, num_levels=num_levels, start_level=start_level
        )
        self._state = None
        self._last_obs = None

        if gym is not None:
            space = self._env.game.obs_space(self._env.cfg)
            self.observation_space = gym.spaces.Dict(
                {"screen": gym.spaces.Box(space.low, space.high,
                                          shape=space.shape, dtype=np.uint8)}
            )
            nvec = self._env.game.action_space(self._env.cfg).nvec
            self.action_space = gym.spaces.Dict(
                {"action": gym.spaces.MultiDiscrete(np.asarray(nvec))}
            )

    # ------------------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if options and "seed" in options:  # reference reset option path
            seed = options["seed"]
        if seed is not None:
            self._key = jax.random.key(seed)
        self._key, k = jax.random.split(self._key)
        self._state, ts = self._env.reset(self._bank, k, num_envs=1)
        obs = {"screen": np.asarray(ts.obs[0])}
        self._last_obs = obs
        return obs, {}

    def step(self, action: Any):
        if isinstance(action, dict):  # reference dict-action path
            action = action["action"]
        a = jnp.asarray(np.asarray(action).reshape(-1)[:1], jnp.int32)
        # step WITHOUT auto-reset: like the reference, the step that
        # returns `terminated=True` shows the terminal frame and episode
        # reset is the caller's job (SURVEY.md §3.3, game_test.py:38-40);
        # stepping past termination keeps simulating the dead world.
        self._state, ts = self._env.step_raw(self._state, a)
        obs = {"screen": np.asarray(ts.obs[0])}
        self._last_obs = obs
        return (
            obs,
            float(ts.reward[0]),
            bool(ts.terminated[0]),
            bool(ts.truncated[0]),
            {},
        )

    def render(self, size: Optional[int] = None):
        """Frame for humans, re-rendered at window resolution.

        Mirrors `cenv_render` (games/coinrun/coinrun.cpp:393-411): the
        scene is rendered a second time onto a window-size target (the
        reference's default viewer surface is 512x512,
        coinrun.cpp:141-149) rather than upscaling the 64x64 obs.
        `size=None` returns the last observation frame (rgb_array mode).
        """
        if self._state is None:
            return None
        if size is None:
            return None if self._last_obs is None else self._last_obs["screen"]
        return np.asarray(self._env.render(self._state, size=size))

    def close(self):
        pass
