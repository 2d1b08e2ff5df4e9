"""Core environment API: pure-functional, batched, auto-resetting.

Replaces the reference's CEnv C ABI + per-process Gymnasium wrapper
(`cenv/cenv.h:121-133`, `cenv/cenv.py:152-380`) with a batched JAX design:

* Env state is an explicit pytree (checkpointing is therefore free — the
  reference keeps state in C++ globals and cannot export it, SURVEY.md §5).
* Levels are pre-generated in a device-resident **level bank** (a stacked
  pytree built with `vmap(generate)`), so auto-reset is a cheap gather rather
  than re-running the procedural generator in the per-step hot path. The bank
  also gives `num_levels` / level-set restriction semantics that the original
  procgen exposed and Procgen2 dropped (SURVEY.md §5 "Config / flag system").
* `step` is unbatched and pure; the wrapper vmaps it over the env batch and
  merges done lanes with a pytree select (auto-reset). Everything jits.

A game module provides:
    Config      frozen dataclass (hashable; used as a static jit argument)
    Level       utils.struct.dataclass pytree of per-episode static data
    State       utils.struct.dataclass pytree of dynamic state (holds its Level copy)
    generate(cfg, key) -> Level
    reset(cfg, level, key) -> State
    step(cfg, state, action) -> (State, reward f32, terminated bool, info dict)
    observe(cfg, state) -> uint8[64, 64, 3]
    obs_space(cfg), action_space(cfg)
"""
from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from ..utils import struct

from ..utils import tree_select
from ..utils.tree import bank_gather

OBS_KEY = "screen"  # matches the reference obs dict key, games/maze/maze.cpp:117


@struct.dataclass
class EnvState:
    """Wrapper state: per-env game state plus episode accumulators."""

    game: Any
    ep_return: jnp.ndarray  # f32, running return of current episode
    ep_length: jnp.ndarray  # i32
    rng: jax.Array  # PRNG key driving auto-reset level choice


@struct.dataclass
class TimeStep:
    obs: jnp.ndarray  # uint8 [..., 64, 64, 3]
    reward: jnp.ndarray  # f32
    terminated: jnp.ndarray  # bool — env reached a terminal state
    truncated: jnp.ndarray  # bool — reserved; reference games signal timeout
    #                          as `terminated` (games/maze/maze.cpp:308-310)
    info: dict


class Environment:
    """Batched auto-resetting environment over a device-resident level bank.

    Usage:
        env = make("maze")
        bank = env.generate_bank(jax.random.key(0), num_levels=2048)
        state, ts = env.reset(bank, jax.random.key(1), num_envs=4096)
        state, ts = jax.jit(env.step)(bank, state, actions)
    """

    def __init__(self, game, cfg, obs_format: str = "hwc"):
        if obs_format not in ("hwc", "chw"):
            raise ValueError(
                f"obs_format must be 'hwc' or 'chw', got {obs_format!r}"
            )
        self.game = game
        self.cfg = cfg
        # "hwc" (default): uint8 [N, 64, 64, 3], the reference layout
        # (coinrun.cpp:377-388's RGBA->RGB copy). "chw": planar
        # [N, 3, 64, 64] — the native layout of the batched renderers
        # and of NCHW learners; skips the per-step HWC transpose.
        self.obs_format = obs_format
        # Jit entry points once per Environment instance; `num_envs` /
        # `num_levels` are static (they set array shapes).
        self.reset = jax.jit(self._reset, static_argnames="num_envs")
        self.reset_pinned = jax.jit(self._reset_pinned)
        self.step = jax.jit(self._step, static_argnames="render")
        self.step_raw = jax.jit(self._step_raw, static_argnames="render")
        self.observe = jax.jit(self._observe)
        self.generate_bank = jax.jit(
            self._generate_bank, static_argnames="num_levels"
        )
        self._render_cache = {}  # (game, cfg, size) -> jitted window render

    # ------------------------------------------------------------------
    # Level bank
    # ------------------------------------------------------------------
    def _generate_bank(self, key, num_levels: int, start_level: int = 0):
        """Batched on-device level generation (one `vmap(generate)` call).

        Level-set semantics (the original procgen's `num_levels` /
        `start_level` kwargs, which the reference dropped — SURVEY.md §5
        "Config / flag system"): level `i` of the returned bank is keyed
        by ``fold_in(key, start_level + i)``, so the same ``(key,
        start_level + i)`` pair reproduces the identical level across
        runs, hosts and bank sizes. Train/test splits are therefore
        expressible exactly as in procgen: train on
        ``generate_bank(k, 200, start_level=0)``, evaluate on
        ``generate_bank(k, 10_000, start_level=200)`` — disjoint,
        portable sets.
        """
        ids = jnp.arange(num_levels, dtype=jnp.uint32) + jnp.uint32(start_level)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(ids)
        gen = functools.partial(self.game.generate, self.cfg)
        return jax.vmap(gen)(keys)

    # ------------------------------------------------------------------
    # Reset / step (pure; safe to jit with self captured — cfg is static)
    # ------------------------------------------------------------------
    def _reset_one(self, bank, key):
        num_levels = jax.tree.leaves(bank)[0].shape[0]
        k_lvl, k_reset, k_state = jax.random.split(key, 3)
        idx = jax.random.randint(k_lvl, (), 0, num_levels)
        level = bank_gather(bank, idx)
        gs = self.game.reset(self.cfg, level, k_reset)
        return EnvState(
            game=gs,
            ep_return=jnp.float32(0.0),
            ep_length=jnp.int32(0),
            rng=k_state,
        )

    def _reset_pinned(self, bank, key, fold_ids=None):
        """Reset env `i` on level `i` of the bank (num_envs = bank size).

        The deterministic-assignment counterpart of `_reset`'s random
        level draw: parity suites and fixtures pin each lane to a known
        (oracle-predicted) reference level. `fold_ids` (i32[num],
        default arange) names each lane: lane i's key is
        ``fold_in(key, fold_ids[i])``, so passing the reference seed ids
        makes a lane's trajectory independent of its batch position.
        Returns the EnvState without rendering — parity drivers step
        with `render=False` and render on demand.
        """
        num = jax.tree.leaves(bank)[0].shape[0]
        if fold_ids is None:
            fold_ids = jnp.arange(num, dtype=jnp.uint32)

        def one(level, i):
            k_reset, k_state = jax.random.split(jax.random.fold_in(key, i))
            gs = self.game.reset(self.cfg, level, k_reset)
            return EnvState(
                game=gs,
                ep_return=jnp.float32(0.0),
                ep_length=jnp.int32(0),
                rng=k_state,
            )

        return jax.vmap(one)(bank, fold_ids)

    def _observe_batch(self, game_states):
        """Batched rendering; games may provide an `observe_batch` that
        exploits cross-env structure (shared cameras, batched stamp
        compositing) instead of a plain vmap. Game `observe_batch` functions
        return planar uint8 [N, 3, OBS, OBS]; the requested layout
        (`obs_format`) is applied here, in one place."""
        fn = getattr(self.game, "observe_batch", None)
        if fn is not None:
            planar = fn(self.cfg, game_states)
            if self.obs_format == "hwc":
                return jnp.transpose(planar, (0, 2, 3, 1))
            return planar
        obs = jax.vmap(self.game.observe, in_axes=(None, 0))(
            self.cfg, game_states
        )  # single-env observe renders HWC
        if self.obs_format == "chw":
            return jnp.moveaxis(obs, -1, 1)
        return obs

    def _reset(self, bank, key, num_envs: int):
        keys = jax.random.split(key, num_envs)
        state = jax.vmap(self._reset_one, in_axes=(None, 0))(bank, keys)
        obs = self._observe_batch(state.game)
        ts = TimeStep(
            obs=obs,
            reward=jnp.zeros(num_envs, jnp.float32),
            terminated=jnp.zeros(num_envs, bool),
            truncated=jnp.zeros(num_envs, bool),
            info={},
        )
        return state, ts

    def _step_one(self, bank, state: EnvState, action):
        gs, reward, terminated, info = self.game.step(self.cfg, state.game, action)
        ep_return = state.ep_return + reward
        ep_length = state.ep_length + 1

        # Auto-reset: pull a fresh level from the bank for done lanes. The
        # gather + reset is cheap (no generator in the hot path); the merge is
        # a per-leaf select, mirroring SURVEY.md §7's auto-reset design.
        rng, k_lvl, k_reset = jax.random.split(state.rng, 3)
        num_levels = jax.tree.leaves(bank)[0].shape[0]
        idx = jax.random.randint(k_lvl, (), 0, num_levels)
        # bank_gather: one-hot matmul over byte planes (bit-exact)
        level = bank_gather(bank, idx)
        fresh = self.game.reset(self.cfg, level, k_reset)
        gs = tree_select(terminated, fresh, gs)

        info = dict(info)
        info.update(
            returned_episode_return=ep_return,
            returned_episode_length=ep_length,
            done=terminated,
        )
        new_state = EnvState(
            game=gs,
            ep_return=jnp.where(terminated, 0.0, ep_return),
            ep_length=jnp.where(terminated, 0, ep_length),
            rng=rng,
        )
        ts = TimeStep(
            obs=None,  # rendered batched in _step
            reward=reward,
            terminated=terminated,
            truncated=jnp.zeros_like(terminated),
            info=info,
        )
        return new_state, ts

    def _step(self, bank, state: EnvState, action, render: bool = True):
        """Batched step. `action` is int32[num_envs] (or [num_envs, 1]).

        `render=False` skips observation rendering (ts.obs is None) —
        for frame-skip wrappers, state-based probes and tests; render on
        demand later with `env.observe(state)`. The reference has no such
        split (every cenv_step renders, coinrun.cpp:373-388)."""
        if action.ndim > 1:
            action = action.squeeze(-1)
        new_state, ts = jax.vmap(
            self._step_one, in_axes=(None, 0, 0)
        )(bank, state, action)
        obs = self._observe_batch(new_state.game) if render else None
        return new_state, ts.replace(obs=obs)

    def _step_raw(self, state: EnvState, action, render: bool = True):
        """Batched step WITHOUT auto-reset.

        Done lanes return the *terminal* state and frame; continuing to
        step a terminated lane keeps simulating the dead world. This is
        the reference contract — episode reset is the caller's job
        (SURVEY.md §3.3, game_test.py:38-40) and the step that returns
        `terminated=True` still shows the terminal scene. The vectorized
        training path (`step`) auto-resets instead; this entry point
        backs the single-env Gymnasium adapter and parity harnesses.
        """
        if action.ndim > 1:
            action = action.squeeze(-1)

        def one(state, a):
            gs, reward, terminated, info = self.game.step(
                self.cfg, state.game, a
            )
            new_state = EnvState(
                game=gs,
                ep_return=state.ep_return + reward,
                ep_length=state.ep_length + 1,
                rng=state.rng,
            )
            return new_state, reward, terminated, info

        new_state, reward, terminated, info = jax.vmap(one)(state, action)
        obs = self._observe_batch(new_state.game) if render else None
        ts = TimeStep(
            obs=obs,
            reward=reward,
            terminated=terminated,
            truncated=jnp.zeros_like(terminated),
            info=dict(info),
        )
        return new_state, ts

    def _observe(self, state: EnvState):
        """Render observations for an existing state (on-demand path)."""
        return self._observe_batch(state.game)

    # ------------------------------------------------------------------
    # Window-resolution human render (cenv_render counterpart)
    # ------------------------------------------------------------------
    def render(self, state: EnvState, size: int = 512, env_index: int = 0):
        """Re-render one env's scene at window resolution.

        The reference renders every scene twice — the 64x64 obs and a
        W x H viewer surface (`cenv_render`, games/coinrun/
        coinrun.cpp:393-411; `width`/`height` make-options
        coinrun.cpp:141-149). Here the same scene description traces at
        a different resolution (render/compositor.resolution), compiled
        once per (game, size).

        Returns uint8 [size, size, 3].
        """
        from ..render import compositor as C

        key = (self.game.NAME, self.cfg, int(size))
        fn = self._render_cache.get(key)
        if fn is None:
            with C.resolution(size):
                fn = jax.jit(
                    functools.partial(self.game.observe, self.cfg)
                )
                # trace eagerly inside the resolution context so the
                # size is baked into the compiled program
                one = jax.tree.map(lambda x: x[env_index], state.game)
                out = fn(one)
            self._render_cache[key] = fn
            return out
        one = jax.tree.map(lambda x: x[env_index], state.game)
        return fn(one)

    # ------------------------------------------------------------------
    # Spaces (mirrors cenv.py:211-245's dict-of-spaces surface)
    # ------------------------------------------------------------------
    def observation_space(self):
        space = self.game.obs_space(self.cfg)
        if self.obs_format == "chw" and len(space.shape) == 3:
            import dataclasses as _dc

            h, w, c = space.shape
            space = _dc.replace(space, shape=(c, h, w))
        return {OBS_KEY: space}

    def action_space(self):
        return {"action": self.game.action_space(self.cfg)}
