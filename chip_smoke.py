#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU (or four).

Drives the main path through the entry points a user calls
(`procgen2_tpu.make`, `Environment.reset/step`, `dist.make_vec`,
`dist.rollout`, `GymEnv`) at the batch sizes users run, and checks what
comes out against the repository's own references. Everything runs in
one process; no phase swallows a failure.

  phase 0  the device: JAX must find a GPU (no CPU fallback); prints
           its kind and count and nvidia-smi's name and power limit.
  phase 1  all 7 games at batch 4096 over a 1024-level bank (and maze
           at 8192): a 16-step `dist.rollout` whose obs buffer must be
           uint8[16, N, 64, 64, 3] with finite rewards; prints compile
           seconds, env-steps/s with and without rendering and the
           step's `memory_analysis()` (informational, not a benchmark).
  phase 2  the Procgen protocol's small batch: coinrun easy mode, 64
           envs over 200 levels, one 256-step rollout.
  phase 3  behaviour on the card: (a) the scripted and fatal parity
           suites, whose expected rewards and terminations come from
           numpy predictors independent of JAX, must match exactly;
           (b) every game steps 64 envs x 16 steps on the GPU and on the
           CPU backend from the same bank and keys: rewards and
           terminations must be equal, observations within OBS_TOL.
  phase 4  `GymEnv("maze", seed=42)`: reset and 5 steps.
  phase 5  (`--cards 4` only, and then the only phase) the sharded
           path: coinrun and bossfight at 4 x 4096 envs over a 4-card
           mesh against the same keys on a 1-card mesh.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Run:  python chip_smoke.py              # one card: phases 0-4
      python chip_smoke.py --cards 4    # four cards: phases 0 and 5
      python chip_smoke.py --trace DIR  # also profile 3 rendered steps
                                        # per game of phase 1 under DIR
"""
from __future__ import annotations

import argparse
import functools
import gzip
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import procgen2_tpu as pg
from procgen2_tpu import dist
from procgen2_tpu.utils import device
from procgen2_tpu.utils.cache import enable_compilation_cache

ROOT = os.path.dirname(os.path.abspath(__file__))

# Phase 3(b) observation tolerance, in pixel-value units (0..255). The
# renderers accumulate bf16 blend chains; XLA fuses them differently on
# the GPU and the CPU and the stamp placement sums premultiplied
# contributions in another order, so a pixel can round one or two
# units apart. A stamp whose f32 screen position sits on a .5 rounding
# edge can also land one pixel apart, which moves a few of its texels by
# a full sprite-vs-background contrast. The bound is therefore on the
# mean over all pixel values and on the share of values that differ by
# more than two units.
OBS_TOL = dict(mean_abs=0.5, share_over_2=0.01)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """`msg` after the seconds since this module was loaded."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def _steps_per_s(step, bank, state, actions, num_envs, iters):
    state, ts = step(bank, state, actions)  # warm up
    jax.block_until_ready((state, ts))
    t0 = time.perf_counter()
    for _ in range(iters):
        state, ts = step(bank, state, actions)
    jax.block_until_ready((state, ts))
    return num_envs * iters / (time.perf_counter() - t0)


@jax.jit
def _obs_diff(a, b):
    """(max, mean, share > 2) of |a - b| over two uint8 obs arrays."""
    d = jnp.abs(a.astype(jnp.int16) - b.astype(jnp.int16))
    return d.max(), d.astype(jnp.float32).mean(), (d > 2).mean()


def _diff_row(a, b) -> dict:
    mx, mean, share = _obs_diff(a, b)
    return dict(obs_max_abs=int(mx), obs_mean_abs=float(mean),
                obs_share_over_2=float(share))


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    names = ("argument", "output", "temp", "alias", "generated_code")
    return {n: getattr(m, f"{n}_size_in_bytes", None) for n in names} \
        if m is not None else {}


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_device() -> tuple[dict, str]:
    dev = device.require_gpu()
    card = device.card_name_and_power_limit()
    log(f"[phase 0] platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    log(card)
    return dev, card


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def prepare_game(game, num_envs, num_levels=1024, steps=16) -> dict:
    """Everything of phase 1 that compiles, for one game at one batch:
    bank + reset, a `dist.rollout` whose buffer is checked, and the
    rendered and render-off steps compiled ahead of time."""
    sv = dist.make_vec(game, num_envs=num_envs, num_levels=num_levels)
    t0 = time.perf_counter()
    state, ts = sv.reset(jax.random.key(0))
    jax.block_until_ready((state, ts))
    reset_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, buf = dist.rollout(sv, state, jax.random.key(1), num_steps=steps)
    jax.block_until_ready((state, buf))
    rollout_s = time.perf_counter() - t0
    want = (steps, num_envs, 64, 64, 3)
    assert buf.obs.dtype == jnp.uint8 and buf.obs.shape == want, (
        game, buf.obs.dtype, buf.obs.shape)
    assert np.isfinite(np.asarray(buf.rewards)).all(), game
    del buf

    n_act = int(sv.env.game.action_space(sv.env.cfg).nvec[0])
    actions = jax.device_put(
        jax.random.randint(jax.random.key(2), (num_envs,), 0, n_act),
        sv.shard)
    t0 = time.perf_counter()
    step = sv._step.lower(sv.bank, state, actions).compile()
    compile_s = time.perf_counter() - t0
    no_render = jax.jit(
        functools.partial(sv.env._step, render=False),
        in_shardings=(sv.repl, sv.shard, sv.shard),
        out_shardings=(sv.shard, sv.shard),
    ).lower(sv.bank, state, actions).compile()
    row = dict(game=game, num_envs=num_envs, num_levels=num_levels,
               reset_first_call_s=reset_s, rollout_first_call_s=rollout_s,
               step_compile_s=compile_s, step_memory=_memory(step))
    return dict(row=row, bank=sv.bank, state=state, actions=actions,
                step=step, no_render=no_render)


def measure_game(prep, iters=10, card="", trace_dir=None) -> dict:
    """Env-steps/s of the prepared rendered and render-off steps (run
    with nothing else on the device), and optionally a profiler trace
    of 3 rendered steps beside the step's optimized HLO (which
    scripts/xprof_by_source.py reads to map kernels to source lines)."""
    row = dict(prep["row"], card=card)
    args = (prep["bank"], prep["state"], prep["actions"])
    n = row["num_envs"]
    rate = _steps_per_s(prep["step"], *args, n, iters)
    rate_nr = _steps_per_s(prep["no_render"], *args, n, iters)
    row.update(env_steps_per_s_rendered=rate,
               env_steps_per_s_no_render=rate_nr,
               render_share_of_step=1.0 - rate / rate_nr)
    if trace_dir:
        bank, state, actions = args
        out = os.path.join(trace_dir, f"{row['game']}_{n}")
        with jax.profiler.trace(out):
            for _ in range(3):
                state, ts = prep["step"](bank, state, actions)
            jax.block_until_ready((state, ts))
        with gzip.open(os.path.join(out, "step.hlo.txt.gz"), "wt") as f:
            f.write(prep["step"].as_text())
    log(f"[phase 1] {json.dumps(row)}")
    return row


PHASE1_ROWS = tuple((g, 4096) for g in pg.GAMES) + (("maze", 8192),)


def phase_games(rows=PHASE1_ROWS, num_levels=1024, steps=16, iters=10,
                card="", trace_dir=None) -> list[dict]:
    return [measure_game(prepare_game(g, n, num_levels, steps), iters,
                         card, trace_dir) for g, n in rows]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def phase_small_batch(num_envs=64, num_levels=200, steps=256) -> dict:
    sv = dist.make_vec("coinrun", num_envs=num_envs, num_levels=num_levels,
                       easy_mode=True)
    state, _ = sv.reset(jax.random.key(0))
    t0 = time.perf_counter()
    state, buf = dist.rollout(sv, state, jax.random.key(1), num_steps=steps)
    jax.block_until_ready((state, buf))
    first_s = time.perf_counter() - t0
    assert buf.obs.shape == (steps, num_envs, 64, 64, 3), buf.obs.shape
    assert buf.obs.dtype == jnp.uint8
    assert np.isfinite(np.asarray(buf.rewards)).all()
    row = dict(num_envs=num_envs, num_levels=num_levels, steps=steps,
               rollout_first_call_s=first_s,
               episodes_done=int(np.asarray(buf.dones).sum()))
    log(f"[phase 2] {json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

PARITY_SUITES = ("test_parity_scripted.py", "test_parity_fatal.py")


def parity_tests(suites=PARITY_SUITES, names=None) -> list[tuple]:
    """[(label, test function)] of the scripted/fatal parity suites
    (all, or those in `names`). Loading imports modules, so do it
    before starting threads: Python's import locks can deadlock when
    threads import one package's modules concurrently."""
    tests = []
    for suite in suites:
        path = os.path.join(ROOT, "tests", suite)
        spec = importlib.util.spec_from_file_location(suite[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        tests += [(f"{suite}::{n}", getattr(mod, n))
                  for n in sorted(vars(mod)) if n.startswith("test_")
                  and (names is None or n in names)]
    return tests


def phase_parity_scripted(tests) -> list[str]:
    """Run parity test functions in this process (on JAX's default
    device): each asserts the numpy predictors' per-step reward and
    termination sequences exactly."""
    for label, fn in tests:
        t0 = time.perf_counter()
        fn()
        log(f"[phase 3a] {label} ok ({time.perf_counter() - t0:.1f} s)")
    return [label for label, _ in tests]


def _on(x, platform):
    return {d.platform for d in x.devices()} == {platform}


def cpu_agreement(game, num_envs=64, steps=16, num_levels=1024) -> dict:
    """Step `game` on the default device and on the CPU backend from the
    same bank (generated on the default device, copied to the CPU) and
    the same keys and actions. Rewards and terminations must be equal;
    returns the observation |difference| statistics."""
    cpu = jax.devices("cpu")[0]
    platform = jax.devices()[0].platform
    env = pg.make(game)
    bank = env.generate_bank(jax.random.key(3), num_levels=num_levels)
    bank_c = jax.device_put(bank, cpu)
    key = jax.random.key(4)
    s_d, ts_d = env.reset(bank, key, num_envs=num_envs)
    s_c, ts_c = env.reset(bank_c, jax.device_put(key, cpu),
                          num_envs=num_envs)
    n_act = int(env.game.action_space(env.cfg).nvec[0])
    acts = np.random.default_rng(5).integers(0, n_act, (steps, num_envs),
                                             dtype=np.int32)
    obs_d, obs_c = [np.asarray(ts_d.obs)], [np.asarray(ts_c.obs)]
    for t in range(steps):
        s_d, ts_d = env.step(bank, s_d, jnp.asarray(acts[t]))
        s_c, ts_c = env.step(bank_c, s_c, jax.device_put(acts[t], cpu))
        assert _on(ts_d.obs, platform) and _on(ts_c.obs, "cpu")
        np.testing.assert_array_equal(
            np.asarray(ts_d.reward), np.asarray(ts_c.reward),
            err_msg=f"{game} reward, step {t}")
        np.testing.assert_array_equal(
            np.asarray(ts_d.terminated), np.asarray(ts_c.terminated),
            err_msg=f"{game} terminated, step {t}")
        obs_d.append(np.asarray(ts_d.obs))
        obs_c.append(np.asarray(ts_c.obs))
    row = dict(game=game, **_diff_row(np.stack(obs_d), np.stack(obs_c)))
    log(f"[phase 3b] {json.dumps(row)}")
    return row


def check_obs_tolerance(row, tol=OBS_TOL) -> None:
    assert row["obs_mean_abs"] <= tol["mean_abs"], row
    assert row["obs_share_over_2"] <= tol["share_over_2"], row


def phase_cpu_agreement(games=pg.GAMES, num_envs=64, steps=16,
                        num_levels=1024) -> list[dict]:
    rows = [cpu_agreement(g, num_envs, steps, num_levels) for g in games]
    for row in rows:
        check_obs_tolerance(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_gym(steps=5) -> dict:
    env = pg.GymEnv("maze", seed=42)
    obs, _ = env.reset()
    platform = jax.devices()[0].platform
    assert all(_on(x, platform) for x in jax.tree.leaves(env._bank))
    total = 0.0
    for _ in range(steps):
        obs, reward, term, trunc, _ = env.step(7)
        assert obs["screen"].shape == (64, 64, 3)
        assert obs["screen"].dtype == np.uint8
        total += float(reward)
    row = dict(steps=steps, total_reward=total)
    log(f"[phase 4] {json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------
# phase 5 (four cards)
# ---------------------------------------------------------------------------

def _sharded_run(game, mesh, num_envs, num_levels, steps):
    """make_vec over `mesh`, a `steps`-step rollout, one more step and
    its psum'd metrics; everything else the timing needs."""
    sv = dist.make_vec(game, num_envs=num_envs, num_levels=num_levels,
                       mesh=mesh)
    state, _ = sv.reset(jax.random.key(0))
    state, buf = dist.rollout(sv, state, jax.random.key(1), num_steps=steps)
    n_act = int(sv.env.game.action_space(sv.env.cfg).nvec[0])
    actions = jax.device_put(
        jax.random.randint(jax.random.key(2), (num_envs,), 0, n_act),
        sv.shard)
    state, ts = sv.step(state, actions)
    metrics = {k: float(v) for k, v in sv.metrics(ts).items()}
    return dict(sv=sv, state=state, buf=buf, metrics=metrics,
                actions=actions)


def _assert_spread(x, axis, devices, rows):
    """`x` is split along `axis` into one `rows`-row shard per device."""
    shards = x.addressable_shards
    assert {s.device for s in shards} == set(devices), shards
    assert all(s.data.shape[axis] == rows for s in shards), \
        [s.data.shape for s in shards]


def phase_four_cards(games=("coinrun", "bossfight"), per_card=4096,
                     num_levels=1024, steps=16, iters=5,
                     devices=None) -> list[dict]:
    """Every (game, mesh) run compiles and runs concurrently in threads;
    the checks and the timings follow, one run at a time."""
    devices = list(jax.devices() if devices is None else devices)
    assert len(devices) == 4, devices
    n = 4 * per_card
    meshes = {4: Mesh(np.asarray(devices), ("env",)),
              1: Mesh(np.asarray(devices[:1]), ("env",))}
    _import_games(games)
    with ThreadPoolExecutor(2 * len(games)) as pool:
        futures = {(g, c): pool.submit(_sharded_run, g, mesh, n, num_levels,
                                       steps)
                   for g in games for c, mesh in meshes.items()}
        runs = {k: f.result() for k, f in futures.items()}
    rows = []
    for game in games:
        r4, r1 = runs[(game, 4)], runs[(game, 1)]
        _assert_spread(r4["buf"].obs, 1, devices, per_card)
        for leaf in jax.tree.leaves(r4["state"]):
            _assert_spread(leaf, 0, devices, per_card)
        for f in ("rewards", "dones", "ep_returns", "ep_lengths"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r4["buf"], f)),
                np.asarray(getattr(r1["buf"], f)), err_msg=f"{game} {f}")
        assert r4["metrics"] == r1["metrics"], (game, r4["metrics"],
                                                r1["metrics"])
        rate4, rate1 = (
            _steps_per_s(r["sv"]._step, r["sv"].bank, r["state"],
                         r["actions"], n, iters) for r in (r4, r1))
        row = dict(game=game, num_envs=n, metrics=r4["metrics"],
                   env_steps_per_s_4_cards=rate4,
                   env_steps_per_s_per_card_4_cards=rate4 / 4,
                   env_steps_per_s_1_card=rate1,
                   **_diff_row(jax.device_put(r4["buf"].obs, devices[0]),
                               r1["buf"].obs))
        log(f"[phase 5] {json.dumps(row)}")
        check_obs_tolerance(row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------

def _import_games(games) -> None:
    """Import the game modules in this thread, before any worker
    thread does (see `parity_tests`)."""
    for g in games:
        importlib.import_module(f"procgen2_tpu.games.{g}")


def run_phases(rows=PHASE1_ROWS, games=pg.GAMES, small=(64, 200, 256),
               agree=(64, 16), num_levels=1024, parity_names=None,
               card="", trace_dir=None, workers=12) -> None:
    """Phases 1-4. Whatever compiles runs first, concurrently in threads
    (compilation dominates a cold start and XLA compiles with the
    interpreter lock released): phase 1's preparation, phases 2, 3(a)
    (one task per parity test, the long bossfight duels first) and
    3(b). Phase 1's timings run after, one game at a time with nothing
    else on the device; then phase 4. Every result is read, so any
    failure propagates; the first one cancels the tasks not yet
    started."""
    _import_games({*games, *(g for g, _ in rows), "coinrun"})
    tests = sorted(parity_tests(names=parity_names),
                   key=lambda t: "bossfight" not in t[0])
    with ThreadPoolExecutor(workers) as pool:
        try:
            parity = [pool.submit(phase_parity_scripted, [t])
                      for t in tests[:2]]
            preps = [pool.submit(prepare_game, g, n, num_levels)
                     for g, n in rows]
            parity += [pool.submit(phase_parity_scripted, [t])
                       for t in tests[2:]]
            small_batch = pool.submit(phase_small_batch, *small)
            agreement = [pool.submit(cpu_agreement, g, *agree, num_levels)
                         for g in games]
            preps = [f.result() for f in preps]
            small_batch.result()
            for f in parity:
                f.result()
            for f in agreement:
                check_obs_tolerance(f.result())
        except BaseException:
            pool.shutdown(cancel_futures=True)
            raise
    for prep in preps:
        measure_game(prep, card=card, trace_dir=trace_dir)
    phase_gym()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    parser.add_argument("--trace", metavar="DIR", default=None)
    args = parser.parse_args(argv)

    enable_compilation_cache()
    dev, card = phase_device()
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_four_cards()
    else:
        run_phases(card=card, trace_dir=args.trace)
    log(f"phases: {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
