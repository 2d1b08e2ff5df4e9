"""Per-game throughput benchmark CLI (counterpart of game_test.py).

The reference measures a single env's per-step FPS across the ctypes FFI
(game_test.py:17-30). Here the unit of work is a jit `lax.scan` rollout
of a batch with on-device random actions and observations materialized
to device memory; reported as env-steps/s. `main` runs only on a GPU
and names the device in every record; `bench_game` itself runs on any
backend (the CPU tests call it).

Run:  python -m procgen2_tpu.tools.bench_cli            # all games
      python -m procgen2_tpu.tools.bench_cli chaser --num-envs 8192
"""
from __future__ import annotations

import argparse
import json
import time


def bench_game(game: str, num_envs: int = 4096, num_levels: int = 1024,
               T: int = 8, iters: int = 20, profile_dir: str | None = None,
               **config) -> dict:
    import contextlib

    import jax
    import jax.numpy as jnp

    from .. import make

    env = make(game, **config)
    key = jax.random.key(0)
    bank = env.generate_bank(key, num_levels=num_levels)
    state, _ = env.reset(bank, jax.random.key(1), num_envs=num_envs)

    @jax.jit
    def rollout(bank, state, k):
        def scan_step(carry, _):
            state, k = carry
            k, sk = jax.random.split(k)
            actions = jax.random.randint(sk, (num_envs,), 0, 15)
            state, ts = env._step(bank, state, actions)
            # Barrier: keep the u8 obs conversion OUT of the scan
            # buffer's dynamic-update-slice fusion — fused, the DUS
            # can lose its in-place update and rewrite the whole
            # [T, N, 64, 64, 3] buffer every step.
            obs = jax.lax.optimization_barrier(ts.obs)
            return (state, k), (obs, ts.reward)

        (state, k), (obs, rew) = jax.lax.scan(scan_step, (state, k), None, length=T)
        # checksum forces materialization (obs must be written, not DCE'd)
        return state, k, obs[::4].sum(dtype=jnp.int32), rew.sum()

    k = jax.random.key(2)
    state, k, chk, _ = rollout(bank, state, k)
    int(chk)  # sync: wait for compile + first run

    t_gen0 = time.perf_counter()
    bank2 = env.generate_bank(jax.random.key(3), num_levels=num_levels)
    jax.block_until_ready(bank2)
    t_gen = time.perf_counter() - t_gen0

    # SURVEY.md §5 tracing: optional jax.profiler trace of the timed loop
    # (the reference's only instrument is game_test.py:17-30's FPS EMA)
    trace = (
        jax.profiler.trace(f"{profile_dir}/{game}")
        if profile_dir else contextlib.nullcontext()
    )
    with trace:
        start = time.perf_counter()
        for _ in range(iters):
            state, k, chk, _ = rollout(bank, state, k)
        int(chk)  # host readback syncs the stream
        elapsed = time.perf_counter() - start

    steps = num_envs * T * iters
    return dict(
        game=game,
        num_envs=num_envs,
        env_steps_per_s=steps / elapsed,
        levelgen_per_s=num_levels / t_gen,
        seconds=elapsed,
    )


def main(argv=None):
    from .. import GAMES
    from ..utils import device
    from ..utils.cache import enable_compilation_cache

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("game", nargs="?", default=None)
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--num-levels", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument(
        "--profile", metavar="DIR", default=None,
        help="emit a jax.profiler trace of the timed loop under DIR "
             "(view with tensorboard/xprof)",
    )
    parser.add_argument(
        "--out", metavar="FILE", default=None,
        help="also write the results as one JSON document (a machine-"
             "readable per-game record: steps/s, batch, date, commit)",
    )
    args = parser.parse_args(argv)
    dev = device.require_gpu()
    card = device.card_name_and_power_limit()
    print(json.dumps(dict(device=dev, card=card)))
    enable_compilation_cache()

    games = [args.game] if args.game else list(GAMES)
    results = []
    for g in games:
        r = bench_game(g, num_envs=args.num_envs, num_levels=args.num_levels,
                       iters=args.iters, profile_dir=args.profile)
        print(json.dumps(r))
        results.append(r)
    if args.out:
        import datetime
        import os
        import subprocess

        # the checkout may not be a git repository (commit then "unknown")
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.strip() or "unknown"
        except OSError:
            commit = "unknown"
        doc = dict(
            date=datetime.date.today().isoformat(),
            commit=commit,
            device=dev,
            card=card,
            obs="rendered 64x64 uint8 HWC, materialized to device memory",
            games=results,
        )
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
