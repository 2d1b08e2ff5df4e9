"""Headline benchmark: maze env-steps/s per card with rendered 64x64
observations, on one GPU.

Prints the device (JAX's platform, device kind and count; the card's
name and power limit from nvidia-smi), then ONE JSON line:
{"metric", "value", "unit", "device"}. Refuses to run without a GPU.

The hot loop is a jit `lax.scan` over T steps of the batched auto-resetting
env, with on-device random actions; the [T, N, 64, 64, 3] observation
buffer is a program output, so every frame is written to device memory.

Run:  python bench.py            (BENCH_NUM_ENVS overrides the batch)
"""
import json
import os
import time

import jax
import jax.numpy as jnp

import procgen2_tpu as pg
from procgen2_tpu.utils import device
from procgen2_tpu.utils.cache import enable_compilation_cache

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 8192))
NUM_LEVELS = 2048
T = 8  # rollout buffer depth per timing iteration


def main():
    dev = device.require_gpu()
    card = device.card_name_and_power_limit()
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}; "
          f"card: {card}")
    enable_compilation_cache()

    env = pg.make("maze", mode="easy")
    key = jax.random.key(0)
    bank = env.generate_bank(key, num_levels=NUM_LEVELS)
    state, _ = env.reset(bank, jax.random.key(1), num_envs=NUM_ENVS)

    # The bank is a jit *argument*, never a captured constant (a large
    # captured constant is embedded in the compiled program).
    @jax.jit
    def rollout(bank, state, k):
        def scan_step(carry, _):
            state, k = carry
            k, sk = jax.random.split(k)
            actions = jax.random.randint(sk, (NUM_ENVS,), 0, 15)
            state, ts = env._step(bank, state, actions)
            return (state, k), (ts.obs, ts.reward)

        (state, k), (obs_buf, rew_buf) = jax.lax.scan(
            scan_step, (state, k), None, length=T
        )
        return state, k, obs_buf, rew_buf.sum()

    state, k, obs_buf, chk = rollout(bank, state, jax.random.key(2))
    jax.block_until_ready((state, obs_buf, chk))  # compile + warm up

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, k, obs_buf, chk = rollout(bank, state, k)
    jax.block_until_ready((state, obs_buf, chk))
    dt = time.perf_counter() - t0

    steps_per_s = NUM_ENVS * T * iters / dt
    print(
        json.dumps(
            {
                "metric": "maze_env_steps_per_s_per_card_rendered_obs",
                "value": steps_per_s,
                "unit": "env-steps/s/card",
                "device": dict(dev, card=card),
            }
        )
    )


if __name__ == "__main__":
    main()
