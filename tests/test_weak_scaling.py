"""Weak-scaling smoke on the virtual CPU mesh (docs/SCALING.md §3).

This measures *program structure*, not hardware throughput: growing the
mesh 1 -> 8 devices with per-device batch held fixed must (a) leave
each lane's results BIT-IDENTICAL — proof that no cross-lane data
dependency exists in generate/reset/step — and (b) scale wall time no
worse than the serialized work itself on the shared host cores (a
hidden O(N^2) cross-lane term would blow the bound immediately).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import procgen2_tpu as pg
from procgen2_tpu.dist.vec import ShardedEnv

B = 16  # per-device batch
T = 8   # rollout length per timed repetition


def _rollout_time(venv, state, actions, reps=3):
    @jax.jit
    def run(bank, state):
        def body(s, _):
            s, ts = venv.env._step(bank, s, actions)
            return s, ts.reward.sum()
        s, r = jax.lax.scan(body, state, None, length=T)
        return s, r.sum()

    state, chk = run(venv.bank, state)
    float(chk)  # compile + warm
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        state, chk = run(venv.bank, state)
        float(chk)
        best = min(best, time.perf_counter() - t0)
    return best


@pytest.mark.parametrize("game,kw", [("maze", {"mode": "easy"}),
                                     ("coinrun", {})])
def test_weak_scaling_smoke_no_cross_lane_structure(game, kw):
    devs = jax.devices()
    assert len(devs) >= 8, "conftest pins an 8-device CPU platform"
    env = pg.make(game, **kw)
    m1 = Mesh(np.asarray(devs[:1]), ("env",))
    m8 = Mesh(np.asarray(devs[:8]), ("env",))
    v1 = ShardedEnv(env, B, num_levels=32, mesh=m1)
    v8 = ShardedEnv(env, 8 * B, num_levels=32, mesh=m8)

    key = jax.random.key(5)
    s1, t1 = v1.reset(key)
    s8, t8 = v8.reset(key)

    a1 = jnp.arange(B, dtype=jnp.int32) % 15
    a8 = jnp.arange(8 * B, dtype=jnp.int32) % 15
    for _ in range(3):
        s1, t1 = v1.step(s1, a1)
        s8, t8 = v8.step(s8, a8)

    # (a) lane independence: the first B lanes of the 8x mesh are
    # bit-identical to the 1x run — same bank, same per-lane reset
    # derivation, no cross-lane coupling anywhere in the step
    np.testing.assert_array_equal(
        np.asarray(t8.obs)[:B], np.asarray(t1.obs))
    np.testing.assert_array_equal(
        np.asarray(t8.reward)[:B], np.asarray(t1.reward))
    np.testing.assert_array_equal(
        np.asarray(t8.terminated)[:B], np.asarray(t1.terminated))

    # (b) time ratio bounded: 8x total work on shared host cores may
    # cost up to ~8x serialized plus dispatch overhead; a cross-lane
    # O(N^2) term would cost >= 64x and trip this immediately
    dt1 = _rollout_time(v1, s1, a1)
    dt8 = _rollout_time(v8, s8, a8)
    assert dt8 < 20.0 * max(dt1, 1e-4), (
        f"{game}: 8x mesh step took {dt8:.4f}s vs 1x {dt1:.4f}s"
    )
