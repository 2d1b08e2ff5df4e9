"""Sharding tests on the virtual 8-device CPU mesh (conftest sets
XLA_FLAGS=--xla_force_host_platform_device_count=8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.dist import make_vec, rollout


@pytest.fixture(scope="module")
def venv():
    return make_vec("maze", num_envs=16, num_levels=8, mode="easy")


def test_mesh_has_8_devices(cpu_devices):
    assert len(cpu_devices) == 8


def test_sharded_reset_step(venv):
    state, ts = venv.reset(jax.random.key(0))
    assert ts.obs.shape == (16, 64, 64, 3)
    # batch is sharded over the env axis
    shard_shapes = {s.data.shape[0] for s in ts.obs.addressable_shards}
    assert shard_shapes == {2}  # 16 envs / 8 devices
    actions = jax.device_put(
        jnp.zeros(16, jnp.int32), venv.shard
    )
    state, ts = venv.step(state, actions)
    assert ts.reward.shape == (16,)


def test_bank_replicated(venv):
    venv.reset(jax.random.key(0))
    leaf = jax.tree.leaves(venv.bank)[0]
    assert len({s.data.shape for s in leaf.addressable_shards}) == 1
    assert leaf.addressable_shards[0].data.shape == leaf.shape  # full copy


def test_metrics_reduce(venv):
    state, ts = venv.reset(jax.random.key(1))
    actions = jax.device_put(jnp.zeros(16, jnp.int32), venv.shard)
    state, ts = venv.step(state, actions)
    m = venv.metrics(ts)
    assert set(m) == {"reward_mean", "episodes_done", "episode_return_mean"}
    assert np.isfinite(float(m["reward_mean"]))


def test_rollout_scan(venv):
    state, _ = venv.reset(jax.random.key(2))
    state, buf = rollout(venv, state, jax.random.key(3), num_steps=5)
    assert buf.obs.shape == (5, 16, 64, 64, 3)
    assert buf.rewards.shape == (5, 16)
    assert buf.obs.dtype == jnp.uint8
    # rollout keeps the env-axis sharding on the time-major buffer
    assert {s.data.shape[1] for s in buf.obs.addressable_shards} == {2}


def test_rollout_rewards_consistent(venv):
    # stepping manually with the same key sequence matches the scan
    state, _ = venv.reset(jax.random.key(4))
    s2 = state
    key = jax.random.key(5)
    state, buf = rollout(venv, state, key, num_steps=4)
    k = key
    for t in range(4):
        k, k_act = jax.random.split(k)
        a = jax.random.randint(k_act, (16,), 0, 15)
        s2, ts = venv.step(s2, a)
        np.testing.assert_allclose(
            np.asarray(ts.reward), np.asarray(buf.rewards[t])
        )


# ---------------------------------------------------------------------------
# every game steps sharded on the 8-device mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("game,kw", [
    ("coinrun", {}),
    ("chaser", {"mode": "easy"}),
    ("jumper", {"mode": "easy"}),
    ("climber", {"easy_mode": True}),
    ("caveflyer", {"mode": "easy"}),
    ("bossfight", {}),
])
def test_sharded_step_every_game(game, kw):
    """Different bank shapes, stamp banks and rotated render paths all
    compile and execute under the env-axis sharding."""
    venv = make_vec(game, num_envs=8, num_levels=4, **kw)
    state, ts = venv.reset(jax.random.key(0))
    assert ts.obs.shape == (8, 64, 64, 3)
    assert {s.data.shape[0] for s in ts.obs.addressable_shards} == {1}
    actions = jax.device_put(jnp.zeros(8, jnp.int32), venv.shard)
    for _ in range(2):
        state, ts = venv.step(state, actions)
    assert ts.reward.shape == (8,)
    assert {s.data.shape[0] for s in ts.obs.addressable_shards} == {1}
    assert np.isfinite(float(venv.metrics(ts)["reward_mean"]))
