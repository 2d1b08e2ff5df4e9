"""Worker for tests/test_multihost.py: one of 2 `jax.distributed` processes.

Exercises the real multi-host path: `init_multihost`
-> global 4-device mesh (2 processes x 2 virtual CPU devices) ->
ShardedEnv reset/step with the batch sharded over all processes ->
psum-reduced metrics -> `local_slice` row-ownership check.

Run (by the test, or by hand):
    python tests/multihost_worker.py <process_id> <port>
"""
import os
import sys

PID = int(sys.argv[1])
PORT = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from procgen2_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

from procgen2_tpu.dist.vec import init_multihost, local_slice, make_vec  # noqa: E402

init_multihost(coordinator_address=f"localhost:{PORT}",
               num_processes=2, process_id=PID)

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

import jax.numpy as jnp  # noqa: E402

NUM_ENVS = 8
env = make_vec("maze", num_envs=NUM_ENVS, num_levels=4, mode="easy")
state, ts = env.reset(jax.random.key(0))

# On-device action production (steady state needs zero host->device
# transfer; actions come from the co-located learner in production)
actions = jax.jit(
    lambda k: jax.random.randint(k, (NUM_ENVS,), 0, 15),
    out_shardings=env.shard,
)(jax.random.key(1))

for _ in range(3):
    state, ts = env.step(state, actions)

m = env.metrics(ts)  # cross-process psum reduction over Gloo
reward_mean = float(m["reward_mean"])

# local_slice: this process owns a contiguous half of the batch rows
rows, start = local_slice(ts.reward, env.mesh)
assert rows.shape[0] == NUM_ENVS // 2, rows.shape
assert start == PID * (NUM_ENVS // 2), (start, PID)

# observations are sharded over the batch too; check local shard shape
obs_rows, obs_start = local_slice(ts.obs, env.mesh)
assert obs_rows.shape == (NUM_ENVS // 2, 64, 64, 3), obs_rows.shape
assert obs_start == start

print(f"MHOK pid={PID} rows={rows.shape[0]} start={start} "
      f"reward_mean={reward_mean}", flush=True)
