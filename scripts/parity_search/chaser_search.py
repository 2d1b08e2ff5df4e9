import os, sys, time
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
import jax
jax.config.update("jax_platforms", "cpu")
from procgen2_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
import jax.numpy as jnp, numpy as np
import procgen2_tpu as pg
from procgen2_tpu.tools import bots
from procgen2_tpu.tools.reference_levels import reference_bank

lo, hi = int(sys.argv[1]), int(sys.argv[2])
SEEDS = list(range(lo, hi))
bank_np = reference_bank("chaser", SEEDS)
env = pg.make("chaser", mode="easy")

acts, preds = [], []
for i, s in enumerate(SEEDS):
    lvl = jax.tree.map(lambda x, i=i: np.asarray(x[i]), bank_np)
    route = bots.chaser_full_route(lvl)
    a = bots.route_to_actions(route, bots.CHASER_STEPS_PER_CELL)
    rew, term = bots.chaser_predict(lvl, a)
    acts.append(a); preds.append((rew, term))

bank = jax.tree.map(jnp.asarray, bank_np)
state = env.reset_pinned(bank, jax.random.key(123),
                         jnp.asarray(SEEDS, jnp.uint32))
T = max(len(a) for a in acts)
A = np.full((T, len(SEEDS)), 4, np.int32)
for i, a in enumerate(acts):
    A[:len(a), i] = a
R = np.zeros((T, len(SEEDS)), np.float32)
D = np.zeros((T, len(SEEDS)), bool)
t0 = time.time()
for t in range(T):
    state, ts = env.step_raw(state, jnp.asarray(A[t]), render=False)
    R[t] = np.asarray(ts.reward); D[t] = np.asarray(ts.terminated)
print(f"engine {T} steps x {len(SEEDS)} in {time.time()-t0:.1f}s", flush=True)

ok = []
for i, s in enumerate(SEEDS):
    rew, term = preds[i]
    n = len(rew)
    first_done = int(np.argmax(D[:, i])) if D[:, i].any() else -1
    if first_done == n - 1 and np.array_equal(R[:n, i], rew):
        ok.append(s)
print("OK seeds:", ok, f"({len(ok)}/{len(SEEDS)})")
