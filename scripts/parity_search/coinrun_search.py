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
N = len(SEEDS)
bank_np = reference_bank("coinrun", SEEDS)
env = pg.make("coinrun")

levels = [jax.tree.map(lambda x, i=i: np.asarray(x[i]), bank_np) for i in range(N)]
bbots = [bots.CoinrunBot(l) for l in levels]

bank = jax.tree.map(jnp.asarray, bank_np)
state = env.reset_pinned(bank, jax.random.key(123), jnp.asarray(SEEDS, jnp.uint32))
T = 600
R = np.zeros((T, N), np.float32)
D = np.zeros((T, N), bool)
done = np.zeros(N, bool)
t0 = time.time()
for t in range(T):
    gs = state.game
    pos = np.asarray(gs.pos); vel = np.asarray(gs.vel)
    og = np.asarray(gs.on_ground)
    acts = np.array([
        bbots[i].act(pos[i], vel[i], og[i]) if not done[i] else 4
        for i in range(N)], np.int32)
    state, ts = env.step_raw(state, jnp.asarray(acts), render=False)
    R[t] = np.asarray(ts.reward); D[t] = np.asarray(ts.terminated)
    done |= D[t]
    if done.all():
        T = t + 1
        break
print(f"{T} steps x {N} in {time.time()-t0:.1f}s", flush=True)

ok = []
for i, s in enumerate(SEEDS):
    d = D[:T, i]; r = R[:T, i]
    if not d.any():
        print(f"seed {s}: stuck (no terminal)")
        continue
    end = int(np.argmax(d))
    if r[end] != np.float32(10.0):
        print(f"seed {s}: death at {end} (reward {r[end]})")
        continue
    if np.count_nonzero(r[:end]):
        print(f"seed {s}: nonzero rewards before coin?!")
        continue
    ok.append((s, end))
print("OK:", ok)
print("OK seeds:", [s for s, _ in ok], f"({len(ok)}/{N})")
