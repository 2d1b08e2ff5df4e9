"""Multi-host path: 2 real `jax.distributed` processes over a CPU mesh.

Launches tests/multihost_worker.py twice (process_id 0/1, shared
coordinator), which initializes the distributed runtime through
`init_multihost`, steps a ShardedEnv whose batch is sharded over the
*global* 4-device mesh, reduces metrics with cross-process collectives
(Gloo), and validates `local_slice` row ownership. This keeps the
multi-process story honest beyond the single-process dry run.
"""
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")
    port = str(_free_port())

    # Fresh env: the workers pin their own JAX platform/device config
    # (a set compilation cache dir passes through).
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))
           or k == "JAX_COMPILATION_CACHE_DIR"}

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=root,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=280)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MHOK pid={pid}" in out, out
        assert f"start={pid * 4}" in out, out

    # both processes computed the same globally-reduced metric
    rm = [line.split("reward_mean=")[1].strip()
          for out in outs for line in out.splitlines() if "MHOK" in line]
    assert len(rm) == 2 and rm[0] == rm[1], rm
