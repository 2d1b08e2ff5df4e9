"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
report success anywhere but on a GPU.

The script itself runs on the card; here each phase function runs at a
few envs and steps so that its control flow and checks are exercised.
"""
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_games_tiny(tmp_path):
    (row,) = cs.phase_games(rows=(("maze", 8),), num_levels=8, steps=2,
                            iters=1, card="cpu", trace_dir=str(tmp_path))
    assert row["game"] == "maze" and row["num_envs"] == 8
    assert row["env_steps_per_s_rendered"] > 0
    assert row["env_steps_per_s_no_render"] > 0
    assert set(row["step_memory"]) >= {"argument", "output", "temp"}
    # the trace and the step's HLO that xprof_by_source.py reads
    out = tmp_path / "maze_8"
    assert list(out.glob("**/*.trace.json.gz"))
    assert (out / "step.hlo.txt.gz").stat().st_size > 0


def test_run_phases_tiny():
    """Phases 1-4 through the thread pool `main()` uses (no parity
    test selected: those run in tests/test_parity_*.py)."""
    cs.run_phases(rows=(("chaser", 8),), games=("chaser",), small=(8, 8, 2),
                  agree=(4, 2), num_levels=8, parity_names=(), workers=3)


def test_phase_small_batch_tiny():
    row = cs.phase_small_batch(num_envs=8, num_levels=8, steps=4)
    assert row["steps"] == 4 and row["episodes_done"] >= 0


def test_cpu_agreement_tiny():
    # both sides run on the CPU here, so they must agree exactly
    (row,) = cs.phase_cpu_agreement(games=("maze",), num_envs=4, steps=2,
                                    num_levels=8)
    assert row["obs_max_abs"] == 0


def test_phase_gym():
    assert cs.phase_gym(steps=2)["steps"] == 2


def test_phase_four_cards_tiny():
    rows = cs.phase_four_cards(games=("maze", "bossfight"), per_card=2,
                               num_levels=8, steps=2, iters=1,
                               devices=jax.devices()[:4])
    assert [r["game"] for r in rows] == ["maze", "bossfight"]
    assert all(r["num_envs"] == 8 and r["obs_max_abs"] == 0 for r in rows)


def _run(script, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_main_fails_without_gpu_or_repo(where, tmp_path):
    """No GPU (or no repository beside the script): non-zero exit and
    no result line."""
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    else:
        script, cwd = os.path.join(ROOT, "chip_smoke.py"), ROOT
    out = _run(script, cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
