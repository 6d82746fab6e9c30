"""chip_smoke.py: its refusals, and every phase at a tiny size on the CPU.

On the card each phase runs at production widths; here the same code runs
at sizes that take seconds, which checks its control flow, its oracle and
its comparisons.  The card-only numbers (times, TF32 lowering, cuSOLVER)
come from the script itself on the GPU.
"""
import os
import shutil
import subprocess
import sys

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CASE = dict(k=6, nx=12, ny=10, nz=4, n_synop=40, n_radar=300)


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run(cwd, script):
    return subprocess.run([sys.executable, script], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=300)


def test_smoke_refuses_cpu():
    p = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_phase_device(capsys):
    chip_smoke.phase_device("H100, 700.00 W")
    out = capsys.readouterr().out
    assert "platform cpu" in out and "H100, 700.00 W" in out


def test_phase_solver(capsys):
    chip_smoke.phase_solver(batch=32, ks=(8, 24), f64_batch=16, reps=1)
    out = capsys.readouterr().out
    assert out.count("XLA Newton-Schulz") == 2
    assert out.count("group solve") == 2


def test_phase_precision(capsys):
    chip_smoke.phase_precision(ks=(8,), nx=16, nz=4, n_obs=(100, 800, 800),
                               n_sample=24, c=64, r=256, reps=1)
    out = capsys.readouterr().out
    assert out.count("within tolerance") == 2


def test_phase_cycle(capsys):
    chip_smoke.phase_cycle(k=8, nx=16, nz=4, n_obs=(100, 800, 800),
                           n_sample=24)
    assert "overflow 0" in capsys.readouterr().out


def test_phase_production(capsys):
    chip_smoke.phase_production(grid=(32, 32, 6), k=12, r_obs=3000,
                                n_slabs=4, n_sample=24, chunk=512)
    assert "overflow 0" in capsys.readouterr().out


def test_phase_cli(tmp_path, capsys):
    chip_smoke.phase_cli(str(tmp_path), case=TINY_CASE, n_sample=24,
                         expect_platform="cpu")
    out = capsys.readouterr().out
    assert "stream vs eager" in out and "metrics name cpu" in out


def test_oracle_rejects_a_wrong_analysis():
    """The comparison the phases rely on must see a wrong answer."""
    import numpy as np

    xb = np.full((4, 1, 3), 290.0)
    ref = xb + 1.0
    assert chip_smoke.compare_oracle("ok", ref, ref, xb) == 0.0
    bad = ref.copy()
    bad[2, 0, 1] += 1.0
    assert chip_smoke.compare_oracle("bad", bad, ref, xb) > \
        chip_smoke.CYCLE_TOL
