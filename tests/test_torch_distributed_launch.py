"""The port's launcher (orb_slam2_with_comment_tpu_torch/parallel/launch.py,
the counterpart of scripts/launch_distributed.py): two processes on this
host join one gloo group at a free port of 127.0.0.1, run the sharded BA,
the sharded pose graph and one MultiSeqTracker frame over it, and each
prints DISTRIBUTED OK; the launcher exits 0. The children import no jax,
and the launcher bounds them at 100 s."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_gloo_processes():
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-m",
         "orb_slam2_with_comment_tpu_torch.parallel.launch",
         "--nprocs", "2", "--device", "cpu", "--timeout", "100"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    out = p.stdout + p.stderr
    assert p.returncode == 0, out[-3000:]
    assert out.count("DISTRIBUTED OK") == 2, out[-3000:]
    assert "multi_seq: 2 sequences, initialized [True, True]" in out


RUN = ("import sys, time; from orb_slam2_with_comment_tpu_torch.parallel "
       "import launch; sys.exit(launch.run_ranks(lambda r: [sys.executable, "
       "'-c', {child!r}.format(r=r)], 2, 5.0))")


def _launch(child: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", RUN.format(child=child)],
                          capture_output=True, text=True, timeout=60,
                          env=env, cwd=REPO)


def test_a_failing_rank_fails_the_launch():
    """Rank 1 exits 3 while rank 0 would run on: the launcher kills rank 0
    and exits non-zero."""
    p = _launch("import sys, time; time.sleep(0 if {r} else 30); "
                "sys.exit(3 if {r} else 0)")
    assert p.returncode == 3, p.stdout + p.stderr


def test_a_rank_past_the_time_limit_fails_the_launch():
    p = _launch("import time; time.sleep(30)")
    assert p.returncode == 124, p.stdout + p.stderr
    assert "timed out" in p.stderr
