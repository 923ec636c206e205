"""The street circuit at a keyframe capacity of choice on the card, with
K4's accept test watched: what examples/eval_street.py scores (frames
tracked, keyframes, loops closed, ATE, drift), and, over every dense BA
solve of the run, the LM iterations where the kernel's accept test
(csrc/ba.cu: chi2_new < chi2_old on the float64 sums, the trace's fourth
column) and a float32 strict < of the same two sums rounded to float32 part
(the JAX package's test compares float32 sums, optim/ba.py:337-341).

    python3 scripts/street_accept_test.py [FRAMES KMAX [ROOT]]   (300 48)

The fixture is ROOT's kitti_street_fixture where ROOT is given (for
instance the one the JAX package's run below rendered with numpy, the same
bytes for both packages), else it is rendered on the card into a temporary
directory (about 25 s for 600 views; a few pixels differ by one grey level
from numpy's). The JAX package's run on the same circuit, on the CPU:
    JAX_PLATFORMS=cpu python3 scripts/jax_reference_runs.py street FRAMES KMAX ROOT
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from orb_slam2_with_comment_tpu_torch.dataio import fixtures  # noqa: E402
from orb_slam2_with_comment_tpu_torch.examples import eval_street  # noqa
from orb_slam2_with_comment_tpu_torch.optim import ba  # noqa: E402

RUN = ba.KernelSolve.run


def watch(solves: list):
    """KernelSolve.run patched: each solve's iterations and those where the
    two tests part."""
    def watched(self):
        out = RUN(self)
        trace = self.trace[:self.iters].cpu()
        lower32 = (trace[:, 1] < trace[:, 0]).float()
        n = 0 if self.accept_all else int((lower32 != trace[:, 3]).sum())
        solves.append((0 if self.accept_all else len(trace), n))
        return out

    ba.KernelSolve.run = watched


def circuit(frames: int, kmax: int, given: str | None) -> dict:
    solves = []
    watch(solves)
    with tempfile.TemporaryDirectory() as root:
        fix = os.path.join(root, "kitti_street_fixture")
        t0 = time.perf_counter()
        if given:
            os.symlink(os.path.abspath(os.path.join(
                given, "kitti_street_fixture")), fix)
        else:
            fixtures.make_kitti_street(fix, n_frames=frames, workers=4,
                                       device="cuda")
        print(f"fixture: {frames} pairs in {time.perf_counter() - t0:.1f} s"
              f" ({'given: ' + given if given else 'rendered on the card'})",
              flush=True)
        t0 = time.perf_counter()
        rc = eval_street.main(["--root", root, "--kmax", str(kmax),
                               "--device", "cuda"])
        assert rc == 0
        print(f"run: {time.perf_counter() - t0:.1f} s", flush=True)
        _, sc = eval_street.score(fix, os.path.join(root, "run_street"),
                                  kmax)
    summ = sc["summary"]
    return {
        "frames": frames, "kmax": kmax, "tracked": summ["n_frames"],
        "n_keyframes": summ["n_keyframes"],
        "n_compact_kf": summ["n_compact_kf"],
        "n_loops_closed": summ["n_loops_closed"], "ate_m": sc["ate_m"],
        "trans_pct": sc["trans_pct"], "rot_deg_per_m": sc["rot_deg_per_m"],
        "path_len_m": sc["path_len_m"], "ba_solves": len(solves),
        "ba_iterations": sum(s[0] for s in solves),
        "tests_part": sum(s[1] for s in solves),
        "solves_where_they_part": sum(s[1] > 0 for s in solves)}


def main(frames: int, kmax: int, given: str | None = None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(json.dumps(circuit(frames, kmax, given)), flush=True)


if __name__ == "__main__":
    main(*((int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:4])
           if len(sys.argv) > 2 else (300, 48)))
