"""Count and locate the host's waits on the card in the port's System path.

    python3 scripts/sync_sites.py [--root DIR] [--frames N] [--no-13a]

Imports the port and ``chip_smoke.py`` from ``--root`` (default: this
checkout; give an unpacked copy of another commit to compare two trees in
one run), renders the 60-frame synthetic orbit, and drives
``System(cfg, Sensor.RGBD)`` at the bench configuration over its first
``--frames`` frames under torch.cuda's sync debug mode. Every flagged wait
is attributed to the innermost line of the port that caused it, with its
caller; the table splits them between calls that inserted a keyframe and
plain calls. Then, unless ``--no-13a``, it runs chip_smoke's phase 13a
(``run_system_rgbd``) from the same tree, which prints the waits per call
that PERF.md quotes. Needs a CUDA device.
"""
import argparse
import collections
import json
import os
import sys
import time
import traceback
import warnings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--no-13a", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from orb_slam2_with_comment_tpu_torch import Sensor, System
    from orb_slam2_with_comment_tpu_torch.pipeline import loop_closing

    if not torch.cuda.is_available():
        raise SystemExit("sync_sites.py needs a CUDA device")
    pkg = os.path.join(root, "orb_slam2_with_comment_tpu_torch")
    t0 = time.perf_counter()
    cs.render_all(7, names=["orbit60"])
    print(f"[{root}] rendered the orbit in {time.perf_counter() - t0:.1f} s",
          flush=True)
    frames = cs.frames_of("orbit60")[:args.frames]
    dev = torch.device("cuda", 0)
    slam = System(cs.bench_cfg(), Sensor.RGBD, device=dev)
    tr = slam.tracker
    sites = {True: collections.Counter(), False: collections.Counter()}
    calls = {True: 0, False: 0}
    waits = {True: 0, False: 0}
    current = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1]
                 if f.filename.startswith(pkg)]
        key = " <- ".join(
            f"{os.path.relpath(f.filename, root)}:{f.lineno}"
            for f in reversed(stack[-2:])) or f"{filename}:{lineno}"
        current.append(key)

    wait = loop_closing.Readback.result

    def counted(self):
        if self._event is not None and not hasattr(self, "_waited"):
            current.append("Readback.result (the tracker's own readback)")
        self._waited = True
        return wait(self)

    loop_closing.Readback.result = counted
    mode = torch.cuda.get_sync_debug_mode()
    for i, (img, depth) in enumerate(frames):
        n_kf = tr.n_kf_host
        current.clear()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            slam.track_rgbd(img, depth, i / 30.0)
        torch.cuda.set_sync_debug_mode(mode)
        ins = tr.n_kf_host > n_kf
        if i == 0:
            continue  # the initialization frame
        calls[ins] += 1
        waits[ins] += len(current)
        sites[ins].update(current)
    loop_closing.Readback.result = wait
    slam.shutdown()
    out = {}
    for ins, label in ((False, "plain"), (True, "insert")):
        n = max(calls[ins], 1)
        print(f"[{root}] {label} calls: {calls[ins]}, waits per call "
              f"{waits[ins] / n:.2f}", flush=True)
        for key, c in sites[ins].most_common():
            print(f"    {c / n:8.2f}  {key}")
        out[label] = {"calls": calls[ins], "per_call": waits[ins] / n,
                      "sites": {k: c / n for k, c in sites[ins].items()}}
    print("SITES " + json.dumps(out), flush=True)
    if not args.no_13a:
        cs.run_system_rgbd(dev)


if __name__ == "__main__":
    main()
