"""The outputs of every hand kernel at its default shapes on fixed inputs,
to hold two trees' kernels against each other bit for bit on one card.

    python3 scripts/kernel_bits.py run ROOT OUT.pt
    python3 scripts/kernel_bits.py compare A.pt B.pt

``run`` imports orb_slam2_with_comment_tpu_torch from the tree at ROOT
(its kernels built from that tree's csrc into its build/) and saves what
K1-K5 give on seeded inputs: masked_best_two and distance_matrix at
[4096,1000], 30% admissible; the pose LM at [3x1000] and [1x4096]; ORB
extraction of a rendered orbit frame (640x480, 1000 features) and of a
KITTI-sized frame (1241x376, 2000); the stereo match of the rendered
pair at the bench's 8 cm baseline; the dense BA at 24 poses / 8192
landmarks and at 64 / 10000. ``compare`` prints, for each output, whether
the two files hold the same bits, and exits 1 if any differs.
"""
import os
import sys

import numpy as np
import torch


def run(root: str, out: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from orb_slam2_with_comment_tpu_torch.dataio.synthetic import (
        SyntheticWorld, ba_problem, orbit_trajectory, pose_problem)
    from orb_slam2_with_comment_tpu_torch.frontend.extractor import (
        OrbExtractor)
    from orb_slam2_with_comment_tpu_torch.ops import hamming
    from orb_slam2_with_comment_tpu_torch.optim import ba, pose_opt
    from orb_slam2_with_comment_tpu_torch.optim.residuals import CamParams
    import orb_slam2_with_comment_tpu_torch as pkg
    assert os.path.dirname(os.path.dirname(pkg.__file__)) == \
        os.path.abspath(root)
    dev = torch.device("cuda", 0)
    res = {}
    gen = torch.Generator().manual_seed(0)
    dq = torch.randint(-2 ** 31, 2 ** 31, (4096, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32).to(dev)
    dt = torch.randint(-2 ** 31, 2 ** 31, (1000, 8), generator=gen,
                       dtype=torch.int64).to(torch.int32).to(dev)
    mask = (torch.rand((4096, 1000), generator=gen) < 0.3).to(dev)
    res["K1 masked_best_two"] = hamming.masked_best_two(dq, dt, mask)
    res["K1 distance_matrix"] = (hamming.distance_matrix(dq, dt),)
    cam = CamParams.of(500.0, 500.0, 320.0, 240.0, 40.0)
    for b, n in ((3, 1000), (1, 4096)):
        p = pose_problem("outliers", 300, b, n)
        res[f"K3 [{b}x{n}]"] = tuple(pose_opt.optimize_pose(cam, *(
            torch.as_tensor(p[k]).to(dev) for k in (
                "R0", "t0", "Xw", "obs_uvr", "inv_sigma2", "valid"))))
    world = SyntheticWorld(seed=1)
    R, t = orbit_trajectory(16)[5]
    views = [np.clip(world.render(R, tt)[0], 0, 255).astype(np.uint8)
             for tt in (t, np.asarray(t, np.float32)
                        - np.float32([0.08, 0, 0]))]
    for name, img, n in (("640x480, 1000", views[0], 1000),
                         ("1241x376, 2000", np.ascontiguousarray(
                             np.tile(views[0], (1, 2))[:376, :1241]), 2000)):
        ext = OrbExtractor(n_features=n)
        res[f"K2 {name}"] = tuple(ext(torch.as_tensor(img, device=dev)))
    ext = OrbExtractor(n_features=1000)
    feats, sd = ext.stereo(*(torch.as_tensor(v, device=dev) for v in views),
                           40.0, 500.0)
    res["K5 stereo pair, 1000"] = (*feats, *sd)
    for P, L in ((24, 8192), (64, 10000)):
        p = ba_problem("mixed", P, P=P, L=L)
        prob = ba.BAProblem(*(torch.as_tensor(p[f]).to(dev)
                              for f in ba.BAProblem._fields))
        res[f"K4 P {P}, L {L}"] = tuple(ba.ba_solve(cam, prob, 5))
    torch.cuda.synchronize()
    torch.save({k: [x.cpu() for x in v] for k, v in res.items()}, out)
    print(f"{root}: {len(res)} outputs saved to {out}")


def compare(a: str, b: str) -> int:
    A, B = torch.load(a), torch.load(b)
    bad = 0
    for k in A:
        same = len(A[k]) == len(B[k]) and all(
            x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.reshape(-1).view(torch.uint8),
                            y.reshape(-1).view(torch.uint8))
            for x, y in zip(A[k], B[k]))
        bad += not same
        print(f"{k}: {'the same bits' if same else 'DIFFERENT'}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"] and len(sys.argv) == 4:
        run(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        raise SystemExit(compare(sys.argv[2], sys.argv[3]))
    else:
        raise SystemExit(__doc__)
