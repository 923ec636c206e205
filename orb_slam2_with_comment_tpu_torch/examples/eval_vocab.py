"""Vocabulary recall: the packaged 88.5k-word tree against the earlier 10k
tree, on held-out synthetic worlds (the counterpart of
scripts/eval_vocab.py, the same protocol and table).

Usage: python -m orb_slam2_with_comment_tpu_torch.examples.eval_vocab
       [--device cuda] [--workers 1]

For each of the held-out worlds 200-211 (seen by neither training run),
the view of orbit pose 3 is scored against four others, 600 features and a
sparse BoW row of 600 words each:

- positives, the revisit loop closing must recognize: the same view under
  a new exposure (gamma, gain and noise from ``default_rng(77)``), and the
  adjacent pose 4 under a new exposure;
- negatives: the same pose in another world (seed + 1000), and pose 11 on
  the far side of the orbit.

Per vocabulary it prints the median same-place and different-place score,
their ratio, and the recall at the zero-false-positive threshold (the share
of positives scoring above every negative). The renders are numpy's
(``--workers`` processes); extraction and scoring run on ``--device``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing

import numpy as np
import torch

from ..dataio.synthetic import SyntheticWorld, orbit_trajectory
from ..frontend.extractor import OrbExtractor
from ..pipeline.tracking import upload_frame
from ..place import vocabulary as V

HELD_OUT_SEEDS = range(200, 212)
CAP = 600
N_FEATURES = 600
VOCABULARIES = ((V.VOCAB_10K_PATH, "10k (24 worlds, r3 default)"),
                (V.DEFAULT_PATH, "88.5k (48 worlds, default)"))
HEADER = ("| vocabulary | words | same-place score (med) | "
          "different-place score (med) | separation | recall @ zero-FP |\n"
          "|---|---|---|---|---|---|")


def jitter(img, rng):
    gamma = rng.uniform(0.75, 1.35)
    gain = rng.uniform(0.75, 1.2)
    img = 255.0 * (img / 255.0) ** gamma * gain
    return np.clip(img + rng.normal(0, 3.0, img.shape), 0, 255)


def world_views(seed: int):
    """The four renders of one held-out world: (pose 3, pose 4, pose 3 in
    world seed + 1000, pose 11)."""
    world = SyntheticWorld(seed=seed)
    poses = orbit_trajectory(n_frames=16)
    other = SyntheticWorld(seed=seed + 1000)
    return (world.render(*poses[3])[0], world.render(*poses[4])[0],
            other.render(*poses[3])[0], world.render(*poses[11])[0])


def render_worlds(seeds=HELD_OUT_SEEDS, workers: int = 1) -> list:
    if workers <= 1:
        return [world_views(s) for s in seeds]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        return list(pool.map(world_views, seeds))


def bow_row(voc, ext, img, device):
    f = ext(upload_frame(np.clip(img, 0, 255).astype(np.uint8), device))
    return V.bow_sparse(voc, V.transform(voc, f.desc, f.valid), f.valid, CAP)


def world_scores(voc, ext, views, rng, device) -> np.ndarray:
    """[4] scores of one world's pose-3 view against its two positives and
    two negatives, jitter drawn from ``rng`` (positives first)."""
    img_a, img_b, img_n1, img_n2 = views
    va = bow_row(voc, ext, img_a, device)
    rows = [bow_row(voc, ext, im, device) for im in (
        jitter(img_a, rng), jitter(img_b, rng), img_n1, img_n2)]
    return V.score_l1_sparse(va[0], va[1], torch.stack([r[0] for r in rows]),
                             torch.stack([r[1] for r in rows]),
                             voc.n_words).cpu().numpy()


def evaluate(voc, label: str, worlds: list, device) -> dict:
    """The table row of one vocabulary over the rendered ``worlds``:
    {"same", "diff" (scores in world order), "recall", "separation",
    "row"}."""
    ext = OrbExtractor(n_features=N_FEATURES)
    rng = np.random.default_rng(77)
    s = np.stack([world_scores(voc, ext, views, rng, device)
                  for views in worlds])
    same, diff = s[:, :2].reshape(-1), s[:, 2:].reshape(-1)
    recall = float(np.mean(same > diff.max()))  # zero false positives
    sep = np.median(same) / max(np.median(diff), 1e-9)
    row = (f"| {label} | {voc.n_words} | {np.median(same):.3f} | "
           f"{np.median(diff):.3f} | {sep:.2f}x | {recall * 100:.0f}% |")
    return {"same": same, "diff": diff, "recall": recall,
            "separation": float(sep), "row": row}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=1,
                    help="render the worlds in this many processes")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    worlds = render_worlds(workers=args.workers)
    print(HEADER, flush=True)
    for path, label in VOCABULARIES:
        print(evaluate(V.load_vocabulary(path, device), label, worlds,
                       device)["row"], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
