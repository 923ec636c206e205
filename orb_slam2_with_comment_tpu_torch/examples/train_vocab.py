"""Train a BoW vocabulary (the counterpart of scripts/train_vocab.py).

    python -m orb_slam2_with_comment_tpu_torch.examples.train_vocab \\
        [--worlds 24] [--frames 8] [--k 10] [--levels 4] [--out vocab.npz] \\
        [--device cuda]

The reference ships ORBvoc.txt, a k=10, L=6 DBoW2 tree trained offline on
Flickr1M. This trainer harvests ORB descriptors with the port's extractor
from a spread of synthetic worlds (orbit views, each with a random gamma,
gain and sensor noise), trains a k-majority tree
(place.vocabulary.train_vocabulary) and saves it in the JAX package's
file format, which place.vocabulary.load_vocabulary and the JAX package
both load. The packaged default vocabulary is not overwritten unless
``--out`` names it.
"""
import argparse
import sys

import numpy as np
import torch

from ..dataio.synthetic import SyntheticWorld, orbit_trajectory
from ..frontend.extractor import OrbExtractor
from ..place.vocabulary import save_vocabulary, train_vocabulary


def harvest(n_worlds: int, frames_per_world: int, device,
            log=print) -> np.ndarray:
    """The descriptors [M, 8] uint32 of every valid feature of the jittered
    orbit views of ``n_worlds`` worlds."""
    ext = OrbExtractor(n_features=1000)
    rng = np.random.RandomState(42)
    all_desc = []
    for seed in range(n_worlds):
        world = SyntheticWorld(seed=seed)
        for R, t in orbit_trajectory(n_frames=frames_per_world):
            img, _ = world.render(R, t)
            img = np.clip(img, 0, 255).astype(np.float32)
            # photometric jitter: gamma, gain and sensor noise
            gamma = rng.uniform(0.7, 1.4)
            gain = rng.uniform(0.7, 1.25)
            img = 255.0 * (img / 255.0) ** gamma * gain
            img = img + rng.normal(0, 3.0, img.shape)
            img = np.clip(img, 0, 255).astype(np.uint8)
            f = ext(torch.as_tensor(img, device=device))
            all_desc.append(f.desc[f.valid].cpu().numpy().view(np.uint32))
        log(f"world {seed}: {sum(len(d) for d in all_desc)} descriptors "
            f"so far")
    return np.concatenate(all_desc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, default=24)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--out", default="vocab.npz")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    descs = harvest(a.worlds, a.frames, torch.device(a.device))
    print(f"training k={a.k} L={a.levels} on {len(descs)} descriptors",
          flush=True)
    voc = train_vocabulary(descs, k=a.k, levels=a.levels, seed=0,
                           device=a.device)
    save_vocabulary(voc, a.out)
    print(f"saved {voc.n_words}-word vocabulary -> {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
