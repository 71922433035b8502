"""FID of a generated ``output.npz`` against a reference batch or statistics
(``deco_tpu/eval_fid.py``):

    python -m deco_tpu_torch.eval_fid samples.npz reference.npz \\
        [--inception w.pt] [--stats-out s.npz] [--batch-size 64] [--device cuda]

The reference is an image batch npz (``arr_0`` uint8 NHWC, the ADM
reference-batch layout) or a statistics npz with ``mu`` and ``sigma``
(pytorch-fid's), which ``--stats-out`` writes for the samples side: make it
once from the real data and reuse it. ``--inception`` is a torchvision or
pytorch-fid InceptionV3 state dict (``.pt``/``.pth``); without it the tower
is drawn from seed 0 and the score compares only with scores of that same
tower. Prints ``FID: x``; a score that is not finite exits with 1. The
default device is CUDA, which raises where there is no card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from deco_tpu_torch.models.inception import compute_fid_features, load_inception, random_inception
from deco_tpu_torch.train.metrics import FIDStats, frechet_distance, to_unit_range


def _first_array(z) -> np.ndarray:
    return z["arr_0"] if "arr_0" in z else z[list(z.keys())[0]]


def _stats_from_images(images: np.ndarray, tower, batch_size: int):
    feats = compute_fid_features(to_unit_range(images), tower, batch_size)
    stats = FIDStats(feats.shape[1])
    stats.update(feats)
    return stats.finalize()


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("samples", help="generated output.npz (arr_0 NHWC uint8)")
    ap.add_argument("reference", help="reference npz: an arr_0 image batch or mu/sigma stats")
    ap.add_argument("--inception", default=None,
                    help="InceptionV3 weights: a torchvision or pytorch-fid state dict")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--stats-out", default=None,
                    help="also write the samples' mu/sigma to this npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.inception:
        tower = load_inception(args.inception, device=args.device)
    else:
        tower = random_inception(seed=0, device=args.device)
    with np.load(args.samples) as z:
        mu_s, cov_s = _stats_from_images(_first_array(z), tower, args.batch_size)
    if args.stats_out:
        np.savez(args.stats_out, mu=mu_s, sigma=cov_s)
    with np.load(args.reference) as z:
        if "mu" in z and "sigma" in z:
            mu_r, cov_r = z["mu"], z["sigma"]
        else:
            mu_r, cov_r = _stats_from_images(_first_array(z), tower, args.batch_size)
    fid = frechet_distance(mu_s, cov_s, mu_r, cov_r)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    sys.exit(0 if np.isfinite(main()) else 1)
