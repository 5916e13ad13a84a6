"""Precompute FID reference statistics of an image directory (counterpart
of ``uspace_tpu/cli/fid_stats.py``; reference ``tools/fid_score.py:
228-236`` save_statistics_of_path): pool3 activations of every image, their
mean and covariance saved as pytorch-fid's ``{mu, sigma}`` ``.npz``.

    python -m uspace_tpu_torch.cli.fid_stats --images <dir> \\
        --out assets/fid_stats/fid_stats_cm256.npz \\
        --inception assets/fid/pt_inception-2015-12-05.pth
    python -m uspace_tpu_torch.cli.fid_stats --images <dir> --out s.npz \\
        --inception random --device cpu
"""

from __future__ import annotations

import argparse

from ..evals.fid import InceptionFeaturizer, save_statistics_of_path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--images", required=True, help="image directory")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--inception", default=None,
                    help="pytorch-fid Inception weights (default "
                    "assets/fid/pt_inception-2015-12-05.pth; 'random': "
                    "seeded weights)")
    ap.add_argument("--batch_size", type=int, default=50)
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    feat = InceptionFeaturizer(a.inception, a.device)
    save_statistics_of_path(a.images, a.out, feat, a.batch_size)
    print(f"stats -> {a.out}", flush=True)


if __name__ == "__main__":
    main()
