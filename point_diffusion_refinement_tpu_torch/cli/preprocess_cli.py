"""Mirror-and-concat preprocessing of MVP partial clouds.

    python -m point_diffusion_refinement_tpu_torch.cli.preprocess_cli --data_dir <mvp>

Counterpart of the JAX package's ``cli/preprocess_cli.py``: each split's
partials (then the novel ones) are reflected across the xy-plane, tagged
+-1 in a 4th channel and FPS-downsampled on the device
(``data/mirror.py``) to each target count, written to
``mirror_and_concated_partial/mvp_{split}_input_mirror_and_concat_{n}pts.h5``.
Needs ``h5py``; runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.mirror import generate_mirrored_partials


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser(description="Generate mirrored partial clouds")
    p.add_argument("--data_dir", required=True, help="MVP dataset directory")
    p.add_argument("--splits", nargs="+", default=["train", "test"])
    p.add_argument("--num_points", type=int, nargs="+", default=[2048, 3072])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    out_dir = os.path.join(args.data_dir, "mirror_and_concated_partial")
    os.makedirs(out_dir, exist_ok=True)
    for split in args.splits:
        with h5py.File(os.path.join(args.data_dir, f"mvp_{split}_input.h5"), "r") as f:
            partials = np.concatenate(
                [np.array(f["incomplete_pcds"]), np.array(f["novel_incomplete_pcds"])],
                axis=0).astype(np.float32)
        for n in args.num_points:
            mirrored = generate_mirrored_partials(partials, n, batch_size=args.batch_size,
                                                  device=args.device)
            out = os.path.join(out_dir, f"mvp_{split}_input_mirror_and_concat_{n}pts.h5")
            with h5py.File(out, "w") as f:
                f.create_dataset("data", data=mirrored)
            print(f"wrote {out} {mirrored.shape}")


if __name__ == "__main__":
    main()
