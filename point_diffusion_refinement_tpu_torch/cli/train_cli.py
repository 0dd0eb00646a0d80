"""Training CLI: one process a device.

    python -m point_diffusion_refinement_tpu_torch.cli.train_cli -c cfg.json
    torchrun --nproc_per_node 8 -m point_diffusion_refinement_tpu_torch.cli.train_cli -c cfg.json

Counterpart of the JAX package's ``cli/train_cli.py``.  Runs on the GPU
unless ``--device cpu`` is given; ``--fused_gather`` and ``--fused_sa`` turn
on the network's fused training routes (off by default).  Under ``torchrun``
each process trains data-parallel on its card (``parallel.mesh_from_environment``;
gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse

from ..config.loader import load_config
from ..parallel.mesh import mesh_from_environment
from ..train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser(description="Train PDR (DDPM or refinement)")
    p.add_argument("-c", "--config", required=True, help="JSON config path")
    p.add_argument("--max_steps", type=int, default=None,
                   help="truncate training (smoke runs)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--fused_gather", action="store_true",
                   help="radius groupings through the fused ball query + gather")
    p.add_argument("--fused_sa", action="store_true",
                   help="eligible set-abstraction levels through the fused ball group")
    args = p.parse_args(argv)
    result = train(load_config(args.config), max_steps=args.max_steps, device=args.device,
                   fused_gather=args.fused_gather, fused_sa=args.fused_sa,
                   mesh=mesh_from_environment(args.device))
    print(f"training finished at iteration {result['n_iter']}, "
          f"avg loss {result['final_loss']:.6f}")
    return result


if __name__ == "__main__":
    main()
