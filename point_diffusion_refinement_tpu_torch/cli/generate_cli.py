"""Generation CLI: one process a device (several under ``torchrun``).

    python -m point_diffusion_refinement_tpu_torch.cli.generate_cli -c cfg.json \
        --phase test_trainset --num_trials 10 --augment_data_during_generation

Counterpart of the JAX package's ``cli/generate_cli.py``: the test set, or
(``--num_trials``) the augmented train-set generations the refinement net
trains on.  Runs on the GPU unless ``--device cpu`` is given;
``--fused_attention``, ``--fused_knn`` and ``--packed`` turn on the opt-in
inference routes (off by default).  Under ``torchrun`` each process generates
its rank's shard into ``rank_<i>`` and rank 0 merges them
(``parallel.mesh_from_environment``; gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse

from ..config.loader import load_config
from ..parallel.mesh import mesh_from_environment
from ..sample.pipeline import run_generation


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate coarse completions")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--phase", default="test", choices=["test", "test_trainset"])
    p.add_argument("--ckpt_iter", default="max")
    p.add_argument("--num_trials", type=int, default=1)
    p.add_argument("--fast_sampling", action="store_true")
    p.add_argument("--fast_sampling_length", type=int, default=50)
    p.add_argument("--fast_sampling_method", default="var", choices=["var", "step"])
    p.add_argument("--fast_sampling_schedule", default="quadratic",
                   choices=["linear", "quadratic"])
    p.add_argument("--fast_sampling_kappa", type=float, default=0.5)
    p.add_argument("--augment_data_during_generation", action="store_true")
    p.add_argument("--num_samples_tested", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--no_save", action="store_true")
    p.add_argument("--no_emd", action="store_true")
    # warm start: resume the reverse process from a precomputed x_{T_step}
    p.add_argument("--use_a_precomputed_XT", action="store_true")
    p.add_argument("--T_step", type=int, default=100)
    p.add_argument("--XT_folder", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--fused_attention", action="store_true")
    p.add_argument("--fused_knn", action="store_true")
    p.add_argument("--packed", action="store_true")
    args = p.parse_args(argv)

    fs_cfg = None
    if args.fast_sampling:
        fs_cfg = {
            "length": args.fast_sampling_length,
            "sampling_method": args.fast_sampling_method,
            "schedule": args.fast_sampling_schedule,
            "kappa": args.fast_sampling_kappa,
        }
    return run_generation(
        load_config(args.config),
        phase=args.phase,
        ckpt_iter=args.ckpt_iter,
        fast_sampling=args.fast_sampling,
        fast_sampling_config=fs_cfg,
        num_trials=args.num_trials,
        augment_data_during_generation=args.augment_data_during_generation,
        num_samples_tested=args.num_samples_tested,
        save_generated=not args.no_save,
        batch_size=args.batch_size,
        compute_emd=not args.no_emd,
        use_a_precomputed_XT=args.use_a_precomputed_XT,
        T_step=args.T_step,
        XT_folder=args.XT_folder,
        device=args.device,
        mesh=mesh_from_environment(args.device),
        fused_attention=args.fused_attention,
        fused_knn=args.fused_knn,
        packed=args.packed,
    )


if __name__ == "__main__":
    main()
