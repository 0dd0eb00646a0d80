from .evaluate import EvalResult, evaluate
from .generate import make_coarse_sampler, make_refiner, unaugment
from .pipeline import gather_generated_results, generation_save_dir, run_generation

__all__ = [
    "EvalResult",
    "evaluate",
    "gather_generated_results",
    "generation_save_dir",
    "make_coarse_sampler",
    "make_refiner",
    "run_generation",
    "unaugment",
]
