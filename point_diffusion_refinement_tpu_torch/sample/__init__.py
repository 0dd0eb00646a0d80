from .evaluate import EvalResult, evaluate
from .generate import make_coarse_sampler, make_refiner, unaugment

__all__ = ["EvalResult", "evaluate", "make_coarse_sampler", "make_refiner", "unaugment"]
