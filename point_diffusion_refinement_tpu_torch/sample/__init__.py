from .generate import make_coarse_sampler, unaugment

__all__ = ["make_coarse_sampler", "unaugment"]
