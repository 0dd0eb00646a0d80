from .mirror import generate_mirrored_partials, mirror_and_concat

__all__ = ["generate_mirrored_partials", "mirror_and_concat"]
