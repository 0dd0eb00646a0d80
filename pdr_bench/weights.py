"""Seeded weights, made on the device in a few large calls.

Both sides get the same tensors: the program's network and the frozen
reference share their parameter names (the Flax scope names), so one
state dict loads into either.  Each kind of leaf gets its usual scale at
initialisation, and the small random parts on biases and GroupNorm
affines make every parameter matter to the output:

- a Dense kernel (out, in): N(0, 1 / in);
- a Dense bias: N(0, 0.02^2);
- a norm's scale: 1 + N(0, 0.05^2), its bias N(0, 0.05^2);
- an embedding (n, f): N(0, 1 / f).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import inputs


def _scale_offset(name: str, shape: Tuple[int, ...], names) -> Tuple[float, float]:
    stem = name.rsplit(".", 1)[0] + "."
    if name.endswith(".scale"):
        return 0.05, 1.0
    if name.endswith(".bias") and stem + "scale" in names:
        return 0.05, 0.0
    if name.endswith("embedding"):
        return shape[-1] ** -0.5, 0.0
    if name.endswith(".weight") and len(shape) == 2:
        return shape[1] ** -0.5, 0.0
    if name.endswith(".bias"):
        return 0.02, 0.0
    raise ValueError(f"no initialisation rule for parameter {name} {tuple(shape)}")


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 parameters for ``shapes`` (name -> shape) drawn from ``seed``:
    one gaussian draw for all of them, scaled and offset leaf by leaf in two
    more calls; the results are views of one flat buffer."""
    names = list(shapes)
    numels = [int(torch.Size(shapes[n]).numel()) for n in names]
    rules = [_scale_offset(n, tuple(shapes[n]), shapes) for n in names]
    counts = torch.tensor(numels, device=device)
    scale = torch.repeat_interleave(torch.tensor([r[0] for r in rules], device=device), counts)
    offset = torch.repeat_interleave(torch.tensor([r[1] for r in rules], device=device), counts)
    g = inputs.generator(device, seed, 0x5eed)
    flat = torch.randn(sum(numels), generator=g, device=device).mul_(scale).add_(offset)
    out, at = {}, 0
    for n, k in zip(names, numels):
        out[n] = flat[at: at + k].view(shapes[n])
        at += k
    return out


def parameter_shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}
