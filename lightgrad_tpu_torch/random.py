"""Random state of the lightgrad tape's initializers and stochastic ops.

Counterpart of ``lightgrad_tpu/random.py``: one ``torch.Generator`` per
device takes the place of the JAX package's global PRNG key.
``CudaTensor.uniform`` (and so ``xavier`` and every layer's initializer),
``dropout``, ``randn_like`` and ``randint_like`` draw from the generator of
the device they run on.  The two packages give different numbers from one
seed: tests carry weights across as numpy arrays.
"""

import torch

__all__ = ["seed", "generator"]

_seed = 0
_generators = {}


def seed(n: int) -> None:
    """(Re)seed every device's generator."""
    global _seed
    _seed = int(n)
    _generators.clear()


def generator(device) -> torch.Generator:
    """The generator of ``device``, made from the seed at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _generators.get(device)
    if g is None:
        g = _generators[device] = torch.Generator(device=device)
        g.manual_seed(_seed)
    return g
