"""Training-time seeds.

The counterpart of the JAX package's ``utils/rng.py``: parameter init
draws from an explicit ``torch.Generator`` (``models.networks.init_params``),
and the training stream, which only feeds dropout, is a per-run base seed
from which every (phase, epoch) draws its own dropout seed. A seed is an
int below 2³¹: the FFN kernels hash it into their masks, and the LSTM's and
moment net's dropout draw from a ``torch.Generator`` seeded with it. The
masks are not the JAX package's (a TPU PRNG there); they are reproducible
from the seed alone, on any device.
"""

from __future__ import annotations

from typing import List

import torch

N_PHASES = 3


def train_base_generator(seed: int) -> torch.Generator:
    """The base training generator of a run (the counterpart of
    ``train_base_key``)."""
    return torch.Generator().manual_seed(int(seed))


def phase_epoch_seeds(seed: int, num_epochs: List[int]) -> List[List[int]]:
    """Per-phase lists of per-epoch dropout seeds: the base generator draws
    one seed per phase (the counterpart of ``jax.random.split(rng, 3)``),
    and each phase's generator draws one seed per epoch (``fold_in``)."""
    base = train_base_generator(seed)
    phase_seeds = torch.randint(0, 2 ** 31 - 1, (N_PHASES,), generator=base)
    out = []
    for ps, n in zip(phase_seeds.tolist(), num_epochs):
        g = torch.Generator().manual_seed(ps)
        out.append(torch.randint(0, 2 ** 31 - 1, (n,), generator=g).tolist())
    return out
