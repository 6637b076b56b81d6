"""Multiple-instance-learning bag logits, the paper's core contribution
(counterpart of ``wssdl_bus_tpu/mil/__init__.py``; the reference's
``lib/mil/core.py``).

Each weak image is a bag: a fixed [P] block of instance (ROI) logits and a
validity mask.  A selector reduces the bag to one [C] logit row; columns
follow the 3-class background/benign/malignant layout:

  * ``mal_max``  - the instance with the largest malignant logit;
  * ``ben_max``  - the instance with the largest benign logit;
  * ``mass_max`` - the instance with the SMALLEST background logit;
  * ``disc_max`` - the instance with the largest non-background logit;
  * ``mean_ben`` - [0, mean benign logit over valid instances, 0].

Argmax and argmin take the first index among equals, as ``jnp.argmax``
does.  ``get_bag_logits`` applies ``selector_pair[0]`` to bags labelled
benign (1) and ``selector_pair[1]`` to the others.  The gradient reaches
only the selected instance's row.
"""

from __future__ import annotations

import torch

_NEG = -1e30
_POS = 1e30


def _rows(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, P, C] x [B] -> [B, C]: each bag's row ``idx``."""
    return logits.gather(1, idx[:, None, None].expand(-1, 1,
                                                      logits.shape[-1]))[:, 0]


def _argmax_row(logits, score, valid):
    masked = torch.where(valid, score, torch.full_like(score, _NEG))
    return _rows(logits, masked.argmax(dim=1))


def mal_max(logits, valid):
    return _argmax_row(logits, logits[..., 2], valid)


def ben_max(logits, valid):
    return _argmax_row(logits, logits[..., 1], valid)


def mass_max(logits, valid):
    masked = torch.where(valid, logits[..., 0],
                         torch.full_like(logits[..., 0], _POS))
    return _rows(logits, masked.argmin(dim=1))


def disc_max(logits, valid):
    return _argmax_row(logits, logits[..., 1:].amax(dim=-1), valid)


def mean_ben(logits, valid):
    cnt = valid.sum(dim=1).clamp_min(1).to(logits.dtype)
    m = torch.where(valid, logits[..., 1],
                    torch.zeros_like(logits[..., 1])).sum(dim=1) / cnt
    z = torch.zeros_like(m)
    return torch.stack([z, m, z], dim=-1)


SELECTORS = {
    "mal_max": mal_max,
    "ben_max": ben_max,
    "mass_max": mass_max,
    "disc_max": disc_max,
    "mean_ben": mean_ben,
}


def get_bag_logits(instance_logits: torch.Tensor, valid: torch.Tensor,
                   bag_labels: torch.Tensor,
                   selector_pair=("mal_max", "mal_max")) -> torch.Tensor:
    """instance_logits [B, P, C], valid [B, P] bool, bag_labels [B] int
    (1 = benign, 2 = malignant) -> per-bag logits [B, C]."""
    f0 = SELECTORS[selector_pair[0]](instance_logits, valid)
    if selector_pair[1] == selector_pair[0]:
        return f0
    f1 = SELECTORS[selector_pair[1]](instance_logits, valid)
    return torch.where((bag_labels == 1)[:, None], f0, f1)
