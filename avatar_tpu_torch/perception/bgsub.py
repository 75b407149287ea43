"""Background subtraction stencil (counterpart of ``_foreground_mask`` in
``avatar_tpu/perception/bgsub.py``; the ``BGSubtractor`` class is not
ported yet).

A pixel is foreground iff no valid background pixel in its 3x3 window lies
within sqrt(nn_dist_thresh) of it in 3D; z == 0 is invalid (reference
BGSubtractor.cpp:30-80).
"""

from __future__ import annotations

import torch


def _foreground_mask(background: torch.Tensor, image: torch.Tensor,
                     nn_dist_thresh) -> torch.Tensor:
    """[H, W] bool foreground mask of XYZ ``image`` against
    ``background`` (both [H, W, 3])."""
    valid = image[..., 2] != 0.0
    bg_valid = background[..., 2] != 0.0
    min_d2 = torch.full(image.shape[:2], float("inf"), dtype=image.dtype,
                        device=image.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = torch.roll(background, (dy, dx), (0, 1))
            nb_valid = torch.roll(bg_valid, (dy, dx), (0, 1)).clone()
            # out-of-bounds neighbours are invalid
            if dy == 1:
                nb_valid[0, :] = False
            elif dy == -1:
                nb_valid[-1, :] = False
            if dx == 1:
                nb_valid[:, 0] = False
            elif dx == -1:
                nb_valid[:, -1] = False
            d = (nb - image) ** 2
            d2 = d[..., 0] + d[..., 1] + d[..., 2]
            min_d2 = torch.where(nb_valid, torch.minimum(min_d2, d2), min_d2)
    return valid & (min_d2 >= nn_dist_thresh)
