"""Connected components as label propagation (frozen copy of the port's ``perception/cc.py``).

Pixels propagate the minimum flat index of their component across gated
4-neighbour edges, with one pointer-jumping pass (label <- label[label])
per sweep.  A component's id is the flat index of its first pixel in
row-major scan order.  The loop reads its ``changed`` flag from the device
once per sweep.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ._noop import scope

_GATES = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _shift(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[y, x] = a[y - dy, x - dx], vacated cells = ``fill``."""
    H, W = a.shape[:2]
    out = torch.full_like(a, fill)
    ys_o = slice(max(dy, 0), H + min(dy, 0))
    ys_i = slice(max(-dy, 0), H - max(dy, 0))
    xs_o = slice(max(dx, 0), W + min(dx, 0))
    xs_i = slice(max(-dx, 0), W - max(dx, 0))
    out[ys_o, xs_o] = a[ys_i, xs_i]
    return out


def connected_components(active: torch.Tensor,
                         edge_gate_fn: Optional[Callable] = None,
                         values: Optional[torch.Tensor] = None,
                         max_iters: int = 64) -> torch.Tensor:
    """[H, W] int32 labels of ``active`` pixels (-1 inactive).

    ``values``: edges only join equal values, or those ``edge_gate_fn(
    values, shifted_values)`` accepts when it is given.
    """
    H, W = active.shape
    dev = active.device
    flat = torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
    big = H * W
    label = torch.where(active, flat, big)

    gate_masks = []
    for dy, dx in _GATES:
        ok = active & _shift(active, dy, dx, False)
        if values is not None:
            nb_val = _shift(values, dy, dx, 0)
            if edge_gate_fn is not None:
                ok = ok & edge_gate_fn(values, nb_val)
            else:
                ok = ok & (values == nb_val)
        gate_masks.append(ok)

    pad = torch.full((H * W + 1,), big, dtype=torch.int32, device=dev)
    with scope("sync"):
        changed = bool(active.any())
    it = 0
    while changed and it < max_iters:
        new = label
        for (dy, dx), g in zip(_GATES, gate_masks):
            nb = _shift(label, dy, dx, big)
            new = torch.where(g, torch.minimum(new, nb), new)
        newf = new.reshape(-1)
        pad[:-1] = newf
        newf = torch.minimum(newf, pad[torch.clamp(newf, max=big).long()])
        new = newf.reshape(H, W)
        with scope("sync"):
            changed = bool((new != label).any())
        label = new
        it += 1
    return torch.where(active, label, -1)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """[H*W] int32 sizes in root-index space (0 where not a root)."""
    H, W = labels.shape
    flat = labels.reshape(-1)
    idx = torch.where(flat >= 0, flat, H * W).long()
    return torch.bincount(idx, minlength=H * W + 1)[:-1].to(torch.int32)


def component_centroids(labels: torch.Tensor):
    """Sum of (x, y) coords per root: ([H*W] sum_x, [H*W] sum_y)."""
    H, W = labels.shape
    dev = labels.device
    yy, xx = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    flat = labels.reshape(-1)
    idx = torch.where(flat >= 0, flat, H * W).long()
    z = torch.zeros(H * W + 1, dtype=torch.float32, device=dev)
    sx = z.index_add(0, idx, xx.reshape(-1).to(torch.float32))[:-1]
    sy = z.index_add(0, idx, yy.reshape(-1).to(torch.float32))[:-1]
    return sx, sy
