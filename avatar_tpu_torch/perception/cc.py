"""Connected components as label propagation (counterpart of
``avatar_tpu/perception/cc.py``).

Pixels propagate the minimum flat index of their component across gated
4-neighbour edges, with one pointer-jumping pass (label <- label[label])
per sweep.  A component's id is the flat index of its first pixel in
row-major scan order.  CUDA tensors are labelled by one hand-written
kernel (``cc_kernel.label``), which runs the same sweeps with no host read
and whose labels equal the loop's to the bit; CPU tensors by
``connected_components_plain``, which reads its ``changed`` flag from the
device once per sweep.  ``component_sizes`` is an integer scatter on the
card and a ``bincount`` on the CPU, whose reads of its input's least and
largest value are counted (``profiling.host_sync``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from avatar_tpu_torch.perception import cc_kernel
from avatar_tpu_torch.profiling import host_sync, scope

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


class Dist2Gate:
    """The background subtractors' edge gate: neighbours join when the
    squared 3-D distance of their XYZ values is at most ``thresh``.  As a
    callable it is the plain loop's gate; on the card the kernel computes it
    itself and reads ``thresh`` (a one-element float32 tensor) there."""

    __slots__ = ("thresh",)

    def __init__(self, thresh):
        self.thresh = thresh

    def __call__(self, vals: torch.Tensor, shifted: torch.Tensor
                 ) -> torch.Tensor:
        d = (vals - shifted) ** 2
        return d[..., 0] + d[..., 1] + d[..., 2] <= self.thresh


def connected_components(active: torch.Tensor,
                         edge_gate_fn: Optional[Callable] = None,
                         values: Optional[torch.Tensor] = None,
                         max_iters: int = 64) -> torch.Tensor:
    """[H, W] int32 labels of ``active`` pixels (-1 inactive).

    ``values``: edges only join equal values, or those ``edge_gate_fn(
    values, shifted_values)`` accepts when it is given.  On the card the
    kernel takes no gate but a ``Dist2Gate`` (or none, with uint8 or no
    values) and raises on others; the CPU takes any.
    """
    if active.device.type == "cpu":
        return connected_components_plain(active, edge_gate_fn, values,
                                          max_iters)
    return cc_kernel.label(active, values, _kernel_thresh(edge_gate_fn),
                           max_iters)


def _kernel_thresh(edge_gate_fn: Optional[Callable]):
    """The threshold the kernel reads for ``edge_gate_fn`` (None: the
    equality gate)."""
    if edge_gate_fn is None:
        return None
    if isinstance(edge_gate_fn, Dist2Gate):
        return edge_gate_fn.thresh
    raise ValueError(f"the kernel computes its edge gate itself: want None "
                     f"or a Dist2Gate, got {edge_gate_fn!r}")


def connected_components_plain(active: torch.Tensor,
                               edge_gate_fn: Optional[Callable] = None,
                               values: Optional[torch.Tensor] = None,
                               max_iters: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``connected_components`` on any device:
    the sweep loop, eager, reading its ``changed`` flag once per sweep."""
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
    with scope("sync"), host_sync():
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
        with scope("sync"), host_sync():
            changed = bool((new != label).any())
        label = new
        it += 1
    return torch.where(active, label, -1)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """[H*W] int32 sizes in root-index space (0 where not a root)."""
    H, W = labels.shape
    flat = labels.reshape(-1)
    idx = torch.where(flat >= 0, flat, H * W).long()
    if labels.device.type == "cuda":
        # an integer scatter: exact in any order, and no read of the card
        ones = torch.ones_like(flat)
        return torch.zeros(H * W + 1, dtype=torch.int32,
                           device=labels.device).index_add_(0, idx, ones)[:-1]
    with host_sync(2):
        sizes = torch.bincount(idx, minlength=H * W + 1)
    return sizes[:-1].to(torch.int32)


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
