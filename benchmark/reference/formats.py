"""The forest and part-map readers of the port's ``io/formats.py``,
frozen: ``.srtr`` (binary 'R' format) and ``.partmap``."""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np


class ForestData:
    """Raw loaded decision-tree data: flat node arrays + leaf distributions.

    nodes are stored structure-of-arrays for direct use by the vectorized
    TPU tree-walk: u [N,2], v [N,2], thresh [N], lnode [N], rnode [N],
    leafid [N] (-1 for internal nodes); leaf_data [L, num_parts].
    """

    def __init__(self, u, v, thresh, lnode, rnode, leafid, leaf_data, num_parts):
        self.u = u
        self.v = v
        self.thresh = thresh
        self.lnode = lnode
        self.rnode = rnode
        self.leafid = leafid
        self.leaf_data = leaf_data
        self.num_parts = num_parts

    @property
    def num_nodes(self):
        return len(self.thresh)


def read_srtr(path: str) -> ForestData:
    """Load a ``.srtr`` forest file (binary 'R' format or legacy text).

    Binary layout (reference RTree.cpp:2967-3015): 'R', u32 nNodes,
    u32 nLeafs, i32 numParts; then per node u8 isLeaf; if leaf: u8 cnt then
    cnt x (u8 part, f32 prob); else i32 lnode, i32 rnode, f32 thresh,
    f32 u[2], f32 v[2].  Terminated by 'T'.
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(f"empty srtr file {path}")
    if data[0:1] == b"R":
        off = 1
        n_nodes, n_leafs = struct.unpack_from("<II", data, off)
        off += 8
        (num_parts,) = struct.unpack_from("<i", data, off)
        off += 4
        u = np.zeros((n_nodes, 2), np.float32)
        v = np.zeros((n_nodes, 2), np.float32)
        thresh = np.zeros(n_nodes, np.float32)
        lnode = np.full(n_nodes, -1, np.int32)
        rnode = np.full(n_nodes, -1, np.int32)
        leafid = np.full(n_nodes, -1, np.int32)
        leaf_data = np.zeros((n_leafs, num_parts), np.float32)
        leaf_i = 0
        for i in range(n_nodes):
            is_leaf = data[off]
            off += 1
            if is_leaf:
                cnt = data[off]
                off += 1
                if cnt > num_parts:
                    raise ValueError("corrupt srtr: leaf part count too large")
                for _ in range(cnt):
                    k = data[off]
                    off += 1
                    (val,) = struct.unpack_from("<f", data, off)
                    off += 4
                    leaf_data[leaf_i, k] = val
                leafid[i] = leaf_i
                leaf_i += 1
            else:
                lnode[i], rnode[i], thresh[i] = struct.unpack_from("<iif", data, off)
                off += 12
                u[i] = struct.unpack_from("<ff", data, off)
                off += 8
                v[i] = struct.unpack_from("<ff", data, off)
                off += 8
        if data[off:off + 1] != b"T":
            raise ValueError("corrupt srtr: missing 'T' end marker")
        return ForestData(u, v, thresh, lnode, rnode, leafid, leaf_data, num_parts)
    raise ValueError(f"{path}: not a binary 'R' forest")


PARTMAP_CONTIGUOUS = 0
PARTMAP_DISJOINT = 1


def read_partmap(path_or_text) -> Tuple[List[int], int, int]:
    """Parse a ``.partmap`` file.

    Returns (part_map, num_new_parts, partmap_type) where part_map[i] is the
    destination part for source part i, and partmap_type is 0 for
    'contiguous', 1 for 'disjoint'.  Reference RTree.cpp:3465-3509.
    """
    if os.path.exists(str(path_or_text)):
        with open(path_or_text, "r") as f:
            toks = f.read().split()
    else:
        toks = str(path_or_text).split()
    pos = 0

    def nxt():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    if nxt() != "partmap":
        raise ValueError("invalid partmap: missing 'partmap' marker")
    kind = nxt()
    if kind == "disjoint":
        pm_type = PARTMAP_DISJOINT
    elif kind == "contiguous":
        pm_type = PARTMAP_CONTIGUOUS
    else:
        raise ValueError(f"invalid partmap type {kind!r}")
    if nxt() != "src":
        raise ValueError("invalid partmap: missing 'src'")
    n_old = int(nxt())
    old_enum = {nxt(): i for i in range(n_old)}
    if nxt() != "dest":
        raise ValueError("invalid partmap: missing 'dest'")
    n_new = int(nxt())
    new_enum = {nxt(): i for i in range(n_new)}
    result = [0] * n_old
    for _ in range(n_old):
        if pos + 1 >= len(toks) + 1 and pos >= len(toks):
            break
        old_name = nxt()
        new_name = nxt()
        result[old_enum[old_name]] = new_enum[new_name]
    return result, n_new, pm_type
