"""Forest, part-map and depth-frame codecs (numpy copies of ``ForestData``,
``read_srtr`` / ``write_srtr``, ``read_partmap`` / ``write_partmap`` and
the ``.depth`` codec from ``avatar_tpu/io/formats.py`` and
``avatar_tpu/native/rle.py``).

Copied, not imported: the port never imports the JAX package, and
``tests/test_torch_perception.py`` and ``tests/test_torch_train.py`` hold
these copies against the originals, byte for byte.  Formats: ``.srtr``
(reference RTree.cpp:2967-3120), ``.partmap`` (RTree.cpp:3465-3509) and
``.depth`` (Util.cpp:176-247).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np


def decode_depth_rle(data: bytes) -> np.ndarray:
    """Decode a ``.depth`` byte stream -> float32 [H, W].

    Layout (reference Util.cpp:176-209): uint16 rows, uint16 cols, then
    float32 values in row-major order where a negative value -n stands for
    a run of n zeros (runs may span rows) and the others are depths.
    """
    if len(data) < 4:
        raise ValueError("truncated .depth stream")
    rows, cols = struct.unpack_from("<HH", data, 0)
    n = rows * cols
    vals = np.frombuffer(data, dtype="<f4", offset=4)
    neg = vals < 0
    lengths = np.where(neg, (-vals).astype(np.int64), 1)
    pieces = np.where(neg, np.float32(0), vals)
    out_flat = np.repeat(pieces, lengths)
    out = np.zeros(n, dtype=np.float32)
    m = min(n, out_flat.shape[0])
    out[:m] = out_flat[:m]
    return out.reshape(rows, cols)


def encode_depth_rle(depth: np.ndarray) -> bytes:
    """Encode float32 [H, W] -> ``.depth`` byte stream.  A trailing zero
    run is not written, as in the reference (Util.cpp:219-247): the
    decoder zero-fills."""
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    rows, cols = depth.shape
    header = struct.pack("<HH", rows, cols)
    flat = depth.reshape(-1)
    nz = np.nonzero(flat)[0]
    if nz.shape[0] == 0:
        return header
    gaps = np.diff(np.concatenate([[-1], nz])) - 1   # zeros before each value
    has_gap = gaps > 0
    stream = np.empty(nz.shape[0] + int(has_gap.sum()), dtype=np.float32)
    pos = np.cumsum(has_gap.astype(np.int64)) + np.arange(nz.shape[0])
    stream[pos] = flat[nz]
    stream[pos[has_gap] - 1] = -gaps[has_gap].astype(np.float32)
    return header + stream.tobytes()


def read_depth_rle(path: str) -> np.ndarray:
    """Read a ``.depth`` RLE file -> float32 [H, W] depth image."""
    with open(path, "rb") as f:
        return decode_depth_rle(f.read())


def write_depth_rle(path: str, depth: np.ndarray) -> None:
    """Write a float32 [H, W] depth image as ``.depth`` RLE."""
    with open(path, "wb") as f:
        f.write(encode_depth_rle(depth))


def read_depth(path: str, allow_exr: bool = True) -> np.ndarray:
    """Read a depth frame (``.exr`` through OpenCV, else ``.depth`` RLE):
    float32 [H, W], or [H, W, C] for a multi-channel EXR (an XYZ map).
    Reference Util.cpp:176-209."""
    if allow_exr and path.endswith(".exr"):
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "OpenCV required to read EXR depth frames") from e
        m = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if m is None:
            raise FileNotFoundError(path)
        return np.asarray(m, dtype=np.float32)
    return read_depth_rle(path)


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

    # Legacy text format (reference RTree.cpp:3017-3047)
    toks = data.decode("utf-8", errors="replace").split()
    pos = 0

    def nxt():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    n_nodes, n_leafs, num_parts = int(nxt()), int(nxt()), int(nxt())
    u = np.zeros((n_nodes, 2), np.float32)
    v = np.zeros((n_nodes, 2), np.float32)
    thresh = np.zeros(n_nodes, np.float32)
    lnode = np.full(n_nodes, -1, np.int32)
    rnode = np.full(n_nodes, -1, np.int32)
    leafid = np.full(n_nodes, -1, np.int32)
    for i in range(n_nodes):
        leafid[i] = int(nxt())
        if leafid[i] < 0:
            lnode[i] = int(nxt())
            rnode[i] = int(nxt())
            thresh[i] = float(nxt())
            u[i, 0] = float(nxt())
            u[i, 1] = float(nxt())
            v[i, 0] = float(nxt())
            v[i, 1] = float(nxt())
    leaf_data = np.zeros((n_leafs, num_parts), np.float32)
    for i in range(n_leafs):
        for j in range(num_parts):
            leaf_data[i, j] = float(nxt())
    return ForestData(u, v, thresh, lnode, rnode, leafid, leaf_data, num_parts)


def write_srtr(path: str, forest: ForestData) -> None:
    """Write the binary 'R' format (reference RTree.cpp:3063-3094)."""
    out = bytearray()
    out += b"R"
    n_leafs = int((forest.leafid >= 0).sum())
    out += struct.pack("<II", forest.num_nodes, n_leafs)
    out += struct.pack("<i", forest.num_parts)
    for i in range(forest.num_nodes):
        if forest.leafid[i] >= 0:
            out += struct.pack("<B", 255)
            dist = forest.leaf_data[forest.leafid[i]]
            nz = np.nonzero(dist)[0]
            out += struct.pack("<B", len(nz))
            for k in nz:
                out += struct.pack("<Bf", int(k), float(dist[k]))
        else:
            out += struct.pack("<B", 0)
            out += struct.pack(
                "<iif", int(forest.lnode[i]), int(forest.rnode[i]),
                float(forest.thresh[i]))
            out += struct.pack("<ff", float(forest.u[i, 0]),
                               float(forest.u[i, 1]))
            out += struct.pack("<ff", float(forest.v[i, 0]),
                               float(forest.v[i, 1]))
    out += b"T"
    with open(path, "wb") as f:
        f.write(bytes(out))


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


def write_partmap(path: str, pm_type: int, src_names: List[str],
                  dest_names: List[str], mapping: Dict[str, str]) -> None:
    with open(path, "w") as f:
        f.write("partmap %s\n" % ("contiguous" if pm_type == 0 else "disjoint"))
        f.write("src %d\n%s\n" % (len(src_names), " ".join(src_names)))
        f.write("dest %d\n%s\n" % (len(dest_names), " ".join(dest_names)))
        for s in src_names:
            f.write(f"{s} {mapping[s]}\n")
