"""Forest, part-map, depth-frame and trainer-checkpoint codecs (numpy
copies of ``avatar_tpu/io/formats.py``; the ``.depth`` codec is
``native.rle``'s, as in the reference).

Copied, not imported: the port never imports the JAX package, and
``tests/test_torch_perception.py``, ``tests/test_torch_train.py`` and
``tests/test_torch_formats.py`` hold these copies against the originals,
byte for byte.  Formats: ``.srtr`` (reference RTree.cpp:2967-3120),
``.partmap`` (RTree.cpp:3465-3509), ``.depth`` (Util.cpp:176-247) and the
RTREE_V2 / RTREE_V3 trainer checkpoints (RTree.cpp:1964-2130, 2649-2779).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from avatar_tpu_torch.native import rle as _rle


# the .depth codec lives in native.rle (C++ when built, else numpy)
decode_depth_rle = _rle.decode
encode_depth_rle = _rle.encode


def read_depth_rle(path: str) -> np.ndarray:
    """Read a ``.depth`` RLE file -> float32 [H, W] depth image."""
    with open(path, "rb") as f:
        return _rle.decode(f.read())


def write_depth_rle(path: str, depth: np.ndarray) -> None:
    """Write a float32 [H, W] depth image as ``.depth`` RLE."""
    with open(path, "wb") as f:
        f.write(_rle.encode(depth))


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


def read_xyz(path: str, intrin, allow_exr: bool = True) -> np.ndarray:
    """Read a depth frame and convert to an XYZ map if single-channel.

    Reference Util.cpp:211-217 (readXYZ).
    """
    m = read_depth(path, allow_exr)
    if m.ndim == 2:
        return intrin.depth_to_xyz_np(m)
    return m


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


# ---------------------------------------------------------------------------
# Reference trainer checkpoint files (RTREE_V2 / RTREE_V3)
# ---------------------------------------------------------------------------
#
# Byte-compatible codecs for the reference's resumable trainer state so a
# reference training run can be inspected, converted to an .srtr, or handed
# back to the reference (writer provided for V3, the production format).
# Layouts from RTree.cpp: V3 writeSamples/readSamples (2649-2779), V2
# (1964-2130); data sources AvatarDataSource.serialize (502-540) and
# FileDataSource.serialize (392-420).  All fields little-endian;
# size_t = u64, int = i32, pix = 2x i16, V3 sample label = u8.


class RTreeV3State:
    """Parsed RTREE_V3 checkpoint (mid-training V3 trainer state)."""

    def __init__(self, num_parts, source, nodes, node_interval, leaf_data,
                 sample_index, sample_pix, sample_label):
        self.num_parts = num_parts
        self.source = source          # dict: see _read_data_source
        self.nodes = nodes            # ForestData (leaf_data attached)
        self.node_interval = node_interval  # [N, 2] u64 sample ranges
        self.leaf_data = leaf_data
        self.sample_index = sample_index    # [S] i32 image ids
        self.sample_pix = sample_pix        # [S, 2] i16 (x, y)
        self.sample_label = sample_label    # [S] u8 part labels


def _read_data_source(f) -> dict:
    marker = f.read(8)
    if marker == b"SRC_FILE":
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        depth_dir = f.read(n).decode()
        n2 = int(np.frombuffer(f.read(8), "<u8")[0])
        # NOTE: the reference writes depthDir for BOTH fields
        # (RTree.cpp:395-397, a bug we must reproduce to stay in sync)
        mask_dir = f.read(n2).decode()
        return dict(kind="file", depth_dir=depth_dir, mask_dir=mask_dir)
    marker += f.read(2)
    if marker != b"SRC_AVATAR":
        raise ValueError(f"unknown data source marker {marker!r}")
    sz = int(np.frombuffer(f.read(8), "<u8")[0])
    if sz == 0xFFFFFFFFFFFFFFFF:  # new format: xorKey present
        xor_key = int(np.frombuffer(f.read(4), "<u4")[0])
        sz = int(np.frombuffer(f.read(8), "<u8")[0])
    else:
        xor_key = 0
    seq = np.frombuffer(f.read(4 * sz), "<i4").copy()
    return dict(kind="avatar", xor_key=xor_key, seq=seq)


def _write_data_source(f, src: dict) -> None:
    if src["kind"] == "file":
        f.write(b"SRC_FILE")
        d = src["depth_dir"].encode()
        f.write(np.uint64(len(d)).tobytes())
        f.write(d)
        m = src["mask_dir"].encode()
        f.write(np.uint64(len(m)).tobytes())
        # reproduce the reference's bug of writing depthDir twice, padded /
        # truncated to the recorded mask length so the stream stays aligned
        f.write((d + b"\0" * len(m))[: len(m)])
        return
    f.write(b"SRC_AVATAR")
    f.write(np.uint64(0xFFFFFFFFFFFFFFFF).tobytes())
    f.write(np.uint32(src.get("xor_key", 0)).tobytes())
    seq = np.asarray(src.get("seq", []), "<i4")
    f.write(np.uint64(len(seq)).tobytes())
    f.write(seq.tobytes())


def _read_node_block(f, n: int):
    raw = np.frombuffer(f.read(32 * n), np.uint8).reshape(n, 32)
    fl = raw[:, :20].copy().view("<f4").reshape(n, 5)
    ints = raw[:, 20:].copy().view("<i4").reshape(n, 3)
    return (fl[:, 0:2].copy(), fl[:, 2:4].copy(), fl[:, 4].copy(),
            ints[:, 0].copy(), ints[:, 1].copy(), ints[:, 2].copy())


def _write_node_block(f, fd: ForestData) -> None:
    n = fd.num_nodes
    raw = np.zeros((n, 32), np.uint8)
    fl = np.concatenate([np.asarray(fd.u, "<f4").reshape(n, 2),
                         np.asarray(fd.v, "<f4").reshape(n, 2),
                         np.asarray(fd.thresh, "<f4").reshape(n, 1)], axis=1)
    raw[:, :20] = fl.view(np.uint8).reshape(n, 20)
    ints = np.stack([np.asarray(fd.lnode, "<i4"), np.asarray(fd.rnode, "<i4"),
                     np.asarray(fd.leafid, "<i4")], axis=1)
    raw[:, 20:] = ints.view(np.uint8).reshape(n, 12)
    f.write(raw.tobytes())


def read_rtree_v3(path: str) -> RTreeV3State:
    """Read a reference RTREE_V3 trainer checkpoint (RTree.cpp:2704-2779)."""
    with open(path, "rb") as f:
        if f.read(9) != b"RTREE_V3 ":
            raise ValueError(f"{path}: not an RTREE_V3 checkpoint")
        num_parts = int(np.frombuffer(f.read(4), "<i4")[0])
        source = _read_data_source(f)
        if f.read(2) != b"N\n":
            raise ValueError(f"{path}: corrupted N section")
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        u, v, thresh, lnode, rnode, leafid = _read_node_block(f, n)
        node_interval = np.frombuffer(f.read(16 * n), "<u8").reshape(
            n, 2).copy()
        nleaf = int(np.frombuffer(f.read(8), "<u8")[0])
        leaf_data = np.frombuffer(f.read(4 * nleaf * num_parts),
                                  "<f4").reshape(nleaf, num_parts).copy()
        if f.read(2) != b"S\n":
            raise ValueError(f"{path}: corrupted S section")
        ns = int(np.frombuffer(f.read(8), "<u8")[0])
        raw = np.frombuffer(f.read(9 * ns), np.uint8).reshape(ns, 9)
        sample_index = raw[:, 0:4].copy().view("<i4").reshape(ns)
        sample_label = raw[:, 4].copy()
        sample_pix = raw[:, 5:9].copy().view("<i2").reshape(ns, 2)
        if f.read(2) != b"E\n":
            raise ValueError(f"{path}: end marker not found")
    fd = ForestData(u, v, thresh, lnode, rnode, leafid, leaf_data, num_parts)
    return RTreeV3State(num_parts, source, fd, node_interval, leaf_data,
                        sample_index, sample_pix, sample_label)


def write_rtree_v3(path: str, state: RTreeV3State) -> None:
    """Write an RTREE_V3 checkpoint the reference trainer can resume
    (atomic .partial + rename, like RTree.cpp:2649-2702)."""
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(b"RTREE_V3 ")
        f.write(np.int32(state.num_parts).tobytes())
        _write_data_source(f, state.source)
        f.write(b"N\n")
        n = state.nodes.num_nodes
        f.write(np.uint64(n).tobytes())
        _write_node_block(f, state.nodes)
        f.write(np.asarray(state.node_interval, "<u8").tobytes())
        f.write(np.uint64(len(state.leaf_data)).tobytes())
        f.write(np.asarray(state.leaf_data, "<f4").tobytes())
        f.write(b"S\n")
        ns = len(state.sample_index)
        f.write(np.uint64(ns).tobytes())
        raw = np.zeros((ns, 9), np.uint8)
        raw[:, 0:4] = np.asarray(state.sample_index, "<i4").view(
            np.uint8).reshape(ns, 4)
        raw[:, 4] = np.asarray(state.sample_label, np.uint8)
        raw[:, 5:9] = np.asarray(state.sample_pix, "<i2").view(
            np.uint8).reshape(ns, 4)
        f.write(raw.tobytes())
        f.write(b"E\n")
    os.replace(tmp, path)


class RTreeV2State:
    """Parsed RTREE_V2 checkpoint (breadth-first V2 trainer state)."""

    def __init__(self, num_parts, source, need_init, depth, curr_start_node,
                 sparse, assigned_node, nodes, leaf_data,
                 sample_index, sample_pix):
        self.num_parts = num_parts
        self.source = source
        self.need_init = need_init
        self.depth = depth
        self.curr_start_node = curr_start_node
        self.sparse = sparse              # list of u64 arrays
        self.assigned_node = assigned_node  # [S] i32
        self.nodes = nodes                # ForestData
        self.leaf_data = leaf_data
        self.sample_index = sample_index
        self.sample_pix = sample_pix


def read_rtree_v2(path: str) -> RTreeV2State:
    """Read a reference RTREE_V2 trainer checkpoint (RTree.cpp:2025-2130)."""
    with open(path, "rb") as f:
        if f.read(9) != b"RTREE_V2 ":
            raise ValueError(f"{path}: not an RTREE_V2 checkpoint")
        num_parts = int(np.frombuffer(f.read(4), "<i4")[0])
        source = _read_data_source(f)
        need_init = bool(f.read(1)[0])
        depth = int(np.frombuffer(f.read(4), "<i4")[0])
        curr_start = int(np.frombuffer(f.read(4), "<i4")[0])
        nsp = int(np.frombuffer(f.read(8), "<u8")[0])
        sparse = []
        for _ in range(nsp):
            m = int(np.frombuffer(f.read(8), "<u8")[0])
            sparse.append(np.frombuffer(f.read(8 * m), "<u8").copy())
        na = int(np.frombuffer(f.read(8), "<u8")[0])
        assigned = np.frombuffer(f.read(4 * na), "<i4").copy()
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        u, v, thresh, lnode, rnode, leafid = _read_node_block(f, n)
        nleaf = int(np.frombuffer(f.read(8), "<u8")[0])
        leaf_data = np.frombuffer(f.read(4 * nleaf * num_parts),
                                  "<f4").reshape(nleaf, num_parts).copy()
        if f.read(2) != b"S\n":
            raise ValueError(f"{path}: corrupted S section")
        ns_total = int(np.frombuffer(f.read(8), "<u8")[0])
        idxs, pixs = [], []
        read_total = 0
        while read_total < ns_total:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            img_index, img_samps = np.frombuffer(hdr, "<i4")
            if img_samps < 0:
                break
            pix = np.frombuffer(f.read(4 * img_samps), "<i2").reshape(
                img_samps, 2).copy()
            idxs.append(np.full(img_samps, img_index, np.int32))
            pixs.append(pix)
            read_total += int(img_samps)
        sample_index = (np.concatenate(idxs) if idxs
                        else np.zeros(0, np.int32))
        sample_pix = (np.concatenate(pixs) if pixs
                      else np.zeros((0, 2), np.int16))
    fd = ForestData(u, v, thresh, lnode, rnode, leafid, leaf_data, num_parts)
    return RTreeV2State(num_parts, source, need_init, depth, curr_start,
                        sparse, assigned, fd, leaf_data, sample_index,
                        sample_pix)


def write_rtree_v2(path: str, state: RTreeV2State) -> None:
    """Write an RTREE_V2 checkpoint the reference V2 trainer can resume
    (layout from RTree::TrainerV2 saveState, RTree.cpp:1964-2024; atomic
    .partial + rename).  The sample section groups pixels by image:
    ``(img_index i32, n i32, n x (x i16, y i16))`` runs, terminated by the
    total count written up front."""
    tmp = path + ".partial"
    with open(tmp, "wb") as f:
        f.write(b"RTREE_V2 ")
        f.write(np.int32(state.num_parts).tobytes())
        _write_data_source(f, state.source)
        f.write(bytes([1 if state.need_init else 0]))
        f.write(np.int32(state.depth).tobytes())
        f.write(np.int32(state.curr_start_node).tobytes())
        f.write(np.uint64(len(state.sparse)).tobytes())
        for arr in state.sparse:
            a = np.asarray(arr, "<u8")
            f.write(np.uint64(len(a)).tobytes())
            f.write(a.tobytes())
        assigned = np.asarray(state.assigned_node, "<i4")
        f.write(np.uint64(len(assigned)).tobytes())
        f.write(assigned.tobytes())
        fd = state.nodes
        f.write(np.uint64(fd.num_nodes).tobytes())
        _write_node_block(f, fd)
        leaf = np.asarray(state.leaf_data, "<f4").reshape(
            -1, state.num_parts)
        f.write(np.uint64(len(leaf)).tobytes())
        f.write(leaf.tobytes())
        f.write(b"S\n")
        idx = np.asarray(state.sample_index, np.int32)
        pix = np.asarray(state.sample_pix, "<i2").reshape(-1, 2)
        f.write(np.uint64(len(idx)).tobytes())
        # group consecutive runs of the same image id (the reference's
        # per-image sample lists)
        start = 0
        while start < len(idx):
            end = start
            while end < len(idx) and idx[end] == idx[start]:
                end += 1
            f.write(np.int32(idx[start]).tobytes())
            f.write(np.int32(end - start).tobytes())
            f.write(pix[start:end].tobytes())
            start = end
    os.replace(tmp, path)


def trainer_checkpoint_to_forest(state) -> ForestData:
    """Convert a (possibly mid-training) V2/V3 checkpoint into a usable
    forest: frontier nodes that have neither children nor a leaf id get
    uniform leaf distributions so the tree remains walkable."""
    fd = state.nodes
    leafid = np.asarray(fd.leafid, np.int32).copy()
    leaf_data = np.asarray(state.leaf_data, np.float32)
    if leaf_data.size == 0:
        leaf_data = leaf_data.reshape(0, state.num_parts)
    extra = []
    next_leaf = len(leaf_data)
    for i in range(fd.num_nodes):
        if leafid[i] < 0 and fd.lnode[i] < 0 and fd.rnode[i] < 0:
            extra.append(np.full(state.num_parts, 1.0 / state.num_parts,
                                 np.float32))
            leafid[i] = next_leaf
            next_leaf += 1
    if extra:
        leaf_data = np.concatenate([leaf_data, np.stack(extra)])
    return ForestData(fd.u, fd.v, fd.thresh, fd.lnode, fd.rnode, leafid,
                      leaf_data, state.num_parts)
