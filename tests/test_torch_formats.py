"""The port's host-only copies against their originals in the JAX package:
the RTREE_V2 / RTREE_V3 trainer-checkpoint codecs, ``read_xyz``,
``RTree.load_trainer_checkpoint``, the legacy text model format,
``GaussianMixture.save``, the palette, ``shaped_dtype`` and the synthetic
pose bank and model directory.

Tolerances: bytes and integers equal; floats exact where both sides are
numpy.  The synthetic pose bank's quaternions go through each package's
own float32 ``so3_exp`` / ``mat_to_quat`` (torch and XLA): 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from avatar_tpu.core import lbs as jlbs
from avatar_tpu.core.model import AvatarModel as JModel
from avatar_tpu.core.pose_prior import GaussianMixture as JGmm
from avatar_tpu.core.sequence import AvatarPoseSequence as JSequence
from avatar_tpu.io import formats as jformats
from avatar_tpu.io.calibration import CameraIntrin as JIntrin
from avatar_tpu.perception.rtree import RTree as JRTree
from avatar_tpu import testing as jtesting
from avatar_tpu import utils as jutils
from avatar_tpu_torch.core import lbs as tlbs
from avatar_tpu_torch.core.model import AvatarModel as TModel
from avatar_tpu_torch.core.pose_prior import GaussianMixture as TGmm
from avatar_tpu_torch.core.sequence import AvatarPoseSequence as TSequence
from avatar_tpu_torch.io import formats as tformats
from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
from avatar_tpu_torch.perception.rtree import RTree as TRTree
from avatar_tpu_torch import testing as ttesting
from avatar_tpu_torch import utils as tutils

P = 5


def _forest(mod, rng):
    """A 7-node tree with two leaves and two frontier nodes (5, 6)."""
    n = 7
    return mod.ForestData(
        rng.normal(size=(n, 2)).astype(np.float32),
        rng.normal(size=(n, 2)).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        np.array([1, 3, -1, 5, -1, -1, -1], np.int32),
        np.array([2, 4, -1, 6, -1, -1, -1], np.int32),
        np.array([-1, -1, 0, -1, 1, -1, -1], np.int32),
        rng.dirichlet(np.ones(P), size=2).astype(np.float32), P)


def _v3_state(mod, source):
    rng = np.random.default_rng(3)
    fd = _forest(mod, rng)
    ns = 11
    return mod.RTreeV3State(
        num_parts=P, source=source, nodes=fd,
        node_interval=rng.integers(0, 100, (7, 2)).astype(np.uint64),
        leaf_data=fd.leaf_data,
        sample_index=rng.integers(0, 6, ns).astype(np.int32),
        sample_pix=rng.integers(0, 128, (ns, 2)).astype(np.int16),
        sample_label=rng.integers(0, P, ns).astype(np.uint8))


def _v2_state(mod, source):
    rng = np.random.default_rng(4)
    fd = _forest(mod, rng)
    return mod.RTreeV2State(
        num_parts=P, source=source, need_init=True, depth=12,
        curr_start_node=3,
        sparse=[np.array([10, 20], np.uint64), np.zeros(0, np.uint64)],
        assigned_node=np.array([0, 1, 5, 6, 6], np.int32), nodes=fd,
        leaf_data=fd.leaf_data,
        sample_index=np.array([0, 0, 2, 2, 2], np.int32),
        sample_pix=rng.integers(0, 128, (5, 2)).astype(np.int16))


@pytest.fixture(scope="module")
def body_depth():
    """A 427x240 depth frame of a posed body, rendered by the port."""
    from avatar_tpu_torch.core.model import Avatar
    from avatar_tpu_torch.render.renderer import AvatarRenderer

    ava = Avatar(ttesting.synthetic_model(detail=2, device="cpu"))
    ava.randomize(seed=5)
    ava.p = np.array([0.0, 0.1, 2.6])
    ava.r[0] = np.diag([-1.0, 1.0, -1.0])
    ava.update()
    intrin = TIntrin(fx=606.438 / 3, fy=606.351 / 3, cx=213.0, cy=120.0)
    return AvatarRenderer(ava, intrin).render_depth((240, 427))


SOURCES = {
    "avatar": dict(kind="avatar", xor_key=12345,
                   seq=np.arange(6, dtype=np.int32)),
    "file": dict(kind="file", depth_dir="/data/depth", mask_dir="/data/mask"),
}


def _same_fields(a, b, path=""):
    """Two parsed states (or forests, dicts, lists) equal field by field."""
    if hasattr(a, "__dict__") and not isinstance(a, np.ndarray):
        assert vars(a).keys() == vars(b).keys(), path
        for k in vars(a):
            _same_fields(getattr(a, k), getattr(b, k), f"{path}.{k}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same_fields(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_fields(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("version", ["v2", "v3"])
def test_trainer_checkpoint_codecs_match_reference(tmp_path, version,
                                                   source):
    """From one state both packages' writers give the same bytes, each
    reader parses the other's file into the same fields, and
    ``trainer_checkpoint_to_forest`` gives the same forest."""
    make = _v3_state if version == "v3" else _v2_state
    paths = {}
    for name, mod in (("j", jformats), ("t", tformats)):
        paths[name] = str(tmp_path / f"{name}.rtree_{version}")
        getattr(mod, f"write_rtree_{version}")(paths[name],
                                               make(mod, SOURCES[source]))
        assert not os.path.exists(paths[name] + ".partial")
    data = open(paths["t"], "rb").read()
    assert data == open(paths["j"], "rb").read()
    assert data[:9] == f"RTREE_{version.upper()} ".encode()
    back_j = getattr(jformats, f"read_rtree_{version}")(paths["t"])
    back_t = getattr(tformats, f"read_rtree_{version}")(paths["j"])
    _same_fields(back_t, back_j)
    assert back_t.num_parts == P and back_t.nodes.num_nodes == 7
    if source == "avatar":
        assert back_t.source["xor_key"] == 12345
    else:       # the reference writes depthDir into both fields
        assert back_t.source["mask_dir"] == "/data/depth"[:len("/data/mask")]
    conv_j = jformats.trainer_checkpoint_to_forest(back_j)
    conv_t = tformats.trainer_checkpoint_to_forest(back_t)
    _same_fields(conv_t, conv_j)
    assert (conv_t.leafid >= 0).sum() == 4          # two frontier leaves
    np.testing.assert_allclose(conv_t.leaf_data.sum(1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="not an RTREE"):
        other = "v2" if version == "v3" else "v3"
        getattr(tformats, f"read_rtree_{other}")(paths["t"])


def test_data_source_and_node_block_helpers(tmp_path):
    """The private pieces on their own: a data source and a node block
    written by one package and read by the other."""
    rng = np.random.default_rng(9)
    for wmod, rmod in ((tformats, jformats), (jformats, tformats)):
        path = str(tmp_path / "piece.bin")
        fd = _forest(wmod, rng)
        with open(path, "wb") as f:
            wmod._write_data_source(f, SOURCES["avatar"])
            wmod._write_node_block(f, fd)
        with open(path, "rb") as f:
            src = rmod._read_data_source(f)
            u, v, thresh, lnode, rnode, leafid = rmod._read_node_block(f, 7)
            assert f.read() == b""
        _same_fields(src, SOURCES["avatar"])
        for got, want in ((u, fd.u), (v, fd.v), (thresh, fd.thresh),
                          (lnode, fd.lnode), (rnode, fd.rnode),
                          (leafid, fd.leafid)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown data source"):
        with open(path, "rb") as f:
            f.seek(3)
            tformats._read_data_source(f)


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_rtree_loads_trainer_checkpoint_like_reference(tmp_path, version,
                                                       body_depth):
    """``RTree.load_trainer_checkpoint`` on a mid-training checkpoint of a
    real tree (the committed forest cut at depth 11, its cut nodes left as
    frontier): the same forest, and the same labels on a depth image."""
    fd = jformats.read_srtr("data/bench_forest.srtr")
    depth_of = np.zeros(fd.num_nodes, np.int32)
    for i in range(fd.num_nodes):
        if fd.leafid[i] < 0:
            depth_of[fd.lnode[i]] = depth_of[fd.rnode[i]] = depth_of[i] + 1
    keep = np.nonzero(depth_of <= 11)[0]
    remap = np.full(fd.num_nodes, -1, np.int32)
    remap[keep] = np.arange(len(keep))
    cut = (depth_of[keep] == 11) & (fd.leafid[keep] < 0)
    leaf_rows = fd.leafid[keep]
    is_leaf = (leaf_rows >= 0) & ~cut
    leafid = np.full(len(keep), -1, np.int32)
    leafid[is_leaf] = np.arange(is_leaf.sum())
    internal = (leaf_rows < 0) & ~cut
    nodes = jformats.ForestData(
        fd.u[keep], fd.v[keep], fd.thresh[keep],
        np.where(internal, remap[fd.lnode[keep]], -1).astype(np.int32),
        np.where(internal, remap[fd.rnode[keep]], -1).astype(np.int32),
        leafid, fd.leaf_data[leaf_rows[is_leaf]], fd.num_parts)
    assert cut.sum() > 100 and is_leaf.sum() > 100 and internal.sum() > 100
    src = SOURCES["avatar"]
    if version == "v3":
        state = jformats.RTreeV3State(
            fd.num_parts, src, nodes, np.zeros((len(keep), 2), np.uint64),
            nodes.leaf_data, np.zeros(0, np.int32), np.zeros((0, 2), np.int16),
            np.zeros(0, np.uint8))
    else:
        state = jformats.RTreeV2State(
            fd.num_parts, src, False, 11, 0, [], np.zeros(0, np.int32), nodes,
            nodes.leaf_data, np.zeros(0, np.int32), np.zeros((0, 2), np.int16))
    path = str(tmp_path / f"cut.rtree_{version}")
    getattr(jformats, f"write_rtree_{version}")(path, state)
    jt, tt = JRTree(fd.num_parts), TRTree(fd.num_parts, device="cpu")
    sj, st = jt.load_trainer_checkpoint(path), tt.load_trainer_checkpoint(path)
    _same_fields(st, sj)
    _same_fields(tt.forest, jt.forest)
    assert (tt.forest.leafid >= 0).sum() == is_leaf.sum() + cut.sum()
    lab_j = jt.predict_best(body_depth, interval=2, fill_in_gaps=False)
    lab_t = tt.predict_best(body_depth, interval=2, fill_in_gaps=False)
    np.testing.assert_array_equal(lab_t, np.asarray(lab_j))
    assert len(np.unique(lab_t)) > 4
    np.testing.assert_array_equal(
        tt.predict(body_depth, interval=2, fill_in_gaps=False),
        np.asarray(jt.predict(body_depth, interval=2, fill_in_gaps=False)))
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"RTREE_V9 nothing")
    with pytest.raises(ValueError, match="not an RTREE_V2/V3"):
        tt.load_trainer_checkpoint(str(bad))


def test_grouped_forest_walk_matches_reference(body_depth):
    """The committed 14-group forest walks alike in both packages, at the
    tracker's stride 3, on a port-rendered frame: labels equal to the
    pixel and leaf distributions equal."""
    path = "data/bench_forest_g14c.srtr"
    jt, tt = JRTree(path), TRTree(path, device="cpu")
    assert jt.num_parts == tt.num_parts == 14
    assert list(tt.part_map) == list(jt.part_map)
    lab_j = np.asarray(jt.predict_best(body_depth, interval=3))
    lab_t = tt.predict_best(body_depth, interval=3)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert (lab_t != 255).sum() > 500 and len(np.unique(lab_t)) > 4
    np.testing.assert_array_equal(
        tt.predict(body_depth, interval=3),
        np.asarray(jt.predict(body_depth, interval=3)))


def _write_legacy_model_dir(out_dir, arrays, regressor: str) -> None:
    """The legacy text model format (reference AvatarModel.cpp:128-288):
    model.pcd, skeleton.txt, shapekey/*.pcd, mesh.txt and, by
    ``regressor``, joint_shape_regressor.txt, joint_regressor.txt or
    neither."""
    os.makedirs(os.path.join(out_dir, "shapekey"))

    def pcd(path, pts):
        with open(path, "w") as f:
            f.write("# .PCD v.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                    "DATA ascii\n")
            for p in pts:
                f.write(" ".join(repr(float(x)) for x in p) + "\n")

    v, W = arrays["v_template"], arrays["weights"]
    J, K = len(arrays["parent"]), arrays["shapedirs"].shape[2]
    pcd(os.path.join(out_dir, "model.pcd"), v)
    for k in range(K):
        pcd(os.path.join(out_dir, "shapekey", f"key{k:03d}.pcd"),
            arrays["shapedirs"][:, :, k])
    joints = arrays["joint_reg"] @ v
    with open(os.path.join(out_dir, "skeleton.txt"), "w") as f:
        f.write(f"{J} {len(v)}\n")
        for j in range(J):
            f.write(f"{j} {int(arrays['parent'][j])} joint{j} "
                    + " ".join(repr(float(x)) for x in joints[j]) + "\n")
        for i in range(len(v)):
            nz = np.nonzero(W[i])[0]
            f.write(f"{len(nz)} " + " ".join(
                f"{j} {float(W[i, j])!r}" for j in nz) + "\n")
    with open(os.path.join(out_dir, "mesh.txt"), "w") as f:
        f.write(f"{len(arrays['faces'])}\n")
        for t in arrays["faces"]:
            f.write(" ".join(str(int(x)) for x in t) + "\n")
    if regressor == "shape":
        base = joints.reshape(-1)
        mat = np.einsum("jp,pck->jck", arrays["joint_reg"],
                        arrays["shapedirs"]).reshape(J * 3, K)
        with open(os.path.join(out_dir, "joint_shape_regressor.txt"),
                  "w") as f:
            f.write(f"{K}\n" + " ".join(repr(float(x)) for x in base) + "\n")
            for row in mat:
                f.write(" ".join(repr(float(x)) for x in row) + "\n")
    elif regressor == "joint":
        with open(os.path.join(out_dir, "joint_regressor.txt"), "w") as f:
            f.write(f"{J}\n")
            for j in range(J):
                nz = np.nonzero(arrays["joint_reg"][j])[0]
                f.write(f"{len(nz)} " + " ".join(
                    f"{i} {float(arrays['joint_reg'][j, i])!r}"
                    for i in nz) + "\n")


MODEL_FIELDS = ("v_template", "shapedirs", "weights_np", "joint_reg_np",
                "parent", "faces", "joint_shape_reg_base", "joint_shape_reg",
                "initial_joint_pos", "main_joint", "ancestor_mask")


def _same_model(tm, jm):
    for k in MODEL_FIELDS:
        a, b = getattr(tm, k), getattr(jm, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert tm.parents == jm.parents
    assert tm.use_joint_shape_regressor == jm.use_joint_shape_regressor
    assert (tm.has_mesh(), tm.has_pose_prior()) == \
        (jm.has_mesh(), jm.has_pose_prior())
    for a, b in zip(tm.params, jm.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("regressor,one_joint",
                         [("shape", False), ("joint", False),
                          ("none", False), ("joint", True)])
def test_legacy_model_dir_loads_like_reference(tmp_path, regressor,
                                               one_joint):
    """A model directory in the legacy text format, with each kind of
    joint regressor and with ``limit_one_joint_per_point``: every array of
    both packages' ``AvatarModel`` equal, exactly (both parse with numpy)."""
    arrays = ttesting.synthetic_arrays(1, n_keys=3)
    d = str(tmp_path / "legacy")
    _write_legacy_model_dir(d, arrays, regressor)
    ttesting.synthetic_pose_prior(24, device="cpu").save(
        os.path.join(d, "pose_prior.txt"))
    jm = JModel(d, limit_one_joint_per_point=one_joint)
    tm = TModel(d, device="cpu", limit_one_joint_per_point=one_joint)
    _same_model(tm, jm)
    assert tm.has_mesh() and tm.has_pose_prior()
    assert tm.num_shape_keys() == 3 and tm.num_faces() == len(arrays["faces"])
    assert tm.use_joint_shape_regressor == (regressor != "joint")
    np.testing.assert_array_equal(tm.v_template, arrays["v_template"])
    if one_joint:
        assert set(np.unique(tm.weights_np)) == {0.0, 1.0}
    np.testing.assert_array_equal(
        ttesting.synthetic_arrays(1, n_keys=3)["faces"], tm.faces)
    with pytest.raises(FileNotFoundError, match="model.pcd"):
        TModel(str(tmp_path / "nothing"), device="cpu")
    pcd = tmp_path / "binary.pcd"
    pcd.write_text("WIDTH 1\nDATA binary\n")
    with pytest.raises(ValueError, match="non-ascii"):
        from avatar_tpu_torch.core.model import _read_ascii_pcd
        _read_ascii_pcd(str(pcd))


def test_synthetic_model_dir_matches_reference(tmp_path):
    """``write_synthetic_model_dir`` of both packages: ``pose_prior.txt``
    byte-equal, ``model.npz`` equal array by array, and each package's
    ``AvatarModel`` loads the other's directory to the same model.  A
    model with no faces and no prior says so."""
    dj = jtesting.write_synthetic_model_dir(str(tmp_path / "j"), n_keys=4)
    dt = ttesting.write_synthetic_model_dir(str(tmp_path / "t"), n_keys=4)
    assert open(os.path.join(dt, "pose_prior.txt"), "rb").read() == \
        open(os.path.join(dj, "pose_prior.txt"), "rb").read()
    with np.load(os.path.join(dj, "model.npz")) as zj, \
            np.load(os.path.join(dt, "model.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    _same_model(TModel(dj, device="cpu"), JModel(dt))
    tm = TModel(dt, device="cpu")
    for a, b in zip((tm.pose_prior.weights, tm.pose_prior.means,
                     tm.pose_prior.prec_cho), (
            JModel(dj).pose_prior.weights, JModel(dj).pose_prior.means,
            JModel(dj).pose_prior.prec_cho)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    arrays = ttesting.synthetic_arrays(1)
    arrays["faces"] = np.zeros((0, 3), np.int32)
    bare = TModel(arrays=arrays, device="cpu")
    assert not bare.has_mesh() and not bare.has_pose_prior()


def test_gaussian_mixture_save_round_trips(tmp_path):
    """``save`` writes what the reference's writes, and both loaders read
    it back to the float64 masters exactly."""
    tg = ttesting.synthetic_pose_prior(24, device="cpu")
    jg = jtesting.synthetic_pose_prior(24)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tg.save(pt)
    jg.save(pj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back_t, back_j = TGmm.load(pj, device="cpu"), JGmm.load(pt)
    for k in ("weights", "means", "covs", "prec_cho", "consts_log"):
        np.testing.assert_array_equal(back_t._np[k], tg._np[k], err_msg=k)
        np.testing.assert_array_equal(back_t._np[k], back_j._np[k],
                                      err_msg=k)
    assert (back_t.n_comps, back_t.n_dims) == (jg.n_comps, jg.n_dims)


def test_synthetic_pose_sequence_matches_reference(tmp_path):
    """The pose bank of both packages from one seed: the same header, root
    positions equal (numpy on both sides), quaternions within 1e-6."""
    pj, pt = str(tmp_path / "j.dat"), str(tmp_path / "t.dat")
    jtesting.synthetic_pose_sequence(pj, n_frames=12, seed=5)
    ttesting.synthetic_pose_sequence(pt, n_frames=12, seed=5)
    assert open(pt + ".txt").read() == open(pj + ".txt").read()
    a = np.fromfile(pt, "<f8").reshape(12, -1)
    b = np.fromfile(pj, "<f8").reshape(12, -1)
    assert a.shape == b.shape == (12, 3 + 24 * 4)
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(
        a[:, 3:].reshape(12, 24, 4), axis=-1), 1.0, atol=1e-6)
    # each package reads the other's bank
    sj, st = JSequence(pt), TSequence(pj)
    assert sj.num_frames == st.num_frames == 12
    np.testing.assert_array_equal(st.get_frame(7), b[7])
    np.testing.assert_array_equal(sj.get_frame(7), a[7])


def test_palette_shaped_dtype_and_read_xyz(tmp_path):
    for bgr in (False, True):
        np.testing.assert_array_equal(tutils.palette_color_table(20, bgr),
                                      jutils.palette_color_table(20, bgr))
        for i in (0, 5, 16, 17, 40):
            np.testing.assert_array_equal(tutils.palette_color(i, bgr),
                                          jutils.palette_color(i, bgr))
    table = tutils.palette_color_table(17)
    assert table.shape == (17, 3) and table.dtype == np.float64
    assert 0.0 <= table.min() and table.max() <= 1.0
    tm = ttesting.synthetic_model(device="cpu")
    assert tlbs.shaped_dtype(tm.params) == torch.float32
    assert str(jlbs.shaped_dtype(jtesting.synthetic_model().params)) == \
        "float32"
    # read_xyz: a .depth frame through the camera model
    rng = np.random.default_rng(2)
    depth = np.where(rng.random((24, 32)) < 0.5, 0.0,
                     rng.uniform(1.0, 3.0, (24, 32))).astype(np.float32)
    path = str(tmp_path / "frame.depth")
    tformats.write_depth_rle(path, depth)
    kw = dict(fx=40.0, fy=41.0, cx=16.0, cy=12.0)
    xyz_t = tformats.read_xyz(path, TIntrin(**kw))
    xyz_j = jformats.read_xyz(path, JIntrin(**kw))
    assert xyz_t.shape == (24, 32, 3)
    np.testing.assert_array_equal(xyz_t, np.asarray(xyz_j))
    np.testing.assert_array_equal(xyz_t[..., 2], depth)
