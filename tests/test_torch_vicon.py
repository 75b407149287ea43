"""The port's ASF/AMC loader (``avatar_tpu_torch/io/vicon.py``, a numpy
copy): the cases of ``tests/test_vicon.py`` on the port, on the same
skeleton and motion text, and equality with the reference on that text
(positions and exports equal to the last bit: both run the same float64
numpy arithmetic)."""

import numpy as np
import pytest

from avatar_tpu.core.sequence import AvatarPoseSequence as JSequence
from avatar_tpu.io.vicon import ViconSkeleton as JSkeleton
from avatar_tpu_torch.io.vicon import ViconSkeleton as TSkeleton
from test_vicon import AMC, ASF


@pytest.fixture()
def skel(tmp_path):
    asf = tmp_path / "t.asf"
    amc = tmp_path / "t.amc"
    asf.write_text(ASF)
    amc.write_text(AMC)
    return TSkeleton(str(asf), str(amc), length_scale=1.0)


def test_parse_structure(skel):
    assert set(skel.bones) == {"upper", "lower"}
    assert skel.bones["lower"].parent == "upper"
    assert skel.num_frames == 2


def test_rest_pose_positions(skel):
    pos = skel.joint_positions(-1)
    np.testing.assert_allclose(pos["root"], [0, 0, 0], atol=1e-9)
    np.testing.assert_allclose(pos["upper"], [0, 2, 0], atol=1e-9)
    np.testing.assert_allclose(pos["lower"], [0, 3, 0], atol=1e-9)


def test_frame_zero_matches_rest(skel):
    pos = skel.joint_positions(0)
    np.testing.assert_allclose(pos["upper"], [0, 2, 0], atol=1e-9)
    np.testing.assert_allclose(pos["lower"], [0, 3, 0], atol=1e-9)


def test_posed_frame(skel):
    pos = skel.joint_positions(1)
    # root rotated 90 deg about z and translated (1,2,3): bone (0,1,0)
    # becomes (-1,0,0) scaled by lengths
    np.testing.assert_allclose(pos["root"], [1, 2, 3], atol=1e-9)
    np.testing.assert_allclose(pos["upper"], [-1, 2, 3], atol=1e-7)
    # lower additionally rotates 90 deg about its local x: (0,1,0)->(0,0,1),
    # then through the root's 90-deg z rotation
    np.testing.assert_allclose(pos["lower"], [-1, 2, 4], atol=1e-7)


def test_smpl_joint_export(skel, tmp_path):
    arr = skel.smpl_joints(1)
    assert arr.shape == (24, 3)
    assert np.isfinite(arr[0]).all()  # root mapped
    # unmapped joints are NaN
    assert np.isnan(arr[4]).any() or np.isfinite(arr).all()

# -- joint-op API (ViconSkeleton.h:36-74 spec; frame nav .cpp:253-310) --------


def test_frame_navigation(skel):
    skel.rest()
    assert skel.cur_frame == 0
    np.testing.assert_allclose(skel.pos["lower"], [0, 3, 0], atol=1e-9)
    assert skel.next_frame()          # -> frame 1 (1-based; AMC frame 0)
    assert skel.cur_frame == 1
    np.testing.assert_allclose(skel.pos["lower"], [0, 3, 0], atol=1e-9)
    assert skel.next_frame()          # -> frame 2 (the posed one)
    np.testing.assert_allclose(skel.pos["lower"], [-1, 2, 4], atol=1e-7)
    assert not skel.next_frame()      # past the end without loop
    assert skel.next_frame(1, loop=True)
    assert skel.cur_frame == 1
    assert skel.prev_frame(1, loop=True)
    assert skel.cur_frame == 2


def test_translate_subtree(skel):
    skel.rest()
    skel.translate("upper", [1.0, 0.0, 0.0])
    np.testing.assert_allclose(skel.pos["upper"], [1, 2, 0], atol=1e-9)
    np.testing.assert_allclose(skel.pos["lower"], [1, 3, 0], atol=1e-9)
    np.testing.assert_allclose(skel.pos["root"], [0, 0, 0], atol=1e-9)


def test_local_pos_and_length(skel):
    skel.rest()
    np.testing.assert_allclose(skel.local_pos("lower"), [0, 1, 0],
                               atol=1e-9)
    assert skel.bone_length("upper") == pytest.approx(2.0)
    skel.set_local_pos("lower", [0.0, 2.0, 0.0])
    np.testing.assert_allclose(skel.pos["lower"], [0, 4, 0], atol=1e-9)


def test_rotate_about_parent(skel):
    skel.rest()
    # rotate the lower bone 90 deg about z around its parent (upper @ (0,2,0))
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    skel.rotate("lower", Rz)
    np.testing.assert_allclose(skel.pos["lower"], [-1, 2, 0], atol=1e-9)
    # root rotation is a no-op
    before = {k: v.copy() for k, v in skel.pos.items()}
    skel.rotate("root", Rz)
    for k in before:
        np.testing.assert_allclose(skel.pos[k], before[k], atol=1e-12)


def test_rotate_to_direction(skel):
    skel.rest()
    skel.rotate_to("upper", [1.0, 0.0, 0.0])
    np.testing.assert_allclose(skel.pos["upper"], [2, 0, 0], atol=1e-9)
    # subtree carried: lower keeps its local offset, rotated the same way
    np.testing.assert_allclose(skel.pos["lower"], [3, 0, 0], atol=1e-9)
    assert skel.bone_length("upper") == pytest.approx(2.0)  # pure rotation


def test_scale_one_translates_children(skel):
    skel.rest()
    skel.scale_one("upper", 2.0)
    np.testing.assert_allclose(skel.pos["upper"], [0, 4, 0], atol=1e-9)
    # child bone NOT scaled, just carried
    assert skel.bone_length("lower") == pytest.approx(1.0)
    np.testing.assert_allclose(skel.pos["lower"], [0, 5, 0], atol=1e-9)


def test_scale_subtree(skel):
    skel.rest()
    skel.scale("upper", 2.0)
    np.testing.assert_allclose(skel.pos["upper"], [0, 4, 0], atol=1e-9)
    np.testing.assert_allclose(skel.pos["lower"], [0, 6, 0], atol=1e-9)
    assert skel.bone_length("lower") == pytest.approx(2.0)


def test_rotate_and_scale_exact(skel):
    skel.rest()
    skel.rotate_and_scale("lower", [0.5, 0.0, 0.0])
    np.testing.assert_allclose(skel.local_pos("lower"), [0.5, 0, 0],
                               atol=1e-9)


def test_smpl_joints_from_posed_state(skel):
    skel.load_frame(2)
    arr = skel.smpl_joints(None)
    np.testing.assert_allclose(arr[0], [1, 2, 3], atol=1e-7)


def _both(tmp_path, scale):
    asf, amc = tmp_path / "t.asf", tmp_path / "t.amc"
    asf.write_text(ASF)
    amc.write_text(AMC)
    return (JSkeleton(str(asf), str(amc), length_scale=scale),
            TSkeleton(str(asf), str(amc), length_scale=scale))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("scale", [1.0, 0.056444])
def test_matches_reference(tmp_path, scale):
    j, t = _both(tmp_path, scale)
    assert j.bones.keys() == t.bones.keys() and j.root_order == t.root_order
    for name in j.bones:
        bj, bt = j.bones[name], t.bones[name]
        for f in ("direction", "length", "axis", "axis_inv"):
            np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f))
        assert (bt.dof, bt.parent, bt.children) == (bj.dof, bj.parent,
                                                    bj.children)
    for frame in (-1, 0, 1):
        _same(j.joint_positions(frame), t.joint_positions(frame))
        np.testing.assert_array_equal(t.smpl_joints(frame),
                                      j.smpl_joints(frame))
    Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    ops = [("load_frame", 2), ("translate", "upper", [0.5, 0.0, 0.1]),
           ("rotate", "lower", Rz), ("rotate_to", "upper", [1.0, 1.0, 0.0]),
           ("scale_one", "upper", 1.5), ("scale", "upper", 0.5),
           ("rotate_and_scale", "lower", [0.2, 0.0, 0.3]),
           ("set_local_pos", "lower", [0.0, 0.4, 0.0]),
           ("prev_frame", 1, True), ("next_frame", 3, True)]
    for name, *args in ops:
        assert getattr(t, name)(*args) == getattr(j, name)(*args)
        _same(j.pos, t.pos)
        assert t.cur_frame == j.cur_frame
        np.testing.assert_array_equal(t.smpl_joints(None),
                                      j.smpl_joints(None))
    jp, tp = tmp_path / "j.dat", tmp_path / "t.dat"
    j.to_pose_bank(str(jp))
    t.to_pose_bank(str(tp))
    assert jp.read_bytes() == tp.read_bytes()
    assert JSequence(str(tp)).num_frames == 2
