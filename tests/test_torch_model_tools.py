"""The port's model tools (``optim_tool``, ``smpltrim``, ``smpl_viewer``,
``scratch``, ``face_landmark_tracking``) against the reference's, on the
CPU, mirroring ``tests/test_tools.py``'s flows (``--synthetic-model 1``).

- ``smpltrim``: the written ``model.npz`` arrays equal the reference's; the
  trimmed model loads and poses in the port.
- ``smpl_viewer``: each ``--mode`` at 128x128, and ``InteractiveViewer``'s
  renders after ``set_pose`` / ``set_shape``: at most 0.1% of pixels
  differ, all on edges (a 3x3 neighbour more than ``EDGE_JUMP`` away, or
  the border), and elsewhere the part image is equal and depth and
  Lambert images within 1 grey level (``tests/test_torch_render.py``'s
  rule); the headless snapshot is written.
- ``scratch``: what it hands to matplotlib (cloud, joints, bones, colours)
  within 1e-5 m of the reference's.
- ``optim_tool``: the reference test's flow (vertex RMSE after the fit
  under 0.08 m); on the reference's render, the same data points and
  pre-fit RMSE (to the printed 0.01 mm) and the post-fit RMSE within
  ``OPTIM_POST_MM`` of the reference's.  The two fits differ in their NN
  (the port plans it, the reference's CPU path does not) and in float32
  summation order over 30 LM steps.
- ``face_landmark_tracking``: the printed lines equal the reference's,
  line for line, over one ``data_recording`` recording.
"""

import os

import numpy as np
import pytest
import torch

from avatar_tpu.tools import face_landmark_tracking as jface
from avatar_tpu.tools import optim_tool as joptim
from avatar_tpu.tools import scratch as jscratch
from avatar_tpu.tools import smpl_viewer as jviewer
from avatar_tpu.tools import smpltrim as jtrim
from avatar_tpu_torch.tools import data_recording as trec
from avatar_tpu_torch.tools import face_landmark_tracking as tface
from avatar_tpu_torch.tools import optim_tool as toptim
from avatar_tpu_torch.tools import scratch as tscratch
from avatar_tpu_torch.tools import smpl_viewer as tviewer
from avatar_tpu_torch.tools import smpltrim as ttrim

MODEL = ["--synthetic-model", "1"]
CPU = ["--device", "cpu"]
DIFF_FRAC = 1e-3     # differing pixels, as a share of the image
EDGE_JUMP = 8        # grey levels between neighbours that make an edge
OPTIM_POST_MM = 1.0  # port vs reference post-fit vertex RMSE


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: parallel test workers each taking every core
    contend badly."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def headless(monkeypatch):
    """The tools plot to files, as without a display."""
    monkeypatch.delenv("DISPLAY", raising=False)


# ---------------------------------------------------------------------------
# smpltrim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [
    ["-d", "L_HIP", "-d", "R_HIP", "-t", "0.5"],
    ["-r", "SPINE1", "-d", "L_SHOULDER"],
])
def test_smpltrim_writes_the_reference_model(tmp_path, cut):
    from avatar_tpu_torch.core.model import Avatar, AvatarModel

    ref, out = str(tmp_path / "ref"), str(tmp_path / "port")
    jtrim.main([ref, *MODEL, *cut])
    ttrim.main([out, *MODEL, *cut, *CPU])
    with np.load(os.path.join(ref, "model.npz")) as r, \
            np.load(os.path.join(out, "model.npz")) as g:
        assert sorted(g.files) == sorted(r.files)
        for k in r.files:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    m = AvatarModel(out, device="cpu")
    if cut[1] == "L_HIP":
        assert m.num_joints() == 16      # both leg subtrees gone
    assert m.num_points() > 100 and (m.faces < m.num_points()).all()
    ava = Avatar(m)
    ava.update()
    assert np.isfinite(ava.cloud).all()


# ---------------------------------------------------------------------------
# smpl_viewer
# ---------------------------------------------------------------------------


def _edges(img, jump):
    """Pixels with a 3x3 neighbour more than ``jump`` away (any channel),
    or on the image's border."""
    a = img.astype(np.int64)
    if a.ndim == 2:
        a = a[..., None]
    pad = np.pad(a, ((1, 1), (1, 1), (0, 0)), mode="edge")
    H, W = img.shape[:2]
    out = np.zeros((H, W), bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            n = pad[dy:dy + H, dx:dx + W]
            out |= (np.abs(n - a) > jump).any(-1)
    out[0, :] = out[-1, :] = out[:, 0] = out[:, -1] = True
    return out


def _same_image(got, ref, exact: bool):
    """At most DIFF_FRAC of the pixels differ, all on edges; elsewhere
    equal (``exact``) or within 1 grey level."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    if d.ndim == 3:
        d = d.max(-1)
    off = d > (0 if exact else 1)
    assert off.mean() <= DIFF_FRAC, f"{off.sum()} pixels differ"
    edges = _edges(ref, 0 if exact else EDGE_JUMP)
    assert not (off & ~edges).any(), \
        f"{(off & ~edges).sum()} differing pixels off the edges"
    body = ref != 0
    assert (body.any(-1) if body.ndim == 3 else body).sum() > 200


def _read(path):
    import cv2

    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("mode", ["lambert", "depth", "parts"])
def test_smpl_viewer_modes_match_reference(tmp_path, mode):
    args = [*MODEL, "--random", "3", "--mode", mode, "--size", "128x128",
            "--pose", "18:0.5,0,0", "--shape", "0:1.5"]
    ref, out = str(tmp_path / "ref.png"), str(tmp_path / "port.png")
    jviewer.main(["-o", ref, *args])
    tviewer.main(["-o", out, *args, *CPU])
    _same_image(_read(out), _read(ref), exact=mode == "parts")


def test_smpl_viewer_interactive_matches_reference(tmp_path):
    """The slider viewer's state driven programmatically (a joint's pose,
    a shape key, the LBS-weight view) renders as the reference's, and the
    headless snapshot is written."""
    from avatar_tpu.core.model import Avatar as JAvatar
    from avatar_tpu.io.calibration import CameraIntrin as JIntrin
    from avatar_tpu.testing import synthetic_model as j_synthetic_model
    from avatar_tpu_torch.core.model import Avatar as TAvatar
    from avatar_tpu_torch.io.calibration import CameraIntrin as TIntrin
    from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model

    out = str(tmp_path / "iview.png")
    tviewer.main(["-o", out, *MODEL, "--interactive", "--size", "96x96",
                  "--lbs-weights-of", "4", *CPU])
    assert os.path.getsize(out) > 0

    intrin = dict(fx=90.0, fy=90.0, cx=48.0, cy=48.0)
    viewers = []
    for model, ava_cls, intrin_cls, mod in (
            (j_synthetic_model(detail=1), JAvatar, JIntrin, jviewer),
            (t_synthetic_model(detail=1, device="cpu"), TAvatar, TIntrin,
             tviewer)):
        ava = ava_cls(model)
        ava.p = np.array([0.0, 0.0, 2.5])
        ava.update()
        viewers.append(mod.InteractiveViewer(model, ava, intrin_cls(**intrin),
                                             (96, 96)))
    jv, tv = viewers
    base = tv.render()
    _same_image(base, np.asarray(jv.render()), exact=False)
    for v in viewers:
        v.set_pose(4, [1.0, 0.2, 0.0])
    posed = tv.render()
    _same_image(posed, np.asarray(jv.render()), exact=False)
    assert (posed != base).mean() > 0.001
    for v in viewers:
        v.set_shape(0, 2.0)
        v.lbs_joint = 4
    _same_image(tv.render(), np.asarray(jv.render()), exact=False)


# ---------------------------------------------------------------------------
# scratch
# ---------------------------------------------------------------------------


@pytest.fixture
def plotted(monkeypatch):
    """What the tools hand to the 3D axes: (call, x, y, z, colour)."""
    from mpl_toolkits.mplot3d import Axes3D

    calls = []
    for name in ("scatter", "plot"):
        real = getattr(Axes3D, name)

        def record(self, *a, _name=name, _real=real, **kw):
            colour = kw.get("c", a[3] if len(a) > 3 else None)
            calls.append((_name, *(np.asarray(x, np.float64)
                                   for x in a[:3]), colour))
            return _real(self, *a, **kw)

        monkeypatch.setattr(Axes3D, name, record)
    return calls


def test_scratch_plots_the_reference_scene(tmp_path, plotted):
    args = [*MODEL, "--random", "5"]
    jscratch.main(["-o", str(tmp_path / "ref.png"), *args])
    ref = list(plotted)
    plotted.clear()
    out = str(tmp_path / "port.png")
    tscratch.main(["-o", out, *args, *CPU])
    assert os.path.getsize(out) > 0
    # the cloud, the joints and 23 bones
    assert [c[0] for c in plotted] == [c[0] for c in ref] == \
        ["scatter", "scatter"] + ["plot"] * 23
    for got, want in zip(plotted, ref):
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g, w, atol=1e-5)
        if isinstance(want[4], str):
            assert got[4] == want[4]
        else:
            np.testing.assert_array_equal(got[4], want[4])


# ---------------------------------------------------------------------------
# optim_tool
# ---------------------------------------------------------------------------

OPTIM = [*MODEL, "--size", "192x192", "--icp-iters", "3", "--interval", "2"]


def test_optim_tool():
    """The reference test's flow: the perturbed avatar is fitted back."""
    assert toptim.main([*OPTIM, *CPU]) < 0.08


def _printed(text, key):
    return next(ln for ln in text.splitlines() if ln.startswith(key))


def test_optim_tool_matches_reference_on_its_render(monkeypatch, capsys):
    """The port's tool on the reference tool's depth and part mask: the
    same data points and pre-fit RMSE, and a post-fit RMSE within
    OPTIM_POST_MM of the reference's."""
    shared = {}

    class Recording(joptim.AvatarRenderer):
        def render_depth(self, size):
            shared["depth"] = np.asarray(super().render_depth(size))
            return shared["depth"]

        def render_part_mask(self, size):
            shared["mask"] = np.asarray(super().render_part_mask(size))
            return shared["mask"]

    class Shared:
        def __init__(self, ava, intrin):
            pass

        def render_depth(self, size):
            return shared["depth"]

        def render_part_mask(self, size):
            return shared["mask"]

    monkeypatch.setattr(joptim, "AvatarRenderer", Recording)
    monkeypatch.setattr(toptim, "AvatarRenderer", Shared)
    post_ref = joptim.main(OPTIM)
    ref = capsys.readouterr().out
    post = toptim.main([*OPTIM, *CPU])
    got = capsys.readouterr().out
    for key in ("data points", "vertex RMSE"):
        assert _printed(got, key).split("->")[0] == \
            _printed(ref, key).split("->")[0], key
    assert abs(post - post_ref) * 1e3 <= OPTIM_POST_MM, (post, post_ref)
    assert post < 0.5 * float(_printed(got, "vertex RMSE").split()[2]) / 1e3


# ---------------------------------------------------------------------------
# face_landmark_tracking
# ---------------------------------------------------------------------------


def test_face_landmark_tracking_prints_the_reference_lines(tmp_path, capsys):
    rec = str(tmp_path / "rec")
    trec.main([rec, "--camera", "synthetic", "--frames", "4", "--fps", "0",
               *CPU])
    capsys.readouterr()
    jface.main([rec, "--max-frames", "4"])
    ref = capsys.readouterr().out.splitlines()
    tface.main([rec, "--max-frames", "4"])
    got = capsys.readouterr().out.splitlines()
    assert got == ref
    frames = [ln for ln in got if ln.startswith("frame")]
    assert len(frames) >= 4
    assert any("nose=" in ln and "mouth=" in ln for ln in frames)


@pytest.mark.parametrize("tool,argv", [
    (toptim, []),
    (ttrim, ["out"]),
    (tviewer, ["-o", "view.png"]),
    (tscratch, ["-o", "scratch.png"]),
])
def test_model_tools_default_to_the_card(tmp_path, monkeypatch, tool, argv):
    """Every tool that loads a model runs on the card unless asked for the
    CPU, and raises where there is none: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would not raise")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main([*argv, *MODEL])
    assert os.listdir(tmp_path) == []
