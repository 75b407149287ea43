"""Parity of the port's perception stages and numpy copies with the JAX
reference.  Integer outputs — component labels, foreground masks, leaf
ids, filtered label images — must be equal bit for bit; the blob centres
within 1e-4 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu import testing as jtesting
from avatar_tpu import tracking as jtracking
from avatar_tpu.io import formats as jformats
from avatar_tpu.perception import bgsub as jbgsub
from avatar_tpu.perception import cc as jcc
from avatar_tpu.perception import partgroups as jgroups
from avatar_tpu.perception import rtree as jrtree
from avatar_tpu_torch import testing as ttesting
from avatar_tpu_torch import tracking as ttracking
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.io import formats as tformats
from avatar_tpu_torch.perception import bgsub as tbgsub
from avatar_tpu_torch.perception import cc as tcc
from avatar_tpu_torch.perception import partgroups as tgroups
from avatar_tpu_torch.perception import rtree as trtree

FOREST = "data/bench_forest.srtr"


def _blobs(seed, H=48, W=40, n_labels=5):
    """Label image of random rectangles over a background of 255."""
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 255, np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
        h, w = rng.integers(2, 14), rng.integers(2, 14)
        img[y:y + h, x:x + w] = rng.integers(0, n_labels)
    return img


@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components(seed):
    img = _blobs(seed)
    active = img != 255
    ref = jcc.connected_components(jnp.asarray(active),
                                   values=jnp.asarray(img))
    got = tcc.connected_components(torch.as_tensor(active),
                                   values=torch.as_tensor(img))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tcc.component_sizes(got).numpy(),
                                  np.asarray(jcc.component_sizes(ref)))
    for a, b in zip(jcc.component_centroids(ref),
                    tcc.component_centroids(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _xyz_pair(seed, H=40, W=36):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    bg_z = np.full((H, W), 4.0, np.float32)
    bg_z[rng.random((H, W)) < 0.05] = 0.0              # invalid pixels
    img_z = bg_z + rng.normal(0, 0.01, (H, W)).astype(np.float32)
    img_z[10:30, 8:25] = 2.5 + 0.1 * rng.random((20, 17))  # a body
    img_z[rng.random((H, W)) < 0.03] = 0.0
    mk = lambda z: np.stack([(xx - W / 2) * z / 50.0,
                             (yy - H / 2) * z / 50.0, z], -1).astype(
        np.float32)
    return mk(bg_z), mk(img_z)


def test_foreground_mask_and_gated_components():
    bg, img = _xyz_pair(2)
    thresh = np.float32(0.01)
    ref = jbgsub._foreground_mask(jnp.asarray(bg), jnp.asarray(img), thresh)
    got = tbgsub._foreground_mask(torch.as_tensor(bg), torch.as_tensor(img),
                                  torch.tensor(thresh))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 100 < got.sum() < img.shape[0] * img.shape[1] // 2
    nb = np.float32(0.02)
    ref_l, _ = jbgsub._components(jnp.asarray(img), ref, nb)

    def gate(v, s):
        d = (v - s) ** 2
        return d[..., 0] + d[..., 1] + d[..., 2] <= nb

    got_l = tcc.connected_components(got, values=torch.as_tensor(img),
                                     edge_gate_fn=gate)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


@pytest.fixture(scope="module")
def forest():
    return jrtree.RTree(FOREST)


def test_read_srtr_and_partmap_match_reference(forest):
    ref = jformats.read_srtr(FOREST)
    got = tformats.read_srtr(FOREST)
    for f in ("u", "v", "thresh", "lnode", "rnode", "leafid", "leaf_data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    assert got.num_parts == ref.num_parts
    t = trtree.RTree(FOREST, device="cpu")
    assert t._max_depth == forest._max_depth
    for f in trtree.TreeTensors._fields:
        np.testing.assert_array_equal(getattr(t._tree, f).numpy(),
                                      np.asarray(getattr(forest._tree, f)), f)
    pm = "data/bench_forest_g14c.srtr.partmap"
    assert tformats.read_partmap(pm) == jformats.read_partmap(pm)


@pytest.mark.parametrize("stride", [1, 3])
def test_walk_pixels_leaf_ids(forest, stride):
    """Leaf ids of a compacted pixel set on a probe window, bit for bit."""
    rng = np.random.default_rng(stride)
    Hp, Wp = 60, 50
    depth = np.where(rng.random((Hp, Wp)) < 0.6,
                     rng.uniform(1.5, 3.5, (Hp, Wp)), 0.0).astype(np.float32)
    depth[20:40, 15:35] = rng.uniform(2.4, 2.6, (20, 20))
    K = 512
    sel = rng.choice(Hp * Wp, K, replace=False).astype(np.int32)
    ys, xs = sel // Wp, sel % Wp
    z = depth.reshape(-1)[sel]
    fg = z > 0
    tree_j = forest._tree._replace(u=forest._tree.u / stride,
                                   v=forest._tree.v / stride)
    tl, br = (0, 0), (Wp - 1, Hp - 1)
    ref = jrtree.walk_pixels(tree_j, jnp.asarray(ys), jnp.asarray(xs),
                             jnp.asarray(z), jnp.asarray(fg),
                             jnp.asarray(depth.reshape(-1)), (Hp, Wp),
                             forest._max_depth, jnp.asarray(tl),
                             jnp.asarray(br))
    got = trtree.walk_pixels(from_reference(tree_j, "cpu"),
                             torch.as_tensor(ys), torch.as_tensor(xs),
                             torch.as_tensor(z), torch.as_tensor(fg),
                             torch.as_tensor(depth.reshape(-1)), (Hp, Wp),
                             forest._max_depth, tl, br)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() >= 0).sum() == fg.sum()


@pytest.mark.parametrize("seed", [3, 4])
def test_suppress_part_nonmax(seed):
    img = _blobs(seed, n_labels=4)
    rng = np.random.default_rng(seed)
    com_pre = np.stack([rng.uniform(-20, 150, 4),
                        rng.uniform(0, 150, 4)]).astype(np.float32)
    origin = (12, 6)
    ref_out, ref_com = jrtree.suppress_part_nonmax(
        jnp.asarray(img), jnp.asarray(com_pre), 4, 3, 0.001,
        jnp.asarray(origin, jnp.int32))
    got_out, got_com = trtree.suppress_part_nonmax(
        torch.as_tensor(img), torch.as_tensor(com_pre), 4, 3,
        torch.tensor(0.001), origin)
    np.testing.assert_array_equal(got_out.numpy(), np.asarray(ref_out))
    np.testing.assert_allclose(got_com.numpy(), np.asarray(ref_com),
                               atol=1e-4)


@pytest.mark.parametrize("detail", [1, 6])
def test_synthetic_arrays_copy(detail):
    ref = jtesting.synthetic_arrays(detail)
    got = ttesting.synthetic_arrays(detail)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    if detail == 6:
        assert got["v_template"].shape[0] == 6624
        assert got["faces"].shape[0] == 12420


def test_model_derived_fields_and_prior():
    ref = jtesting.synthetic_model(detail=1)
    got = ttesting.synthetic_model(detail=1, device="cpu")
    for f in ("main_joint", "ancestor_mask", "joint_shape_reg_base",
              "joint_shape_reg", "faces"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
    assert got.parents == ref.parents
    for f in got.params._fields:
        np.testing.assert_array_equal(getattr(got.params, f).numpy(),
                                      np.asarray(getattr(ref.params, f)), f)
    for f in ("means", "prec_cho", "consts_log", "weights"):
        np.testing.assert_array_equal(getattr(got.pose_prior, f).numpy(),
                                      np.asarray(getattr(ref.pose_prior, f)))


def test_model_npz_loading(tmp_path):
    d = jtesting.write_synthetic_model_dir(str(tmp_path / "m"))
    from avatar_tpu.core.model import AvatarModel as JModel
    from avatar_tpu_torch.core.model import AvatarModel as TModel

    ref, got = JModel(d), TModel(d, device="cpu")
    np.testing.assert_array_equal(got.parent, ref.parent)
    np.testing.assert_array_equal(got.v_template, ref.v_template)
    np.testing.assert_array_equal(got.pose_prior.prec_cho.numpy(),
                                  np.asarray(ref.pose_prior.prec_cho))
    with pytest.raises(FileNotFoundError):
        TModel(str(tmp_path / "missing"), device="cpu")


def test_tracker_config_and_partgroups_copies():
    ref = {f.name: f.default for f in
           dataclasses.fields(jtracking.TrackerConfig)}
    got = {f.name: f.default for f in
           dataclasses.fields(ttracking.TrackerConfig)}
    assert got == ref
    assert [f.name for f in dataclasses.fields(ttracking.TrackResult)] == \
        [f.name for f in dataclasses.fields(jtracking.TrackResult)]
    np.testing.assert_array_equal(tgroups.SMPL24_GROUP_LUT,
                                  jgroups.SMPL24_GROUP_LUT)
    assert tgroups.SMPL24_GROUP_CHAIN_ROOT == jgroups.SMPL24_GROUP_CHAIN_ROOT
    lut = jgroups.SMPL24_GROUP_LUT
    np.testing.assert_array_equal(tgroups.group_label_lut(lut),
                                  jgroups.group_label_lut(lut))
    ld = np.random.default_rng(0).random((30, 24)).astype(np.float32)
    np.testing.assert_array_equal(tgroups.fold_leaf_data(ld, lut, 14),
                                  jgroups.fold_leaf_data(ld, lut, 14))
