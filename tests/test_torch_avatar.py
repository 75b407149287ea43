"""Parity of the port's ``Avatar`` (``core/model.py``) and the pose prior's
``component_energies`` / ``pdf`` with the JAX reference.

``randomize`` draws from the same numpy generator in the same order and
evaluates Rodrigues in float32 as the reference does, so ``w`` and ``p``
are equal and ``r`` agrees within 1e-6.  ``update`` (LBS) within 1e-5 m;
``smpl_params``, ``pdf`` and ``align_to_joints`` within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu.core import rotation as jrot
from avatar_tpu.core.model import Avatar as JAvatar
from avatar_tpu.testing import synthetic_model as j_synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core.model import Avatar as TAvatar
from avatar_tpu_torch.core.model import SmplJoint
from avatar_tpu_torch.testing import synthetic_model as t_synthetic_model


@pytest.fixture(scope="module")
def models():
    return (j_synthetic_model(detail=2),
            t_synthetic_model(detail=2, device="cpu"))


@pytest.mark.parametrize("seed", [77, 3])
def test_randomize_draw_for_draw(models, seed):
    jm, tm = models
    ja, ta = JAvatar(jm), TAvatar(tm)
    ja.randomize(seed=seed)
    ta.randomize(seed=seed)
    np.testing.assert_array_equal(ta.w, ja.w)
    np.testing.assert_array_equal(ta.p, ja.p)
    np.testing.assert_allclose(ta.r, ja.r, atol=1e-6)
    # a shared generator continues in step: the next draw is equal too
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    ja.randomize(randomize_shape=False, rng=rj)
    ta.randomize(randomize_shape=False, rng=rt)
    np.testing.assert_array_equal(ta.p, ja.p)
    np.testing.assert_array_equal(rt.random(), rj.random())


def test_update_smpl_params_pdf(models):
    jm, tm = models
    ja = JAvatar(jm)
    ja.randomize(seed=77)
    ja.update()
    ta = from_reference(ja, model=tm)
    assert ta.cloud is None
    ta.update()
    np.testing.assert_allclose(ta.cloud, ja.cloud, atol=1e-5)
    np.testing.assert_allclose(ta.joint_pos, ja.joint_pos, atol=1e-5)
    np.testing.assert_allclose(ta.joint_rot_global, ja.joint_rot_global,
                               atol=1e-5)
    np.testing.assert_allclose(ta.smpl_params(), ja.smpl_params(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.smplParams(), ta.smpl_params())
    # a random draw's density underflows float32 (XLA flushes it to 0, the
    # port keeps a denormal): compare the density near a prior mode, where
    # it is a normal float32 (~4e-29 for the synthetic prior)
    mean = jm.pose_prior._np["means"][0].reshape(-1, 3)
    for scale in (0.0, 0.02):
        aa = mean + np.random.default_rng(1).normal(0, scale, mean.shape)
        ja.r[1:] = np.asarray(jrot.so3_exp(jnp.asarray(aa, jnp.float32)))
        ta.r = ja.r.copy()
        assert ja.pdf() > 1e-35
        np.testing.assert_allclose(ta.pdf(), ja.pdf(), rtol=1e-5)


def test_prior_energies_and_pdf(models):
    jm, tm = models
    x = np.random.default_rng(2).normal(0, 0.3, (5, 69)).astype(np.float32)
    np.testing.assert_allclose(
        tm.pose_prior.component_energies(torch.as_tensor(x)).numpy(),
        np.asarray(jm.pose_prior.component_energies(jnp.asarray(x))),
        rtol=1e-5)
    np.testing.assert_allclose(
        tm.pose_prior.pdf(torch.as_tensor(x)).numpy(),
        np.asarray(jm.pose_prior.pdf(jnp.asarray(x))), rtol=1e-5)


def test_align_to_joints(models):
    jm, tm = models
    src = JAvatar(jm)
    src.randomize(seed=11)
    src.update()
    pos = src.joint_pos.astype(np.float64)
    pos[SmplJoint.L_HAND] = np.nan          # a missing joint stays identity
    ja, ta = JAvatar(jm), TAvatar(tm)
    ja.align_to_joints(pos)
    ta.alignToJoints(pos)
    np.testing.assert_allclose(ta.p, ja.p, rtol=1e-5)
    np.testing.assert_allclose(ta.w, ja.w, rtol=1e-5)
    np.testing.assert_allclose(ta.r, ja.r, rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(ta.r[SmplJoint.L_HAND], np.eye(3))


def test_random_mocap_pose_needs_a_bank(models):
    ta = TAvatar(models[1])
    with pytest.raises(FileNotFoundError):
        ta.random_mocap_pose()
    with pytest.raises(FileNotFoundError):
        ta.randomMocapPose()


def test_avatar_conversion_needs_model(models):
    ja = JAvatar(models[0])
    with pytest.raises(ValueError):
        from_reference(ja)
