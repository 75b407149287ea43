"""Parity of the PyTorch port's core math with the JAX reference:
rotations, LBS / forward kinematics and the GMM prior residual.

Inputs are made with numpy from a seed and given to both packages; the
model state goes across through ``avatar_tpu_torch.convert``.  Tolerance:
atol 1e-5 (both sides float32; the two frameworks sum in different
orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avatar_tpu.core import lbs as jlbs
from avatar_tpu.core import rotation as jrot
from avatar_tpu.testing import synthetic_model
from avatar_tpu_torch.convert import from_reference
from avatar_tpu_torch.core import lbs as tlbs
from avatar_tpu_torch.core import rotation as trot
from avatar_tpu_torch.testing import synthetic_pose_prior

ATOL = 1e-5


def _both(fn_j, fn_t, *arrays):
    a = np.asarray(fn_j(*[jnp.asarray(x) for x in arrays]))
    b = fn_t(*[torch.as_tensor(np.array(x)) for x in arrays]).numpy()
    return a, b


def _rotations(rng, n):
    aa = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    aa[0] = 0.0                                    # identity
    aa[1] = [1e-6, -2e-6, 0.0]                     # Taylor branch
    aa[2] = [np.pi - 0.01, 0.0, 0.0]               # near pi
    return aa


@pytest.mark.parametrize("name", ["skew", "so3_exp", "so3_left_jacobian_inv"])
def test_axis_angle_functions(name):
    aa = _rotations(np.random.default_rng(0), 64)
    a, b = _both(getattr(jrot, name), getattr(trot, name), aa)
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_so3_log_and_quaternions():
    aa = _rotations(np.random.default_rng(1), 64)
    R = np.asarray(jrot.so3_exp(jnp.asarray(aa)))
    for name in ("so3_log", "mat_to_quat"):
        a, b = _both(getattr(jrot, name), getattr(trot, name), R)
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=name)
    q = np.random.default_rng(2).normal(size=(32, 4)).astype(np.float32)
    a, b = _both(jrot.quat_to_mat, trot.quat_to_mat, q)
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.fixture(scope="module")
def model():
    return synthetic_model(detail=1)


@pytest.mark.parametrize("use_jsr", [True, False])
def test_lbs_and_fk(model, use_jsr):
    rng = np.random.default_rng(3)
    J, K = model.num_joints(), model.num_shape_keys()
    w = rng.normal(0, 0.5, K).astype(np.float32)
    p = (rng.normal(0, 0.3, 3) + [0, 0, 2.5]).astype(np.float32)
    rots = np.array(jrot.so3_exp(jnp.asarray(
        rng.normal(0, 0.4, (J, 3)), jnp.float32)))
    ref = jlbs.lbs(model.params, model.parents, jnp.asarray(w),
                   jnp.asarray(p), jnp.asarray(rots), use_jsr=use_jsr)
    params = from_reference(model.params)
    assert isinstance(params, tlbs.LBSParams)
    got = tlbs.lbs(params, model.parents, torch.as_tensor(w),
                   torch.as_tensor(p), torch.as_tensor(rots),
                   use_jsr=use_jsr)
    for name, a, b in zip(("cloud", "joints", "Rg", "j_init"), ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   err_msg=name)
    # the non-standard root: the pelvis lands at p
    np.testing.assert_allclose(got[1][0].numpy(), p, atol=1e-6)
    assert tlbs._lifting_pointers(model.parents) == \
        jlbs._lifting_pointers(model.parents)


def test_gmm_residual(model):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.2, (8, 69)).astype(np.float32)
    ref_r, ref_c = model.pose_prior.residual(jnp.asarray(x))
    prior = synthetic_pose_prior(24, seed=8)        # synthetic_model's seed+1
    got_r, got_c = prior.residual(torch.as_tensor(x))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=ATOL)
    for k in ("weights", "means", "covs", "cov_cho", "prec_cho",
              "consts_log"):
        np.testing.assert_array_equal(prior._np[k], model.pose_prior._np[k])
