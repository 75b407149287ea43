"""ICP + Levenberg-Marquardt avatar fit (counterpart of
``avatar_tpu/optim/gauss_newton.py``; see its docstring for the model).

Tangent: delta = [dp (3) | dr_0..dr_{J-1} (3 each, global-frame so(3)) |
dw (K)], retraction rot_j <- C_j^T exp(dr_j^) C_j rot_j with C_j the
parent's global rotation frozen at the linearization point, so the
per-point rotation Jacobian is -skew(a_pj - b_pj t_j).  Normal equations
come from per-model-point sufficient statistics; the LM accept/reject cost
gathers actual residuals (the statistics expansion cancels in f32).

Differences from the reference, all of control flow and none of maths:
  * the device ``lax.while_loop`` is a Python loop that reads its two
    flags (accept, stop) from the device once per step;
  * ``lax.cond`` over re-linearization is a Python ``if`` on that flag;
  * correspondences always take the part-sorted planned NN
    (``correspond.find_nn_stats_planned``), which needs N % 256 == 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import LBSParams, fk, shape_fwd
from avatar_tpu_torch.optim import correspond

_SQRT_HALF = math.sqrt(0.5)


class PriorData(NamedTuple):
    """GMM pose prior tensors."""
    means: torch.Tensor       # [C, D69]
    prec_cho: torch.Tensor    # [C, D69, D69] lower
    consts_log: torch.Tensor  # [C]


class FitContext(NamedTuple):
    """Per-model tensors consumed by the fit."""
    lbs: LBSParams
    anc_mask: torch.Tensor    # [J, J] anc[j, k] = 1 iff j ancestor-or-self
    faces: torch.Tensor       # [F, 3] int
    model_part: torch.Tensor  # [P] int32 body part per model vertex
    prior: PriorData
    cand_mask: Optional[torch.Tensor] = None  # [P] bool NN candidates
    n_rest: Optional[torch.Tensor] = None     # [P, 3] rest-pose normals


class Theta(NamedTuple):
    p: torch.Tensor      # [3]
    rots: torch.Tensor   # [J, 3, 3] local joint rotations
    w: torch.Tensor      # [K]


class FitDiag(NamedTuple):
    cost: torch.Tensor         # final cost
    n_matched: torch.Tensor    # matches in the last linearization
    inner_iters: torch.Tensor  # accepted LM steps
    part_counts: torch.Tensor  # [num_parts] int32 matched points per part


def _bmm(*ops):
    return torch.einsum("jab,jbc->jac", *ops)


def extrapolate(theta: Theta, theta_prev: Theta, gamma,
                max_ang: float = 0.25, max_dp: float = 0.10) -> Theta:
    """Constant-velocity pose prediction: advance ``theta`` by ``gamma``
    times its one-frame velocity, clamped to ``max_ang`` rad per joint and
    ``max_dp`` meters.  ``gamma`` = 0 returns ``theta``'s pose exactly."""
    g = torch.as_tensor(gamma, dtype=theta.p.dtype, device=theta.p.device)
    dp = (theta.p - theta_prev.p) * g
    dpn = torch.linalg.norm(dp)
    dp = dp * torch.clamp(max_dp / torch.clamp(dpn, min=1e-9), max=1.0)
    aa = rotation.so3_log(torch.einsum(
        "jab,jcb->jac", theta.rots, theta_prev.rots)) * g           # [J,3]
    ang = torch.linalg.norm(aa, dim=-1, keepdim=True)
    aa = aa * torch.clamp(max_ang / torch.clamp(ang, min=1e-9), max=1.0)
    rots = _bmm(rotation.so3_exp(aa), theta.rots)
    return Theta(p=theta.p + dp, rots=rots, w=theta.w)


def _forward(ctx: FitContext, parents, theta: Theta, use_jsr: bool):
    """LBS forward with the intermediates the Jacobians need."""
    shaped, j_init = shape_fwd(ctx.lbs, theta.w, use_jsr)
    Rg, tg = fk(parents, theta.rots, theta.p, j_init)
    J = len(parents)
    A = (ctx.lbs.weights @ Rg.reshape(J, 9)).reshape(-1, 3, 3)
    t_eff = tg - torch.einsum("jab,jb->ja", Rg, j_init)
    b = ctx.lbs.weights @ t_eff
    x = torch.einsum("pab,pb->pa", A, shaped) + b
    return x, shaped, j_init, Rg, tg, A


def _vertex_normals(x: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    f = faces.long()
    fn = torch.linalg.cross(x[f[:, 1]] - x[f[:, 0]], x[f[:, 2]] - x[f[:, 0]])
    vn = torch.zeros_like(x)
    for k in range(3):
        vn = vn.index_add(0, f[:, k], fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(min=1e-12)


def _icp_jacobian(ctx: FitContext, parents, theta: Theta, fwd,
                  with_shape: bool = True) -> torch.Tensor:
    """Analytic d(posed point)/d(delta) for every model point: [P, 3, D]
    (D = 3 + 3J without the shape columns)."""
    x, shaped, j_init, Rg, tg, A = fwd
    W = ctx.lbs.weights
    P = W.shape[0]
    J = len(parents)
    K = ctx.lbs.shapedirs.shape[2]
    dtype, dev = x.dtype, x.device

    # rotation blocks: -skew(a_pj - b_pj t_j)
    Rs = torch.einsum("kab,pb->pka", Rg, shaped)                  # [P,J,3]
    t_eff = tg - torch.einsum("jab,jb->ja", Rg, j_init)
    c = W[:, :, None] * (Rs + t_eff[None, :, :])                  # [P,J,3]
    a = torch.einsum("jk,pkc->pjc", ctx.anc_mask, c)              # [P,J,3]
    b = W @ ctx.anc_mask.T                                        # [P,J]
    g = a - b[:, :, None] * tg[None, :, :]
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    zz = torch.zeros_like(gx)
    r0 = torch.stack([zz, gz, -gy], dim=-1)                       # [P,J,3]
    r1 = torch.stack([-gz, zz, gx], dim=-1)
    r2 = torch.stack([gy, -gx, zz], dim=-1)
    Jrot = torch.stack([r0, r1, r2], dim=1).reshape(P, 3, 3 * J)
    Jpos = torch.eye(3, dtype=dtype, device=dev).expand(P, 3, 3)
    if not with_shape:
        return torch.cat([Jpos, Jrot], dim=2)

    # shape block: A_p D_p - W (Rg_k S_k - H_k)
    S = ctx.lbs.joint_shape_reg                                   # [J,3,K]
    Sp = [torch.zeros((3, K), dtype=dtype, device=dev)]
    for j in range(1, J):
        Sp.append(S[j] - S[parents[j]])
    H = [torch.zeros((3, K), dtype=dtype, device=dev)] * J
    for j in range(1, J):
        H[j] = Rg[parents[j]] @ Sp[j] + H[parents[j]]
    H = torch.stack(H)                                            # [J,3,K]
    M = torch.einsum("jab,jbk->jak", Rg, S) - H
    Jshape = torch.einsum("pab,pbk->pak", A, ctx.lbs.shapedirs) - \
        torch.einsum("pj,jak->pak", W, M)
    return torch.cat([Jpos, Jrot, Jshape], dim=2)


def _prior_whiten(ctx: FitContext, aa_flat: torch.Tensor):
    """Whitened residuals of every component and the min-energy one."""
    diff = aa_flat[None, :] - ctx.prior.means                     # [C, 69]
    wh = torch.einsum("cdk,cd->ck", ctx.prior.prec_cho, diff) * _SQRT_HALF
    energies = torch.sum(wh * wh, dim=-1) - ctx.prior.consts_log
    return wh, torch.argmin(energies)


def _prior_terms(ctx: FitContext, parents, theta: Theta, Rg, beta_pose,
                 beta_shape):
    """Pose + shape prior J^T J, J^T r contributions (D x D, D)."""
    J = len(parents)
    K = theta.w.shape[0]
    dtype, dev = theta.w.dtype, theta.w.device
    aa = rotation.so3_log(theta.rots[1:])                         # [J-1,3]
    wh, comp = _prior_whiten(ctx, aa.reshape(-1))
    r_head = wh[comp] * beta_pose                                 # [69]
    L = ctx.prior.prec_cho[comp]                                  # [69, 69]

    # d(aa_i)/d(dr_i) = J_l^{-1}(aa_i) C_i^T,  C_i = Rg[parent(i)]
    Jl = rotation.so3_left_jacobian_inv(aa)
    C = Rg[torch.tensor([parents[i] for i in range(1, J)], device=dev)]
    chain = torch.einsum("iab,icb->iac", Jl, C)                   # Jl @ C^T
    Lt_blocks = L.reshape(J - 1, 3, 3 * (J - 1)).permute(0, 2, 1)  # [J-1,69,3]
    Jblocks = torch.einsum("iqa,iab->iqb", Lt_blocks, chain) * (
        _SQRT_HALF * beta_pose)

    D = 3 + 3 * J + K
    JtJ = torch.zeros((D, D), dtype=dtype, device=dev)
    Jtr = torch.zeros(D, dtype=dtype, device=dev)
    G = torch.einsum("iqb,jqc->ibjc", Jblocks, Jblocks).reshape(
        3 * (J - 1), 3 * (J - 1))
    JtJ[6:3 + 3 * J, 6:3 + 3 * J] += G
    Jtr[6:3 + 3 * J] += torch.einsum("iqb,q->ib", Jblocks, r_head).reshape(-1)
    # shape prior: resid = beta_shape * w
    JtJ[3 + 3 * J:, 3 + 3 * J:] += torch.eye(K, dtype=dtype, device=dev) * \
        beta_shape ** 2
    Jtr[3 + 3 * J:] += beta_shape ** 2 * theta.w
    return JtJ, Jtr


def _prior_cost(ctx: FitContext, theta: Theta, beta_pose, beta_shape):
    aa = rotation.so3_log(theta.rots[1:]).reshape(-1)
    wh, comp = _prior_whiten(ctx, aa)
    c = torch.sum(wh[comp] ** 2) - ctx.prior.consts_log[comp]
    return 0.5 * (beta_pose ** 2 * c + beta_shape ** 2 * torch.sum(theta.w ** 2))


def _parent_frames(Rg: torch.Tensor, parents) -> torch.Tensor:
    """C_j = Rg[parent(j)], with C_0 = I."""
    J = len(parents)
    idx = torch.tensor([parents[j] if parents[j] >= 0 else 0
                        for j in range(J)], device=Rg.device)
    C = Rg[idx].clone()
    C[0] = torch.eye(3, dtype=Rg.dtype, device=Rg.device)
    return C


def _retract(theta: Theta, delta: torch.Tensor, Rg, parents) -> Theta:
    """theta (+) delta with parent frames C frozen at the linearization."""
    J = len(parents)
    dp = delta[:3]
    dr = delta[3:3 + 3 * J].reshape(J, 3)
    dw = delta[3 + 3 * J:]
    E = rotation.so3_exp(dr)
    C = _parent_frames(Rg, parents)
    new_rots = torch.einsum("jba,jbc,jcd,jde->jae", C, E, C, theta.rots)
    return Theta(p=theta.p + dp, rots=new_rots, w=theta.w + dw)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian``: the mean of the two middle values on an even
    count (``torch.nanmedian`` returns the lower one); NaN when empty."""
    n = torch.sum(~torch.isnan(x))
    s = torch.sort(torch.nan_to_num(x, nan=math.inf)).values
    lo = s[torch.clamp((n - 1) // 2, min=0)]
    hi = s[torch.clamp(n // 2, max=x.shape[0] - 1)]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, math.nan))


def fit(ctx: FitContext, parents: Tuple[int, ...], data_pts: torch.Tensor,
        data_part: torch.Tensor, theta0: Theta, beta_pose, beta_shape,
        n_steps: int, use_jsr: bool = True, enable_occlusion: bool = True,
        chunk: int = 512, robust: bool = True, plane_weight=0.0,
        point_weight=1.0, function_tolerance: float = 1e-4,
        num_parts: int = 0, huber_k=1.5, robust_per_part: bool = False,
        beta_temp=0.0, clamp_angle=0.0, clamp_support=10.0,
        freeze_shape: bool = False, model_sorted: bool = False,
        wild_gate=0.15, wild_weight=1.0) -> Tuple[Theta, FitDiag]:
    """Full avatar fit (the reference's AvatarOptimizer::optimize).

    data_pts [N,3] / data_part [N] are padded (data_part < 0) to a multiple
    of 256.  Points labelled ``num_parts`` are wildcards: they match the
    nearest visible vertex of any part, gated at ``wild_gate`` meters and
    weighted ``wild_weight``.
    """
    dtype, dev = data_pts.dtype, data_pts.device
    P = ctx.lbs.weights.shape[0]
    f = lambda v: torch.as_tensor(v, dtype=dtype, device=dev)
    w_pt, w_pl, w_tmp = f(point_weight), f(plane_weight), f(beta_temp)
    huber_k = f(huber_k)

    # renormalize the incoming rotations (the reference's quaternion
    # round-trip does this each optimize() call, AvatarOptimizer.cpp:1249)
    theta0 = Theta(p=theta0.p, rots=rotation.quat_to_mat(
        rotation.mat_to_quat(theta0.rots)), w=theta0.w)

    # rest-pose normals once per fit; per step they are rotated by A_p
    if ctx.n_rest is not None:
        n_rest = ctx.n_rest
    else:
        shaped0, _ = shape_fwd(ctx.lbs, theta0.w, use_jsr)
        n_rest = _vertex_normals(shaped0, ctx.faces)
    occ_margin = 0.2

    rots0 = theta0.rots
    J_all = len(parents)
    K_all = ctx.lbs.shapedirs.shape[2]
    D_fit = 3 + 3 * J_all if freeze_shape else 3 + 3 * J_all + K_all
    rot_dims = torch.zeros(D_fit, dtype=dtype, device=dev)
    rot_dims[3:3 + 3 * J_all] = 1.0

    NP = num_parts or len(parents)     # also the wildcard label id
    plan = correspond.make_nn_plan(data_pts, data_part, ctx.model_part,
                                   num_parts=NP, tile_n=256, chunk=chunk,
                                   model_sorted=model_sorted)
    data_pts = plan.dpts
    data_part = plan.dpart

    w_wild = f(wild_weight)
    wild_gate2 = f(wild_gate) ** 2
    if robust and robust_per_part:
        # one extra column: wildcards get their own robust-scale bucket
        part_oh = (torch.nn.functional.one_hot(
            torch.clamp(data_part, 0, NP).long(), NP + 1).to(dtype) *
            (data_part >= 0).to(dtype)[:, None])                 # [N, NP+1]

    def cost_at(th, xf, cidx, wgt, vn, bp, bs, bt):
        rr = xf[cidx] - data_pts
        c_pt = 0.5 * torch.sum(wgt * torch.sum(rr * rr, -1))
        c_pl = 0.5 * torch.sum(wgt * torch.sum(vn[cidx] * rr, -1) ** 2)
        aa_t = rotation.so3_log(torch.einsum("jab,jcb->jac", th.rots, rots0))
        c_t = 0.5 * bt ** 2 * torch.sum(aa_t * aa_t)
        return (w_pt ** 2 * c_pt + w_pl ** 2 * c_pl + c_t +
                _prior_cost(ctx, th, bp, bs))

    def linearize(theta, fwd, corr_prev):
        """NN correspondence, robust weights, statistics, Jacobian, gram
        and gradient, and the cost, all at the current iterate."""
        x, shaped, j_init, Rg, tg, A = fwd
        vn = torch.einsum("pab,pb->pa", A, n_rest)
        vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(min=1e-12)
        if enable_occlusion:
            vis = vn[:, 2] < occ_margin
        else:
            vis = torch.ones(P, dtype=torch.bool, device=dev)
        if ctx.cand_mask is not None:
            vis = vis & ctx.cand_mask
        st = correspond.find_nn_stats_planned(plan, x, vis, wild=NP,
                                              wild_gate2=wild_gate2)
        valid = st.corr >= 0
        cidx = torch.clamp(st.corr, min=0).long()

        if robust:
            r0 = x[cidx] - data_pts
            dist = torch.sqrt(torch.sum(r0 * r0, -1) + 1e-12)
            if robust_per_part:
                vw = valid.to(dtype)
                acc = part_oh.T @ torch.stack([dist * vw, vw], dim=1)
                mean_p = acc[:, 0] / torch.clamp(acc[:, 1], min=1.0)
                delta_h = torch.clamp(huber_k * (part_oh @ mean_p), min=1e-3)
            else:
                big = torch.where(valid, dist, torch.full_like(dist, math.nan))
                med = torch.nan_to_num(_nanmedian(big), nan=0.01)
                delta_h = torch.clamp(huber_k * med, min=1e-3)
            wgt = torch.where(valid, torch.clamp(delta_h / dist, max=1.0),
                              torch.zeros_like(dist))
        else:
            wgt = valid.to(dtype)
        # label-free wildcard matches carry reduced weight
        wgt = wgt * torch.where(data_part == NP, w_wild, f(1.0))

        idx = torch.where(valid, cidx, P)
        cs = torch.zeros((P + 1, 4), dtype=dtype, device=dev).index_add_(
            0, idx, torch.cat([wgt[:, None], data_pts * wgt[:, None]], 1))[:-1]
        cnt = cs[:, 0]
        s = cs[:, 1:]

        n_matched = torch.sum(valid.to(dtype))
        scale = torch.sqrt(torch.clamp(n_matched, min=1.0)) / 15.0
        bp = beta_pose * scale
        bs = beta_shape * scale
        bt = w_tmp * scale

        cost = cost_at(theta, x, cidx, wgt, vn, bp, bs, bt)
        Jm = _icp_jacobian(ctx, parents, theta, fwd,
                           with_shape=not freeze_shape)           # [P,3,D]
        rhs = cnt[:, None] * x - s                                # [P,3]
        sq = torch.sqrt(torch.clamp(cnt, min=0.0))
        Jw = (Jm * sq[:, None, None]).reshape(-1, D_fit)
        JtJ = w_pt ** 2 * (Jw.T @ Jw)
        Jtr = w_pt ** 2 * (Jm.reshape(-1, D_fit).T @ rhs.reshape(-1))
        Jpl = torch.einsum("pc,pci->pi", vn, Jm)                  # [P,D]
        Jplw = Jpl * sq[:, None]
        JtJ = JtJ + w_pl ** 2 * (Jplw.T @ Jplw)
        Jtr = Jtr + w_pl ** 2 * (Jpl.T @ torch.sum(vn * rhs, -1))
        pJtJ, pJtr = _prior_terms(ctx, parents, theta, Rg, bp, bs)
        JtJ = JtJ + pJtJ[:D_fit, :D_fit]
        Jtr = Jtr + pJtr[:D_fit]
        # temporal pose prior: residual log(R_j R_j0^T), Jacobian C_j^T
        aa_t = rotation.so3_log(torch.einsum("jab,jcb->jac", theta.rots,
                                             rots0))
        JtJ = JtJ + bt ** 2 * torch.diag(rot_dims)
        Cmat = _parent_frames(Rg, parents)
        Jtr = Jtr.clone()
        Jtr[3:3 + 3 * J_all] += bt ** 2 * torch.einsum(
            "jab,jb->ja", Cmat, aa_t).reshape(-1)
        corr_stable = torch.all(st.corr == corr_prev)
        return (JtJ, Jtr, cost, n_matched, st.corr, cidx, wgt, vn,
                torch.stack([bp, bs, bt]), corr_stable)

    theta = theta0
    fwd = _forward(ctx, parents, theta0, use_jsr)
    lam = f(1e-2)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    small_cnt = torch.zeros((), dtype=torch.int32, device=dev)
    cost = f(math.inf)
    lin = None
    corr_prev = torch.full((data_pts.shape[0],), -2, dtype=torch.int32,
                           device=dev)
    need_lin = True
    eye = torch.eye(D_fit, dtype=dtype, device=dev)
    for _ in range(n_steps):
        if need_lin:
            lin = linearize(theta, fwd, corr_prev if lin is None else lin[4])
        else:
            # a rejected step leaves theta unchanged: reuse the bundle,
            # correspondences are trivially stable
            lin = lin[:9] + (torch.ones((), dtype=torch.bool, device=dev),)
        (JtJ, Jtr, cost, n_matched, corr, cidx, wgt, vn, b3,
         corr_stable) = lin
        bp, bs, bt = b3[0], b3[1], b3[2]
        Rg = fwd[3]
        # Marquardt damping with a diagonal floor
        d = torch.diagonal(JtJ)
        d = torch.maximum(d, 1e-3 * torch.max(d))
        M = JtJ + lam * torch.diag(d) + 1e-8 * eye
        L, info = torch.linalg.cholesky_ex(M)
        delta = -torch.cholesky_solve(Jtr[:, None], L)[:, 0]
        # a failed factorization yields NaN, as the reference's does: the
        # trial cost is NaN and the step is rejected
        delta = torch.where(info == 0, delta, torch.full_like(delta, math.nan))
        if freeze_shape:
            delta = torch.cat([delta, torch.zeros(K_all, dtype=dtype,
                                                  device=dev)])
        trial = _retract(theta, delta, Rg, parents)
        trial_fwd = _forward(ctx, parents, trial, use_jsr)
        trial_cost = cost_at(trial, trial_fwd[0], cidx, wgt, vn, bp, bs, bt)

        accept = trial_cost < cost
        rel = torch.abs(cost - trial_cost) / torch.clamp(cost, min=1e-12)
        small = (rel < function_tolerance) & corr_stable
        small_cnt = torch.where(small, small_cnt + 1, 0)
        lam = torch.where(accept, torch.clamp(lam * 0.33, min=1e-7),
                          torch.clamp(lam * 6.0, max=1e6))
        accepted = accepted + accept.to(torch.int32)
        cost = torch.where(accept, trial_cost, cost)
        need_lin, stop = torch.stack([accept, small_cnt >= 2]).tolist()
        if need_lin:
            theta, fwd = trial, trial_fwd
        if stop:
            break

    n_matched = lin[3]
    corr_final = lin[4]
    matched_f = corr_final >= 0
    # wildcard matches (label == NP) are excluded from the part counts
    pidx = torch.where(matched_f & (data_part < NP),
                       torch.clamp(data_part, 0, NP - 1), NP).long()
    part_counts = torch.bincount(pidx, minlength=NP + 1)[:NP].to(torch.int32)

    # per-joint motion clamp for joints whose subtree matched almost no data
    w_clamp = f(clamp_angle)
    cidx_f = torch.clamp(corr_final, min=0).long()
    vcnt = torch.zeros(P + 1, dtype=dtype, device=dev).index_add_(
        0, torch.where(matched_f, cidx_f, P),
        torch.ones_like(corr_final, dtype=dtype))[:-1]
    subtree_w = ctx.lbs.weights @ ctx.anc_mask.T                  # [P,J]
    support = vcnt @ subtree_w                                    # [J]
    aa_rel = rotation.so3_log(torch.einsum("jab,jcb->jac", theta.rots,
                                           theta0.rots))
    ang = torch.linalg.norm(aa_rel, dim=-1, keepdim=True)
    lim = torch.where((support[:, None] < clamp_support) & (w_clamp > 0),
                      torch.clamp(w_clamp / torch.clamp(ang, min=1e-9),
                                  max=1.0), f(1.0))
    rots_c = _bmm(rotation.so3_exp(aa_rel * lim), theta0.rots)
    theta = Theta(p=theta.p, rots=rots_c, w=theta.w)
    return theta, FitDiag(cost=cost, n_matched=n_matched,
                          inner_iters=accepted, part_counts=part_counts)
