"""ICP + Levenberg-Marquardt avatar fit (counterpart of
``avatar_tpu/optim/gauss_newton.py``; see its docstring for the model).

Tangent: delta = [dp (3) | dr_0..dr_{J-1} (3 each, global-frame so(3)) |
dw (K)], retraction rot_j <- C_j^T exp(dr_j^) C_j rot_j with C_j the
parent's global rotation frozen at the linearization point, so the
per-point rotation Jacobian is -skew(a_pj - b_pj t_j).  Normal equations
come from per-model-point sufficient statistics; the LM accept/reject cost
gathers actual residuals (the statistics expansion cancels in f32).

How the loop runs.  The reference's loop is a device ``lax.while_loop``
that reads nothing back.  Here one LM step is a function over static
buffers (the iterate, its forward pass, lambda, the cost, the stall count,
the accepted count and the linearization bundle): ``lin`` re-linearizes,
then solves, tries and updates; ``step`` does the same over the kept
bundle (the reference's ``lax.cond`` false branch).  The accept is a
device-side select, as in the reference.  A step reads nothing from the
device and builds no tensor from host data, so on the card each of the
two is captured once per static configuration as a CUDA graph (all graphs
in one memory pool) and replayed; after each replay the host reads the two
flags (accept, stop) once, which choose the next graph or end the loop, so
a fit stops early as the reference's does.  Per-fit setup (the
renormalized ``theta0``, rest normals, the NN plan, the robust buckets)
and the tail after the loop (part counts, motion clamp) run eagerly; the
setup copies its results into the buffers before the first replay.

The programs (a configuration's buffers, step functions and graphs) live
in a dict the caller owns and passes as ``programs``: the tracker or
optimizer whose contexts they read, so they are freed with it.  A
program's key holds everything a capture bakes in besides the context:
the joints' parents, the search's kernel and shapes, D, the robust mode,
occlusion, the shape regressor switch, whether a candidate mask is given,
dtype and device.  The program reads the context's tensors where they are
and is built anew when a fit brings another context under its key; the
candidate mask is copied into a buffer per fit.  Every per-call number
(prior weights, point and plane weights, Huber and trim scales, the
wildcard gate and weight, the function tolerance) goes through a 0-d buffer
and is never a constant of the graph.  On the CPU, on the card under
``eager_steps()``, and for a fit given no ``programs`` (nothing would keep
its graphs), the same step functions run uncaptured.  A capture or replay
that fails on the card raises; it never falls back to the uncaptured
steps.

Differences from the reference, all of control flow and none of maths:
  * the host reads the step's two flags once per step (above), a counted
    read (``profiling.host_sync``); the fit counts its ``steps`` in the
    scope open around it (``profiling.count``);
  * correspondences take the part-sorted planned NN
    (``correspond.matcher``) whenever N % 256 == 0, and the unplanned
    search of ``correspond.find_nn_stats`` otherwise, the reference's
    branches without its TPU gate.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import math
import threading
from types import SimpleNamespace
from typing import NamedTuple, Optional, Tuple

import torch

from avatar_tpu_torch.core import rotation
from avatar_tpu_torch.core.lbs import LBSParams, fk, fk_indices, shape_fwd
from avatar_tpu_torch.optim import correspond, nn_kernel
from avatar_tpu_torch.profiling import count, host_sync, scope, unclocked

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
    corr: Optional[torch.Tensor] = None  # [N] int32 last correspondences,
    #                            in the fit's row order (part-sorted when
    #                            the NN was planned)


def _bmm(*ops):
    return torch.einsum("jab,jbc->jac", *ops)


@functools.lru_cache(maxsize=64)
def _parent_index(parents: Tuple[int, ...], device: torch.device):
    """Index tensors on ``device``, built once per ``(parents, device)``
    (a host-to-device copy cannot be captured and synchronises an eager
    step): the parents of joints 1..J-1, and each joint's parent with the
    root's taken as 0."""
    J = len(parents)
    return (torch.tensor([parents[i] for i in range(1, J)], device=device),
            torch.tensor([parents[j] if parents[j] >= 0 else 0
                          for j in range(J)], device=device))


def _pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-d index tensor ``i``, without the host read that
    indexing with a 0-d tensor makes."""
    return torch.index_select(t, 0, i.reshape(1))[0]


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
    r_head = _pick(wh, comp) * beta_pose                          # [69]
    L = _pick(ctx.prior.prec_cho, comp)                           # [69, 69]

    # d(aa_i)/d(dr_i) = J_l^{-1}(aa_i) C_i^T,  C_i = Rg[parent(i)]
    Jl = rotation.so3_left_jacobian_inv(aa)
    C = Rg[_parent_index(tuple(parents), dev)[0]]
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
    c = torch.sum(_pick(wh, comp) ** 2) - _pick(ctx.prior.consts_log, comp)
    return 0.5 * (beta_pose ** 2 * c + beta_shape ** 2 * torch.sum(theta.w ** 2))


def _parent_frames(Rg: torch.Tensor, parents) -> torch.Tensor:
    """C_j = Rg[parent(j)], with C_0 = I."""
    C = Rg[_parent_index(tuple(parents), Rg.device)[1]].clone()
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
    lo = _pick(s, torch.clamp((n - 1) // 2, min=0))
    hi = _pick(s, torch.clamp(n // 2, max=x.shape[0] - 1))
    return torch.where(n > 0, 0.5 * (lo + hi), torch.full_like(lo, math.nan))


# -- the LM loop: step functions over static buffers, graphed on the card --

_mode = threading.local()   # .eager: eager_steps() is active on the thread
CAPTURES = 0            # programs captured in this process (each capture
#                         first runs both step functions once, uncaptured)
_capture_streams: dict = {}
_pools: dict = {}


@contextlib.contextmanager
def eager_steps():
    """Run the LM steps of this thread's ``fit`` and ``fit_refine`` calls
    uncaptured on the card too, for the block: the comparison of a graphed
    fit with the eager one and the per-part profile of a step."""
    prev = getattr(_mode, "eager", False)
    _mode.eager = True
    try:
        yield
    finally:
        _mode.eager = prev


class _Program:
    """One static configuration of a fit: its buffers (``b``), its two step
    functions and, on the card, their CUDA graphs and the searches each
    replay launches.  Holds the context whose tensors the steps read.
    ``lin``'s search is ``correspond.search(b.match, b.x, b.vis, wild,
    b.wild_gate2)`` at the iterate it starts from (no gate where ``b`` has
    none)."""

    def __init__(self, ctx, b, lin, step, wild: int, keep=()):
        self.ctx = ctx
        self.b = b
        self.wild = wild
        self.fns = {"lin": lin, "step": step}
        self.keep = keep        # cached index tensors the graphs read
        self.graphs = None
        self.launches = {}

    def reads(self, ctx: FitContext) -> bool:
        """Whether the steps read ``ctx``'s tensors: every field but the
        candidate mask (a buffer, loaded per fit) is the same object."""
        return all(getattr(self.ctx, f) is getattr(ctx, f)
                   for f in FitContext._fields if f != "cand_mask")

    def run(self, relinearize: bool, graphed: bool) -> Tuple[bool, bool]:
        """One LM step; returns its (accept, stop) flags, the host's one
        read of the step.  A re-linearizing step is also the span ``lin``:
        inside ``step`` where graphed; where eager, around the step
        function, its parts keeping their paths (``scope(nests=False)``)."""
        name = "lin" if relinearize else "step"
        if graphed:
            if self.graphs is None:
                self.capture()
            with scope("step"), (scope("lin") if relinearize
                                 else contextlib.nullcontext()):
                self.graphs[name].replay()
                nn_kernel.count_replay(self.launches[name])
        else:
            with (scope("lin", nests=False) if relinearize
                  else contextlib.nullcontext()):
                self.fns[name]()
        with scope("sync"), host_sync():
            accept, stop = self.b.flags.tolist()
        return accept, stop

    def capture(self) -> None:
        """Capture both step functions as CUDA graphs on a side stream,
        after one uncaptured run of each there (handles, workspaces and the
        kernel's build are made outside the capture) whose effect on the
        buffers is undone."""
        global CAPTURES
        dev = self.b.flags.device
        if dev not in _capture_streams:
            _capture_streams[dev] = torch.cuda.Stream(dev)
            _pools[dev] = torch.cuda.graph_pool_handle()
        stream, pool = _capture_streams[dev], _pools[dev]
        bufs = [t for t in vars(self.b).values()
                if isinstance(t, torch.Tensor)]
        kept = [t.clone() for t in bufs]
        graphs, launches = {}, {}
        with unclocked():
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                for fn in self.fns.values():
                    fn()
            torch.cuda.current_stream(dev).wait_stream(stream)
            for t, k in zip(bufs, kept):
                t.copy_(k)
            # no collection inside a capture: one that frees a dropped
            # program's graphs there destroys them mid-capture, which
            # invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                for name, fn in self.fns.items():
                    g = torch.cuda.CUDAGraph()
                    with nn_kernel.captured_launches() as counts:
                        with torch.cuda.graph(
                                g, pool=pool, stream=stream,
                                capture_error_mode="thread_local"):
                            fn()
                    graphs[name], launches[name] = g, dict(counts)
            finally:
                if collecting:
                    gc.enable()
        self.graphs, self.launches = graphs, launches
        CAPTURES += 1


def _program(programs: Optional[dict], key: tuple, ctx: FitContext,
             build) -> _Program:
    """The program of ``key`` in the caller's ``programs``, built anew when
    it is missing or reads another context; without ``programs``, one for
    this fit alone."""
    if programs is None:
        return build()
    prog = programs.get(key)
    if prog is None or not prog.reads(ctx):
        prog = programs[key] = build()
    return prog


def _scalar(v, dtype, dev) -> torch.Tensor:
    """``v`` as a 0-d tensor on ``dev``, without a host-to-device copy
    for a Python number."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=dev)
    return torch.full((), float(v), dtype=dtype, device=dev)


def _put(buf: torch.Tensor, v) -> None:
    """Load a per-call number into its 0-d buffer."""
    if isinstance(v, torch.Tensor):
        buf.copy_(v.reshape(()))
    else:
        buf.fill_(float(v))


def _lm_buffers(ctx: FitContext, parents, match, D: int, dtype, dev
                ) -> SimpleNamespace:
    """The buffers both fits share: the search over buffers of its own,
    the candidate mask (when the context has one) and the visibility of
    the last search, the iterate and its forward pass, the loop state and
    flags, the bundle's common part, and the per-call prior weights and
    tolerance."""
    P = ctx.lbs.weights.shape[0]
    J = len(parents)
    K = ctx.lbs.shapedirs.shape[2]
    m = nn_kernel.static_match(match)
    N = m.dpts.shape[0]

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    return SimpleNamespace(
        match=m, vis=z(P, dt=torch.bool),
        cand=None if ctx.cand_mask is None else z(P, dt=torch.bool),
        beta_pose=z(), beta_shape=z(), ftol=z(), w_pt=z(),
        w_pl=z(), rots0=z(J, 3, 3),
        p=z(3), rots=z(J, 3, 3), w=z(K), x=z(P, 3), shaped=z(P, 3),
        j_init=z(J, 3), Rg=z(J, 3, 3), tg=z(J, 3), A=z(P, 3, 3),
        lam=z(), cost=z(), small_cnt=z(dt=torch.int32),
        accepted=z(dt=torch.int32), flags=z(2, dt=torch.bool),
        JtJ=z(D, D), Jtr=z(D), cost_lin=z(), n_matched=z(),
        corr=z(N, dt=torch.int32), wgt=z(N),
        corr_stable=z(dt=torch.bool),
        eye=torch.eye(D, dtype=dtype, device=dev))


def _iterate(b) -> tuple:
    """The buffers of the iterate (theta) and of its forward pass."""
    return (b.p, b.rots, b.w, b.x, b.shaped, b.j_init, b.Rg, b.tg, b.A)


def _load_lm(b, ctx, parents, match, theta0: Theta, use_jsr: bool, lam0,
             beta_pose, beta_shape, function_tolerance) -> None:
    """Per-fit setup into the buffers: the plan, the candidate mask, the
    prior weights, the starting iterate and its forward pass, and the loop
    state."""
    nn_kernel.load_match(b.match, match)
    if b.cand is not None:
        b.cand.copy_(ctx.cand_mask)
    _put(b.beta_pose, beta_pose)
    _put(b.beta_shape, beta_shape)
    _put(b.ftol, function_tolerance)
    b.rots0.copy_(theta0.rots)
    b.lam.fill_(lam0)
    b.cost.fill_(math.inf)
    b.small_cnt.zero_()
    b.accepted.zero_()
    b.corr.fill_(-2)
    with scope("lbs"):
        fwd = _forward(ctx, parents, theta0, use_jsr)
    for buf, v in zip(_iterate(b), tuple(theta0) + tuple(fwd)):
        buf.copy_(v)


def _solve(b, extra=None):
    """The Marquardt-damped step from the bundle, (delta, info):
    ``extra(d)`` adds a term to the damped matrix, ``d`` its floored
    diagonal."""
    d = torch.diagonal(b.JtJ)
    d = torch.maximum(d, 1e-3 * torch.max(d))
    M = b.JtJ + b.lam * torch.diag(d) + 1e-8 * b.eye
    if extra is not None:
        M = M + extra(d)
    L, info = torch.linalg.cholesky_ex(M)
    return -torch.cholesky_solve(b.Jtr[:, None], L)[:, 0], info


def _update(b, trial: Theta, trial_fwd, trial_cost, cost_floor: float,
            lam_min: float) -> None:
    """Accept or reject the trial, as the reference's loop body does:
    lambda, the stall count, the accepted count and the cost, the iterate
    and its forward pass by a device-side select, and the two flags the
    host reads."""
    cost = b.cost_lin
    accept = trial_cost < cost
    rel = torch.abs(cost - trial_cost) / torch.clamp(cost, min=cost_floor)
    small = (rel < b.ftol) & b.corr_stable
    small_cnt = torch.where(small, b.small_cnt + 1, 0)
    b.lam.copy_(torch.where(accept, torch.clamp(b.lam * 0.33, min=lam_min),
                            torch.clamp(b.lam * 6.0, max=1e6)))
    b.accepted.add_(accept.to(torch.int32))
    b.cost.copy_(torch.where(accept, trial_cost, cost))
    b.small_cnt.copy_(small_cnt)
    for buf, new in zip(_iterate(b), tuple(trial) + tuple(trial_fwd)):
        buf.copy_(torch.where(accept, new, buf))
    b.flags.copy_(torch.stack([accept, small_cnt >= 2]))


def _store(*pairs) -> None:
    for buf, v in pairs:
        buf.copy_(v)


def _run_loop(prog: _Program, n_steps: int, programs: Optional[dict],
              dev) -> None:
    """Up to ``n_steps`` LM steps, re-linearizing after each accepted step,
    ending when the stall count reaches 2: graphed on the card when the
    caller keeps the program and ``eager_steps`` is not active."""
    graphed = programs is not None and dev.type == "cuda" and \
        not getattr(_mode, "eager", False)
    relinearize = True
    for _ in range(n_steps):
        relinearize, stop = prog.run(relinearize, graphed)
        count("steps")
        if stop:
            break


def _part_counts(corr, data_part, NP: int) -> torch.Tensor:
    """[NP] int32 matched rows per part; wildcard matches (label NP) are
    excluded.  A comparison sum: ``bincount`` reads its maximum back."""
    pidx = torch.where((corr >= 0) & (data_part < NP),
                       torch.clamp(data_part, 0, NP - 1), NP).long()
    return torch.sum(pidx[:, None] == torch.arange(NP, device=corr.device),
                     dim=0, dtype=torch.int32)


def fit(ctx: FitContext, parents: Tuple[int, ...], data_pts: torch.Tensor,
        data_part: torch.Tensor, theta0: Theta, beta_pose, beta_shape,
        n_steps: int, use_jsr: bool = True, enable_occlusion: bool = True,
        chunk: int = 512, robust: bool = True, plane_weight=0.0,
        point_weight=1.0, function_tolerance: float = 1e-4,
        num_parts: int = 0, huber_k=1.5, robust_per_part: bool = False,
        beta_temp=0.0, clamp_angle=0.0, clamp_support=10.0,
        freeze_shape: bool = False, model_sorted: bool = False,
        wild_gate=0.15, wild_weight=1.0,
        programs: Optional[dict] = None) -> Tuple[Theta, FitDiag]:
    """Full avatar fit (the reference's AvatarOptimizer::optimize).

    data_pts [N,3] / data_part [N]; padding rows carry data_part < 0.  At
    N % 256 == 0 the NN runs over a part-sorted plan built once, else over
    the whole model axis every step.  Points labelled ``num_parts`` are
    wildcards: they match the nearest visible vertex of any part, gated at
    ``wild_gate`` meters and weighted ``wild_weight``.  ``programs``: the
    caller's dict of LM programs (see the module docstring); without it
    the steps run uncaptured.
    """
    dtype, dev = data_pts.dtype, data_pts.device
    parents = tuple(parents)
    P = ctx.lbs.weights.shape[0]
    J_all = len(parents)
    K_all = ctx.lbs.shapedirs.shape[2]
    D_fit = 3 + 3 * J_all if freeze_shape else 3 + 3 * J_all + K_all
    NP = num_parts or J_all            # also the wildcard label id
    per_part = robust and robust_per_part

    # renormalize the incoming rotations (the reference's quaternion
    # round-trip does this each optimize() call, AvatarOptimizer.cpp:1249)
    theta0 = Theta(p=theta0.p, rots=rotation.quat_to_mat(
        rotation.mat_to_quat(theta0.rots)), w=theta0.w)
    with scope("plan"):
        data_pts, data_part, match = correspond.matcher(
            data_pts, data_part, ctx.model_part, NP, chunk=chunk,
            model_sorted=model_sorted)
    key = ("fit", parents, dtype, dev, nn_kernel.match_key(match), NP, D_fit,
           robust, per_part, enable_occlusion, use_jsr,
           ctx.cand_mask is not None)
    prog = _program(programs, key, ctx, lambda: _fit_program(
        ctx, parents, match, dtype, dev, NP, D_fit, robust, per_part,
        enable_occlusion, use_jsr))
    b = prog.b
    with scope("load"):
        _put(b.w_wild, wild_weight)
        _put(b.wild_gate2, _scalar(wild_gate, dtype, dev) ** 2)
        _put(b.w_pt, point_weight)
        _put(b.w_pl, plane_weight)
        _put(b.w_tmp, beta_temp)
        _put(b.huber_k, huber_k)
        if per_part:
            # one extra column: wildcards get their own robust-scale bucket
            b.part_oh.copy_(torch.nn.functional.one_hot(
                torch.clamp(data_part, 0, NP).long(), NP + 1).to(dtype) *
                (data_part >= 0).to(dtype)[:, None])
        if ctx.n_rest is None:
            # rest-pose normals once per fit; per step A_p rotates them
            shaped0, _ = shape_fwd(ctx.lbs, theta0.w, use_jsr)
            b.n_rest.copy_(_vertex_normals(shaped0, ctx.faces))
    _load_lm(b, ctx, parents, match, theta0, use_jsr, 1e-2, beta_pose,
             beta_shape, function_tolerance)
    _run_loop(prog, n_steps, programs, dev)

    corr_final = b.corr
    part_counts = _part_counts(corr_final, data_part, NP)
    # per-joint motion clamp for joints whose subtree matched almost no data
    matched_f = corr_final >= 0
    w_clamp = _scalar(clamp_angle, dtype, dev)
    cidx_f = torch.clamp(corr_final, min=0).long()
    vcnt = torch.zeros(P + 1, dtype=dtype, device=dev).index_add_(
        0, torch.where(matched_f, cidx_f, P),
        torch.ones_like(corr_final, dtype=dtype))[:-1]
    subtree_w = ctx.lbs.weights @ ctx.anc_mask.T                  # [P,J]
    support = vcnt @ subtree_w                                    # [J]
    aa_rel = rotation.so3_log(torch.einsum("jab,jcb->jac", b.rots,
                                           theta0.rots))
    ang = torch.linalg.norm(aa_rel, dim=-1, keepdim=True)
    lim = torch.where((support[:, None] < clamp_support) & (w_clamp > 0),
                      torch.clamp(w_clamp / torch.clamp(ang, min=1e-9),
                                  max=1.0), 1.0)
    rots_c = _bmm(rotation.so3_exp(aa_rel * lim), theta0.rots)
    theta = Theta(p=b.p.clone(), rots=rots_c, w=b.w.clone())
    return theta, FitDiag(cost=b.cost.clone(), n_matched=b.n_matched.clone(),
                          inner_iters=b.accepted.clone(),
                          part_counts=part_counts, corr=corr_final.clone())


def _fit_program(ctx: FitContext, parents, match, dtype, dev, NP: int,
                 D_fit: int, robust: bool, per_part: bool,
                 enable_occlusion: bool, use_jsr: bool) -> _Program:
    """The buffers and step functions of one ``fit`` configuration."""
    P = ctx.lbs.weights.shape[0]
    J_all = len(parents)
    K_all = ctx.lbs.shapedirs.shape[2]
    freeze_shape = D_fit < 3 + 3 * J_all + K_all
    occ_margin = 0.2
    b = _lm_buffers(ctx, parents, match, D_fit, dtype, dev)
    N = b.corr.shape[0]
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    b.w_tmp, b.huber_k, b.w_wild, b.wild_gate2 = z(), z(), z(), z()
    b.cidx = torch.zeros(N, dtype=torch.long, device=dev)
    b.vn, b.b3 = z(P, 3), z(3)
    b.rot_dims = z(D_fit)
    b.rot_dims[3:3 + 3 * J_all] = 1.0
    if per_part:
        b.part_oh = z(N, NP + 1)
    if ctx.n_rest is None:
        b.n_rest = z(P, 3)
    n_rest = ctx.n_rest if ctx.n_rest is not None else b.n_rest
    data_pts, data_part, m = b.match.dpts, b.match.dpart, b.match

    def cost_at(th, xf, cidx, wgt, vn, bp, bs, bt):
        rr = xf[cidx] - data_pts
        c_pt = 0.5 * torch.sum(wgt * torch.sum(rr * rr, -1))
        c_pl = 0.5 * torch.sum(wgt * torch.sum(vn[cidx] * rr, -1) ** 2)
        aa_t = rotation.so3_log(torch.einsum("jab,jcb->jac", th.rots,
                                             b.rots0))
        c_t = 0.5 * bt ** 2 * torch.sum(aa_t * aa_t)
        return (b.w_pt ** 2 * c_pt + b.w_pl ** 2 * c_pl + c_t +
                _prior_cost(ctx, th, bp, bs))

    def lin():
        """NN correspondence, robust weights, statistics, Jacobian, gram
        and gradient, and the cost, all at the current iterate, into the
        bundle; then the step."""
        theta = Theta(b.p, b.rots, b.w)
        fwd = (b.x, b.shaped, b.j_init, b.Rg, b.tg, b.A)
        x, A, Rg = b.x, b.A, b.Rg
        with scope("vis"):
            vn = torch.einsum("pab,pb->pa", A, n_rest)
            vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(
                min=1e-12)
            if enable_occlusion:
                vis = vn[:, 2] < occ_margin
            else:
                vis = torch.ones(P, dtype=torch.bool, device=dev)
            if b.cand is not None:
                vis = vis & b.cand
        with scope("nn"):
            corr = correspond.search(m, x, vis, NP, b.wild_gate2)
        with scope("weights"):
            valid = corr >= 0
            cidx = torch.clamp(corr, min=0).long()

            if robust:
                r0 = x[cidx] - data_pts
                dist = torch.sqrt(torch.sum(r0 * r0, -1) + 1e-12)
                if per_part:
                    vw = valid.to(dtype)
                    acc = b.part_oh.T @ torch.stack([dist * vw, vw], dim=1)
                    mean_p = acc[:, 0] / torch.clamp(acc[:, 1], min=1.0)
                    delta_h = torch.clamp(b.huber_k * (b.part_oh @ mean_p),
                                          min=1e-3)
                else:
                    big = torch.where(valid, dist,
                                      torch.full_like(dist, math.nan))
                    med = torch.nan_to_num(_nanmedian(big), nan=0.01)
                    delta_h = torch.clamp(b.huber_k * med, min=1e-3)
                wgt = torch.where(valid, torch.clamp(delta_h / dist, max=1.0),
                                  torch.zeros_like(dist))
            else:
                wgt = valid.to(dtype)
            # label-free wildcard matches carry reduced weight
            wgt = wgt * torch.where(data_part == NP, b.w_wild, 1.0)

            idx = torch.where(valid, cidx, P)
            cs = torch.zeros((P + 1, 4), dtype=dtype, device=dev).index_add_(
                0, idx, torch.cat([wgt[:, None], data_pts * wgt[:, None]],
                                  1))[:-1]
            cnt = cs[:, 0]
            s = cs[:, 1:]

            n_matched = torch.sum(valid.to(dtype))
            scale = torch.sqrt(torch.clamp(n_matched, min=1.0)) / 15.0
            bp = b.beta_pose * scale
            bs = b.beta_shape * scale
            bt = b.w_tmp * scale

        with scope("cost"):
            cost = cost_at(theta, x, cidx, wgt, vn, bp, bs, bt)
        with scope("jacobian"):
            Jm = _icp_jacobian(ctx, parents, theta, fwd,
                               with_shape=not freeze_shape)           # [P,3,D]
        with scope("gram"):
            w_pt2, w_pl2 = b.w_pt ** 2, b.w_pl ** 2
            rhs = cnt[:, None] * x - s                                # [P,3]
            sq = torch.sqrt(torch.clamp(cnt, min=0.0))
            Jw = (Jm * sq[:, None, None]).reshape(-1, D_fit)
            JtJ = w_pt2 * (Jw.T @ Jw)
            Jtr = w_pt2 * (Jm.reshape(-1, D_fit).T @ rhs.reshape(-1))
            Jpl = torch.einsum("pc,pci->pi", vn, Jm)                  # [P,D]
            Jplw = Jpl * sq[:, None]
            JtJ = JtJ + w_pl2 * (Jplw.T @ Jplw)
            Jtr = Jtr + w_pl2 * (Jpl.T @ torch.sum(vn * rhs, -1))
            pJtJ, pJtr = _prior_terms(ctx, parents, theta, Rg, bp, bs)
            JtJ = JtJ + pJtJ[:D_fit, :D_fit]
            Jtr = Jtr + pJtr[:D_fit]
            # temporal pose prior: residual log(R_j R_j0^T), Jacobian C_j^T
            aa_t = rotation.so3_log(torch.einsum("jab,jcb->jac", theta.rots,
                                                 b.rots0))
            JtJ = JtJ + bt ** 2 * torch.diag(b.rot_dims)
            Cmat = _parent_frames(Rg, parents)
            Jtr = Jtr.clone()
            Jtr[3:3 + 3 * J_all] += bt ** 2 * torch.einsum(
                "jab,jb->ja", Cmat, aa_t).reshape(-1)
            corr_stable = torch.all(corr == b.corr)
        _store((b.JtJ, JtJ), (b.Jtr, Jtr), (b.cost_lin, cost),
               (b.n_matched, n_matched), (b.corr, corr), (b.cidx, cidx),
               (b.wgt, wgt), (b.vn, vn), (b.b3, torch.stack([bp, bs, bt])),
               (b.vis, vis), (b.corr_stable, corr_stable))
        solve_try()

    def step():
        # a rejected step leaves theta unchanged: the bundle is kept and the
        # correspondences are trivially stable
        b.corr_stable.fill_(True)
        solve_try()

    def solve_try():
        theta = Theta(b.p, b.rots, b.w)
        bp, bs, bt = b.b3[0], b.b3[1], b.b3[2]
        with scope("solve"):
            delta, info = _solve(b)
            # a failed factorization yields NaN, as the reference's does: the
            # trial cost is NaN and the step is rejected
            delta = torch.where(info == 0, delta,
                                torch.full_like(delta, math.nan))
            if freeze_shape:
                delta = torch.cat([delta, torch.zeros(K_all, dtype=dtype,
                                                      device=dev)])
            trial = _retract(theta, delta, b.Rg, parents)
        with scope("trial"):
            with scope("lbs"):
                trial_fwd = _forward(ctx, parents, trial, use_jsr)
            trial_cost = cost_at(trial, trial_fwd[0], b.cidx, b.wgt, b.vn,
                                 bp, bs, bt)
            _update(b, trial, trial_fwd, trial_cost, 1e-12, 1e-7)

    keep = (fk_indices(parents, dev), _parent_index(parents, dev))
    return _Program(ctx, b, lin, step, NP, keep)


def fit_refine(ctx: FitContext, parents: Tuple[int, ...],
               ring_faces: torch.Tensor, data_pts: torch.Tensor,
               data_part: torch.Tensor, theta0: Theta, beta_pose,
               beta_shape, n_steps: int = 10, use_jsr: bool = True,
               enable_occlusion: bool = True, chunk: int = 512,
               num_parts: int = 0, plane_weight=1.0, point_weight=0.2,
               function_tolerance: float = 1e-7, huber_k=4.0, trim_k=20.0,
               wild: int = -1000, wild_gate2=None,
               freeze_shape: bool = False,
               programs: Optional[dict] = None) -> Tuple[Theta, FitDiag]:
    """High-exactness fit: point-to-MESH ICP (see the reference's
    docstring).  Each data point matches the closest point on the one-ring
    surface of its NN vertex (``optim/surface.py``); residuals are
    r_n = sum_i b_i x_{v_i} - d_n and its face-normal component.

    ``ring_faces`` comes from ``surface.vertex_face_rings``.  The NN plan
    (N % 256 == 0) is over the full, unsorted model axis (``mperm``), as
    the reference builds it; other N take ``correspond.find_nn_stats``.
    Unlike the reference, ``part_counts`` excludes wildcard matches
    (label ``num_parts``), as ``fit`` does.  ``programs`` as for ``fit``.
    """
    dtype, dev = data_pts.dtype, data_pts.device
    parents = tuple(parents)
    theta0 = Theta(p=theta0.p, rots=rotation.quat_to_mat(
        rotation.mat_to_quat(theta0.rots)), w=theta0.w)
    NP = num_parts or len(parents)
    with scope("plan"):
        data_pts, data_part, match = correspond.matcher(
            data_pts, data_part, ctx.model_part, NP, chunk=chunk)
    key = ("refine", parents, dtype, dev, nn_kernel.match_key(match),
           tuple(ring_faces.shape), wild, wild_gate2 is None, freeze_shape,
           enable_occlusion, use_jsr, ctx.cand_mask is not None)
    prog = _program(programs, key, ctx, lambda: _refine_program(
        ctx, parents, match, tuple(ring_faces.shape), dtype, dev, wild,
        wild_gate2 is not None, freeze_shape, enable_occlusion, use_jsr))
    b = prog.b
    with scope("load"):
        b.ring.copy_(ring_faces)
        _put(b.w_pt, point_weight)
        _put(b.w_pl, plane_weight)
        _put(b.huber_k, huber_k)
        _put(b.trim_k, trim_k)
        if wild_gate2 is not None:
            _put(b.wild_gate2, wild_gate2)
        if ctx.n_rest is None:
            shaped0, _ = shape_fwd(ctx.lbs, theta0.w, use_jsr)
            b.n_rest.copy_(_vertex_normals(shaped0, ctx.faces))
    _load_lm(b, ctx, parents, match, theta0, use_jsr, 1e-4, beta_pose,
             beta_shape, function_tolerance)
    _run_loop(prog, n_steps, programs, dev)

    part_counts = _part_counts(b.corr, data_part, NP)
    theta = Theta(p=b.p.clone(), rots=b.rots.clone(), w=b.w.clone())
    return theta, FitDiag(cost=b.cost.clone(), n_matched=b.n_matched.clone(),
                          inner_iters=b.accepted.clone(),
                          part_counts=part_counts, corr=b.corr.clone())


def _refine_program(ctx: FitContext, parents, match, ring_shape, dtype, dev,
                    wild: int, gated: bool, freeze_shape: bool,
                    enable_occlusion: bool, use_jsr: bool) -> _Program:
    """The buffers and step functions of one ``fit_refine``
    configuration."""
    from avatar_tpu_torch.optim.surface import surface_correspond

    P = ctx.lbs.weights.shape[0]
    J_all = len(parents)
    D_all = 3 + 3 * J_all + ctx.lbs.shapedirs.shape[2]
    nk = D_all - (3 + 3 * J_all)
    occ_margin = 0.2
    b = _lm_buffers(ctx, parents, match, D_all, dtype, dev)
    N = b.corr.shape[0]
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    b.huber_k, b.trim_k = z(), z()
    b.ring = torch.zeros(ring_shape, dtype=torch.int32, device=dev)
    b.tri_idx = torch.zeros((N, 3), dtype=torch.long, device=dev)
    b.bary, b.fnrm, b.b2 = z(N, 3), z(N, 3), z(2)
    b.fmask = z(D_all)
    b.fmask[D_all - nk:] = 1.0
    if gated:
        b.wild_gate2 = z()
    if ctx.n_rest is None:
        b.n_rest = z(P, 3)
    n_rest = ctx.n_rest if ctx.n_rest is not None else b.n_rest
    data_pts, m = b.match.dpts, b.match

    def surf(xf, tri_idx, bary):
        return torch.sum(bary[..., None] * xf[tri_idx], dim=1)

    def cost_at(th, xf, tri_idx, bary, fnrm, wgt, bp, bs):
        rr = surf(xf, tri_idx, bary) - data_pts
        c_pt = 0.5 * torch.sum(wgt * torch.sum(rr * rr, -1))
        c_pl = 0.5 * torch.sum(wgt * torch.sum(fnrm * rr, -1) ** 2)
        return b.w_pt ** 2 * c_pt + b.w_pl ** 2 * c_pl + _prior_cost(
            ctx, th, bp, bs)

    def lin():
        """Surface correspondence, robust weights, the mass-lumped gram,
        the exact gradient and the cost, all at the current iterate, into
        the bundle; then the step."""
        theta = Theta(b.p, b.rots, b.w)
        fwd = (b.x, b.shaped, b.j_init, b.Rg, b.tg, b.A)
        x, A, Rg = b.x, b.A, b.Rg
        w_pt2, w_pl2 = b.w_pt ** 2, b.w_pl ** 2
        with scope("vis"):
            vn = torch.einsum("pab,pb->pa", A, n_rest)
            vn = vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp(
                min=1e-12)
            if enable_occlusion:
                vis = vn[:, 2] < occ_margin
                front = occ_margin
            else:
                vis = torch.ones(P, dtype=torch.bool, device=dev)
                front = None
            if b.cand is not None:
                vis = vis & b.cand
        with scope("nn"):
            corr = correspond.search(m, x, vis, wild,
                                     b.wild_gate2 if gated else None)
        with scope("surface"):
            tri_idx, bary, fnrm, valid = surface_correspond(
                data_pts, corr, x, ctx.faces, b.ring, front_margin=front)
        with scope("weights"):
            # Huber IRLS plus a hard trim on the current match distances; the
            # robust scale is the reference's sort-free one-round trimmed mean
            # (mean |r|, then the mean over |r| < 3 x that), not a median
            r_cur = surf(x, tri_idx, bary) - data_pts
            dist = torch.sqrt(torch.sum(r_cur * r_cur, -1) + 1e-16)
            vw = valid.to(dtype)
            nv = torch.clamp(torch.sum(vw), min=1.0)
            m0 = torch.sum(dist * vw) / nv
            keep = vw * (dist < 3.0 * m0).to(dtype)
            med = torch.sum(dist * keep) / torch.clamp(torch.sum(keep),
                                                       min=1.0)
            med = torch.where(med > 0, med, 1e-3)
            delta_h = torch.clamp(b.huber_k * med, min=2e-4)
            wgt = torch.where(valid, torch.clamp(delta_h / dist, max=1.0), 0.0)
            wgt = torch.where(dist > b.trim_k * med, 0.0, wgt)
            n_matched = torch.sum((wgt > 0).to(dtype))
            scale = torch.sqrt(torch.clamp(n_matched, min=1.0)) / 15.0
            bp = b.beta_pose * scale
            bs = b.beta_shape * scale

        with scope("cost"):
            cost = cost_at(theta, x, tri_idx, bary, fnrm, wgt, bp, bs)
        with scope("jacobian"):
            Jm = _icp_jacobian(ctx, parents, theta, fwd)           # [P,3,D]
        with scope("gram"):
            rpl = torch.sum(fnrm * r_cur, -1)                          # [N]
            # Normal equations without the data axis:
            #   gradient (exact):  J^T r = sum_p Jm[p]^T G[p],
            #     G[p] = sum_n w_n b_np (wpt^2 r_n + wpl^2 n_f rpl_n)
            #   gram (mass-lumped): sum_p Jm[p]^T W_p Jm[p],
            #     W_p = wpt^2 m_p I + wpl^2 sum_n w_n b_np n_f n_f^T
            # every per-datum sum reduces through ONE [3N, 13] index_add_
            nx, ny, nz = fnrm[:, 0], fnrm[:, 1], fnrm[:, 2]
            nn6 = torch.stack([nx * nx, ny * ny, nz * nz, nx * ny, nx * nz,
                               ny * nz], dim=-1)                       # [N,6]
            payload = torch.cat([torch.ones_like(wgt)[:, None], r_cur,
                                 fnrm * rpl[:, None], nn6], dim=-1)    # [N,13]
            bw = (bary * wgt[:, None]).reshape(-1)                     # [3N]
            acc = torch.zeros((P, 13), dtype=dtype, device=dev).index_add_(
                0, tri_idx.reshape(-1),
                bw[:, None] * payload.repeat_interleave(3, dim=0))     # [P,13]
            m_pt = acc[:, 0]
            G = w_pt2 * acc[:, 1:4] + w_pl2 * acc[:, 4:7]              # [P,3]
            a_, b_, c_, d_, e_, f_ = acc[:, 7:13].unbind(-1)
            Npp = torch.stack([a_, d_, e_, d_, b_, f_, e_, f_, c_],
                              dim=-1).reshape(-1, 3, 3)            # [P,3,3]
            eye3 = torch.eye(3, dtype=dtype, device=dev)
            W_p = w_pt2 * m_pt[:, None, None] * eye3 + w_pl2 * Npp
            JmW = torch.einsum("pab,pbd->pad", W_p, Jm)            # [P,3,D]
            Jflat = Jm.reshape(-1, D_all)
            JtJ = Jflat.T @ JmW.reshape(-1, D_all)
            Jtr = Jflat.T @ G.reshape(-1)
            pJtJ, pJtr = _prior_terms(ctx, parents, theta, Rg, bp, bs)
            corr_stable = torch.all(corr == b.corr)
        _store((b.JtJ, JtJ + pJtJ), (b.Jtr, Jtr + pJtr), (b.cost_lin, cost),
               (b.n_matched, n_matched), (b.corr, corr), (b.tri_idx, tri_idx),
               (b.bary, bary), (b.fnrm, fnrm), (b.wgt, wgt),
               (b.b2, torch.stack([bp, bs])), (b.vis, vis),
               (b.corr_stable, corr_stable))
        solve_try()

    def step():
        b.corr_stable.fill_(True)
        solve_try()

    def pin_shape(d):
        # in-tracker refine: pin the shape block of the FULL tangent with a
        # dominant diagonal penalty, so delta_w ~ 0
        return torch.diag(b.fmask * (1e6 * torch.max(d)))

    def solve_try():
        theta = Theta(b.p, b.rots, b.w)
        bp, bs = b.b2[0], b.b2[1]
        with scope("solve"):
            delta, info = _solve(b, pin_shape
                                 if freeze_shape and nk > 0 else None)
            delta = torch.where(info == 0, delta, math.nan)
            trial = _retract(theta, delta, b.Rg, parents)
        with scope("trial"):
            with scope("lbs"):
                trial_fwd = _forward(ctx, parents, trial, use_jsr)
            trial_cost = cost_at(trial, trial_fwd[0], b.tri_idx, b.bary,
                                 b.fnrm, b.wgt, bp, bs)
            _update(b, trial, trial_fwd, trial_cost, 1e-20, 1e-9)

    keep = (fk_indices(parents, dev), _parent_index(parents, dev))
    return _Program(ctx, b, lin, step, wild, keep)
