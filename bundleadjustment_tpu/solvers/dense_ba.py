"""Dense-layout bundle adjustment.

The flat observation-table engine (`solvers/lm.py`) leans on `segment_sum`
scatter-adds and large gathers.  This engine restructures the problem so
every reduction is a dense contraction:

- observations are grouped **by landmark** into rectangular blocks
  ``[L, O]`` (O = capped max observations per landmark, validity-masked), so
  every landmark-side quantity (V blocks, point gradients, back-substitution)
  is a dense reduction over the O axis — no scatter, no gather;
- camera-side reductions go through one-hot observation->camera matrix
  products, replacing both the camera gathers and the camera scatter-adds.

**Layout**: all per-observation tensors live in *component-major* form
``[components..., O, L]`` — the landmark axis L is the trailing (contiguous)
axis, so every elementwise op runs over full-width rows instead of
2- to 6-element component vectors.  The small component axes (2 residual
rows, 6 camera dofs, 3 point dofs) are unrolled in Python, which XLA fuses
into a handful of full-width loops; camera-side reductions become
``[C, O*L] @ [O*L, K]`` products whose one-hot operand is generated inline.
Every such product runs at full float32 precision (`utils/precision.py`):
a one-hot gather is exact only then.

The LM loop, Huber-IRLS weighting, cheirality penalty, Nielsen schedule, and
Schur-PCG structure mirror `solvers/lm.py` (numerical parity is tested);
only the data layout differs.

Replaces Ceres LM + DENSE_SCHUR (reference `ba_project/src/ba/Optimizer.cpp:80-90`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from bundleadjustment_tpu.geometry.se3 import aa_to_rotmat, rotmat_to_aa
from bundleadjustment_tpu.solvers.lm import CHEIRALITY_PENALTY, LMConfig
from bundleadjustment_tpu.solvers.residuals import HUBER_DELTA
from bundleadjustment_tpu.utils.precision import HIGHEST, einsum, mm


class DenseBAProblem(NamedTuple):
    K4: jnp.ndarray  # [4]
    cam_idx: jnp.ndarray  # [L, O] int32
    uv: jnp.ndarray  # [L, O, 2]
    sigma2: jnp.ndarray  # [L, O]
    valid: jnp.ndarray  # [L, O] bool
    cam_fixed: jnp.ndarray  # [K] bool
    pt_valid: jnp.ndarray  # [L] bool


def densify_problem(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                    n_points, max_obs=16):
    """Host-side regrouping of a flat observation table by landmark.

    Observations beyond `max_obs` per landmark are dropped (rare in SLAM maps;
    raise max_obs for dense reconstructions).  Returns (DenseBAProblem,
    n_dropped).
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    uv = np.asarray(uv)
    sigma2 = np.asarray(sigma2)
    valid = np.asarray(valid)

    L = n_points
    # vectorized grouping: stable-sort valid observations by landmark, rank
    # within each group, scatter ranks < max_obs into the dense slots
    vi = np.nonzero(valid)[0]
    p = pt_idx[vi]
    order = np.argsort(p, kind="stable")
    vi = vi[order]
    p = p[order]
    if len(p):
        starts = np.flatnonzero(np.r_[True, p[1:] != p[:-1]])
        sizes = np.diff(np.r_[starts, len(p)])
        ranks = np.arange(len(p)) - np.repeat(starts, sizes)
    else:
        ranks = np.zeros(0, np.int64)
    keep = ranks < max_obs
    dropped = int(len(p) - keep.sum())

    # trim the O axis to the ACTUAL max slots used (rounded up to a
    # multiple of 8): every [O, L] plane in the solver — eval, W carry,
    # Q expansion, accept/reject selects — scales with O, and a requested
    # max_obs of 16 on an 8-obs-per-landmark problem would double all of it
    # for all-invalid padding columns (measured 64c/10k: ~1.5x marginal)
    used = int(ranks[keep].max()) + 1 if keep.any() else 1
    max_obs = min(max_obs, max(8, ((used + 7) // 8) * 8))
    ci = np.zeros((L, max_obs), np.int32)
    uvd = np.zeros((L, max_obs, 2), np.float32)
    sg = np.ones((L, max_obs), np.float32)
    vd = np.zeros((L, max_obs), bool)
    lk, sk, nk = p[keep], ranks[keep], vi[keep]
    ci[lk, sk] = cam_idx[nk]
    uvd[lk, sk] = uv[nk]
    sg[lk, sk] = sigma2[nk]
    vd[lk, sk] = True
    slots = np.bincount(lk, minlength=L)

    return (
        DenseBAProblem(
            K4=jnp.asarray(np.asarray(K4, np.float32)),
            cam_idx=jnp.asarray(ci),
            uv=jnp.asarray(uvd),
            sigma2=jnp.asarray(sg),
            valid=jnp.asarray(vd),
            cam_fixed=jnp.asarray(np.asarray(cam_fixed, bool)),
            pt_valid=jnp.asarray(slots > 0),
        ),
        dropped,
    )


def densify_problem_auto(K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed,
                         n_points, max_obs=16, max_obs_cap=512):
    """densify_problem with max_obs auto-raised (doubling, up to
    max_obs_cap) until no observation is dropped: a landmark observed by
    more than max_obs keyframes must not silently lose constraints.
    Returns (DenseBAProblem, n_dropped, max_obs_used)."""
    while True:
        dense, dropped = densify_problem(
            K4, cam_idx, pt_idx, uv, sigma2, valid, cam_fixed, n_points,
            max_obs=max_obs,
        )
        if dropped == 0 or max_obs >= max_obs_cap:
            # report the ACTUAL O (densify trims trailing unused slots)
            return dense, dropped, int(dense.cam_idx.shape[1])
        max_obs *= 2


# ---------------------------------------------------------------------------
# component-major internals
# ---------------------------------------------------------------------------


class _CM(NamedTuple):
    """The dense problem transposed to component-major [.., O, L] layout."""

    K4: jnp.ndarray
    cam_t: jnp.ndarray  # [O, L] int32
    uv_t: jnp.ndarray  # [2, O, L]
    inv_sigma_t: jnp.ndarray  # [O, L]
    inv_sigma2_t: jnp.ndarray  # [O, L]
    valid_t: jnp.ndarray  # [O, L] bool
    fixed_t: jnp.ndarray  # [O, L] bool (observation's camera is fixed)
    cam_fixed: jnp.ndarray  # [K]
    pt_valid: jnp.ndarray  # [L]


def _to_cm(prob: DenseBAProblem) -> _CM:
    sigma2 = jnp.maximum(prob.sigma2, 1e-12)
    return _CM(
        K4=prob.K4,
        cam_t=prob.cam_idx.T,
        uv_t=jnp.transpose(prob.uv, (2, 1, 0)),
        inv_sigma_t=(1.0 / jnp.sqrt(sigma2)).T,
        inv_sigma2_t=(1.0 / sigma2).T,
        valid_t=prob.valid.T,
        fixed_t=prob.cam_fixed[prob.cam_idx].T,
        cam_fixed=prob.cam_fixed,
        pt_valid=prob.pt_valid,
    )


def _oh(cm: _CM, K, dtype):
    """One-hot [K, O*L] camera-membership matrix, generated inline from
    cam_t for the consuming product."""
    flat = cm.cam_t.reshape(1, -1)
    return (jnp.arange(K, dtype=cm.cam_t.dtype)[:, None] == flat).astype(dtype)


def _gather_cams(M, cm: _CM):
    """[K, C] camera table -> [C, O, L] per-observation values."""
    O, L = cm.cam_t.shape
    out = einsum("kc,kn->cn", M, _oh(cm, M.shape[0], M.dtype))
    return out.reshape(M.shape[1], O, L)


def _reduce_cams(G, cm: _CM, K, bf16=False):
    """[C, O, L] per-observation values -> [K, C] camera sums."""
    C = G.shape[0]
    Gf = G.reshape(C, -1)
    if bf16:
        return jnp.einsum(
            "cn,kn->kc", Gf.astype(jnp.bfloat16), _oh(cm, K, jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return einsum("cn,kn->kc", Gf, _oh(cm, K, Gf.dtype))


def _project_cm(cm: _CM, R, t, Xt):
    """Project all observations.  Returns (x_cam [3,O,L], Rg [3,3,O,L],
    u [O,L], v [O,L], z [O,L])."""
    K = R.shape[0]
    Rt = jnp.concatenate([R.reshape(K, 9), t], axis=1)  # [K, 12]
    g = _gather_cams(Rt, cm)  # [12, O, L]
    Rg = g[:9].reshape(3, 3, *cm.cam_t.shape)
    tg = g[9:]
    RX = jnp.stack(
        [sum(Rg[i, j] * Xt[j][None, :] for j in range(3)) for i in range(3)]
    )
    x_cam = RX + tg
    z = x_cam[2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    inv_z = 1.0 / zs
    fx, fy, cx, cy = cm.K4[0], cm.K4[1], cm.K4[2], cm.K4[3]
    u = fx * x_cam[0] * inv_z + cx
    v = fy * x_cam[1] * inv_z + cy
    return x_cam, RX, Rg, u, v, z, inv_z


def _eval_cm(cm: _CM, R, t, Xt, robust):
    """One fused pass: robust cost + residuals + Jacobians at (R, t, Xt).

    Returns (cost, r [2,O,L], Jc [2,6,O,L], Jp [2,3,O,L]).  The LM scan
    evaluates every trial point exactly once: the cost decides accept/reject
    and the residual/Jacobian blocks are carried into the next iteration if
    accepted — the projection and residual work is never repeated (the split
    cost-then-Jacobians form paid a second full projection pass per
    iteration).  Mirrors the math of the reference's AngleReprojectionError
    (`ba_project/src/ba/Optimizer.h:49-88`) with a left-multiplicative so(3)
    perturbation.
    """
    x_cam, RX, Rg, u, v, z, inv_z = _project_cm(cm, R, t, Xt)
    fx, fy = cm.K4[0], cm.K4[1]
    isig = cm.inv_sigma_t
    r = jnp.stack([(u - cm.uv_t[0]) * isig, (v - cm.uv_t[1]) * isig])

    # robust cost from the sigma-weighted residuals (matches the reference's
    # Huber(sqrt(5.991)) objective, `ba_project/src/ba/Optimizer.cpp:312`)
    r2 = r[0] ** 2 + r[1] ** 2
    if robust:
        nrm2 = jnp.sqrt(jnp.maximum(r2, 1e-20))
        rho = jnp.where(nrm2 <= HUBER_DELTA, 0.5 * r2,
                        HUBER_DELTA * (nrm2 - 0.5 * HUBER_DELTA))
    else:
        rho = 0.5 * r2
    rho = jnp.where(z > 1e-6, rho, CHEIRALITY_PENALTY)
    cost = jnp.sum(jnp.where(cm.valid_t, rho, 0.0))

    zero = jnp.zeros_like(inv_z)
    # duv_dx [2, 3, O, L] (including inv_sigma weighting)
    duv_dx = jnp.stack([
        jnp.stack([fx * inv_z * isig, zero,
                   -fx * x_cam[0] * inv_z * inv_z * isig]),
        jnp.stack([zero, fy * inv_z * isig,
                   -fy * x_cam[1] * inv_z * inv_z * isig]),
    ])
    # neg_skew(RX) [3, 3, O, L]
    RXx, RXy, RXz = RX[0], RX[1], RX[2]
    zeros = jnp.zeros_like(RXx)
    neg_skew = jnp.stack([
        jnp.stack([zeros, RXz, -RXy]),
        jnp.stack([-RXz, zeros, RXx]),
        jnp.stack([RXy, -RXx, zeros]),
    ])
    J_phi = jnp.stack([
        jnp.stack([sum(duv_dx[a, m] * neg_skew[m, j] for m in range(3))
                   for j in range(3)])
        for a in range(2)
    ])  # [2, 3, O, L]
    Jp = jnp.stack([
        jnp.stack([sum(duv_dx[a, m] * Rg[m, j] for m in range(3))
                   for j in range(3)])
        for a in range(2)
    ])  # [2, 3, O, L]
    Jc = jnp.concatenate([J_phi, duv_dx], axis=1)  # [2, 6, O, L]

    mask = cm.valid_t & (z > 1e-6)
    w = jnp.where(mask, 1.0, 0.0)
    if robust:
        nrm = jnp.sqrt(jnp.maximum(r2, 1e-24))
        w = w * jnp.where(nrm <= HUBER_DELTA, 1.0, HUBER_DELTA / nrm)
    sw = jnp.sqrt(w)
    r = jnp.where(mask, r * sw, 0.0)
    Jc = Jc * jnp.where(cm.fixed_t, 0.0, sw)
    Jp = Jp * sw
    return cost, r, Jc, Jp


def _sym3_inv_cm(V):
    """Closed-form symmetric 3x3 inverse, component-major: V [3,3,L]."""
    a, b, c = V[0, 0], V[0, 1], V[0, 2]
    d, e, f = V[1, 1], V[1, 2], V[2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    return jnp.stack([
        jnp.stack([A, B, C]),
        jnp.stack([B, D, E]),
        jnp.stack([C, E, F]),
    ]) * inv_det


def _chol3_cm(V):
    """Closed-form lower Cholesky of SPD 3x3, component-major: V [3,3,L]."""
    a, b, c = V[0, 0], V[0, 1], V[0, 2]
    d, e, f = V[1, 1], V[1, 2], V[2, 2]
    l00 = jnp.sqrt(jnp.maximum(a, 1e-20))
    l10 = b / l00
    l20 = c / l00
    l11 = jnp.sqrt(jnp.maximum(d - l10 * l10, 1e-20))
    l21 = (e - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(f - l20 * l20 - l21 * l21, 1e-20))
    zero = jnp.zeros_like(a)
    return jnp.stack([
        jnp.stack([l00, zero, zero]),
        jnp.stack([l10, l11, zero]),
        jnp.stack([l20, l21, l22]),
    ])


def _mat3vec_cm(M, x):
    """[3,3,L] @ [3,L] -> [3,L]."""
    return jnp.stack([sum(M[i, j] * x[j] for j in range(3)) for i in range(3)])


_TRIU6 = [(i, j) for i in range(6) for j in range(i, 6)]  # 21 unique entries
# [6, 6] map from (i, j) to its upper-triangle slot: one gather rebuilds the
# full symmetric matrix from the 21 reduced rows
_SYM6_IDX = np.zeros((6, 6), np.int32)
for _n, (_i, _j) in enumerate(_TRIU6):
    _SYM6_IDX[_i, _j] = _SYM6_IDX[_j, _i] = _n
_TRIU3 = [(i, j) for i in range(3) for j in range(i, 3)]  # 6 unique entries
_SYM3_IDX = np.zeros((3, 3), np.int32)
for _n, (_i, _j) in enumerate(_TRIU3):
    _SYM3_IDX[_i, _j] = _SYM3_IDX[_j, _i] = _n


def _assemble_cm(cm: _CM, r, Jc, Jp, psum, bf16=False):
    """Undamped block reductions from component-major residuals/Jacobians:
    red [K,27] (21 upper-triangle U rows + 6 g_c rows), Vu [6,L], g_p [3,L],
    W [6,3,O,L].  None of these depend on the LM damping, so the scan carries
    THEM (not r/Jc/Jp): damping is re-applied per iteration by
    `_damp_blocks_cm` on the small reduced arrays, and a rejected iteration
    never re-touches the [O, L] planes."""
    K = cm.cam_fixed.shape[0]
    # camera-side: U is symmetric -> stack only its 21 upper-triangle
    # products + 6 gradient rows into one [27, O*L] @ [O*L, K] matmul
    # (vs 36+6: a third less elementwise work and fewer product rows)
    rows = [sum(Jc[a, i] * Jc[a, j] for a in range(2)) for i, j in _TRIU6]
    rows += [sum(Jc[a, i] * r[a] for a in range(2)) for i in range(6)]
    stacked = jnp.stack(rows)  # [27, O, L]
    red = psum(_reduce_cams(stacked, cm, K, bf16=bf16))  # [K, 27]

    # V symmetric likewise: 6 unique [L] reductions, one stack + gather
    Vu = jnp.stack([
        jnp.sum(Jp[0, i] * Jp[0, j] + Jp[1, i] * Jp[1, j], axis=0)
        for i, j in _TRIU3
    ])  # [6, L]
    g_p = jnp.stack([jnp.sum(Jp[0, i] * r[0] + Jp[1, i] * r[1], axis=0)
                     for i in range(3)])  # [3, L]
    W = jnp.stack([
        jnp.stack([Jc[0, i] * Jp[0, j] + Jc[1, i] * Jp[1, j]
                   for j in range(3)])
        for i in range(6)
    ])  # [6, 3, O, L]
    return red, Vu, g_p, W


def _damp_U_cm(cm: _CM, red, lam):
    """LM-damped camera blocks U [K,6,6], g_c [K,6] from the reduced rows."""
    U = red[:, _SYM6_IDX]  # [K, 6, 6] via one gather
    g_c = red[:, 21:]
    eye6 = jnp.eye(6, dtype=U.dtype)
    dU = jnp.clip(jnp.diagonal(U, axis1=-2, axis2=-1), 1e-6, None)
    U = U + (lam * dU)[..., None] * eye6
    U = jnp.where(cm.cam_fixed[:, None, None], eye6, U)
    g_c = jnp.where(cm.cam_fixed[:, None], 0.0, g_c)
    return U, g_c


def _damp_blocks_cm(cm: _CM, red, Vu, lam):
    """LM-damped U [K,6,6], g_c [K,6], V [3,3,L] from the reduced rows."""
    U, g_c = _damp_U_cm(cm, red, lam)
    V = Vu[_SYM3_IDX]  # [3, 3, L]
    dV = jnp.stack([jnp.clip(V[i, i], 1e-6, None) for i in range(3)])
    V = V + lam * dV[:, None, :] * jnp.eye(3)[:, :, None]
    V = jnp.where(cm.pt_valid[None, None, :], V, jnp.eye(3)[:, :, None])
    return U, g_c, V


def _sym6_matvec(v6, x):
    """y = M x with M the symmetric 3x3 packed as rows (00,01,02,11,12,22);
    v6 [6, L], x [3, L] -> [3, L]."""
    return jnp.stack([
        v6[0] * x[0] + v6[1] * x[1] + v6[2] * x[2],
        v6[1] * x[0] + v6[3] * x[1] + v6[4] * x[2],
        v6[2] * x[0] + v6[4] * x[1] + v6[5] * x[2],
    ])


def _w_reduce(W, x_obs):
    """y[j,l] = sum_{i,o} W[i,j,o,l] * x_obs[i,o,l]  -> [3, L]."""
    return jnp.stack([
        jnp.sum(sum(W[i, j] * x_obs[i] for i in range(6)), axis=0)
        for j in range(3)
    ])


def _w_apply(W, z_pt):
    """G[i,o,l] = sum_j W[i,j,o,l] * z_pt[j,l]  -> [6, O, L]."""
    return jnp.stack([
        sum(W[i, j] * z_pt[j][None, :] for j in range(3)) for i in range(6)
    ])


def _schur_pf(cm: _CM, W, V_inv, bf16=False):
    """Pf[l, k, i, m] = sum_o oh[k,o,l] (W[l,o] @ chol(V^-1)[l])[i,m]: the
    camera-expanded factor Q of the Schur complement, batched over
    landmarks ([L, K, 6, 3])."""
    K = cm.cam_fixed.shape[0]
    O, L = cm.cam_t.shape
    C = _chol3_cm(V_inv)  # [3, 3, L]
    G = jnp.stack([
        jnp.stack([sum(W[i, j] * C[j, m][None, :] for j in range(3))
                   for m in range(3)])
        for i in range(6)
    ])  # [6, 3, O, L]
    pf_dtype = jnp.bfloat16 if bf16 else G.dtype
    return jax.lax.dot_general(
        (jnp.arange(K)[:, None, None] == cm.cam_t[None]).astype(pf_dtype),
        G.reshape(18, O, L).astype(pf_dtype),
        dimension_numbers=(((1,), (1,)), ((2,), (2,))),
        precision=None if bf16 else HIGHEST,
        preferred_element_type=pf_dtype,
    ).reshape(L, K, 6, 3)


def _schur_qqt(Pf):
    """Q Q^T [K, 6, K, 6], contracted directly over (landmark, point-dof).
    XLA:GPU still writes a transposed copy of Pf for the product (the
    second-largest kernel at 128 cameras / 100k landmarks, PERF.md)."""
    return jax.lax.dot_general(
        Pf, Pf,
        dimension_numbers=(((0, 3), (0, 3)), ((), ())),
        precision=None if Pf.dtype == jnp.bfloat16 else HIGHEST,
        preferred_element_type=jnp.float32,
    )


def _make_step(cm: _CM, config: LMConfig, psum=None):
    """Build the (step, eval_assemble) pair for `lax.scan`.  `psum` is the
    cross-shard reduction hook: None single-device, `lax.psum` inside
    shard_map.  `eval_assemble(R, t, Xt) -> (cost, red, Vu, g_p, W)` seeds
    the scan state; `step` carries the trial point's REDUCED blocks forward
    on acceptance (damping is independent of them, see _assemble_cm)."""
    if psum is None:
        psum = lambda x: x
    K = cm.cam_fixed.shape[0]
    bf16 = config.mxu_bf16

    def eval_assemble(R, t, Xt):
        cost, r, Jc, Jp = _eval_cm(cm, R, t, Xt, config.robust)
        red, Vu, g_p, W = _assemble_cm(cm, r, Jc, Jp, psum, bf16=bf16)
        return psum(cost), red, Vu, g_p, W

    def solve_cameras(U, g_c, V_inv, g_p, W):
        zv = _mat3vec_cm(V_inv, g_p)
        red = psum(_reduce_cams(_w_apply(W, zv), cm, K, bf16=bf16))  # [K, 6]
        b = -(g_c - red)

        if config.solver == "dense":
            # exact DENSE_SCHUR: S = U_diag - Q Q^T
            S = -psum(_schur_qqt(_schur_pf(cm, W, V_inv, bf16=bf16)))
            idx = jnp.arange(K)
            S = S.at[idx, :, idx, :].add(U)
            S = S.reshape(K * 6, K * 6) + 1e-8 * jnp.eye(K * 6, dtype=S.dtype)
            dc = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(S), b.reshape(-1)
            ).reshape(K, 6)
        else:
            Minv = jnp.linalg.inv(U)

            def matvec(x):
                xg = _gather_cams(x, cm)  # [6, O, L]
                zz = _mat3vec_cm(V_inv, _w_reduce(W, xg))
                back = psum(_reduce_cams(_w_apply(W, zz), cm, K, bf16=bf16))
                Ux = einsum("kij,kj->ki", U, x)
                return Ux - back

            def cg_body(s, _):
                x, rr, p, rz = s
                Sp = matvec(p)
                pSp = jnp.sum(p * Sp)
                alpha = rz / jnp.where(jnp.abs(pSp) < 1e-30, 1e-30, pSp)
                x = x + alpha * p
                rr = rr - alpha * Sp
                zp = einsum("kij,kj->ki", Minv, rr)
                rz_new = jnp.sum(rr * zp)
                beta = rz_new / jnp.where(jnp.abs(rz) < 1e-30, 1e-30, rz)
                return (x, rr, zp + beta * p, rz_new), None

            x0 = jnp.zeros_like(b)
            z0 = einsum("kij,kj->ki", Minv, b)
            (dc, _, _, _), _ = jax.lax.scan(
                cg_body, (x0, b, z0, jnp.sum(b * z0)), None,
                length=config.pcg_iters,
            )
        return dc

    def step(state, _):
        R, t, Xt, lam, nu, cost, done, red, Vu, g_p, W = state
        U, g_c, V = _damp_blocks_cm(cm, red, Vu, lam)
        V_inv = _sym3_inv_cm(V)
        dc = solve_cameras(U, g_c, V_inv, g_p, W)
        # back-substitution (fully local per landmark)
        xg = _gather_cams(dc, cm)
        y = _w_reduce(W, xg)
        dp = -_mat3vec_cm(V_inv, g_p + y)  # [3, L]
        dp = jnp.where(cm.pt_valid[None, :], dp, 0.0)

        dphi = jnp.where(cm.cam_fixed[:, None], 0.0, dc[:, :3])
        dt = jnp.where(cm.cam_fixed[:, None], 0.0, dc[:, 3:])
        R_new = mm(aa_to_rotmat(dphi), R)
        t_new = t + dt
        Xt_new = Xt + dp

        new_cost, red_new, Vu_new, gp_new, W_new = eval_assemble(
            R_new, t_new, Xt_new)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        sel = lambda a, b2: jnp.where(accept & ~done, a, b2)
        rel = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        return (
            sel(R_new, R), sel(t_new, t), sel(Xt_new, Xt),
            jnp.where(done, lam, jnp.where(accept, lam / 3.0, lam * nu)),
            jnp.where(done, nu, jnp.where(accept, 2.0, nu * 2.0)),
            sel(new_cost, cost),
            done | (accept & (rel < config.rtol)),
            sel(red_new, red), sel(Vu_new, Vu), sel(gp_new, g_p),
            sel(W_new, W),
        ), new_cost

    return step, eval_assemble


@partial(jax.jit, static_argnames=("config",))
def dense_ba_solve(prob: DenseBAProblem, cam_rt6, points, config=LMConfig()):
    """LM/Schur solve in the dense landmark-major layout.

    cam_rt6: [K, 6]; points: [L, 3].  Returns (cam_rt6', points', info).

    Memory note: the scan carry holds the accepted trial's REDUCED blocks
    (W [6,3,O,L] = 18*O*L floats + small red/Vu/g_p) so an accepted trial's
    eval+assembly is reused instead of recomputed; with the trial set live
    during the where-selects, the block planes take ~36*O*L*4 B transient
    (O=16, L=131072: ~300 MB).
    """
    cm = _to_cm(prob)
    R0 = aa_to_rotmat(cam_rt6[:, :3])
    t0 = cam_rt6[:, 3:]
    Xt0 = points.T

    step, eval_assemble = _make_step(cm, config)
    cost0, red0, Vu0, gp0, W0 = eval_assemble(R0, t0, Xt0)
    init = (
        R0, t0, Xt0, jnp.asarray(config.lam0, cost0.dtype),
        jnp.asarray(2.0, cost0.dtype), cost0, jnp.asarray(False),
        red0, Vu0, gp0, W0,
    )
    (R, t, Xt, _, _, cost, _, _, _, _, _), hist = jax.lax.scan(
        step, init, None, length=config.max_iters
    )
    cams_out = jnp.concatenate([rotmat_to_aa(R), t], -1)
    return cams_out, Xt.T, {"cost0": cost0, "cost": cost, "cost_history": hist}
