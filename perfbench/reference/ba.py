"""Plain reference of a bundle-adjustment solve: Levenberg-Marquardt with an
exact Schur complement, in float64 PyTorch.

It takes the problem as numpy arrays in the port's field names (the
benchmark's own generated data, never the program's packed state) and
imports nothing of the program.  The model is the configuration's:

  pc = R x + t, p = pc_xy / pc_z, OpenCV distortion (k1, k2, p1, p2),
  pixels (fx d_x + cx, fy d_y + cy); residual pixels - observation;
  Huber cost with knee h (r^2 inside, h (2|r| - h) outside), weighted by
  obs_w; an observation at depth <= 1e-3 takes the residual (12, 12)
  and weighs 0 in the normal equations.

Jacobians come from forward-mode differentiation of that residual (not
from any hand-derived chain), the point blocks are eliminated exactly
and the reduced camera system is solved densely by Cholesky.  Cameras
freeze as the port's flags say (fix_cam, fix_trans, fix_rot, and with
intrinsics fix_intri and a tied focal); cameras with one cam_kam share
their intrinsics.

`solve(..., control=True)` is the benchmark's control: the same solve in
float32 with every matrix product's operands rounded to TF32 (10 stored
mantissa bits, as a GPU's TF32 path does), the precision just below the
configuration's float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_BAD = 2.0 * 12.0 ** 2  # squared residual of an observation behind the camera


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (nearest, ties away from zero) by
    clearing the 13 low mantissa bits."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


@dataclasses.dataclass
class Arith:
    """Dtype and matrix product of a solve: float64 and exact products, or
    the control's float32 with TF32 operands."""

    dtype: torch.dtype
    control: bool

    def mm(self, a, b):
        if self.control:
            a, b = tf32(a), tf32(b)
        return torch.matmul(a, b)


def quat_to_rot(q):
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(R):
    """Rotation matrices -> unit quaternions (w, x, y, z) by Shepperd's
    largest-pivot rule."""
    m = R
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + tr, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2], 1 + 2 * m[..., 0, 0] - tr,
                     m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 + 2 * m[..., 1, 1] - tr, m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1], 1 + 2 * m[..., 2, 2] - tr], -1),
    ], dim=-2)
    piv = torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
    k = piv.argmax(-1)
    q = torch.gather(cands, -2, k[..., None, None].expand(
        k.shape + (1, 4)))[..., 0, :]
    q = q / q.norm(dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp(w):
    th = w.norm(dim=-1, keepdim=True)[..., None]
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    small = th < 1e-12
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, torch.ones_like(th), torch.sin(ths) / ths)
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1 - torch.cos(ths)) / (ths * ths))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                        -w[..., 1], w[..., 0], z], -1).reshape(
        w.shape[:-1] + (3, 3))


@dataclasses.dataclass
class State:
    R: torch.Tensor  # [C, 3, 3] world to camera
    t: torch.Tensor  # [C, 3]
    intri: torch.Tensor  # [C, 8] fx, fy, cx, cy, k1, k2, p1, p2
    X: torch.Tensor  # [P, 3]

    def to_numpy(self):
        """{cam_q, cam_t, cam_intri, points} as float64 numpy."""
        return dict(cam_q=rot_to_quat(self.R).double().cpu().numpy(),
                    cam_t=self.t.double().cpu().numpy(),
                    cam_intri=self.intri.double().cpu().numpy(),
                    points=self.X.double().cpu().numpy())


class Problem:
    """A problem's observations and freeze flags on a device, with the
    column layout of its free camera unknowns."""

    def __init__(self, arrays: dict, device, optimize_intrinsics: bool,
                 huber_px: float, arith: Arith):
        dt = arith.dtype
        self.a = arith
        self.dev = torch.device(device)
        self.huber = float(huber_px)
        g = lambda k, ty: torch.as_tensor(np.asarray(arrays[k]), dtype=ty,
                                          device=self.dev)
        self.uv = g("obs_uv", dt)
        self.cam = g("obs_cam", torch.int64)
        self.pt = g("obs_pt", torch.int64)
        self.w = g("obs_w", dt)
        C = len(arrays["cam_q"])
        P = len(arrays["points"])
        self.C, self.P, self.O = C, P, len(self.cam)
        fix_cam = np.asarray(arrays["fix_cam"], bool)
        fix_rot = fix_cam | np.asarray(arrays.get("fix_rot")
                                       if arrays.get("fix_rot") is not None
                                       else np.zeros(C, bool), bool)
        fix_tr = fix_cam | np.asarray(arrays["fix_trans"], bool)
        self.fix_pt = g("fix_pt", torch.bool)
        # camera columns: 3 rotation, 3 translation, then 8 intrinsic
        # (log fx, log fy, cx, cy, k1, k2, p1, p2) per intrinsic block
        free = np.zeros((C, 14), bool)
        free[:, :3] = ~fix_rot[:, None]
        free[:, 3:6] = ~fix_tr[:, None]
        kam = np.arange(C)
        if optimize_intrinsics:
            kam = np.asarray(arrays["cam_kam"], np.int64)
            fi = ~np.asarray(arrays["fix_intri"], bool)
            fi[:, 1] &= ~np.asarray(arrays["tie_f"], bool)
            free[:, 6:] = fi
        self.tie = g("tie_f", dt) if optimize_intrinsics else \
            torch.zeros(C, dtype=dt, device=self.dev)
        col = -np.ones((C, 14), np.int64)
        n = 0
        for c in range(C):
            for j in range(6):
                if free[c, j]:
                    col[c, j] = n
                    n += 1
        blocks = {}
        for c in range(C):
            if kam[c] in blocks:
                col[c, 6:] = np.where(free[c, 6:], blocks[kam[c]], -1)
                continue
            ids = -np.ones(8, np.int64)
            for j in range(8):
                if free[c, 6 + j]:
                    ids[j] = n
                    n += 1
            blocks[kam[c]] = ids
            col[c, 6:] = ids
        self.n = n
        self.col = torch.as_tensor(col, device=self.dev)
        self.mask = torch.as_tensor(free, dtype=dt, device=self.dev)
        self._chunks = self._point_chunks()

    def _point_chunks(self, max_obs: int = 65536):
        """Observations sorted by point, points ordered by their lowest
        camera; chunks of whole points, each with its touched unknowns."""
        cam, pt = self.cam.cpu().numpy(), self.pt.cpu().numpy()
        low = np.full(self.P, np.iinfo(np.int64).max)
        np.minimum.at(low, pt, cam)
        rank = np.empty(self.P, np.int64)
        rank[np.lexsort((np.arange(self.P), low))] = np.arange(self.P)
        by_rank = np.argsort(rank)
        order = np.lexsort((np.arange(self.O), rank[pt]))
        cnt = np.bincount(rank[pt], minlength=self.P)
        ends = np.cumsum(cnt)
        col = self.col.cpu().numpy()
        chunks = []
        p0 = o0 = 0
        while p0 < self.P:
            p1 = int(np.searchsorted(ends, o0 + max_obs, side="right"))
            p1 = max(p1, p0 + 1)
            o1 = int(ends[p1 - 1])
            obs = order[o0:o1]
            cols = col[cam[obs]]  # [n, 14]
            uniq = np.unique(cols[cols >= 0])
            loc = np.where(cols >= 0, np.searchsorted(uniq, cols), -1)
            row = rank[pt[obs]] - p0
            chunks.append(dict(
                pids=torch.as_tensor(by_rank[p0:p1], device=self.dev),
                obs=torch.as_tensor(obs, device=self.dev),
                row=torch.as_tensor(row, device=self.dev),
                loc=torch.as_tensor(loc, device=self.dev),
                cols=torch.as_tensor(uniq, device=self.dev),
                n_pts=p1 - p0))
            p0, o0 = p1, o1
        return chunks

    def state(self, arrays: dict) -> State:
        g = lambda k: torch.as_tensor(np.asarray(arrays[k]),
                                      dtype=self.a.dtype, device=self.dev)
        return State(quat_to_rot(g("cam_q")), g("cam_t"), g("cam_intri"),
                     g("points"))

    # -- the model ---------------------------------------------------------

    def _pix(self, R, t, intri, X, mm):
        pc = mm(R, X[..., None])[..., 0] + t
        z = pc[..., 2]
        zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        u, v = pc[..., 0] / zs, pc[..., 1] / zs
        k1, k2, p1, p2 = intri[..., 4], intri[..., 5], intri[..., 6], \
            intri[..., 7]
        r2 = u * u + v * v
        rad = 1 + k1 * r2 + k2 * r2 * r2
        du = u * rad + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
        dv = v * rad + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
        return torch.stack([intri[..., 0] * du + intri[..., 2],
                            intri[..., 1] * dv + intri[..., 3]], -1), z

    def residual(self, s: State, delta=None):
        """Residuals [O, 2] and depths [O]; delta [O, 17] perturbs each
        observation's camera (rotation, translation, intrinsic tangent)
        and point, for the Jacobian, whose products stay exact (the
        control rounds the residual's and the normal equations')."""
        R, t, intri = s.R[self.cam], s.t[self.cam], s.intri[self.cam]
        X = s.X[self.pt]
        tie = self.tie[self.cam]
        mm = self.a.mm
        if delta is not None:
            mm = torch.matmul
            R = mm(R, torch.eye(3, dtype=R.dtype, device=R.device)
                   + _skew(delta[:, :3]))
            t = t + delta[:, 3:6]
            d = delta[:, 6:14]
            fx = intri[:, 0] * torch.exp(d[:, 0])
            fy = intri[:, 1] * torch.exp(tie * d[:, 0] + (1 - tie) * d[:, 1])
            intri = torch.cat([fx[:, None], fy[:, None], intri[:, 2:] + d[:, 2:]],
                              dim=1)
            X = X + delta[:, 14:]
        pix, z = self._pix(R, t, intri, X, mm)
        return pix - self.uv, z

    def cost_and_weight(self, r, z):
        bad = z <= 1e-3
        rn2 = torch.where(bad, torch.full_like(z, _BAD), (r * r).sum(-1))
        rn = torch.sqrt(rn2.clamp_min(1e-18))
        h = self.huber
        quad = rn <= h
        cost = torch.where(quad, rn2, h * (2 * rn - h))
        wt = torch.where(quad, torch.ones_like(rn), h / rn)
        wt = torch.where(bad, torch.zeros_like(wt), wt)
        return (self.w * cost).sum(), self.w * wt

    def cost(self, s: State):
        return self.cost_and_weight(*self.residual(s))[0]

    def jacobian(self, s: State):
        """[O, 2, 17] by forward-mode differentiation, one column at a
        time, frozen columns zeroed."""
        zero = torch.zeros((self.O, 17), dtype=self.a.dtype, device=self.dev)
        cols = []
        for k in range(17):
            e = torch.zeros_like(zero)
            e[:, k] = 1.0
            _, (jr, _) = torch.func.jvp(lambda d: self.residual(s, d),
                                        (zero,), (e,))
            cols.append(jr)
        J = torch.stack(cols, -1)
        J[..., :14] *= self.mask[self.cam][:, None, :]
        J[..., 14:] *= (~self.fix_pt)[self.pt].to(J.dtype)[:, None, None]
        return J

    # -- one LM step ---------------------------------------------------------

    def step(self, s: State, lam: float):
        """The damped Gauss-Newton step (camera unknowns [n], point steps
        [P, 3]) at state s."""
        mm = self.a.mm
        dt = self.a.dtype
        r, z = self.residual(s)
        _, wt = self.cost_and_weight(r, z)
        J = self.jacobian(s)
        Jc, Jp = J[..., :14], J[..., 14:]
        wJc = Jc * wt[:, None, None]
        wJp = Jp * wt[:, None, None]
        # camera blocks, summed per camera, then into the dense system
        S = torch.zeros((self.n, self.n), dtype=dt, device=self.dev)
        U = torch.zeros((self.C, 14, 14), dtype=dt, device=self.dev)
        for o0 in range(0, self.O, 262144):
            sl = slice(o0, o0 + 262144)
            U.index_add_(0, self.cam[sl], mm(wJc[sl].transpose(1, 2), Jc[sl]))
        bc = torch.zeros(self.n + 1, dtype=dt, device=self.dev)
        gcam = -mm(wJc.transpose(1, 2), r[..., None])[..., 0]  # [O, 14]
        ci = self.col[self.cam]
        bc.index_add_(0, torch.where(ci >= 0, ci, self.n).reshape(-1),
                      gcam.reshape(-1))
        bc = bc[:self.n]
        cc = self.col  # [C, 14]
        ok = cc >= 0
        Ui = torch.nonzero(ok[:, :, None] & ok[:, None, :])
        S.index_put_((cc[Ui[:, 0], Ui[:, 1]], cc[Ui[:, 0], Ui[:, 2]]),
                     U[Ui[:, 0], Ui[:, 1], Ui[:, 2]], accumulate=True)
        S.diagonal().mul_(1.0 + lam).add_(1e-8)
        # point blocks
        V = torch.zeros((self.P, 3, 3), dtype=dt, device=self.dev)
        V.index_add_(0, self.pt, mm(wJp.transpose(1, 2), Jp))
        bp = torch.zeros((self.P, 3), dtype=dt, device=self.dev)
        bp.index_add_(0, self.pt, -mm(wJp.transpose(1, 2), r[..., None])[..., 0])
        eye3 = torch.eye(3, dtype=dt, device=self.dev)
        Vd = V + lam * V * eye3 + 1e-8 * eye3
        Vinv = torch.linalg.inv(Vd)
        Vinv = 0.5 * (Vinv + Vinv.transpose(1, 2))
        Lc = torch.linalg.cholesky(Vinv)
        W = mm(wJc.transpose(1, 2), Jp)  # [O, 14, 3]
        u = mm(Lc.transpose(1, 2), bp[..., None])[..., 0]  # [P, 3]
        # S -= sum over points of (W L)(W L)^T, b -= (W L) L^T bp, in
        # chunks of points over the unknowns they touch
        for ch in self._chunks:
            obs = ch["obs"]
            Z = mm(W[obs], Lc[self.pt[obs]])  # [n, 14, 3]
            nl = len(ch["cols"])
            G = torch.zeros((ch["n_pts"] * 3, nl + 1), dtype=dt,
                            device=self.dev)
            rows = (ch["row"][:, None, None] * 3
                    + torch.arange(3, device=self.dev)).expand(-1, 14, 3)
            loc = torch.where(ch["loc"] >= 0, ch["loc"], nl)[:, :, None] \
                .expand(-1, 14, 3)
            G.index_put_((rows.reshape(-1), loc.reshape(-1)), Z.reshape(-1),
                         accumulate=True)
            G = G[:, :nl]
            cols = ch["cols"]
            S.index_put_((cols[:, None].expand(nl, nl),
                          cols[None, :].expand(nl, nl)),
                         -mm(G.T, G), accumulate=True)
            uc = u[ch["pids"]].reshape(-1)
            bc.index_add_(0, cols, -mm(G.T, uc[:, None])[:, 0])
        S = 0.5 * (S + S.T)
        try:
            Lf = torch.linalg.cholesky(S)
            dx = torch.cholesky_solve(bc[:, None], Lf)[:, 0]
        except RuntimeError:
            dx = torch.linalg.lstsq(S, bc[:, None]).solution[:, 0]
        # back-substitution
        dxc = torch.cat([dx, dx.new_zeros(1)])[torch.where(
            ci >= 0, ci, self.n)]  # [O, 14]
        wtx = mm(W.transpose(1, 2), dxc[..., None])[..., 0]  # [O, 3]
        rhs = bp.clone()
        rhs.index_add_(0, self.pt, -wtx)
        dX = mm(Vinv, rhs[..., None])[..., 0]
        dX = dX * (~self.fix_pt).to(dt)[:, None]
        return dx, dX

    def apply(self, s: State, dx, dX) -> State:
        d = torch.cat([dx, dx.new_zeros(1)])[torch.where(
            self.col >= 0, self.col, self.n)]  # [C, 14]
        R = self.a.mm(s.R, so3_exp(d[:, :3]))
        t = s.t + d[:, 3:6]
        di = d[:, 6:]
        fx = s.intri[:, 0] * torch.exp(di[:, 0])
        fy = s.intri[:, 1] * torch.exp(self.tie * di[:, 0]
                                       + (1 - self.tie) * di[:, 1])
        intri = torch.cat([fx[:, None], fy[:, None], s.intri[:, 2:] + di[:, 2:]],
                          dim=1)
        return State(R, t, intri, s.X + dX)


def solve(arrays: dict, device, *, optimize_intrinsics: bool, huber_px: float,
          max_iters: int, control: bool = False, lam_init: float = 1e-4,
          lam_up: float = 4.0, lam_down: float = 0.5, lam_max: float = 1e8,
          stop_rel: float = 1e-6):
    """Levenberg-Marquardt from the problem's own start under the solve's
    options: a step is kept when it lowers the cost, the damping then
    shrinks by lam_down and otherwise grows by lam_up (clamped to [1e-10,
    lam_max]), and the solve ends after max_iters or at a kept step that
    lowers the cost by less than stop_rel at a damping of at most 10 x
    lam_init.  Returns (State, float cost, iterations)."""
    arith = Arith(torch.float32 if control else torch.float64, control)
    pb = Problem(arrays, device, optimize_intrinsics, huber_px, arith)
    s = pb.state(arrays)
    cost = float(pb.cost(s))
    lam = lam_init
    it = 0
    while it < max_iters:
        it += 1
        dx, dX = pb.step(s, lam)
        cand = pb.apply(s, dx, dX)
        c2 = float(pb.cost(cand))
        accept = c2 < cost
        rel = (cost - c2) / max(cost, 1e-12) if accept else 0.0
        done = accept and rel < stop_rel and lam <= 10.0 * lam_init
        if accept:
            s, cost = cand, c2
        lam = min(max(lam * (lam_down if accept else lam_up), 1e-10), lam_max)
        if done:
            break
    return s, cost, it


def evaluate(arrays: dict, state: dict, device, *, optimize_intrinsics: bool,
             huber_px: float) -> float:
    """The float64 cost of the problem at `state` ({cam_q, cam_t, cam_intri,
    points}, e.g. the program's solved values)."""
    pb = Problem(arrays, device, optimize_intrinsics, huber_px,
                 Arith(torch.float64, False))
    return float(pb.cost(pb.state({**arrays, **state})))
