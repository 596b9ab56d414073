"""Bundle-adjustment problems at the shape of a BAL problem, made from a seed.

The method is that of the port's synthetic BA benchmark problem (a camera
chain, each point placed in front of the cameras that see it, pixels
projected and perturbed), widened so that the camera, point and observation
counts equal the configuration's exactly: each point gets a track of
consecutive cameras whose lengths are drawn around the configuration's
mean and then moved by one until they sum to the observation count.  The
chain looks sideways to its motion, as a street-side capture does, so
that every track has parallax: a forward-looking chain leaves the points
near its epipole without depth, and a solve there moves them behind the
cameras.

Cameras follow BAL's model: per camera a focal length and two radial
coefficients k1, k2, no principal point offset, no tangential terms.  The
problem is returned in the port's BAProblem field names (numpy), with the
ground truth beside it, so that a solve starts from a seeded perturbation
of the truth.

Local problems (`local_problems`) free a camera and its most covisible
neighbours with their points, and hold every other camera that sees those
points fixed, as a mapper's local bundle adjustment does.
"""

from __future__ import annotations

import numpy as np

# fix_intri columns of the canonical intrinsics [fx, fy, cx, cy, k1, k2, p1,
# p2] under BAL's model: f (fx, with fy tied to it), k1 and k2 free
_BAL_FIXED = np.array([False, False, True, True, False, False, True, True])


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for each (seed, stream); any whole seed."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def _so3_exp(w):
    """Rodrigues: axis-angle vectors [N, 3] -> rotation matrices [N, 3, 3]."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(th[:, :, 0], 1e-300)
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rot_to_quat(R):
    """Rotation matrices [N, 3, 3] -> unit quaternions (w, x, y, z), w >= 0."""
    tr = np.trace(R, axis1=1, axis2=2)
    w = np.sqrt(np.maximum(1.0 + tr, 1e-12)) / 2.0
    x = (R[:, 2, 1] - R[:, 1, 2]) / (4.0 * w)
    y = (R[:, 0, 2] - R[:, 2, 0]) / (4.0 * w)
    z = (R[:, 1, 0] - R[:, 0, 1]) / (4.0 * w)
    q = np.stack([w, x, y, z], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def track_lengths(rng, n_points, n_obs, lo, hi):
    """Track lengths in [lo, hi] that sum to n_obs exactly: lo - 1 plus a
    geometric draw of the remaining mean, clipped, then raised or lowered
    by one at seeded points until the total is right."""
    mean_extra = n_obs / n_points - lo + 1.0
    if not (n_points * lo <= n_obs <= n_points * hi and mean_extra >= 1.0):
        raise ValueError("observation count out of reach of the track bounds")
    L = lo - 1 + rng.geometric(1.0 / mean_extra, n_points)
    L = np.clip(L, lo, hi).astype(np.int64)
    diff = n_obs - int(L.sum())
    while diff:
        cand = np.nonzero(L < hi if diff > 0 else L > lo)[0]
        pick = rng.choice(cand, min(abs(diff), len(cand)), replace=False)
        L[pick] += 1 if diff > 0 else -1
        diff = n_obs - int(L.sum())
    return L


def project(R, t, f, k1, k2, X):
    """BAL's camera: pc = R X + t, p = pc_xy / pc_z, pixels f (1 + k1 r^2 +
    k2 r^4) p.  Returns (pixels [N, 2], depth [N])."""
    pc = np.einsum("nij,nj->ni", R, X) + t
    p = pc[:, :2] / pc[:, 2:3]
    r2 = (p * p).sum(1)
    return (f * (1.0 + k1 * r2 + k2 * r2 * r2))[:, None] * p, pc[:, 2]


def make_problem(cfg: dict, seed: int) -> dict:
    """The configuration's problem for `seed`: {"start": BAProblem fields
    (numpy) at the seeded perturbation of the truth, "truth": the same
    fields at the truth}."""
    C, P, O = cfg["n_cameras"], cfg["n_points"], cfg["n_observations"]
    rng = rng_for(seed, 1)
    L = track_lengths(rng, P, O, cfg["min_track"], min(cfg["max_track"], C))

    # the camera chain: a street-side capture moving along x and looking
    # along z, with a random walk and small random rotations
    centers = np.cumsum(rng.normal(scale=cfg["walk_m"], size=(C, 3)), axis=0)
    centers[:, 0] += np.arange(C) * cfg["step_m"]
    R = _so3_exp(rng.normal(scale=cfg["rot_sd_rad"], size=(C, 3)))
    t = -np.einsum("nij,nj->ni", R, centers)
    lo, hi = cfg["focal_px"]
    f = rng.uniform(lo, hi, C)
    k1 = rng.normal(scale=cfg["k1_sd"], size=C)
    k2 = rng.normal(scale=cfg["k2_sd"], size=C)

    # each point in front of the middle of its track's cameras, at a
    # depth drawn over depth_m and deep enough that the whole track sees
    # it within half_fov: a short track may lie far beyond its baseline,
    # as many two-view points of a photo collection do
    first = (rng.random(P) * (C - L + 1)).astype(np.int64)
    last = first + L - 1
    mid = 0.5 * (centers[first] + centers[last])
    base = np.abs(centers[last, 0] - centers[first, 0])
    half_span = 0.5 * base + 1.0
    hf = cfg["half_fov"]
    dlo, dhi = cfg["depth_m"]
    depth = np.maximum(dlo + rng.random(P) * (dhi - dlo),
                       half_span / (0.6 * hf))
    off = rng.uniform(-1.0, 1.0, (P, 2)) * np.stack(
        [hf * depth - half_span, hf * depth], axis=1)
    X = mid + np.stack([off[:, 0], off[:, 1], depth], axis=1)

    obs_pt = np.repeat(np.arange(P), L)
    starts = np.concatenate([[0], np.cumsum(L)[:-1]])
    obs_cam = first[obs_pt] + np.arange(O) - starts[obs_pt]
    uv, z = project(R[obs_cam], t[obs_cam], f[obs_cam], k1[obs_cam],
                    k2[obs_cam], X[obs_pt])
    p = uv / f[obs_cam][:, None]
    if z.min() <= 1.0 or np.abs(p).max() >= 2 * hf:
        raise RuntimeError("a generated observation left the view")
    uv = uv + rng.normal(scale=cfg["pixel_noise_px"], size=uv.shape)
    n_out = int(round(cfg["outlier_share"] * O))
    out = rng.choice(O, n_out, replace=False)
    ang = rng.uniform(0, 2 * np.pi, n_out)
    mag = rng.uniform(*cfg["outlier_px"], n_out)
    uv[out] += mag[:, None] * np.stack([np.cos(ang), np.sin(ang)], axis=1)

    fix_cam = np.zeros(C, bool)
    fix_cam[0] = True
    fix_trans = np.zeros(C, bool)
    fix_trans[1] = True

    def fields(R_, t_, f_, k1_, k2_, X_):
        z0 = np.zeros(C)
        intri = np.stack([f_, f_, z0, z0, k1_, k2_, z0, z0], axis=1)
        return dict(
            cam_q=_rot_to_quat(R_).astype(np.float32),
            cam_t=t_.astype(np.float32),
            cam_intri=intri.astype(np.float32),
            points=X_.astype(np.float32),
            obs_uv=uv.astype(np.float32),
            obs_cam=obs_cam.astype(np.int32),
            obs_pt=obs_pt.astype(np.int32),
            obs_w=np.ones(O, np.float32),
            fix_cam=fix_cam, fix_trans=fix_trans,
            fix_pt=np.zeros(P, bool),
            cam_kam=np.arange(C, dtype=np.int64),
            fix_intri=np.tile(_BAL_FIXED, (C, 1)),
            tie_f=np.ones(C, bool),
        )

    # the start: free parameters moved by seeded noise; k1, k2 from zero
    nz = cfg["start_noise"]
    rng2 = rng_for(seed, 2)
    dR = _so3_exp(rng2.normal(scale=nz["rot_rad"], size=(C, 3)))
    R0 = np.where(fix_cam[:, None, None], R, R @ dR)
    c0 = centers + rng2.normal(scale=nz["trans_m"], size=(C, 3))
    c0 = np.where((fix_cam | fix_trans)[:, None], centers, c0)
    t0 = -np.einsum("nij,nj->ni", R0, c0)
    t0[fix_trans] = t[fix_trans]
    f0 = f * (1.0 + rng2.normal(scale=nz["focal_rel"], size=C))
    X0 = X + rng2.normal(scale=nz["point_m"], size=X.shape)
    zc = np.zeros(C)
    return {"start": fields(R0, t0, f0, zc, zc, X0),
            "truth": fields(R, t, f, k1, k2, X)}


def covisibility(prob: dict) -> np.ndarray:
    """[C, C] counts of points shared by each pair of cameras."""
    from scipy import sparse

    C = len(prob["cam_q"])
    P = len(prob["points"])
    A = sparse.csr_matrix(
        (np.ones(len(prob["obs_cam"]), np.int32),
         (prob["obs_cam"], prob["obs_pt"])), shape=(C, P))
    return (A @ A.T).toarray()


def local_problem(prob: dict, covis: np.ndarray, center: int,
                  n_neighbours: int) -> dict:
    """The local problem around `center`: it and its n_neighbours most
    covisible cameras free (ties to the lower index), every point they
    see free, every observation of those points kept, and the other
    cameras that observe them fixed."""
    row = covis[center].astype(np.int64).copy()
    row[center] = -1
    order = np.lexsort((np.arange(len(row)), -row))
    free = np.sort(np.concatenate([[center], order[:n_neighbours]]))
    sees = np.isin(prob["obs_cam"], free)
    pts = np.unique(prob["obs_pt"][sees])
    keep = np.isin(prob["obs_pt"], pts)
    ocam, opt = prob["obs_cam"][keep], prob["obs_pt"][keep]
    cams = np.unique(ocam)
    out = dict(
        cam_q=prob["cam_q"][cams], cam_t=prob["cam_t"][cams],
        cam_intri=prob["cam_intri"][cams], points=prob["points"][pts],
        obs_uv=prob["obs_uv"][keep],
        obs_cam=np.searchsorted(cams, ocam).astype(np.int32),
        obs_pt=np.searchsorted(pts, opt).astype(np.int32),
        obs_w=prob["obs_w"][keep],
        fix_cam=~np.isin(cams, free),
        fix_trans=np.zeros(len(cams), bool),
        fix_pt=np.zeros(len(pts), bool),
        cam_kam=np.arange(len(cams), dtype=np.int64),
        fix_intri=prob["fix_intri"][cams], tie_f=prob["tie_f"][cams],
    )
    return out


def local_centers(n_cameras: int, n_problems: int, seed: int) -> np.ndarray:
    """n_problems centres spread evenly over the chain from a seeded offset,
    in a seeded order: every seed gets the same spacing of local problems."""
    rng = rng_for(seed, 3)
    step = n_cameras / n_problems
    base = (rng.random() * step + np.arange(n_problems) * step).astype(int)
    return base[rng.permutation(n_problems)] % n_cameras
