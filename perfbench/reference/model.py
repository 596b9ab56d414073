"""Plain reference judge of a reconstruction: the COLMAP binary model a pass
wrote, against the scene the benchmark rendered.

Numpy only; reads the model files (cameras.bin, images.bin, points3D.bin
in COLMAP's documented binary layout), never the program's objects.  The
numbers of one model:

  missing_frames  frames of the sequence not registered in images.bin;
  ate_pct         camera centres after the least-squares similarity onto
                  the true centres (Umeyama): RMS error as % of the
                  diagonal of the true centres' bounding box;
  reproj_px       RMS distance between each 3D point projected into each
                  image of its track and the 2D point that track names,
                  in pixels;
  plane_pct       each 3D point, moved by the same similarity, at its
                  distance to the nearest scene plane: the median, as %
                  of the same diagonal.

`bundle` turns the same files into a bundle-adjustment problem in the
port's field names (numpy), for reference/ba.py to solve again: the
model's cameras, poses, points and the observations its tracks name.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# COLMAP camera model id -> number of parameters
_N_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}


def _read(fh, fmt):
    return struct.unpack("<" + fmt, fh.read(struct.calcsize("<" + fmt)))


def read_cameras(path):
    cams = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        for _ in range(n):
            cid, model, w, h = _read(fh, "iiQQ")
            params = np.array(_read(fh, "d" * _N_PARAMS[model]))
            cams[cid] = (model, params)
    return cams


def read_images(path):
    """{name: (q [4], t [3], camera id, xy [N, 2])}"""
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        for _ in range(n):
            iid, qw, qx, qy, qz, tx, ty, tz, cid = _read(fh, "idddddddi")
            name = b""
            while (c := fh.read(1)) != b"\x00":
                name += c
            (n2,) = _read(fh, "Q")
            pts = np.frombuffer(fh.read(24 * n2), dtype=np.dtype(
                [("xy", "<f8", 2), ("id", "<i8")]))
            out[name.decode()] = (iid, np.array([qw, qx, qy, qz]),
                                  np.array([tx, ty, tz]), cid,
                                  pts["xy"].copy())
    return out


def read_points(path):
    """(xyz [P, 3], track image ids and 2D indices per point)."""
    xyz, tracks = [], []
    with open(path, "rb") as fh:
        (n,) = _read(fh, "Q")
        for _ in range(n):
            _pid, x, y, z, _r, _g, _b, _err, tl = _read(fh, "QdddBBBdQ")
            tr = np.frombuffer(fh.read(8 * tl), dtype="<i4").reshape(tl, 2)
            xyz.append((x, y, z))
            tracks.append(tr)
    return np.array(xyz).reshape(-1, 3), tracks


def quat_to_rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def umeyama(src, dst):
    """Least-squares similarity dst ~ s R src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, d, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / ((xs ** 2).sum() / len(src)))
    return s, R, mu_d - s * R @ mu_s


def _pixels(model, params, pc):
    """Pinhole projection with the model's distortion."""
    u, v = pc[:, 0] / pc[:, 2], pc[:, 1] / pc[:, 2]
    if model == 0:
        f, cx, cy = params
        return np.stack([f * u + cx, f * v + cy], 1)
    if model == 1:
        fx, fy, cx, cy = params
        return np.stack([fx * u + cx, fy * v + cy], 1)
    r2 = u * u + v * v
    if model in (2, 3):
        f, cx, cy = params[:3]
        k1 = params[3]
        k2 = params[4] if model == 3 else 0.0
        rad = 1 + k1 * r2 + k2 * r2 * r2
        return np.stack([f * u * rad + cx, f * v * rad + cy], 1)
    fx, fy, cx, cy, k1, k2, p1, p2 = params
    rad = 1 + k1 * r2 + k2 * r2 * r2
    du = u * rad + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * rad + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return np.stack([fx * du + cx, fy * dv + cy], 1)


def judge(model_dir: str, names, planes, poses) -> dict:
    """The numbers of the model in model_dir against the scene (image
    names in order, planes [(p0, ex, ey)], true poses [(R, t)])."""
    imgs = read_images(os.path.join(model_dir, "images.bin"))
    cams = read_cameras(os.path.join(model_dir, "cameras.bin"))
    xyz, tracks = read_points(os.path.join(model_dir, "points3D.bin"))
    reg = [i for i, n in enumerate(names) if n in imgs]
    out = {"missing_frames": float(len(names) - len(reg))}
    if len(reg) < 3:
        return dict(out, ate_pct=float("inf"), reproj_px=float("inf"),
                    plane_pct=float("inf"))
    gt_c = np.array([-poses[i][0].T @ poses[i][1] for i in reg])
    est_c = []
    for i in reg:
        _, q, t, _, _ = imgs[names[i]]
        est_c.append(-quat_to_rot(q).T @ t)
    est_c = np.array(est_c)
    span = float(np.linalg.norm(gt_c.max(0) - gt_c.min(0)))
    s, R, t = umeyama(est_c, gt_c)
    err = np.linalg.norm(s * est_c @ R.T + t - gt_c, axis=1)
    out["ate_pct"] = 100.0 * float(np.sqrt(np.mean(err ** 2))) / span

    # every (point, image, 2D point) of the tracks, projected per camera
    by_id = {v[0]: v for v in imgs.values()}
    ids = sorted(by_id)
    pos = {iid: k for k, iid in enumerate(ids)}
    Rs = np.stack([quat_to_rot(by_id[i][1]) for i in ids])
    ts = np.stack([by_id[i][2] for i in ids])
    lens = np.array([len(tr) for tr in tracks], np.int64)
    flat = np.concatenate(tracks) if len(tracks) else np.zeros((0, 2), int)
    pt = np.repeat(np.arange(len(xyz)), lens)
    im = np.array([pos[int(i)] for i in flat[:, 0]], np.int64)
    obs = np.concatenate([by_id[i][4] for i in ids])
    first = np.concatenate([[0], np.cumsum([len(by_id[i][4]) for i in ids])])
    xy = obs[first[im] + flat[:, 1]]
    pc = np.einsum("nij,nj->ni", Rs[im], xyz[pt]) + ts[im]
    cid = np.array([by_id[i][3] for i in ids])[im]
    sq = 0.0
    for c in np.unique(cid):
        sel = cid == c
        d = _pixels(*cams[int(c)], pc[sel]) - xy[sel]
        sq += float((d * d).sum())
    cnt = len(flat)
    out["reproj_px"] = float(np.sqrt(sq / max(cnt, 1)))

    Xw = s * xyz @ R.T + t
    dist = np.full(len(Xw), np.inf)
    for p0, ex, ey in planes:
        n = np.cross(ex, ey)
        n = n / np.linalg.norm(n)
        dist = np.minimum(dist, np.abs((Xw - np.asarray(p0, float)) @ n))
    out["plane_pct"] = 100.0 * float(np.median(dist)) / span \
        if len(dist) else float("inf")
    return out


def _canonical(model, params):
    """COLMAP camera parameters -> [fx, fy, cx, cy, k1, k2, p1, p2]."""
    out = np.zeros(8)
    if model in (1, 4):
        out[:len(params)] = params
        return out
    out[0] = out[1] = params[0]
    out[2:4] = params[1:3]
    out[4:4 + len(params) - 3] = params[3:]
    return out


def bundle(model_dir: str, gauge) -> dict:
    """The model in model_dir as a BA problem: every registered image a
    camera, every 3D point free, every observation of its track weighted
    1, the intrinsics as written.  The gauge is the mapper's: the image
    named gauge[0] fixed, the translation of the one named gauge[1]
    fixed."""
    imgs = read_images(os.path.join(model_dir, "images.bin"))
    cams = read_cameras(os.path.join(model_dir, "cameras.bin"))
    xyz, tracks = read_points(os.path.join(model_dir, "points3D.bin"))
    by_id = {v[0]: v for v in imgs.values()}
    ids = sorted(by_id)
    pos = {iid: k for k, iid in enumerate(ids)}
    C, P = len(ids), len(xyz)
    lens = np.array([len(tr) for tr in tracks], np.int64)
    flat = np.concatenate(tracks) if P else np.zeros((0, 2), np.int64)
    first = np.concatenate([[0], np.cumsum([len(by_id[i][4]) for i in ids])])
    im = np.array([pos[int(i)] for i in flat[:, 0]], np.int64)
    obs = np.concatenate([by_id[i][4] for i in ids])
    name_of = {v[0]: n for n, v in imgs.items()}
    names = [name_of[i] for i in ids]
    fix_cam = np.array([n == gauge[0] for n in names])
    fix_trans = np.array([n == gauge[1] for n in names])
    return dict(
        cam_q=np.stack([by_id[i][1] for i in ids]),
        cam_t=np.stack([by_id[i][2] for i in ids]),
        cam_intri=np.stack([_canonical(*cams[by_id[i][3]]) for i in ids]),
        points=xyz,
        obs_uv=obs[first[im] + flat[:, 1]],
        obs_cam=im,
        obs_pt=np.repeat(np.arange(P), lens),
        obs_w=np.ones(len(im)),
        fix_cam=fix_cam, fix_trans=fix_trans,
        fix_pt=np.zeros(P, bool),
        cam_kam=np.array([by_id[i][3] for i in ids], np.int64),
        fix_intri=np.ones((C, 8), bool), tie_f=np.ones(C, bool))
