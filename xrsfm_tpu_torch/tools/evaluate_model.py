"""Evaluate a reconstructed COLMAP model against ground-truth poses: the
twin of scripts/evaluate_model.py.

Usage: python -m xrsfm_tpu_torch.tools.evaluate_model <model_dir>
       <gt_poses.txt> [--device cuda]

gt_poses.txt: `name qw qx qy qz tx ty tz` (Tcw), as utils/synth writes it.
Reports the sim(3)-aligned ATE RMSE, the reprojection error of every
observation (one batched projection on `device`), the per-frame rotation
drift against ground truth and the model's size.
"""

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.umeyama import ate_rmse
from ..utils import camera as Cam
from ..utils import geometry as G
from ..utils import io_colmap as IOC

CONJ = np.array([1.0, -1, -1, -1])


def _reprojection_errors(imgs, pts, cams, dev):
    """Pixel error of every observation of an existing point in front of
    its camera: the observations gathered per image in numpy, then one
    batched float32 projection on dev."""
    if not pts:
        return np.zeros(0)
    pids = np.array(sorted(pts), np.int64)
    xyz = np.array([pts[p].xyz for p in pids], np.float64)
    uvn_all, cp_all, xy_all = [], [], []
    for im in imgs.values():
        ids = np.asarray(im.point3D_ids, np.int64)
        row = np.minimum(np.searchsorted(pids, ids), len(pids) - 1)
        ok = (ids >= 0) & (pids[row] == ids)
        R = G.quat_to_rotmat_np(im.qvec)
        pc = xyz[row[ok]] @ R.T + im.tvec
        front = pc[:, 2] > 1e-6
        pc = pc[front]
        cam = cams[im.camera_id]
        cp = Cam.canonicalize_params(cam.model_id, cam.params)
        uvn_all.append(pc[:, :2] / pc[:, 2:3])
        cp_all.append(np.tile(cp, (len(pc), 1)))
        xy_all.append(np.asarray(im.xys, np.float64)[ok][front])
    if not uvn_all:
        return np.zeros(0)
    params = torch.as_tensor(np.concatenate(cp_all), dtype=torch.float32,
                             device=dev)
    uvn = torch.as_tensor(np.concatenate(uvn_all), dtype=torch.float32,
                          device=dev)
    pix = Cam.normalized_to_image(params, uvn).cpu().numpy()
    return np.linalg.norm(pix - np.concatenate(xy_all), axis=1)


def evaluate(model_dir: str, gt_poses: str, device="cuda") -> dict:
    """Prints scripts/evaluate_model.py's lines and returns their figures:
    registered, n_gt, points, mean_track, reproj_mean, reproj_median,
    reproj_p95 (pixels; None without observations), rot_mean_deg,
    rot_max_deg, ate, span, ate_pct."""
    dev = resolve_device(device)
    imgs = IOC.read_images_bin(os.path.join(model_dir, "images.bin"))
    pts = IOC.read_points3d_bin(os.path.join(model_dir, "points3D.bin"))
    cams = IOC.read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
    gt = {}
    for line in open(gt_poses):
        p = line.split()
        gt[p[0]] = (np.array(list(map(float, p[1:5]))),
                    np.array(list(map(float, p[5:8]))))
    est_c, gt_c, names = [], [], []
    for im in sorted(imgs.values(), key=lambda im: im.name):
        if im.name not in gt:
            continue
        est_c.append(G.pose_center_np(im.qvec, im.tvec))
        gt_c.append(G.pose_center_np(*gt[im.name]))
        names.append(im.name)
    est_c = np.asarray(est_c)
    gt_c = np.asarray(gt_c)
    ate = ate_rmse(gt_c, est_c)
    span = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    tl = [len(p.image_ids) for p in pts.values()]
    errs = _reprojection_errors(imgs, pts, cams, dev)

    # per-frame rotation drift, gauge-free: the world alignment R_est^T
    # R_gt is constant across frames for a perfect reconstruction; its
    # spread from the first frame's is the drift
    by_name = {im.name: im for im in imgs.values()}
    rels = [G.quat_mul_np(by_name[n].qvec * CONJ, gt[n][0]) for n in names]
    ang = [2 * np.degrees(np.arccos(np.clip(abs(
        G.quat_mul_np(q, rels[0] * CONJ)[0]), -1, 1))) for q in rels]

    out = dict(registered=len(est_c), n_gt=len(gt), points=len(pts),
               mean_track=float(np.mean(tl)), reproj_mean=None,
               reproj_median=None, reproj_p95=None,
               rot_mean_deg=float(np.mean(ang)),
               rot_max_deg=float(np.max(ang)), ate=float(ate),
               span=float(span), ate_pct=100 * ate / max(span, 1e-9))
    print(f"registered: {len(est_c)}/{len(gt)} frames")
    print(f"points: {len(pts)}, mean track length {np.mean(tl):.2f}")
    if len(errs):
        out.update(reproj_mean=float(errs.mean()),
                   reproj_median=float(np.median(errs)),
                   reproj_p95=float(np.percentile(errs, 95)))
        print(
            f"reprojection error: mean {errs.mean():.3f}px  "
            f"median {np.median(errs):.3f}px  p95 {np.percentile(errs, 95):.3f}px"
        )
    print(f"rotation error vs GT: mean {np.mean(ang):.3f} deg  max {np.max(ang):.3f} deg")
    print(f"ATE (sim3-aligned) RMSE: {ate:.5f}  ({out['ate_pct']:.3f}% of span {span:.2f})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model_dir")
    ap.add_argument("gt_poses")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return evaluate(a.model_dir, a.gt_poses, a.device)


if __name__ == "__main__":
    main()
