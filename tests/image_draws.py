"""The sequential mapper of either package on the CPU under salted RANSAC
seeds, on a workspace of rendered images whose matching bins were already
written (chip_smoke.py phase 17's corridor and loop, whose bins the card
writes): the draws behind phase 17's ATE limits.  Not a test: it imports
both packages, as the port's tests do, and each run takes minutes.

  python tests/image_draws.py run --pkg jax|port --salt K [--correct_pose]
          [--init I J] WS OUT.json
      WS holds bins/ftr.bin, bins/fp.bin, camera.txt and gt_poses.txt;
      runs the package's pipelines.run_reconstruction.main on them and
      records the registered frames, the sim(3)-aligned ATE of their
      centers as a percentage of their ground-truth span (as
      tools/evaluate_model computes it), the corrections, the polish
      verdict, the seconds and the bins' SHA-256; --init fixes the
      initial pair (MapperOptions.init_id1, init_id2)
  python tests/image_draws.py summary OUT.json...

The salt K is tests/circuit_draws.py's: K * 7919 (mod 2^31) added to the
seed of every RANSAC draw of initialization, registration and the loop
check's relocation; K = 0 leaves the shipped seeds.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _ate_pct(m, gt_path):
    from xrsfm_tpu_torch.ops.umeyama import ate_rmse
    from xrsfm_tpu_torch.utils import geometry as G

    gt = {}
    with open(gt_path) as f:
        for line in f:
            p = line.split()
            gt[p[0]] = G.pose_center_np(np.array(p[1:5], float),
                                        np.array(p[5:8], float))
    reg = [i for i in np.nonzero(m.registered)[0] if m.names[i] in gt]
    est = np.array([G.pose_center_np(np.asarray(m.q[i], float),
                                     np.asarray(m.t[i], float)) for i in reg])
    ref = np.array([gt[m.names[i]] for i in reg])
    span = float(np.linalg.norm(ref.max(0) - ref.min(0)))
    return 100.0 * ate_rmse(ref, est) / span


def cmd_run(a):
    import circuit_draws as CD

    P = CD.load(a.pkg, a.salt)
    held = CD._keep_mapper(P)
    bins = os.path.join(a.ws, "bins")
    sha = {}
    for k in ("ftr.bin", "fp.bin"):
        with open(os.path.join(bins, k), "rb") as f:
            sha[k] = hashlib.sha256(f.read()).hexdigest()
    t0 = time.time()
    out = os.path.splitext(a.out)[0] + "_model"
    init = a.init or (-1, -1)
    m = P["RR"].main(bins, os.path.join(a.ws, "camera.txt"), out, *init,
                     correct_pose=a.correct_pose, **P["kw"])
    res = dict(pkg=a.pkg, salt=a.salt, seconds=time.time() - t0, sha256=sha,
               correct_pose=a.correct_pose, init=a.init)
    if m is None:
        res.update(registered=0, ate_pct=None)
    else:
        st = held["mapper"].stats
        res.update(registered=int(np.count_nonzero(m.registered)),
                   ate_pct=_ate_pct(m, os.path.join(a.ws, "gt_poses.txt")),
                   corrections=int(st.corrections),
                   polish=str(getattr(st, "polish", "")))
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)


def cmd_summary(a):
    rs = [json.load(open(p)) for p in a.files]
    ates = [r["ate_pct"] for r in rs if r["ate_pct"] is not None]
    for p, r in zip(a.files, rs):
        print(f"{p}: {r['pkg']} salt {r['salt']}: registered "
              f"{r['registered']}, ATE {r['ate_pct']}%, corrections "
              f"{r.get('corrections')}, polish {r.get('polish')}, "
              f"{r['seconds']:.1f} s")
    print(f"registered min {min(r['registered'] for r in rs)}; ATE % worst "
          f"{max(ates)}, median {statistics.median(ates)}; sha256 "
          f"{sorted({json.dumps(r['sha256']) for r in rs})}")


def main(argv=None):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--pkg", choices=("jax", "port"), required=True)
    r.add_argument("--salt", type=int, default=0)
    r.add_argument("--correct_pose", action="store_true")
    r.add_argument("--init", nargs=2, type=int, metavar=("I", "J"))
    r.add_argument("ws")
    r.add_argument("out")
    s = sub.add_parser("summary")
    s.add_argument("files", nargs="+")
    a = p.parse_args(argv)
    {"run": cmd_run, "summary": cmd_summary}[a.cmd](a)


if __name__ == "__main__":
    main()
