"""1DSfM runner: the twin of scripts/run_1dsfm.py (the reference's
run_1dsfm_matching.py / run_1dsfm_reconstruction.py): for each scene,
matching (covisibility by default), then rec_1dsfm, through the port's
CLI.

Usage: python -m xrsfm_tpu_torch.tools.run_1dsfm <data_root> <workspace>
       [--scenes Alamo ...] [--matching covisibility] [--device cuda]

Expects <data_root>/<scene>/{images/, retrieval.txt, camera_info.txt};
writes <workspace>/<scene>/bins and <workspace>/<scene>/model.
"""

import argparse
import os

from .. import cli
from ..device import resolve_device

SCENES = [
    "Alamo", "Ellis_Island", "Gendarmenmarkt", "Madrid_Metropolis",
    "Montreal_Notre_Dame", "NYC_Library", "Piazza_del_Popolo", "Piccadilly",
    "Roman_Forum", "Tower_of_London", "Trafalgar", "Union_Square",
    "Vienna_Cathedral", "Yorkminster",
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root")
    ap.add_argument("workspace")
    ap.add_argument("--scenes", nargs="*", default=SCENES)
    ap.add_argument("--matching", default="covisibility",
                    choices=["sequential", "retrieval", "covisibility"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    resolve_device(a.device)
    dev = ["--device", a.device]
    for scene in a.scenes:
        root = os.path.join(a.data_root, scene)
        if not os.path.isdir(root):
            print(f"skip {scene}: not found")
            continue
        ws = os.path.join(a.workspace, scene)
        bins = os.path.join(ws, "bins")
        model = os.path.join(ws, "model")
        cli.main(["run_matching", os.path.join(root, "images"),
                  os.path.join(root, "retrieval.txt"), a.matching, bins]
                 + dev)
        cli.main(["rec_1dsfm", bins, os.path.join(root, "camera_info.txt"),
                  model] + dev)


if __name__ == "__main__":
    main()
