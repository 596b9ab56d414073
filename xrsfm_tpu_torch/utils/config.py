"""JSON config loading for the CLI entry points (host copy of
xrsfm_tpu/utils/config.py, with its keys).

The reference drives each binary either with positional argv or with a
small JSON file of paths (LoadJSON, src/utility/io_feature.hpp:19-25;
consumed in src/run_matching.cc:158-166, run_reconstruction.cc:55-64,
run_triangulation.cc:117-125, rec_kitti.cc:64-75, rec_1dsfm.cc:70-77).
``load_json`` reads the file and ``resolve`` merges it under the CLI
arguments of the port's commands (the JAX package's command names),
accepting the reference's key spellings as aliases for ours.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


def load_json(path: str) -> dict:
    """LoadJSON equivalent (reference io_feature.hpp:19-25)."""
    with open(path, "r") as f:
        return json.load(f)


# per-command: CLI arg name -> accepted JSON keys, in priority order.
# First entries are our native spellings; the rest are the reference's.
_KEY_ALIASES: Dict[str, Dict[str, List[str]]] = {
    "run_matching": {
        "images_dir": ["images_dir", "images_path", "image_dir_path"],
        "retrieval_path": ["retrieval_path"],
        "matching_type": ["matching_type"],
        "output_dir": ["output_dir", "output_path"],
    },
    "retrieve": {
        "images_dir": ["images_dir", "images_path", "image_dir_path"],
        "output_dir": ["output_dir", "output_path"],
        "topk": ["topk", "retrieval_topk"],
        "num_words": ["num_words"],
    },
    "run_reconstruction": {
        "bin_dir": ["bin_dir", "bin_path"],
        "camera_txt": ["camera_txt", "camera_path"],
        "output_dir": ["output_dir", "output_path"],
        "init_id1": ["init_id1"],
        "init_id2": ["init_id2"],
    },
    "run_triangulation": {
        # the reference names individual files (bin_path = images.bin,
        # feature_path, matches_path); ours groups them in directories —
        # file-valued keys are resolved to their directory below.
        "bin_dir": ["bin_dir", "feature_path", "matches_path"],
        "model_dir": ["model_dir", "bin_path"],
        "output_dir": ["output_dir", "output_path"],
    },
    "rec_kitti": {
        "bin_dir": ["bin_dir", "bin_path"],
        "seq_name": ["seq_name"],
        "output_dir": ["output_dir", "output_path"],
        "timestamp_path": ["timestamp_path", "data_path"],
    },
    "rec_1dsfm": {
        "bin_dir": ["bin_dir", "bin_dir_path", "bin_path"],
        "camera_info_path": ["camera_info_path"],
        "output_dir": ["output_dir", "output_path"],
    },
    "estimate_scale": {
        "images_dir": ["images_dir", "images_path", "image_dir_path"],
        "model_dir": ["model_dir", "map_path"],
        "tag_length": ["tag_length"],
    },
    "unpack_collect_data": {
        "input_path": ["input_path", "data_path"],
        "output_dir": ["output_dir", "output_path"],
    },
}

# args whose JSON value may name a file where we expect its directory
_DIR_VALUED = {"bin_dir", "model_dir"}


def resolve(cmd: str, args, config_path: Optional[str]):
    """Fill unset CLI arguments of ``args`` (argparse Namespace) from the
    JSON config.  Explicit CLI values always win.  Raises on a missing
    required value so errors name the JSON key."""
    cfg = load_json(config_path) if config_path else {}
    aliases = _KEY_ALIASES.get(cmd, {})
    for arg, keys in aliases.items():
        if getattr(args, arg, None) not in (None, -1) and arg not in (
            "init_id1", "init_id2",
        ):
            continue
        for k in keys:
            if k in cfg:
                v = cfg[k]
                if (
                    arg in _DIR_VALUED
                    and isinstance(v, str)
                    and os.path.splitext(v)[1]
                ):
                    v = os.path.dirname(v)
                setattr(args, arg, v)
                break
    missing = [
        a for a in aliases
        if getattr(args, a, None) is None
        and a not in ("init_id1", "init_id2", "timestamp_path", "tag_length")
    ]
    if missing:
        raise SystemExit(
            f"{cmd}: missing {', '.join(missing)} — pass positionally or "
            f"via --config JSON keys "
            f"{[k for a in missing for k in aliases[a]]}"
        )
    return args
