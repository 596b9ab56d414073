"""Loader for the native I/O extension (native/xrsfm_native.c), the
port's own (the JAX package's loader imports xrsfm_tpu.utils, which loads
JAX).

Tries, in order: an already importable build, an in-tree build artifact,
a build on the fly with the local toolchain.  Without a compiler it
returns None and the readers use the pure-Python parsers of
utils/io_features; the two paths are byte-identical
(tests/test_torch_aux.py holds them so).  This is host I/O, not a device
path.
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

_NATIVE = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")


def _try_import():
    global _NATIVE
    try:
        import xrsfm_native  # noqa: F401

        _NATIVE = xrsfm_native
        return True
    except ImportError:
        return False


def get_native():
    """Return the native module or None."""
    global _NATIVE, _TRIED
    if _NATIVE is not None or _TRIED:
        return _NATIVE
    _TRIED = True
    for cand in glob.glob(os.path.join(_NATIVE_DIR, "xrsfm_native*.so")):
        if _NATIVE_DIR not in sys.path:
            sys.path.insert(0, _NATIVE_DIR)
        if _try_import():
            return _NATIVE
    # build on the fly
    try:
        subprocess.run(
            [sys.executable, "setup.py", "build_ext", "--inplace"],
            cwd=_NATIVE_DIR,
            check=True,
            capture_output=True,
            timeout=120,
        )
        if _NATIVE_DIR not in sys.path:
            sys.path.insert(0, _NATIVE_DIR)
        _try_import()
    except (OSError, subprocess.SubprocessError):
        _NATIVE = None  # no compiler: the Python parsers serve
    return _NATIVE


def read_features_fast(path: str, with_descs: bool = True):
    """Native-accelerated ftr.bin parse with pure-Python fallback."""
    from . import io_features as IOF

    nat = get_native()
    if nat is None:
        return IOF.read_features(path, with_descs)
    return [
        IOF.FrameFeatures(name=n, keypoints=k, descriptors=d)
        for n, k, d in nat.read_features(path, with_descs=with_descs)
    ]


def read_frame_pairs_fast(path: str):
    """Native-accelerated fp.bin parse with pure-Python fallback."""
    import numpy as np

    from . import io_features as IOF

    nat = get_native()
    if nat is None:
        return IOF.read_frame_pairs(path)
    return [
        IOF.FramePairData(
            id1=i1, id2=i2, matches=m, distances=dist, E=E,
            inlier_num=inl, inlier_mask=mask,
        )
        for i1, i2, m, dist, E, inl, mask in nat.read_frame_pairs(path)
    ]
