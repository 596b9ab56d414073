"""Option conversion from the JAX package's dataclasses.

`from_jax_options` takes an xrsfm_tpu SiftOptions or MatchingOptions
instance (read field by field, without importing that package), or a dict
of one of their fields, and returns the port's dataclass of the same name.
"""

from __future__ import annotations

import dataclasses

from ..feature.matching import MatchingOptions
from ..ops.sift import SiftOptions

_TARGETS = {"SiftOptions": SiftOptions, "MatchingOptions": MatchingOptions}


def from_jax_options(obj):
    """Port dataclass with the fields of `obj`; raises on a field the
    port's dataclass does not have, and on an unrecognised object."""
    if isinstance(obj, dict):
        fields = dict(obj)
        matches = [
            cls for cls in _TARGETS.values()
            if fields and set(fields) <= {f.name for f in dataclasses.fields(cls)}
        ]
        if len(matches) != 1:
            raise ValueError(
                f"fields {sorted(fields)} match no single options class of "
                f"{sorted(_TARGETS)}"
            )
        cls = matches[0]
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _TARGETS.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(obj).__name__}")
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)}
    else:
        raise TypeError(f"expected an options dataclass or dict, got "
                        f"{type(obj).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    return cls(**fields)
