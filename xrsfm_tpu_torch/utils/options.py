"""Option conversion from the JAX package's dataclasses.

`from_jax_options` takes an xrsfm_tpu options instance (SiftOptions,
OrbOptions, MatchingOptions, MapperOptions, InitOptions,
RegisterOptions, TriOptions, ErrorCorrectOptions or BAOptions; read field
by field, without importing that package), or a dict of one class's
fields, and returns the port's dataclass of the same name.
MapperOptions' nested init / reg / tri options are converted too, from
dataclasses or dicts.

`pose_graph_from_jax` carries a JAX PoseGraphProblem (its arrays read as
numpy) over to the port's, so that both packages solve the same graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..feature.matching import MatchingOptions
from ..mapper.error_correct import ErrorCorrectOptions
from ..mapper.incremental import MapperOptions
from ..mapper.initialize import InitOptions
from ..mapper.register import RegisterOptions
from ..mapper.triangulate import TriOptions
from ..ops.orb import OrbOptions
from ..ops.sift import SiftOptions
from ..optim.ba import BAOptions
from ..optim.pose_graph import PoseGraphProblem

_TARGETS = {cls.__name__: cls for cls in (
    SiftOptions, OrbOptions, MatchingOptions, MapperOptions, InitOptions,
    RegisterOptions, TriOptions, ErrorCorrectOptions, BAOptions)}
# nested option fields and their classes
_NESTED = {(MapperOptions, "init"): InitOptions,
           (MapperOptions, "reg"): RegisterOptions,
           (MapperOptions, "tri"): TriOptions}


def _fields_of(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _build(cls, fields):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    out = {}
    for name, val in fields.items():
        sub = _NESTED.get((cls, name))
        if sub is not None and isinstance(val, dict):
            val = _build(sub, val)
        elif sub is not None and not isinstance(val, sub):
            val = from_jax_options(val)
        out[name] = val
    return cls(**out)


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
        return _build(matches[0], fields)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _TARGETS.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(obj).__name__}")
        return _build(cls, _fields_of(obj))
    raise TypeError(f"expected an options dataclass or dict, got "
                    f"{type(obj).__name__}")


def pose_graph_from_jax(prob, device) -> PoseGraphProblem:
    """The port's PoseGraphProblem on `device` with the arrays of `prob`
    (a JAX-package PoseGraphProblem, or any object with its fields)."""
    return PoseGraphProblem.from_numpy(device, **{
        f.name: np.asarray(getattr(prob, f.name))
        for f in dataclasses.fields(PoseGraphProblem)})
