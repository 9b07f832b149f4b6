"""What crosses between the JAX package and the port.

ICP has no learned weights. What one package hands the other is the static
configuration, the dynamic parameters and a built RBC index; all three cross
as plain Python values and numpy arrays, so this module imports neither
package's framework counterpart.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping

import numpy as np
import torch

from icp_tpu_torch.rbc.construct import RBCIndex
from icp_tpu_torch.rbc.grouping import GroupedRows
from icp_tpu_torch.runtime import config as _cfg
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams

_ENUM_FIELDS = {
    "rotation": _cfg.RotationMode,
    "weighting": _cfg.Weighting,
    "robust": _cfg.RobustKernel,
    "correspondence": _cfg.Correspondence,
    "objective": _cfg.Objective,
}


def config_from_dict(d: Mapping[str, Any]) -> ICPConfig:
    """ICPConfig from a field dict (e.g. ``dataclasses.asdict`` of the JAX
    config). Enum fields take a member of either package's enum or its
    ``.value`` string. ``use_pallas`` is dropped: the port's kernels are
    selected by the tensors' device."""
    kwargs = {}
    for key, value in d.items():
        if key == "use_pallas":
            continue
        if key in _ENUM_FIELDS:
            value = _ENUM_FIELDS[key](
                value.value if isinstance(value, enum.Enum) else value)
        kwargs[key] = value
    return ICPConfig(**kwargs)


def params_from_numpy(d: Mapping[str, Any], device=None) -> ICPParams:
    """ICPParams of 0-d float32 tensors from a dict of scalars or 0-d
    arrays; with ``device=None`` the fields stay Python floats."""
    params = ICPParams(**{k: float(np.asarray(v)) for k, v in d.items()})
    return params if device is None else params.to(device)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def index_from_numpy(fields: Mapping[str, Any], device="cpu") -> RBCIndex:
    """The port's RBCIndex from an index's fields as numpy arrays.

    ``fields`` maps each :class:`RBCIndex` field name to an array (e.g. the
    JAX ``RBCIndex._asdict()`` with its leaves converted by ``np.asarray``);
    ``layout`` is a (counts, offsets, valid, grouped) sequence. The normal
    fields (``normals``, ``bin_normals``, ``bins_vals12``, ``gn_w``) cross
    as they are: None where the source index has None or lacks the field.
    Integer fields become int32 and float fields float32, as the port keeps
    them.
    """
    out = {}
    for f in dataclasses.fields(RBCIndex):
        value = fields.get(f.name)
        if value is None:
            if f.default is dataclasses.MISSING:
                raise KeyError(f"index field {f.name!r} is missing")
        elif f.name == "layout":
            counts, offsets, valid, grouped = value
            value = GroupedRows(
                _tensor(counts, device).to(torch.int32),
                _tensor(offsets, device).to(torch.int32),
                _tensor(valid, device).to(torch.bool),
                tuple(_tensor(g, device).to(torch.float32) for g in grouped))
        else:
            t = _tensor(value, device)
            if t.dtype == torch.bool:
                value = t
            elif t.is_floating_point():
                value = t.to(torch.float32)
            else:
                value = t.to(torch.int32)
        out[f.name] = value
    return RBCIndex(**out)
