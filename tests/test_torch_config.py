"""icp_tpu_torch configuration against icp_tpu's: one dict builds both, and
they agree field for field (auto-capacities and validation included)."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import icp_tpu.runtime.config as J
import icp_tpu_torch.runtime.config as T
from icp_tpu_torch.interop import config_from_dict, params_from_numpy

SLICE_DICTS = [
    {},
    {"m": 4096, "n_r": 64},
    {"m": 1000, "n_r": 12, "bin_capacity": 40},
    {"m": 65536, "n_r": 1024, "max_iterations": 8},
    {"m": 262144, "n_r": 2048, "query_capacity": 200},
    {"rotation": "svd", "weighting": "regular", "estimate_scale": False},
    {"rotation": "jacobi", "normal_mode": "knn"},
]


_J_ENUMS = {"rotation": J.RotationMode, "weighting": J.Weighting,
            "robust": J.RobustKernel, "correspondence": J.Correspondence,
            "objective": J.Objective}


def _jax_config(d):
    return J.ICPConfig(**{k: _J_ENUMS[k](v) if k in _J_ENUMS else v
                          for k, v in d.items()})


@pytest.mark.parametrize("d", SLICE_DICTS)
def test_config_matches_jax_field_for_field(d):
    jc = _jax_config(d)
    tc = config_from_dict(dataclasses.asdict(jc))
    assert tc == config_from_dict(d)
    for f in dataclasses.fields(tc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(jv, enum.Enum):
            assert jv.value == tv.value, f.name
        else:
            assert jv == tv, f.name
    if jc.n_r & (jc.n_r - 1) == 0:
        assert tc.rep_grid == jc.rep_grid


@pytest.mark.parametrize("d", [{"m": 0}, {"n_r": 0}, {"n_r": 6},
                               {"normal_mode": "bogus"}])
def test_config_validation_matches_jax(d):
    with pytest.raises(ValueError):
        J.ICPConfig(**d)
    with pytest.raises(ValueError):
        T.ICPConfig(**d)


def test_rep_grid_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        J.ICPConfig(n_r=12).rep_grid
    with pytest.raises(ValueError):
        T.ICPConfig(n_r=12).rep_grid


@pytest.mark.parametrize("d", [
    # Configurations the port once refused (BRUTE, the unfused pipeline and
    # the kNN normal modes): each constructs and matches JAX.
    {"correspondence": "brute"},
    {"objective": "plane", "fused_gn": False},
    {"objective": "plane", "normal_mode": "knn"},
    {"objective": "plane", "normal_mode": "knn_rbc"},
    {"robust": "trimmed", "fused_point": False},
    {"fused_point": False},
])
def test_once_refused_configs_construct_and_match_jax(d):
    jc, tc = _jax_config(d), config_from_dict(d)
    assert tc == config_from_dict(dataclasses.asdict(jc))
    for f in dataclasses.fields(tc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        assert (jv.value == tv.value) if isinstance(jv, enum.Enum) else jv == tv, f.name
    assert (tc.needs_normals, tc.needs_index) == (jc.needs_normals, jc.needs_index)


# The configurations slice 2 ports (the reference's bench gates).
SLICE2_DICTS = [
    {"objective": "plane", "estimate_scale": False},
    {"objective": "plane", "plane_symmetric": True, "estimate_scale": False},
    {"objective": "gicp", "estimate_scale": False},
    {"objective": "plane", "weighting": "regular", "robust": "trimmed",
     "robust_adaptive": True, "estimate_scale": False},
]


@pytest.mark.parametrize("d", SLICE2_DICTS)
def test_slice2_configs_construct_and_match_jax(d):
    jc = _jax_config(d)
    tc = config_from_dict(d)
    assert tc == config_from_dict(dataclasses.asdict(jc))
    for f in dataclasses.fields(tc):
        jv, tv = getattr(jc, f.name), getattr(tc, f.name)
        assert (jv.value == tv.value) if isinstance(jv, enum.Enum) else jv == tv, f.name
    assert tc.needs_normals == jc.needs_normals
    assert tc.needs_index == jc.needs_index


@pytest.mark.parametrize("d", SLICE_DICTS[:2] + [{"robust": "huber"},
                                                 {"robust": "tukey",
                                                  "robust_adaptive": True}])
def test_needs_normals_and_index_match_jax(d):
    jc, tc = _jax_config(d), config_from_dict(d)
    assert (tc.needs_normals, tc.needs_index) == (jc.needs_normals, jc.needs_index)


def test_params_cross_as_numpy():
    jp = J.ICPParams(alpha=2e2, translation_threshold=0.02).as_f32()
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)}
    tp = params_from_numpy(fields)
    for f in dataclasses.fields(tp):
        assert getattr(tp, f.name) == pytest.approx(float(fields[f.name]))
    tt = params_from_numpy(fields, device="cpu")
    assert tt.alpha.dtype == torch.float32 and tt.alpha.dim() == 0
    assert float(tt.alpha) == 200.0
