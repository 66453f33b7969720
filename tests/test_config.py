"""Configuration loading without a YAML package: the bundled per-scenario
files load to pinned values, and the reader rejects YAML it does not
implement instead of misreading it."""

import pytest

from commonroad_rp_jax.utils.config import (ReactivePlannerConfiguration,
                                            load_yaml_subset)

_COMMON_PLANNING = {"dt": 0.1, "replanning_frequency": 3,
                    "time_steps_computation": 20}
_DEBUG = {"show_plots": False, "save_plots": False, "draw_traj_set": False}

_EXPECTED = {
    "DEU_Test-1_1_T-1": {
        "planning": _COMMON_PLANNING, "vehicle": {"id_type_vehicle": 2},
        "sampling": {"t_min": 0.2}, "debug": {**_DEBUG, "draw_icons": True}},
    "ZAM-Ramp-1_1-T-1": {
        "planning": _COMMON_PLANNING, "vehicle": {"id_type_vehicle": 2},
        "sampling": {"t_min": 0.4}, "debug": _DEBUG},
    "ZAM_Over-1_1": {
        "planning": _COMMON_PLANNING, "vehicle": {"id_type_vehicle": 2},
        "sampling": {"sampling_method": 1, "t_min": 0.4},
        "debug": {**_DEBUG, "draw_icons": True}},
    "ZAM_Tjunction-1_42_T-1": {
        "planning": {**_COMMON_PLANNING, "low_vel_mode_threshold": 2},
        "vehicle": {"id_type_vehicle": 2}, "sampling": {"t_min": 1.0},
        "debug": {**_DEBUG, "draw_icons": True}},
}


@pytest.mark.parametrize("name", sorted(_EXPECTED))
def test_bundled_config_loads_pinned_values(repo_root, name):
    path = repo_root / "configurations" / f"{name}.yaml"
    assert load_yaml_subset(path.read_text()) == _EXPECTED[name]

    config = ReactivePlannerConfiguration.load(path, f"{name}.xml")
    want = _EXPECTED[name]
    for section, values in want.items():
        for key, value in values.items():
            got = getattr(getattr(config, section), key)
            assert got == value and type(got) is type(value), (section, key)
    assert config.planning.planning_horizon == pytest.approx(2.0)
    assert config.general.name_scenario == f"{name}.xml"


@pytest.mark.parametrize("text", [
    "planning:\n  - dt\n",               # block sequence
    "planning: &anchor\n  dt: 0.1\n",     # anchor
    "planning:\n  dt 0.1\n",              # missing colon
    "a: 1\na: 2\n",                       # duplicate key
])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        load_yaml_subset(text)
