"""ModelParameters JSON schema parity tests (ModelParameters.cpp:37-72)."""

import json
import math

from mahi_mpc import ModelParameters


def test_roundtrip_with_inf_sentinel(tmp_path):
    p = ModelParameters(
        name="nonlinear_double_pendulum", num_x=4, num_u=2,
        step_size=0.002, num_shooting_nodes=25, is_linear=False,
        u_min=[-40.0, -40.0], u_max=[40.0, 40.0])
    path = p.save(tmp_path)
    q = ModelParameters.load("nonlinear_double_pendulum", tmp_path)
    assert q.name == p.name
    assert q.num_x == 4 and q.num_u == 2
    assert q.num_shooting_nodes == 25
    assert abs(q.step_size - 0.002) < 1e-12
    # default bounds round-trip through the +-10e30 sentinel back to inf
    assert all(math.isinf(v) and v < 0 for v in q.x_min)
    assert all(math.isinf(v) and v > 0 for v in q.x_max)
    assert q.u_min == [-40.0, -40.0]
    # on-disk format matches the reference schema
    raw = json.loads(path.read_text())
    m = raw["model"]
    assert m["step_size"] == 2000  # microseconds (ModelParameters.cpp:39-40)
    assert m["timespan"] == 2000 * 25
    assert m["x_min"] == [-10e30] * 4  # sentinel (ModelParameters.cpp:21-24)
    assert set(m) >= {"name", "timespan", "step_size", "num_x", "num_u",
                      "num_shooting_nodes", "x_min", "u_min", "x_max",
                      "u_max", "dll_filepath", "is_linear"}


def test_reference_format_file_loads(tmp_path):
    """A JSON file written by the reference C++ (no extension fields) loads."""
    ref_json = {"model": {
        "name": "m", "timespan": 50000, "step_size": 2000,
        "num_x": 4, "num_u": 2, "num_shooting_nodes": 25,
        "x_min": [-10e30] * 4, "x_max": [10e30] * 4,
        "u_min": [-5.0, -5.0], "u_max": [5.0, 5.0],
        "dll_filepath": "m.so", "is_linear": True}}
    (tmp_path / "m.json").write_text(json.dumps(ref_json))
    p = ModelParameters.load("m", tmp_path)
    assert p.is_linear and p.integrator == "euler"
    assert math.isinf(p.x_max[0])
    assert p.nv == 4 * 26 + 2 * 25
    # linear-mode parameter vector: traj + Q/R/Rm + A + B + xdot0 + x0 + u0
    assert p.num_params == 25 * 4 + 4 + 2 + 2 + 16 + 8 + 4 + 4 + 2


def test_shape_helpers():
    p = ModelParameters("x", num_x=3, num_u=2, step_size=0.01,
                        num_shooting_nodes=10)
    assert p.nv == 3 * 11 + 2 * 10
    assert p.num_params == 10 * 3 + 3 + 2 + 2 + 2
    assert abs(p.timespan - 0.1) < 1e-12
