"""Bundled robot model library.

Port of graphik_tpu/robots/library.py. The kinematic JSON specs are shared
data: they are read by path from graphik_tpu/robots/specs/ (no code of the
JAX package is imported). Each loader returns (RobotTemplate,
ProblemStructure).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.io.urdf import UrdfJoint, UrdfModel
from graphik_tpu_torch.robots.templates import RobotTemplate, revolute_from_dh

SPEC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "graphik_tpu", "robots", "specs",
)


def model_from_spec(name: str) -> UrdfModel:
    with open(os.path.join(SPEC_DIR, name + ".json")) as f:
        spec = json.load(f)
    joints = [
        UrdfJoint(
            name=j["name"],
            jtype=j["type"],
            parent=j["parent"],
            child=j["child"],
            T_origin=np.asarray(j["origin"], dtype=float),
            axis=np.asarray(j["axis"], dtype=float),
            limit_lower=j["limit_lower"],
            limit_upper=j["limit_upper"],
        )
        for j in spec["joints"]
    ]
    return UrdfModel(name=spec["name"], joints=joints, links=spec["links"])


def _load(name: str, limits=None, **kw) -> Tuple[RobotTemplate, ProblemStructure]:
    """kw passes through to UrdfModel.template (e.g. randomized_links)."""
    model = model_from_spec(name)
    if limits is None:
        tpl = model.template(**kw)
    else:
        tpl = model.template(lb=limits[0], ub=limits[1], **kw)
    return tpl, ProblemStructure.from_template(tpl)


def load_ur10(limits=None, **kw):
    return _load("ur10_mod", limits, **kw)


def load_kuka(limits=None, **kw):
    return _load("kuka_iiwr", limits, **kw)


def load_kuka_lwr(limits=None, **kw):
    return _load("kuka_lwr", limits, **kw)


def load_schunk_lwa4d(limits=None, **kw):
    return _load("lwa4d", limits, **kw)


def load_schunk_lwa4p(limits=None, **kw):
    return _load("lwa4p", limits, **kw)


def load_panda(limits=None, **kw):
    return _load("panda_arm", limits, **kw)


def load_panda_truncated(limits=None, **kw):
    return _load("panda_arm_truncated", limits, **kw)


def load_jaco(limits=None, **kw):
    return _load("jaco2arm6DOF_no_hand", limits, **kw)


ALL_MODELS = {
    "ur10": load_ur10,
    "kuka_iiwr": load_kuka,
    "kuka_lwr": load_kuka_lwr,
    "lwa4d": load_schunk_lwa4d,
    "lwa4p": load_schunk_lwa4p,
    "panda": load_panda,
    "panda_truncated": load_panda_truncated,
    "jaco": load_jaco,
}


def load_truncated_ur10(n: int):
    """First n links of a UR10 from DH constants."""
    a = [0, -0.612, -0.5723, 0, 0, 0][:n]
    d = [0.1273, 0, 0, 0.1639, 0.1157, 0.0922][:n]
    al = [np.pi / 2, 0, 0, np.pi / 2, -np.pi / 2, 0][:n]
    th = [0.0] * n
    tpl = revolute_from_dh(a, al, d, th)
    return tpl, ProblemStructure.from_template(tpl)
