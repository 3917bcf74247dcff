"""Minimal URDF ingestion (xml.etree), host-side numpy.

Port of graphik_tpu/io/urdf.py without what only visualization and the
URDF-limit option use (visual/collision meshes, FK at a nonzero
configuration, `use_urdf_limits`); the port has not reached those yet. It
parses joints and links and compiles them into a `RobotTemplate`:

* zero-config FK over the link tree from the <origin> tags,
* per-actuated-joint frames re-aligned so local z == the joint axis,
* end-effector joints = joints with no actuated descendants; their frames
  are the raw child-link frames and *overwrite* aligned frames when the
  last actuated joint is also terminal (the reference's behaviour),
* node labels p0..pk assigned over (actuated joints in document order,
  then new end-effector joints), normalized so T0[p0] = I.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphik_tpu_torch.robots.templates import RobotTemplate, revolute_from_t_zero

ACTUATED_TYPES = ("revolute", "continuous")


def _rpy_to_R(r, p, y):
    """URDF fixed-axis roll-pitch-yaw: R = Rz(y) Ry(p) Rx(r)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _origin_to_T(origin: Optional[ET.Element]) -> np.ndarray:
    T = np.eye(4)
    if origin is None:
        return T
    xyz = [float(v) for v in origin.get("xyz", "0 0 0").split()]
    rpy = [float(v) for v in origin.get("rpy", "0 0 0").split()]
    T[:3, :3] = _rpy_to_R(*rpy)
    T[:3, 3] = xyz
    return T


def axis_alignment(axis: np.ndarray) -> np.ndarray:
    """Rotation mapping `axis` onto z_hat (shortest-arc atan2 form, valid
    for axes at any angle from z)."""
    axis = np.asarray(axis, dtype=float)
    axis = axis / np.linalg.norm(axis)
    z = np.array([0.0, 0.0, 1.0])
    c = np.cross(axis, z)
    s = np.linalg.norm(c)
    d = float(np.dot(axis, z))
    if s < 1e-12:
        if d > 0:
            return np.eye(3)
        # axis == -z: rotate pi about x
        return np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    r = c / s
    ang = np.arctan2(s, d)
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


@dataclasses.dataclass
class UrdfJoint:
    name: str
    jtype: str
    parent: str
    child: str
    T_origin: np.ndarray
    axis: np.ndarray
    limit_lower: Optional[float]
    limit_upper: Optional[float]

    @property
    def actuated(self) -> bool:
        return self.jtype in ACTUATED_TYPES


@dataclasses.dataclass
class UrdfModel:
    name: str
    joints: List[UrdfJoint]
    links: List[str]

    @classmethod
    def parse(cls, source: str) -> "UrdfModel":
        """Parse a URDF file path or XML string."""
        if source.lstrip().startswith("<"):
            root = ET.fromstring(source)
        else:
            root = ET.parse(source).getroot()
        joints = []
        for j in root.findall("joint"):
            lim = j.find("limit")
            axis = j.find("axis")
            joints.append(
                UrdfJoint(
                    name=j.get("name"),
                    jtype=j.get("type"),
                    parent=j.find("parent").get("link"),
                    child=j.find("child").get("link"),
                    T_origin=_origin_to_T(j.find("origin")),
                    axis=np.array([
                        float(v) for v in (
                            axis.get("xyz").split() if axis is not None
                            else ["0", "0", "1"]
                        )
                    ]),
                    limit_lower=float(lim.get("lower")) if lim is not None and lim.get("lower") else None,
                    limit_upper=float(lim.get("upper")) if lim is not None and lim.get("upper") else None,
                )
            )
        links = [l.get("name") for l in root.findall("link")]
        return cls(name=root.get("name", "robot"), joints=joints, links=links)

    # -- structure queries ------------------------------------------------
    @property
    def actuated_joints(self) -> List[UrdfJoint]:
        return [j for j in self.joints if j.actuated]

    def _children_of_link(self, link: str) -> List[UrdfJoint]:
        return [j for j in self.joints if j.parent == link]

    def _actuated_below(self, link: str) -> List[UrdfJoint]:
        """Actuated joints in the subtree under `link`."""
        out = []
        for j in self._children_of_link(link):
            if j.actuated:
                out.append(j)
            else:
                out.extend(self._actuated_below(j.child))
        return out

    def end_effector_joints(self) -> List[UrdfJoint]:
        """Joints with no actuated descendants (terminal actuated joints
        included - their aligned frames are then overwritten)."""
        return [j for j in self.joints if not self._actuated_below(j.child)]

    def link_fk(self) -> Dict[str, np.ndarray]:
        """World pose of every link at zero configuration."""
        parent_joint = {j.child: j for j in self.joints}
        fk: Dict[str, np.ndarray] = {}

        def pose(link: str) -> np.ndarray:
            if link not in fk:
                j = parent_joint.get(link)
                fk[link] = np.eye(4) if j is None else pose(j.parent) @ j.T_origin
            return fk[link]

        for l in self.links:
            pose(l)
        return fk

    # -- template construction -------------------------------------------
    def t_zero(self) -> Tuple[List[UrdfJoint], Dict[str, np.ndarray]]:
        """Ordered joint list + zero-configuration frame dict."""
        fk = self.link_fk()
        order: List[UrdfJoint] = []
        T: Dict[str, np.ndarray] = {}
        for j in self.actuated_joints:
            Tj = np.eye(4)
            Tj[:3, :3] = axis_alignment(j.axis)
            T[j.name] = fk[j.child] @ np.linalg.inv(Tj)
            order.append(j)
        for j in self.end_effector_joints():
            if j.name not in T:
                order.append(j)
            T[j.name] = fk[j.child]  # raw frame; overwrites terminal actuated
        return order, T

    def template(
        self, lb=None, ub=None, randomized_links: bool = False,
        randomize_percentage: float = 0.4, rng=None,
    ) -> RobotTemplate:
        """Compile to a RobotTemplate.

        Default limits are +-pi per joint. randomized_links scales each
        parent->child frame's delta translation by an independent uniform
        factor in [1 - p, 1 + p] drawn from `rng` (a numpy Generator or
        RandomState; default np.random), zeroing sub-1e-6 components.
        """
        order, T = self.t_zero()
        n_nodes = len(order)
        n = n_nodes - 1

        name_to_idx = {j.name: i for i, j in enumerate(order)}
        parents = -np.ones(n_nodes, dtype=np.int64)
        for i, j in enumerate(order):
            for c in self._children_of_link(j.child):
                if c.name in name_to_idx:
                    parents[name_to_idx[c.name]] = i

        # base-relative frames
        T0 = np.stack([T[j.name] for j in order])
        T0 = np.linalg.inv(T0[0])[None] @ T0

        if randomized_links:
            if rng is None:
                rng = np.random
            T_mod = T0.copy()

            def depth(i):
                k = 0
                while parents[i] >= 0:
                    i = int(parents[i])
                    k += 1
                return k

            for i in sorted(range(1, n_nodes), key=depth):
                par = int(parents[i])
                T_delta = np.linalg.inv(T0[par]) @ T0[i]
                scale = (1.0 - randomize_percentage) \
                    + 2.0 * randomize_percentage * rng.uniform()
                t_delta = T_delta[:3, 3] * scale
                t_delta[np.abs(t_delta) < 1e-6] = 0.0
                T_delta = T_delta.copy()
                T_delta[:3, 3] = t_delta
                T_mod[i] = T_mod[par] @ T_delta
            T0 = T_mod

        return revolute_from_t_zero(T0, parents, lb=lb, ub=ub)

