"""Minimal URDF ingestion (xml.etree), host-side numpy.

Port of graphik_tpu/io/urdf.py: joints, links and the visual and collision
geometry of each link, compiled into a `RobotTemplate`:

* zero-config FK over the link tree from the <origin> tags, and FK at a
  joint configuration (`link_fk(cfg)`, `cfg_from_q`),
* per-actuated-joint frames re-aligned so local z == the joint axis,
* end-effector joints = joints with no actuated descendants; their frames
  are the raw child-link frames and *overwrite* aligned frames when the
  last actuated joint is also terminal (the reference's behaviour),
* node labels p0..pk assigned over (actuated joints in document order,
  then new end-effector joints), normalized so T0[p0] = I,
* posed triangle meshes of the link geometry (`visual_meshes`, through
  io/mesh.py), and the inverse: a revolute template serialized to URDF
  (`template_to_urdf`).
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
    """Rotation mapping `axis` onto z_hat (reference get_T_from_joint_axis,
    roboturdf.py:266-297, but via the shortest-arc atan2 form, which is
    correct for axes at any angle from z, not only within 90 degrees)."""
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
class UrdfVisual:
    """One <visual> (or <collision>) geometry attached to a link.

    kind is one of "mesh", "box", "cylinder", "sphere"; `filename` is the
    raw URDF reference for meshes (resolved lazily against the URDF's
    directory or an explicit mesh root — see UrdfModel.resolve_mesh_path);
    `size` holds the primitive parameters (box size xyz / [radius] /
    [radius, length]) or the mesh scale factors.
    """

    link: str
    kind: str
    T_origin: np.ndarray
    filename: Optional[str] = None
    size: Optional[np.ndarray] = None


def _parse_visuals(root: ET.Element, tag: str) -> List["UrdfVisual"]:
    out = []
    for link in root.findall("link"):
        for vis in link.findall(tag):
            geom = vis.find("geometry")
            if geom is None:
                continue
            T = _origin_to_T(vis.find("origin"))
            mesh = geom.find("mesh")
            box = geom.find("box")
            cyl = geom.find("cylinder")
            sph = geom.find("sphere")
            if mesh is not None:
                scale = np.array(
                    [float(v) for v in mesh.get("scale", "1 1 1").split()]
                )
                out.append(UrdfVisual(
                    link=link.get("name"), kind="mesh", T_origin=T,
                    filename=mesh.get("filename"), size=scale,
                ))
            elif box is not None:
                out.append(UrdfVisual(
                    link=link.get("name"), kind="box", T_origin=T,
                    size=np.array(
                        [float(v) for v in box.get("size").split()]
                    ),
                ))
            elif cyl is not None:
                out.append(UrdfVisual(
                    link=link.get("name"), kind="cylinder", T_origin=T,
                    size=np.array([
                        float(cyl.get("radius")), float(cyl.get("length"))
                    ]),
                ))
            elif sph is not None:
                out.append(UrdfVisual(
                    link=link.get("name"), kind="sphere", T_origin=T,
                    size=np.array([float(sph.get("radius"))]),
                ))
    return out


@dataclasses.dataclass
class UrdfModel:
    name: str
    joints: List[UrdfJoint]
    links: List[str]
    visuals: List[UrdfVisual] = dataclasses.field(default_factory=list)
    collisions: List[UrdfVisual] = dataclasses.field(default_factory=list)
    base_dir: Optional[str] = None

    @classmethod
    def parse(cls, source: str) -> "UrdfModel":
        """Parse a URDF file path or XML string."""
        base_dir = None
        if source.lstrip().startswith("<"):
            root = ET.fromstring(source)
        else:
            import os

            root = ET.parse(source).getroot()
            base_dir = os.path.dirname(os.path.abspath(source))
        joints = []
        for j in root.findall("joint"):
            lim = j.find("limit")
            joints.append(
                UrdfJoint(
                    name=j.get("name"),
                    jtype=j.get("type"),
                    parent=j.find("parent").get("link"),
                    child=j.find("child").get("link"),
                    T_origin=_origin_to_T(j.find("origin")),
                    axis=np.array(
                        [
                            float(v)
                            for v in (
                                j.find("axis").get("xyz").split()
                                if j.find("axis") is not None
                                else ["0", "0", "1"]
                            )
                        ]
                    ),
                    limit_lower=float(lim.get("lower")) if lim is not None and lim.get("lower") else None,
                    limit_upper=float(lim.get("upper")) if lim is not None and lim.get("upper") else None,
                )
            )
        links = [l.get("name") for l in root.findall("link")]
        return cls(
            name=root.get("name", "robot"), joints=joints, links=links,
            visuals=_parse_visuals(root, "visual"),
            collisions=_parse_visuals(root, "collision"),
            base_dir=base_dir,
        )

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
        """Joints with no actuated descendants.

        Note this includes terminal *actuated* joints - the reference then
        overwrites their aligned frames with raw link frames.
        """
        return [j for j in self.joints if not self._actuated_below(j.child)]

    def link_fk_zero(self) -> Dict[str, np.ndarray]:
        """World pose of every link at zero configuration."""
        return self.link_fk()

    def link_fk(self, cfg: Optional[Dict[str, float]] = None
                ) -> Dict[str, np.ndarray]:
        """World pose of every link at configuration `cfg`.

        cfg maps joint NAME -> value; missing joints sit at zero (the
        reference's urdfpy `link_fk(cfg=...)` semantics, roboturdf.py:132).
        Revolute/continuous joints rotate about their axis; prismatic
        joints translate along it; fixed joints ignore cfg.
        """
        cfg = cfg or {}
        parent_joint = {j.child: j for j in self.joints}
        fk: Dict[str, np.ndarray] = {}

        def joint_T(j: UrdfJoint) -> np.ndarray:
            v = float(cfg.get(j.name, 0.0))
            T = j.T_origin
            if v == 0.0:
                return T
            M = np.eye(4)
            if j.jtype in ACTUATED_TYPES:
                a = j.axis / np.linalg.norm(j.axis)
                K = np.array([
                    [0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]
                ])
                M[:3, :3] = (np.eye(3) + np.sin(v) * K
                             + (1 - np.cos(v)) * K @ K)
            elif j.jtype == "prismatic":
                M[:3, 3] = v * j.axis / np.linalg.norm(j.axis)
            return T @ M

        def pose(link: str) -> np.ndarray:
            if link in fk:
                return fk[link]
            j = parent_joint.get(link)
            T = np.eye(4) if j is None else pose(j.parent) @ joint_T(j)
            fk[link] = T
            return T

        for l in self.links:
            pose(l)
        return fk

    def cfg_from_q(self, q) -> Dict[str, float]:
        """Map a template joint vector to a URDF joint-name config.

        q[k] is the angle of the k-th actuated joint in document order —
        exactly the reference's `map_to_urdf_ind` contract
        (roboturdf.py:26-38, 178-190: label p{k+1} -> actuated joint k).
        """
        q = np.asarray(q, dtype=float).reshape(-1)
        act = self.actuated_joints
        return {j.name: float(q[k]) for k, j in enumerate(act[: len(q)])}

    def resolve_mesh_path(self, filename: str,
                          mesh_root: Optional[str] = None) -> str:
        """Resolve a URDF mesh reference to a filesystem path.

        `package://<pkg>/rest` drops the package prefix and resolves
        `rest` against mesh_root (or the URDF's own directory); plain
        relative paths resolve against the same roots.
        """
        import os

        fn = filename
        if fn.startswith("package://"):
            fn = fn[len("package://"):]
            fn = fn.split("/", 1)[1] if "/" in fn else fn
        if os.path.isabs(fn):
            return fn
        for root in (mesh_root, self.base_dir):
            if root is not None:
                cand = os.path.join(root, fn)
                if os.path.exists(cand):
                    return cand
        return fn

    def visual_meshes(
        self,
        cfg: Optional[Dict[str, float]] = None,
        mesh_root: Optional[str] = None,
        collision: bool = False,
    ) -> List[Tuple[str, np.ndarray, np.ndarray]]:
        """Posed triangle meshes for every link geometry.

        The mesh-assembly half of the reference's pyrender scene
        (urdf_visualization.py:9-60: urdf.show poses trimesh link meshes
        at the FK frames). Returns [(link_name, verts (V, 3) world-frame,
        faces (F, 3))]; primitives (box/cylinder/sphere) are tessellated.
        Missing mesh files are skipped (the caller can still render the
        remaining geometry).
        """
        from graphik_tpu_torch.io import mesh as _mesh

        fk = self.link_fk(cfg)
        out = []
        for vis in (self.collisions if collision else self.visuals):
            if vis.link not in fk:
                continue
            if vis.kind == "mesh":
                import os

                path = self.resolve_mesh_path(vis.filename, mesh_root)
                if not os.path.exists(path):
                    continue
                v, f = _mesh.load_mesh(path)
                if vis.size is not None:
                    v = v * vis.size
            elif vis.kind == "box":
                v, f = _mesh.box_mesh(vis.size)
            elif vis.kind == "cylinder":
                v, f = _mesh.cylinder_mesh(vis.size[0], vis.size[1])
            elif vis.kind == "sphere":
                v, f = _mesh.sphere_mesh(vis.size[0])
            else:
                continue
            T = fk[vis.link] @ vis.T_origin
            out.append((vis.link, v @ T[:3, :3].T + T[:3, 3], f))
        return out

    # -- template construction -------------------------------------------
    def t_zero(self, cfg: Optional[Dict[str, float]] = None
               ) -> Tuple[List[UrdfJoint], Dict[str, np.ndarray]]:
        """Ordered joint list + frame dict.

        With `cfg`, frames are taken at that configuration (the reference's
        extract_T_zero_from_URDF(q=q) path used by its scene builder,
        urdf_visualization.py:34-42)."""
        fk = self.link_fk(cfg)
        order: List[UrdfJoint] = []
        T: Dict[str, np.ndarray] = {}
        for j in self.actuated_joints:
            A = axis_alignment(j.axis)
            Tj = np.eye(4)
            Tj[:3, :3] = A
            T[j.name] = fk[j.child] @ np.linalg.inv(Tj)
            order.append(j)
        for j in self.end_effector_joints():
            if j.name not in T:
                order.append(j)
            T[j.name] = fk[j.child]  # raw frame; overwrites terminal actuated
        return order, T

    def template(
        self, lb=None, ub=None, use_urdf_limits: bool = False,
        randomized_links: bool = False, randomize_percentage: float = 0.4,
        rng=None,
    ) -> RobotTemplate:
        """Compile to a RobotTemplate (make_Revolute3d, roboturdf.py:226-264).

        Default limits are +-pi per joint (the reference loaders',
        roboturdf.py:299-371); `use_urdf_limits` clips the URDF's own limits
        to +-pi.

        randomized_links: scale each parent->child
        frame's delta TRANSLATION by an independent uniform factor in
        [1 - p, 1 + p] (p = randomize_percentage), zeroing sub-1e-6
        components, then recompose the zero-configuration frames - a
        perturbed-kinematics robot for robustness experiments. The
        reference walks consecutive list entries; we walk the parent tree,
        which is identical on chains (all the reference URDF robots) and
        correct on trees. `rng` is a np.random.Generator/RandomState
        (default: np.random, matching the reference's global-state use).
        """
        order, T = self.t_zero()
        n_nodes = len(order)
        n = n_nodes - 1

        # parents over the ordered joints
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
            # parent-before-child order (URDF joint lists are usually
            # already topological; sorting by depth makes it certain)
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

        if lb is None:
            if use_urdf_limits:
                lb = np.array(
                    [
                        np.clip(j.limit_lower if j.limit_lower is not None else -np.pi, -np.pi, np.pi)
                        for j in order[1 : n + 1]
                    ]
                )
                ub = np.array(
                    [
                        np.clip(j.limit_upper if j.limit_upper is not None else np.pi, -np.pi, np.pi)
                        for j in order[1 : n + 1]
                    ]
                )
            else:
                lb = -np.pi * np.ones(n)
                ub = np.pi * np.ones(n)

        return revolute_from_t_zero(T0, parents, lb=lb, ub=ub)


def template_from_urdf(path: str, lb=None, ub=None, **kw) -> RobotTemplate:
    return UrdfModel.parse(path).template(lb=lb, ub=ub, **kw)


def _R_to_rpy(R: np.ndarray) -> Tuple[float, float, float]:
    """Inverse of _rpy_to_R (URDF fixed-axis convention R = Rz Ry Rx)."""
    cp = np.hypot(R[0, 0], R[1, 0])
    p = np.arctan2(-R[2, 0], cp)
    if cp < 1e-9:
        # gimbal lock (pitch = +-pi/2): only r -+ y is determined; pick y=0.
        y = 0.0
        if R[2, 0] < 0:  # p = +pi/2: R[0,1] = sin(r - y)
            r = np.arctan2(R[0, 1], R[1, 1])
        else:  # p = -pi/2: R[0,1] = -sin(r + y)
            r = np.arctan2(-R[0, 1], R[1, 1])
    else:
        y = np.arctan2(R[1, 0], R[0, 0])
        r = np.arctan2(R[2, 1], R[2, 2])
    return float(r), float(p), float(y)


def template_to_urdf(tpl: RobotTemplate, name: str = "robot") -> str:
    """Serialize a revolute RobotTemplate to URDF XML.

    Each node's zero-config frame becomes a link; joint origins are the
    parent-relative transforms and every joint axis is the local z (the
    template convention: frame z IS the rotation axis). Parsing the result
    with UrdfModel reproduces the template exactly, which is how the
    bundled .urdf assets are generated (tools/make_urdf_assets.py) and how
    the XML path is regression-tested without copying any external URDF.
    """
    assert tpl.dim == 3, "URDF serialization is for revolute (3D) templates"
    T0 = np.asarray(tpl.T0)
    parents = np.asarray(tpl.parents)
    out = [f'<robot name="{name}">']
    out.append('  <link name="link0"/>')
    out.append('  <joint name="joint0" type="revolute">')
    out.append('    <parent link="world"/>')
    out.append('    <child link="link0"/>')
    out.append('    <axis xyz="0 0 1"/>')
    out.append('  </joint>')
    out.append('  <link name="world"/>')
    for i in range(1, tpl.n_nodes):
        p = int(parents[i])
        rel = np.linalg.inv(T0[p]) @ T0[i]
        r, pt, yw = _R_to_rpy(rel[:3, :3])
        x, yy, z = rel[:3, 3]
        out.append(f'  <link name="link{i}"/>')
        out.append(f'  <joint name="joint{i}" type="revolute">')
        out.append(f'    <parent link="link{p}"/>')
        out.append(f'    <child link="link{i}"/>')
        out.append(
            f'    <origin xyz="{x:.17g} {yy:.17g} {z:.17g}" '
            f'rpy="{r:.17g} {pt:.17g} {yw:.17g}"/>'
        )
        out.append('    <axis xyz="0 0 1"/>')
        out.append(
            f'    <limit lower="{float(tpl.lb[i]):.17g}" '
            f'upper="{float(tpl.ub[i]):.17g}" effort="1" velocity="1"/>'
        )
        out.append('  </joint>')
    out.append('</robot>')
    return "\n".join(out)
