"""Triangle-mesh ingestion: OBJ, STL and COLLADA (.dae), numpy only.

Port of graphik_tpu/io/mesh.py (the same loaders and primitives, host
numpy): every format returns a plain ``(vertices (V, 3) float64, faces
(F, 3) int64)`` pair for matplotlib rendering or OBJ export
(utils/visualization.py).

COLLADA support covers the profile robot-arm assets use: <triangles> and
<polylist> primitives, <source>/<accessor> with any stride, multi-<node>
visual scenes with <matrix>/<translate>/<rotate>/<scale> transforms
(nested nodes compose), <instance_node> indirection, per-document
<unit meter=...> scaling and Y_UP/X_UP up-axis conversion to Z-up.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

_C = "{http://www.collada.org/2005/11/COLLADASchema}"


def _floats(text: Optional[str]) -> np.ndarray:
    return np.array([] if not text else text.split(), dtype=float)


def _ints(text: Optional[str]) -> np.ndarray:
    return np.array([] if not text else text.split(), dtype=np.int64)


def _dae_sources(mesh: ET.Element) -> Dict[str, np.ndarray]:
    """id -> (count, stride) array for every <source> in a <mesh>."""
    out = {}
    for src in mesh.findall(_C + "source"):
        arr_el = src.find(_C + "float_array")
        if arr_el is None:
            continue
        data = _floats(arr_el.text)
        stride = 3
        acc = src.find(f"{_C}technique_common/{_C}accessor")
        if acc is not None and acc.get("stride"):
            stride = int(acc.get("stride"))
        n = len(data) // stride
        out[src.get("id")] = data[: n * stride].reshape(n, stride)[:, :3]
    return out


def _dae_geometry(geom: ET.Element) -> Tuple[np.ndarray, np.ndarray]:
    """One <geometry> -> (verts, faces), merging all primitive blocks."""
    mesh = geom.find(_C + "mesh")
    if mesh is None:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    sources = _dae_sources(mesh)

    # <vertices> indirection: the VERTEX input points at this id
    vert_id_map = {}
    for v in mesh.findall(_C + "vertices"):
        for inp in v.findall(_C + "input"):
            if inp.get("semantic") == "POSITION":
                vert_id_map[v.get("id")] = inp.get("source").lstrip("#")

    verts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []
    n_base = 0
    for prim in list(mesh.findall(_C + "triangles")) + list(
        mesh.findall(_C + "polylist")
    ):
        inputs = prim.findall(_C + "input")
        if not inputs:
            continue
        stride = 1 + max(int(i.get("offset", "0")) for i in inputs)
        v_off, v_src = 0, None
        for i in inputs:
            if i.get("semantic") == "VERTEX":
                v_off = int(i.get("offset", "0"))
                sid = i.get("source").lstrip("#")
                v_src = sources.get(vert_id_map.get(sid, sid))
        if v_src is None:
            continue
        p = _ints(prim.findtext(_C + "p"))
        if not len(p):
            continue
        idx = p.reshape(-1, stride)[:, v_off]
        if prim.tag == _C + "polylist":
            vcount = _ints(prim.findtext(_C + "vcount"))
            tris = []
            pos = 0
            for vc in vcount:
                poly = idx[pos : pos + vc]
                for j in range(1, vc - 1):  # fan-triangulate
                    tris.append([poly[0], poly[j], poly[j + 1]])
                pos += vc
            faces = np.asarray(tris, np.int64).reshape(-1, 3)
        else:
            faces = idx.reshape(-1, 3)
        verts_all.append(v_src)
        faces_all.append(faces + n_base)
        n_base += len(v_src)
    if not verts_all:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.concatenate(verts_all), np.concatenate(faces_all)


def _dae_node_transform(node: ET.Element) -> np.ndarray:
    """Compose this node's local transform elements in document order."""
    T = np.eye(4)
    for el in node:
        tag = el.tag
        if tag == _C + "matrix":
            T = T @ _floats(el.text).reshape(4, 4)
        elif tag == _C + "translate":
            M = np.eye(4)
            M[:3, 3] = _floats(el.text)[:3]
            T = T @ M
        elif tag == _C + "rotate":
            x, y, z, ang = _floats(el.text)[:4]
            a = np.deg2rad(ang)
            r = np.array([x, y, z])
            n = np.linalg.norm(r)
            if n > 1e-12:
                r = r / n
                K = np.array([
                    [0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]
                ])
                M = np.eye(4)
                M[:3, :3] = (
                    np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
                )
                T = T @ M
        elif tag == _C + "scale":
            M = np.eye(4)
            np.fill_diagonal(M[:3, :3], _floats(el.text)[:3])
            T = T @ M
    return T


def load_dae(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a COLLADA file as one merged triangle soup: every geometry
    instanced by the visual scene, posed by its (nested) node transforms,
    scaled by the document unit, and rotated into Z-up."""
    root = ET.parse(path).getroot()

    geoms: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for g in root.iter(_C + "geometry"):
        geoms[g.get("id")] = _dae_geometry(g)

    verts_all: List[np.ndarray] = []
    faces_all: List[np.ndarray] = []
    n_base = 0

    def emit(gid: str, T: np.ndarray):
        nonlocal n_base
        if gid not in geoms:
            return
        v, f = geoms[gid]
        if not len(v):
            return
        vw = v @ T[:3, :3].T + T[:3, 3]
        verts_all.append(vw)
        faces_all.append(f + n_base)
        n_base += len(vw)

    # id -> node element anywhere in the document (library_nodes or scene),
    # for <instance_node url="#id"> indirection (SketchUp and some Blender
    # exports route all geometry through library_nodes).
    nodes_by_id = {
        n.get("id"): n for n in root.iter(_C + "node") if n.get("id")
    }

    def walk(node: ET.Element, T_parent: np.ndarray, seen=frozenset()):
        T = T_parent @ _dae_node_transform(node)
        for ig in node.findall(_C + "instance_geometry"):
            emit(ig.get("url", "").lstrip("#"), T)
        for inode in node.findall(_C + "instance_node"):
            ref_id = inode.get("url", "").lstrip("#")
            ref = nodes_by_id.get(ref_id)
            if ref is not None and ref_id not in seen:  # guard cycles
                walk(ref, T, seen | {ref_id})
        for child in node.findall(_C + "node"):
            walk(child, T, seen)

    scenes = root.find(_C + "library_visual_scenes")
    instanced = False
    if scenes is not None:
        for vs in scenes.findall(_C + "visual_scene"):
            for node in vs.findall(_C + "node"):
                walk(node, np.eye(4))
        instanced = n_base > 0
    if not instanced:
        # no visual scene: take every geometry at identity
        for gid in geoms:
            emit(gid, np.eye(4))

    if not verts_all:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_all)
    faces = np.concatenate(faces_all)

    unit = root.find(f"{_C}asset/{_C}unit")
    if unit is not None and unit.get("meter"):
        verts = verts * float(unit.get("meter"))
    up = root.findtext(f"{_C}asset/{_C}up_axis", "Z_UP").strip()
    if up == "Y_UP":  # rotation (x, y, z) -> (x, -z, y): old y becomes up
        verts = verts[:, [0, 2, 1]] * np.array([1.0, -1.0, 1.0])
    elif up == "X_UP":  # cyclic rotation (x, y, z) -> (y, z, x)
        verts = verts[:, [1, 2, 0]]
    return verts, faces


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Wavefront OBJ: v/f records, fan-triangulated, negative indices ok."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    k = int(tok.split("/")[0])
                    idx.append(k - 1 if k > 0 else len(verts) + k)
                for j in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[j], idx[j + 1]])
    return (np.asarray(verts, float),
            np.asarray(faces, np.int64).reshape(-1, 3))


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """STL, ascii or binary. Per-facet vertices; no dedup is attempted."""
    with open(path, "rb") as f:
        raw = f.read()
    head = raw[:512].lstrip()
    # "solid ..." headers appear in BINARY files too (exporters write
    # 'solid <name>' into the 80-byte header), so the discriminator is the
    # binary size formula 84 + 50*n_tri, not the header text.
    is_binary = False
    if len(raw) >= 84:
        (n_tri,) = struct.unpack_from("<I", raw, 80)
        is_binary = len(raw) == 84 + 50 * n_tri
    verts = np.zeros((0, 3), float)
    if not is_binary and head.startswith(b"solid"):
        verts = []
        for line in raw.decode("ascii", "ignore").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(x) for x in parts[1:4]])
        verts = np.asarray(verts, float)
        if not len(verts) and len(raw) >= 84 and len(raw) >= 84 + 50 * n_tri:
            # No ascii vertices but a plausible binary body (e.g. trailing
            # junk broke the exact size match): parse as binary after all.
            is_binary = True
    if is_binary:
        (n_tri,) = struct.unpack_from("<I", raw, 80)
        data = np.frombuffer(
            raw, dtype=np.uint8, count=50 * n_tri, offset=84
        ).reshape(n_tri, 50)
        tri = data[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
        verts = tri.reshape(-1, 3).astype(float)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def box_mesh(size) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box centered at the origin (URDF <box size>)."""
    sx, sy, sz = np.asarray(size, float) / 2.0
    v = np.array([
        [x, y, z] for x in (-sx, sx) for y in (-sy, sy) for z in (-sz, sz)
    ])
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z faces
    ], np.int64)
    return v, f


def cylinder_mesh(radius: float, length: float, n_theta: int = 24
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Capped cylinder along local z, centered at the origin
    (URDF <cylinder radius length>)."""
    th = np.linspace(0.0, 2 * np.pi, n_theta, endpoint=False)
    ring = np.stack([radius * np.cos(th), radius * np.sin(th)], axis=1)
    lo = np.concatenate([ring, np.full((n_theta, 1), -length / 2)], axis=1)
    hi = np.concatenate([ring, np.full((n_theta, 1), length / 2)], axis=1)
    verts = np.concatenate(
        [lo, hi, [[0, 0, -length / 2]], [[0, 0, length / 2]]]
    )
    faces = []
    for j in range(n_theta):
        j2 = (j + 1) % n_theta
        faces += [[j, j2, n_theta + j], [j2, n_theta + j2, n_theta + j]]
        faces += [[2 * n_theta, j2, j],
                  [2 * n_theta + 1, n_theta + j, n_theta + j2]]
    return verts, np.asarray(faces, np.int64)


def sphere_mesh(radius: float, n_theta: int = 16, n_phi: int = 12
                ) -> Tuple[np.ndarray, np.ndarray]:
    """UV sphere at the origin (URDF <sphere radius>)."""
    phi = np.linspace(0.0, np.pi, n_phi)
    th = np.linspace(0.0, 2 * np.pi, n_theta, endpoint=False)
    P, T = np.meshgrid(phi, th, indexing="ij")
    verts = radius * np.stack([
        np.sin(P) * np.cos(T), np.sin(P) * np.sin(T), np.cos(P)
    ], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_phi - 1):
        for j in range(n_theta):
            j2 = (j + 1) % n_theta
            a = i * n_theta + j
            b = i * n_theta + j2
            c = (i + 1) * n_theta + j
            d = (i + 1) * n_theta + j2
            faces += [[a, c, b], [b, c, d]]  # outward (CCW from outside)
    return verts, np.asarray(faces, np.int64)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch on extension: .obj, .stl or .dae."""
    lower = path.lower()
    if lower.endswith(".obj"):
        return load_obj(path)
    if lower.endswith(".stl"):
        return load_stl(path)
    if lower.endswith(".dae"):
        return load_dae(path)
    raise ValueError(f"unsupported mesh format: {path}")
