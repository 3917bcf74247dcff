"""The visual parts of the port's URDF reader (io/urdf.py: UrdfVisual,
link FK at a configuration, cfg_from_q, resolve_mesh_path,
visual_meshes, the template round trip through URDF XML) and the meshed
scene builder, against the JAX package's on the fixtures of
tests/test_mesh.py and tests/test_urdf.py."""

import os

import numpy as np
import torch

from graphik_tpu.io import urdf as jurdf
from graphik_tpu.robots import library as jlib
from graphik_tpu.utils import visualization as jviz
from graphik_tpu_torch.io import urdf as turdf
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import visualization as tviz
from tests.test_mesh import _two_link_model

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "graphik_tpu", "io", "assets")


def _models(tmp_path):
    jm = _two_link_model(tmp_path)
    return jm, turdf.UrdfModel.parse(str(tmp_path / "robot.urdf"))


def test_visuals_parsed_like_jax(tmp_path):
    jm, tm = _models(tmp_path)
    assert sorted(v.kind for v in tm.visuals) == ["box", "cylinder", "mesh"]
    assert [c.kind for c in tm.collisions] == ["sphere"]
    assert tm.base_dir == jm.base_dir
    for a, b in zip(tm.visuals + tm.collisions, jm.visuals + jm.collisions, strict=True):
        assert (a.link, a.kind, a.filename) == (b.link, b.kind, b.filename)
        np.testing.assert_array_equal(a.T_origin, b.T_origin)
        np.testing.assert_array_equal(a.size, b.size)


def test_link_fk_and_cfg_from_q(tmp_path):
    jm, tm = _models(tmp_path)
    cfg = tm.cfg_from_q(torch.tensor([0.7], dtype=torch.float64).numpy())
    assert cfg == jm.cfg_from_q(np.array([0.7])) == {"j0": 0.7}
    for name, T in tm.link_fk(cfg).items():
        np.testing.assert_array_equal(T, jm.link_fk(cfg)[name])
    for name, T in tm.link_fk_zero().items():
        np.testing.assert_array_equal(T, jm.link_fk_zero()[name])


def test_visual_meshes_track_fk(tmp_path):
    jm, tm = _models(tmp_path)
    groups = tm.visual_meshes({"j0": np.pi / 2})
    ref = jm.visual_meshes({"j0": np.pi / 2})
    assert [g[0] for g in groups] == [g[0] for g in ref]
    for (_, v, f), (_, vj, fj) in zip(groups, ref):
        np.testing.assert_array_equal(v, vj)
        np.testing.assert_array_equal(f, fj)
    centers = {n: v.mean(axis=0) for n, v, _ in groups}
    np.testing.assert_allclose(centers["arm"], [0.25, 0, 0.2], atol=1e-6)
    np.testing.assert_allclose(centers["tip"], [0.5, 0, 0.2], atol=1e-3)
    assert len(tm.visual_meshes(collision=True)) == 1


def test_resolve_mesh_path_package_prefix(tmp_path):
    sub = tmp_path / "meshes"
    sub.mkdir()
    (sub / "part.stl").write_bytes(b"")
    m = turdf.UrdfModel.parse("<robot name='r'/>")
    got = m.resolve_mesh_path("package://some_pkg/meshes/part.stl", mesh_root=str(tmp_path))
    assert got == str(sub / "part.stl")
    assert m.resolve_mesh_path("/abs/part.stl") == "/abs/part.stl"


def test_make_scene_matches_jax(tmp_path):
    jm, tm = _models(tmp_path)
    groups = tviz.make_scene(tm, q=torch.tensor([0.5]))
    ref = jviz.make_scene(jm, q=np.array([0.5]))
    assert [g[0] for g in groups] == [g[0] for g in ref]
    for (_, v, f), (_, vj, fj) in zip(groups, ref):
        np.testing.assert_allclose(v, vj, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(f, fj)
    ax = tviz.visualize_meshes(groups, max_faces=500)
    ax.figure.savefig(str(tmp_path / "scene.png"), dpi=30)
    nv, nf = tviz.write_obj(groups, str(tmp_path / "scene.obj"))
    assert nv > 0 and nf > 0


def test_template_urdf_round_trip():
    """A template written as URDF parses back to the same template, and the
    XML is the JAX package's."""
    for load in ("load_ur10", "load_kuka", "load_schunk_lwa4d"):
        tpl = getattr(tlib, load)()[0]
        xml = turdf.template_to_urdf(tpl, name=load)
        assert xml == jurdf.template_to_urdf(getattr(jlib, load)()[0], name=load)
        back = turdf.UrdfModel.parse(xml).template()
        np.testing.assert_allclose(back.T0, tpl.T0, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(back.parents, tpl.parents)
    for r, p, y in ((0.1, -0.4, 2.0), (0.3, np.pi / 2, 0.0), (-1.0, -np.pi / 2, 0.0)):
        R = turdf._rpy_to_R(r, p, y)
        np.testing.assert_allclose(turdf._rpy_to_R(*turdf._R_to_rpy(R)), R, atol=1e-9)


def test_template_from_bundled_urdf():
    """The bundled UR10 URDF compiles to the spec twin's template, with and
    without the URDF's own limits, as in the JAX package."""
    path = os.path.join(ASSETS, "ur10.urdf")
    for kw in ({}, {"use_urdf_limits": True}):
        t = turdf.template_from_urdf(path, **kw)
        j = jurdf.template_from_urdf(path, **kw)
        np.testing.assert_array_equal(t.T0, j.T0)
        np.testing.assert_array_equal(t.lb, j.lb)
        np.testing.assert_array_equal(t.ub, j.ub)
    np.testing.assert_allclose(turdf.template_from_urdf(path).T0, tlib.load_ur10()[0].T0,
                               rtol=0, atol=1e-9)
