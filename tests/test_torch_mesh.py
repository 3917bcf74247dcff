"""The port's mesh pipeline (io/mesh.py, utils/visualization.py) against
the JAX package's on the fixtures of tests/test_mesh.py: the COLLADA, OBJ
and STL loaders and the primitive tessellators give the same vertices and
faces, the scene export writes the same OBJ geometry, and the matplotlib
renders work on the port's tensors. matplotlib is imported lazily by the
module; these tests run on the CPU."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure as JPS
from graphik_tpu.io import mesh as jmesh
from graphik_tpu.robots import library as jlib
from graphik_tpu.utils import visualization as jviz
from graphik_tpu_torch.graphs.problem import ProblemStructure as TPS
from graphik_tpu_torch.io import mesh as tmesh
from graphik_tpu_torch.robots import library as tlib
from graphik_tpu_torch.utils import visualization as tviz
from graphik_tpu_torch.utils.environments import ring_environment
from tests.test_mesh import (DAE_INSTANCE_NODE, POLYLIST, TRIANGLES, _write_dae)


def same(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


NESTED = """<node id="p"><translate>0 0 2000</translate>
  <node id="c"><rotate>0 0 1 90</rotate>
    <instance_geometry url="#tri-mesh"/></node></node>"""
MATRIX = """<node id="a"><matrix>
    1 0 0 5  0 1 0 0  0 0 1 0  0 0 0 1</matrix>
  <instance_geometry url="#tri-mesh"/></node>
  <node id="b"><instance_geometry url="#tri-mesh"/></node>"""


@pytest.mark.parametrize("kw", [
    dict(), dict(prim=POLYLIST), dict(nodes=NESTED), dict(nodes=MATRIX, meter="1"),
    dict(up="Y_UP", meter="1"), dict(up="X_UP", meter="1"), dict(nodes="", meter="1"),
    dict(prim=TRIANGLES, meter="0.01")], ids=lambda kw: "-".join(f"{k}" for k in kw) or "base")
def test_dae_matches_jax(tmp_path, kw):
    path = _write_dae(tmp_path, **kw)
    same(tmesh.load_dae(path), jmesh.load_dae(path))


def test_dae_instance_node(tmp_path):
    p = tmp_path / "inst.dae"
    p.write_text(DAE_INSTANCE_NODE)
    v, f = tmesh.load_dae(str(p))
    np.testing.assert_allclose(v, [[5, 0, 3], [6, 0, 3], [5, 1, 3]], atol=1e-12)
    same((v, f), jmesh.load_dae(str(p)))


def test_primitives_match_jax():
    same(tmesh.box_mesh([1, 2, 3]), jmesh.box_mesh([1, 2, 3]))
    same(tmesh.cylinder_mesh(0.5, 2.0, n_theta=12), jmesh.cylinder_mesh(0.5, 2.0, n_theta=12))
    same(tmesh.sphere_mesh(0.7), jmesh.sphere_mesh(0.7))
    for v, f in (tmesh.box_mesh([1, 2, 3]), tmesh.sphere_mesh(0.7)):
        tris = v[f]
        vol = np.einsum("ij,ij->i", tris[:, 0], np.cross(tris[:, 1], tris[:, 2])).sum() / 6.0
        assert vol > 0  # outward orientation


def test_obj_and_stl_round_trip(tmp_path):
    import struct

    v, f = tmesh.box_mesh([0.2, 0.3, 0.4])
    p = tmp_path / "box.obj"
    tviz.write_obj([("box", v, f)], str(p))
    same(tmesh.load_mesh(str(p)), jmesh.load_mesh(str(p)))
    np.testing.assert_allclose(np.sort(tmesh.load_obj(str(p))[0], axis=0), np.sort(v, axis=0),
                               atol=1e-6)
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    body = struct.pack("<I", 2)
    for _ in range(2):
        body += struct.pack("<3f", 0, 0, 1) + b"".join(struct.pack("<3f", *x) for x in tri)
        body += struct.pack("<H", 0)
    s = tmp_path / "part.stl"
    s.write_bytes((b"solid facetted_part" + b" " * 80)[:80] + body)
    same(tmesh.load_stl(str(s)), jmesh.load_stl(str(s)))
    assert tmesh.load_stl(str(s))[1].shape == (2, 3)
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.load_mesh("part.ply")


def test_export_scene_obj_matches_jax(tmp_path):
    """The solved-scene OBJ from a tensor q: the same objects and
    vertices as the JAX package's from the same angles."""
    tpl = tlib.load_ur10()[0]
    obs = [(np.array([0.5, 0.5, 0.5]), 0.2)]
    tps = TPS.from_template(tpl, obstacles=obs)
    jps = JPS.from_template(jlib.load_ur10()[0], obstacles=obs)
    q = np.random.RandomState(0).uniform(-np.pi, np.pi, 6)
    T = np.eye(4)
    nt = tviz.export_scene_obj(tps, torch.from_numpy(q), str(tmp_path / "t.obj"), T_goal=T)
    nj = jviz.export_scene_obj(jps, q, str(tmp_path / "j.obj"), T_goal=T)
    assert nt == nj

    def parse(path):
        lines = open(path).read().splitlines()
        return ([l for l in lines if l.startswith("o ")],
                np.array([[float(x) for x in l.split()[1:]] for l in lines if l.startswith("v ")]),
                [l for l in lines if l.startswith("f ")])

    ot, vt, ft = parse(tmp_path / "t.obj")
    oj, vj, fj = parse(tmp_path / "j.obj")
    assert ot == oj and ft == fj and len(ot) == 6 + 1 + 3
    np.testing.assert_allclose(vt, vj, rtol=0, atol=2e-6)  # 6-decimal text


def test_renders_on_tensors(tmp_path):
    """The matplotlib plots take the port's tensors: a planar chain among
    the ring's circles, a 3D scene with solution points, the point graph
    and the metric histograms."""
    tpl = tlib.load_planar_chain(10, limits=np.pi / 2)[0]
    ps = TPS.from_template(tpl, obstacles=ring_environment())
    q = torch.zeros(10, dtype=torch.float32)
    ax = tviz.plot_planar_robot(ps, q, T_goal=torch.eye(3)[None])
    assert len(ax.patches) == 6
    ax.figure.savefig(tmp_path / "planar.png", dpi=30)
    _, ur10 = tlib.load_ur10()
    q6 = torch.zeros(6, dtype=torch.float64)
    ax = tviz.visualize(ur10, q6, T_goal=torch.eye(4), points=torch.zeros(3, 3))
    ax.figure.savefig(tmp_path / "scene.png", dpi=30)
    ax = tviz.plot_revolute_points(ur10, ur10.realization(q6))
    ax.figure.savefig(tmp_path / "points.png", dpi=30)
    out = {"e_pos": torch.rand(50), "iterations": torch.arange(50)}
    ax = tviz.plot_solve_metrics(out)
    ax[0].figure.savefig(tmp_path / "metrics.png", dpi=30)
    for name in ("planar", "scene", "points", "metrics"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000
