"""Port vs JAX package: robot templates and compiled problem structures.

Both packages compile robots host-side in numpy, so every array must be
equal exactly (same values, same dtype).
"""

import dataclasses

import numpy as np
import pytest
import torch

from graphik_tpu.robots import library as jlib
from graphik_tpu_torch import interop
from graphik_tpu_torch.io.urdf import UrdfModel as TUrdfModel
from graphik_tpu_torch.robots import library as tlib

torch.set_num_threads(1)

MODELS = sorted(tlib.ALL_MODELS)


def assert_same(a, b, path="root"):
    """Recursive exact equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", MODELS)
def test_template_arrays_equal(name):
    jt, _ = jlib.ALL_MODELS[name]()
    tt, _ = tlib.ALL_MODELS[name]()
    assert_same(dataclasses.asdict(tt), dataclasses.asdict(jt))


@pytest.mark.parametrize("name", MODELS)
def test_problem_structure_fields_equal(name):
    _, jps = jlib.ALL_MODELS[name]()
    _, tps = tlib.ALL_MODELS[name]()
    assert_same(dataclasses.asdict(tps), dataclasses.asdict(jps))
    for a, b in zip(tps.masks(), jps.masks()):
        np.testing.assert_array_equal(a, b)


def test_truncated_ur10_equal():
    for n in (3, 6):
        jt, jps = jlib.load_truncated_ur10(n)
        tt, tps = tlib.load_truncated_ur10(n)
        assert_same(dataclasses.asdict(tps), dataclasses.asdict(jps))


def test_randomized_links_equal():
    jt, _ = jlib.load_ur10(randomized_links=True, rng=np.random.RandomState(5))
    tt, _ = tlib.load_ur10(randomized_links=True, rng=np.random.RandomState(5))
    assert_same(dataclasses.asdict(tt), dataclasses.asdict(jt))


def test_urdf_asset_template_equal():
    """The XML path: a bundled URDF compiles to the JAX package's template."""
    import os

    from graphik_tpu.io.urdf import UrdfModel as JUrdfModel

    path = os.path.join(os.path.dirname(jlib.SPEC_DIR), os.pardir, "io", "assets", "ur10.urdf")
    jt = JUrdfModel.parse(path).template()
    tt = TUrdfModel.parse(path).template()
    assert_same(dataclasses.asdict(tt), dataclasses.asdict(jt))


@pytest.mark.parametrize("name", ["ur10", "kuka_iiwr", "panda"])
def test_interop_structure_round_trip(name):
    """structure_from_numpy on the JAX structure's fields builds a port
    structure whose fields equal them, and that round-trips."""
    _, jps = jlib.ALL_MODELS[name]()
    fields = dataclasses.asdict(jps)
    tps = interop.structure_from_numpy(fields)
    assert_same(dataclasses.asdict(tps), fields)
    again = interop.structure_from_numpy(dataclasses.asdict(tps))
    assert_same(dataclasses.asdict(again), fields)
