"""Smoke tests of the port's examples (examples/torch_*.py) on the CPU, at
small batches and short budgets: each runs end to end and reports numbers
in range. The examples default to the card; these pass device="cpu"."""

import importlib.util
import os

import pytest
import torch

from graphik_tpu_torch.solvers.cidgik import CidgikParams
from graphik_tpu_torch.solvers.riemannian import TRParams

torch.set_num_threads(2)
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_riemannian_example(capsys):
    stats = _load("torch_riemannian_example").main(
        batch=4, device="cpu", params=TRParams.production(maxiter=60, maxinner=32))
    assert 0.0 <= stats["success_rate"] <= 1.0 and stats["mean_iterations"] > 0
    assert "UR10 with 100 obstacles" in capsys.readouterr().out


SHORT = CidgikParams.production(max_outer=2, admm_iters=150, admm_iters_rest=50)


@pytest.mark.parametrize("entry", ["main", "main_obstacles", "main_floor"])
def test_cidgik_example(entry):
    out = getattr(_load("torch_cidgik_example"), entry)(batch=2, device="cpu", params=SHORT)
    for x in (out if isinstance(out, tuple) else (out,)):
        assert 0.0 <= x <= 1.0
