"""Carry compiled state between the JAX package and the port.

The system has no learned weights; what a caller may want to move across
is the compiled problem. Both directions go through plain numpy fields:
`dataclasses.asdict` of either package's `ProblemStructure` or
`EdgeProblem` gives the dict these functions take. Neither package is
imported here.
"""

from __future__ import annotations

import numpy as np

from graphik_tpu_torch.graphs.problem import ProblemStructure
from graphik_tpu_torch.ops.edge import EdgeProblem
from graphik_tpu_torch.robots.templates import RobotTemplate


def _copy(v):
    return v.copy() if isinstance(v, np.ndarray) else v


def structure_from_numpy(fields: dict) -> ProblemStructure:
    """Build the port's ProblemStructure from a field dict (the template
    given as a RobotTemplate or as a dict of its fields)."""
    f = {k: _copy(v) for k, v in fields.items()}
    tpl = f["template"]
    if not isinstance(tpl, RobotTemplate):
        tpl = RobotTemplate(**{k: _copy(v) for k, v in dict(tpl).items()})
    f["template"] = tpl
    f["names"] = list(f["names"])
    f["obstacles"] = [(np.asarray(c), float(r)) for c, r in f["obstacles"]]
    f["limited_joints"] = list(f["limited_joints"])
    return ProblemStructure(**f)


def edge_problem_from_numpy(fields: dict) -> EdgeProblem:
    """Build the port's EdgeProblem from a field dict."""
    return EdgeProblem(**{k: _copy(v) for k, v in fields.items()})
