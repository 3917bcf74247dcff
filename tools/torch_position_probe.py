#!/usr/bin/env python3
"""Whether a goal's result depends on its batch position, on planar10's
CG and float32 "dense" TR (the dense cost sums 13 x 13 values an
instance), for the graphik_tpu_torch of a tree: one seeded goal copied to
every position of a B stack, and B goals in reverse order.

    python3 tools/torch_position_probe.py [--tree DIR] [--B 256] [--device cuda]

One JSON line a path: for each output that splits, the split lanes
counted by position mod 4; for each output that moves when the stack is
reversed, the lanes that move. tests/test_torch_cuda.py -k batch_position
requires both empty; this tool also runs a parent's tree (`--tree`, an
unpacked `git archive`), where the test file may not import.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", default=".", help="the tree whose graphik_tpu_torch runs")
    p.add_argument("--B", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    import graphik_tpu_torch
    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_planar_chain
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import CGParams, TRParams

    print(json.dumps({"package": os.path.dirname(graphik_tpu_torch.__file__)}), flush=True)
    dev, B = torch.device(args.device), args.B
    ps = load_planar_chain(10, limits=np.pi / 2)[1]
    for name, params in (("planar10_cg", CGParams.production()),
                         ("planar10_dense",
                          TRParams.production(maxiter=100, maxinner=24, backend="dense"))):
        t0 = time.perf_counter()
        solver = api.make_solver(ps, params=params, smooth_iters=2,
                                 polish_params=LocalParams(maxiter=10, tol_grad=1e-8))

        def run(T):
            D, Y0 = solver.prepare(T)
            return {"D_goal": D, "Y0": Y0, **solver.finish(solver.solve(Y0, D), T)}

        T = api.random_goals(ps, (B,), torch.Generator().manual_seed(16), dtype=torch.float32,
                             device=dev)[0]
        copied = run(T[:1].expand(T.shape).contiguous())
        split = {k: [int((v != v[:1]).reshape(B, -1).any(-1)[r::4].sum()) for r in range(4)]
                 for k, v in copied.items() if not torch.equal(v, v[:1].expand_as(v))}
        fwd, rev = run(T), run(T.flip(0).contiguous())
        moved = {k: int((rev[k].flip(0) != v).reshape(B, -1).any(-1).sum())
                 for k, v in fwd.items() if not torch.equal(rev[k].flip(0), v)}
        print(json.dumps({"path": name, "B": B, "split_by_position_mod_4": split, "moved": moved,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if solver.graphs is not None:
            solver.graphs.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
