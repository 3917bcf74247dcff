#!/usr/bin/env python3
"""Where the card and the CPU part on the float64 UR10 path (the TR's
"dense" backend), stage by stage. On a machine with a CUDA device:

    python3 tools/torch_f64_card_cpu.py --seeds 0 1 2 3

For each seed, 64 goals (random_goals from a CPU generator) go through
make_solver(TRParams.production(maxiter=100, maxinner=24)) with the UR10
path's 10-step polish and 2-squaring smoothing at float64, and it prints:
prepare's D_goal and Y0 on the card against the CPU (max |d|; Y0 may be
another rotation of the same Gram); riemannian.solve from the CPU's Y0 on
both after 1, 5, 20 and 100 iterations (max |d Y|, counts equal); the
finish of the CPU's solution on both (max |d q|, goals whose success
agrees); solve and finish from the CPU's prepare on both; and the whole
solver on both (goals whose success agrees).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--goals", type=int, default=64)
    args = p.parse_args()

    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.solvers import riemannian
    from graphik_tpu_torch.solvers.local import LocalParams
    from graphik_tpu_torch.solvers.riemannian import TRParams

    if not torch.cuda.is_available():
        print("torch_f64_card_cpu: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device("cuda:0"), torch.device("cpu")
    _, ps = load_ur10()
    solver = api.make_solver(ps, TRParams.production(maxiter=100, maxinner=24),
                             polish_params=LocalParams(maxiter=10, tol_grad=1e-8), smooth_iters=2)

    def hits(o):
        return ((o["e_pos"] < 1e-3) & (o["e_rot"] < torch.pi / 180) & o["success"]).cpu()

    def agree(a, b):
        return int((hits(a) == hits(b)).sum())

    n = args.goals
    for seed in args.seeds:
        T = api.random_goals(ps, (n,), torch.Generator().manual_seed(seed), dtype=torch.float64,
                         device="cpu")[0]
        Dc, Yc = solver.prepare(T)
        Dg, Yg = solver.prepare(T.to(dev))
        print(f"{seed} prepare: |dD| {float((Dg.cpu() - Dc).abs().max()):.3e} "
              f"|dY0| {float((Yg.cpu() - Yc).abs().max()):.3e}", flush=True)
        for it in (1, 5, 20, 100):
            params = TRParams.production(maxiter=it, maxinner=24)
            og, oc = (riemannian.solve(Yc.to(d_), Dc.to(d_), solver.omega, solver.psi_L,
                                       solver.psi_U, params=params) for d_ in (dev, cpu))
            same = all(bool(torch.equal(og[k].cpu(), oc[k])) for k in ("iterations", "num_inner"))
            print(f"{seed} solve {it}: |dY| {float((og['Y'].cpu() - oc['Y']).abs().max()):.3e}, "
                  f"counts equal {same}", flush=True)
        fg = solver.finish({k: v.to(dev) for k, v in oc.items()}, T.to(dev))
        fc = solver.finish(oc, T)
        print(f"{seed} finish from the same solution: |dq| "
              f"{float((fg['q'].cpu() - fc['q']).abs().max()):.3e}, success same "
              f"{agree(fg, fc)} / {n}", flush=True)
        wg = solver.finish(solver.solve(Yc.to(dev), Dc.to(dev)), T.to(dev))
        print(f"{seed} solve + finish from the same prepare: success same {agree(wg, fc)} / {n}",
              flush=True)
        print(f"{seed} whole solver: success same {agree(solver(T.to(dev)), solver(T))} / {n}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
