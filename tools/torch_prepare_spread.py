#!/usr/bin/env python3
"""Which stage of the port's prepare first depends on the goal, on the CPU
and on the card, for one parity config's saved goals:

    python3 tools/torch_prepare_spread.py --goals build/parity/planar40_smooth2_s56.npz

The goals (and the config, hence the robot and its smoothing) come from
the JAX half of tools/torch_parity.py. On each device (the CPU, and the
card where there is one) the MDS init of
riemannian.generate_initialization is taken apart in float32: the
smoothed instance (D_goal, lb, ub), D = (lb + 0.9 (ub - lb))^2, its row,
column and whole means, the Gram G and the symmetrised Gs, K5's
eigendecomposition of Gs (w, V), the MDS factor X, the edge scatter S,
its top basis (K5 again) and Y0 = X basis; then the compiled solver's
prepare Y0. For each stage it prints the spread over the goals (max |x_g
- x_0| and the goals whose x_g is not bitwise x_0), on the card the
largest difference from the CPU's stage, and the first stage past D (the
stages up to D take the goal's distances by construction) that depends
on the goal. Two checks split a goal's effect from its batch position's
in D's whole mean: goal 0's D at every position, and the stack in
reverse order. Two cross-feeds split the eigendecompositions from what
feeds them: the card's sym_eigh on the CPU's Gs and on the CPU's S (a
spread there is the kernel's; none there and one in the card's own w / V
means its input differed). The saved JAX Y0's spread is printed beside.
One JSON line a device, then one for the cross-feeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# the stages that take the goal's distances by construction
BY_GOAL = ("D_goal", "lb", "ub", "D")


def spread(x):
    """{"spread": max |x_g - x_0|, "goals_differ": goals not bitwise goal
    0's, "by_index_mod_4": those at batch positions 0, 1, 2, 3 mod 4,
    "max_abs", "finite"} of a (B, ...) tensor."""
    import torch

    d = (x - x[:1]).abs().reshape(x.shape[0], -1)
    differ = d.amax(1) > 0
    return {"spread": float(d.max()), "goals_differ": int(differ.sum()),
            "by_index_mod_4": [int(differ[r::4].sum()) for r in range(4)],
            "max_abs": float(x.abs().max()), "finite": bool(torch.isfinite(x).all())}


def stages(solver, T_goal):
    """The MDS init's stages of `solver`'s prepare on T_goal's device, as
    riemannian.generate_initializations forms them for one deterministic
    init, then the solver's own prepare Y0."""
    import torch

    from graphik_tpu_torch.ops.eigh import sym_eigh
    from graphik_tpu_torch.utils import dgp

    inst, omega = solver._instance(T_goal)
    out = {"D_goal": inst["D_goal"], "lb": inst["lb"], "ub": inst["ub"]}
    D = dgp.sample_distance_matrix(inst["lb"], inst["ub"])
    G = dgp.gram_from_distance_matrix(D)
    Gs = (G + G.transpose(-1, -2)) / 2.0
    out.update(D=D, D_row_mean=D.mean(dim=-1), D_col_mean=D.mean(dim=-2),
               D_mean=D.mean(dim=(-2, -1)), G=G)
    w, V = sym_eigh(Gs)[:2]
    X = dgp.mds(Gs, eps=1e-8)
    S = dgp.edge_scatter(X, torch.as_tensor(omega, device=T_goal.device))
    basis = dgp.top_basis(S, solver.structure.dim)
    out.update(Gs=Gs, eigh_w=w, eigh_V=V, X=X, S=S, basis=basis, Y0=X @ basis,
               prepare_Y0=solver.prepare(T_goal)[1])
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--goals", default="build/parity/planar40_smooth2_s56.npz")
    p.add_argument("--n", type=int, default=None, help="the first n goals (default: all)")
    args = p.parse_args()

    import torch

    import torch_parity
    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops.eigh import sym_eigh
    from graphik_tpu_torch.robots import library
    from graphik_tpu_torch.utils.environments import table_environment

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = np.load(args.goals)
    config = str(ref["config"])
    cfg = torch_parity.CONFIGS[config]
    ps = torch_parity.structure(cfg["robot"], library, ProblemStructure, table_environment,
                                lambda: library.load_tree5()[1])
    T = torch.as_tensor(ref["T_goal"][:args.n], dtype=torch.float32)
    head = {"config": config, "seed": int(ref["seed"]), "n": T.shape[0]}
    if "Y0" in ref:
        head["jax_Y0"] = spread(torch.as_tensor(ref["Y0"][:args.n]))
    devs = [torch.device("cpu")] + ([torch.device("cuda:0")] if torch.cuda.is_available() else [])
    by_dev = {}
    for dev in devs:
        solver = api.make_solver(ps, device=dev, dtype=torch.float32, smooth_iters=cfg["smooth"])
        by_dev[dev.type] = st = stages(solver, T.to(dev))
        rec = {k: spread(v) for k, v in st.items()}
        if dev.type == "cuda":
            for k, v in st.items():
                rec[k]["vs_cpu"] = float((v.cpu() - by_dev["cpu"][k]).abs().max())
        first = next((k for k in st if k not in BY_GOAL and rec[k]["goals_differ"]), None)
        D, mean = st["D"], st["D_mean"]
        rec["D_mean_of_goal_0_everywhere"] = spread(
            D[:1].expand_as(D).contiguous().mean(dim=(-2, -1)))
        rec["D_mean_same_in_reverse_order"] = bool(torch.equal(
            D.flip(0).contiguous().mean(dim=(-2, -1)).flip(0), mean))
        print(json.dumps({**head, "device": torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu",
                          "first_goal_dependent_stage_past_D": first, "stages": rec}),
              flush=True)
    if "cuda" in by_dev:
        cpu = by_dev["cpu"]
        cross = {}
        for name, A in (("Gs", cpu["Gs"]), ("S", cpu["S"])):
            w, V = sym_eigh(A.to(devs[1]))[:2]
            w_c, V_c = sym_eigh(A)[:2]
            cross[f"card_eigh_of_cpu_{name}"] = {
                "w": spread(w), "V": spread(V), "w_vs_cpu": float((w.cpu() - w_c).abs().max()),
                "V_vs_cpu": float((V.cpu() - V_c).abs().max())}
        print(json.dumps({**head, "cross_feeds": cross}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
