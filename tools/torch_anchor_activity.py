#!/usr/bin/env python3
"""How many anchor rows of the table scene are active, and how far the
anchored nodes move, over a TR solve - the numbers behind the TR kernel's
skipping of inactive anchor rows (csrc/tr_solve.cu).

    python tools/torch_anchor_activity.py [--n 64] [--seed 7]

Runs the plain TR version (`ops/tr_solve.py::solve_tr_reference`) on the
CPU on n ur10_table goals (joint angles from numpy's RandomState(seed),
`maxiter=250, maxinner=32`, plateau stop), from a copy of its source with
two observers added: one records each cost evaluation's hinge terms, one
each outer iteration's iterate and trust radius. It prints:

- the share of live anchor rows with an active hinge at each evaluation;
- the distance an anchored node moves per accepted step;
- a replay of the kernel's skip rule for several reaches a_near: a full
  pass over a group when its node has moved a_near since the group's last
  full pass, else only the rows that were within a_near of turning on
  there. It reports the rows evaluated (the most on one of the 16 lanes
  of an instance, per group, as the kernel pays them) against a full
  pass every time, the share of full passes, and how many active rows
  the rule would have skipped (it must be 0).

The last line is one JSON object. Needs no GPU.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Where the observers go in solve_tr_reference's source.
_COST_AT = "            adY, a1, a2 = anchor_terms(Y)\n            sa = a1 - a2\n"
_OUTER_AT = "        Y = torch.where(col(take), Y_prop, Y)\n"


def observed_reference(log):
    """solve_tr_reference with observers appending to log["cost"] and
    log["outer"]; raises if its source no longer has the spots."""
    from graphik_tpu_torch.ops import tr_solve

    src = inspect.getsource(tr_solve)
    for spot in (_COST_AT, _OUTER_AT):
        if src.count(spot) != 1:
            raise RuntimeError("solve_tr_reference changed: update the observer spots")
    src = src.replace(_COST_AT, _COST_AT.replace(
        "            sa = a1 - a2\n",
        "            LOG['cost'].append((Y[:, anode].clone(), a1.clone(), a2.clone()))\n"
        "            sa = a1 - a2\n"))
    src = src.replace(_OUTER_AT, _OUTER_AT + (
        "        LOG['outer'].append((upd.clone(), take.clone(), Y.clone(), Delta.clone()))\n"))
    ns = {"LOG": log, "__name__": "observed_tr_solve"}
    exec(compile(src, tr_solve.__file__, "exec"), ns)
    return ns["solve_tr_reference"], ns["_anchor_nodes"]


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()

    import torch

    from graphik_tpu_torch import api
    from graphik_tpu_torch.graphs.problem import ProblemStructure
    from graphik_tpu_torch.ops import edge as edge_ops
    from graphik_tpu_torch.robots import kinematics
    from graphik_tpu_torch.robots.library import load_ur10
    from graphik_tpu_torch.utils.environments import table_environment

    log = {"cost": [], "outer": []}
    solve, anchor_nodes = observed_reference(log)
    tpl, _ = load_ur10()
    ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    spec = ps.reduced_spec()
    Nr = spec["Nr"]
    om, pl, pu = ps.masks()
    ep = edge_ops.build_edge_problem(om[:Nr, :Nr], pl[:Nr, :Nr], pu[:Nr, :Nr], dim=3,
                                     anchors=spec)
    q = np.random.RandomState(args.seed).uniform(tpl.lb[1:], tpl.ub[1:], size=(args.n, tpl.n))
    T_goal = kinematics.all_poses(tpl, torch.tensor(q, dtype=torch.float32))[:, tpl.ee]
    D_goal, Y0 = api.make_solver(ps, smooth_iters=2, device="cpu").prepare(T_goal)
    out = solve(ep, Y0.contiguous(), ep.edge_values(D_goal).contiguous(), maxiter=250,
                maxinner=32, plateau_every=16, plateau_rtol=1e-4)
    it, ni = out["iterations"].double(), out["num_inner"].double()
    res = {"n": args.n, "seed": args.seed, "mean_iterations": float(it.mean()),
           "inner_per_outer": float(ni.sum() / it.sum())}

    B, G, R = args.n, ep.a_nsel, ep.a_R
    live_rows = int((np.asarray(ep.aL_mask) != 0).sum() + (np.asarray(ep.aU_mask) != 0).sum())
    # evaluation 0 is at Y0 (every lane); evaluation k + 1 is outer
    # iteration k's trial point (the lanes still iterating)
    lives = [torch.ones(B, dtype=torch.bool)] + [o[0] for o in log["outer"]]
    actives = []
    for (_, a1, a2), live in zip(log["cost"], lives):
        act = ((a1 != 0) | (a2 != 0)).reshape(B, G, -1)[:, :, :R]
        actives.append(act)
    share = torch.stack([a.flatten(1).sum(1).double() / live_rows for a in actives])
    live_share = [float(s[lv].mean()) for s, lv in zip(share, lives) if lv.any()]
    res["active_share_mean"] = float(np.mean(live_share))
    res["active_share_max_lane"] = float(share.max())
    res["lanes_with_an_active_row_at_Y0"] = float((share[0] > 0).double().mean())

    anode = torch.as_tensor(anchor_nodes(ep))
    prev, moves = Y0, []
    for upd, take, Y, _ in log["outer"]:
        d = (Y[:, anode] - prev[:, anode]).norm(dim=-1)
        if take.any():
            moves.append(d[take].flatten())
        prev = Y
    moves = torch.cat(moves).double()
    res["node_move_per_accepted_step"] = {
        "median": float(moves.median()), "p90": float(moves.quantile(0.9)),
        "p99": float(moves.quantile(0.99)), "max": float(moves.max())}

    # the skip rule, replayed in float64 on the same trajectory
    cen = torch.as_tensor(np.asarray(ep.acenters)[:, :3], dtype=torch.float64).reshape(G, R, 3)
    rad = torch.as_tensor(np.sqrt(np.asarray(ep.apsi_L, np.float64))).reshape(G, R)
    hinge = torch.as_tensor(np.asarray(ep.aL_mask) != 0).reshape(G, R)
    lane = (torch.arange(R) % 32) % 16  # a row's lane in a 16-lane segment
    inf = torch.tensor(float("inf"), dtype=torch.float64)

    def per_lane_max(mask):  # (B, G, R) rows evaluated -> (B,) cost of the pass
        cnt = torch.zeros((B, G, 16))
        cnt.index_add_(2, lane, mask.float())
        return cnt.amax(-1).sum(-1)

    full_cost = per_lane_max(hinge.expand(B, G, R))
    replay = {}
    for reach in (0.01, 0.02, 0.05, 0.1, 0.2):
        ref = torch.full((B, G, 3), float("nan"), dtype=torch.float64)
        near = torch.zeros((B, G, R), dtype=torch.bool)
        cost = full = skipped_active = n_groups = 0.0
        total = 0.0
        for (Yu, _, _), act, live in zip(log["cost"], actives, lives):
            X = Yu.double()
            moved = (X - ref).norm(dim=-1)
            fresh = ~(moved < reach)
            slack = torch.where(hinge, (X[:, :, None] - cen).norm(dim=-1) - rad, inf)
            visit = torch.where(fresh[..., None], hinge.expand(B, G, R), near)
            skipped_active += float((act & ~visit & live[:, None, None]).sum())
            cost += float(per_lane_max(visit)[live].sum())
            total += float(full_cost[live].sum())
            full += float(fresh[live].sum())
            n_groups += float(live.sum()) * G
            near = torch.where(fresh[..., None], slack < reach, near)
            ref = torch.where(fresh[..., None], X, ref)
        replay[str(reach)] = {"rows_evaluated_share": cost / total,
                              "full_pass_share": full / n_groups,
                              "active_rows_skipped": int(skipped_active)}
    res["skip_rule"] = replay
    for k, v in res.items():
        print(f"{k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
