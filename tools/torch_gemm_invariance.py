#!/usr/bin/env python3
"""Which small batched products give a lane a result that depends on its
batch? Each product the finish stage forms (or could form) runs on a batch
of B random float32 operands and on its first h lanes alone, for each h
of --prefix; prints, per product, the lanes whose result differs in any
bit. On the card, cuBLAS chooses a batched kernel by batch count and
shape, so a product that differs here differs between a data-parallel
shard and the whole batch; the elementwise forms (lie.matmul_small,
lie.matvec_small) are the port's batch-invariant alternative.

    python3 tools/torch_gemm_invariance.py            # on the card
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=8191)
    p.add_argument("--prefix", type=int, nargs="+", default=[4096, 3000, 2048, 1000, 501, 64])
    a = p.parse_args()
    from graphik_tpu_torch.utils.lie import matmul_small, matvec_small

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_gemm_invariance: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    B = a.batch
    T4, v3 = rnd(B, 4, 4), rnd(B, 3)
    A7, T0 = rnd(B, 7, 4, 4), rnd(7, 4, 4)
    M6, N6, N7 = rnd(B, 6, 6), rnd(B, 6, 6), rnd(B, 6, 7)
    products = {
        "4x4 @ 4x4 (bmm)": (lambda x, y: x @ y, (T4, T4)),
        "(B, 7) 4x4 @ constant 4x4 (bmm of B*7)": (lambda x: x @ T0, (A7,)),
        "(B, 7) 4x4 @ constant 4x4 as matmul_small": (lambda x: matmul_small(x, T0), (A7,)),
        "6x6 @ 6x6 (bmm)": (lambda x, y: x @ y, (M6, N6)),
        "6x6 @ 6x7 (bmm)": (lambda x, y: x @ y, (M6, N7)),
        "6x6 @ 6x7 as matmul_small": (lambda x, y: matmul_small(x, y), (M6, N7)),
        "J^T J, 6x7 (bmm)": (lambda y: y.transpose(-1, -2) @ y, (N7,)),
        "J^T r, 6x7 (bmm)": (lambda y, r: (y.transpose(-1, -2) @ r[..., None])[..., 0], (N7, M6[..., 0])),
        "J^T r, 6x7 as a product and sum": (lambda y, r: (y * r[..., :, None]).sum(-2), (N7, M6[..., 0])),
        "3x3^T v (einsum)": (lambda x, v: torch.einsum("...ji,...j->...i", x[..., :3, :3], v), (T4, v3)),
        "3x3^T v as matvec_small": (lambda x, v: matvec_small(x[..., :3, :3].transpose(-1, -2), v),
                                    (T4, v3)),
    }
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for name, (fn, args) in products.items():
        full = fn(*args)
        lanes = []
        for h in a.prefix:
            part = fn(*[x[:h] for x in args])
            lanes.append(int((full[:h] != part).reshape(h, -1).any(1).sum()))
        print(json.dumps({"device": device, "product": name, "batch": B, "prefix": a.prefix,
                          "lanes_differing": lanes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
