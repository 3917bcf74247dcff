"""ops/linalg.py::rowwise_sum, the per-instance sum whose order does not
depend on an instance's batch position (on a card torch's reduction of a
contiguous extent past 128 values rounds by the instance's address)."""

import numpy as np
import pytest
import torch

from graphik_tpu_torch.ops.linalg import ROW, rowwise_sum


# (per-instance shape, dims summed): the LM's residual without and with
# the table's obstacles, a Riemannian inner product at UR10 and planar40
# (d = 3 would pass 128), CIDGIK's 13 x 13 blocks, the sparse engine's
# clique stack, a dense cost at N = 43
CASES = [((6,), 1), ((606,), 1), ((16, 3), 2), ((43, 3), 2), ((13, 13), 2), ((3, 9, 9), 3),
         ((43, 43), 2)]


@pytest.mark.parametrize("shape,dims", CASES)
def test_rowwise_sum(shape, dims):
    """The float64 sum within float32 rounding; one reduction (torch's own
    sum, bitwise) up to ROW values an instance; one value at every position
    of a stack of one instance, read as it is and through a view 4 bytes
    into its storage (every instance misaligned alike)."""
    rs = np.random.RandomState(len(shape) * 1000 + shape[-1])
    x = torch.from_numpy(rs.normal(size=(5,) + shape).astype(np.float32))
    s = rowwise_sum(x, dims)
    assert s.shape == (5,)
    ref = x.double().flatten(1).sum(1)
    scale = x.double().abs().flatten(1).sum(1)
    assert bool(((s.double() - ref).abs() <= 1e-6 * scale).all())
    if int(np.prod(shape)) <= ROW:
        assert torch.equal(s, x.sum(dim=tuple(range(-dims, 0))))
    stack = x[:1].expand((11,) + shape).contiguous()
    buf = torch.empty(stack.numel() + 1, dtype=torch.float32)
    view = buf[1:].view(stack.shape)
    view.copy_(stack)
    for S in (stack, view):
        assert torch.equal(rowwise_sum(S, dims), s[:1].expand(11))
