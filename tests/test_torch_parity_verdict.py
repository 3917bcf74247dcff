"""The parity tool's verdict for a goal-independent start
(tools/torch_parity.py `shared_start_verdict`, `permutation_p`): where both
packages start every goal from one Y0, the verdict is a permutation test of
the two halves' perturbed-start counts, not a Wilson interval around one
draw. CPU only, numpy alone: no solve runs here."""

import importlib.util
import os

import numpy as np
import pytest

_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                     "torch_parity.py")
_spec = importlib.util.spec_from_file_location("torch_parity", _TOOL)
tp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tp)

# JAX's 16 perturbed-start counts of dh19 at two squarings, seed 56, 1000
# goals (tools/torch_parity.py jax --config dh19_smooth2 --init-noise 16)
JAX_DH19 = [69, 131, 85, 82, 102, 99, 77, 72, 141, 86, 87, 100, 92, 116, 83, 82]


def _stats(counts, spread=0.0):
    return {"init_noise_counts": list(counts), "Y0_spread_over_goals": spread}


def test_permutation_p_is_reproducible_and_bounded():
    """Same inputs, same p (a fixed RandomState); equal samples give p = 1;
    p never falls below 1 / (resamples + 1)."""
    a = np.array(JAX_DH19)
    assert tp.permutation_p(a, a) == 1.0
    p1 = tp.permutation_p(a, a - 12)
    assert p1 == tp.permutation_p(a, a - 12)
    assert 1.0 / (tp.PERM_RESAMPLES + 1) <= p1 < 1.0
    assert tp.PERM_RESAMPLES >= 10_000
    # symmetric in its two samples (two-sided)
    assert tp.permutation_p(a - 12, a) == pytest.approx(p1, abs=0.02)


def test_verdict_passes_on_draws_of_one_distribution():
    """Two sets of 16 counts drawn from one spread (the shape of dh19's)
    pass, however far the two own-start draws are apart: the Wilson test
    on one draw would fail here."""
    rs = np.random.RandomState(3)
    port = list(rs.permutation(JAX_DH19) + rs.randint(-6, 7, 16))
    ok, rec = tp.shared_start_verdict(_stats(JAX_DH19), 0.0, port, 1000, 58, 24)
    assert rec["goal_independent_start"] and rec["verdict"] == "perturbed starts"
    assert ok and rec["port_agrees"] and rec["permutation_p"] >= tp.PERM_ALPHA
    assert rec["own_start"]["note"] == "one draw of the shared start"
    assert not rec["own_start"]["port_inside_jax_interval"]  # 24 against [45, 74]


def test_verdict_fails_on_a_shifted_distribution():
    """A port whose perturbed counts sit ~40 below JAX's fails."""
    port = [c - 40 for c in JAX_DH19]
    ok, rec = tp.shared_start_verdict(_stats(JAX_DH19), 0.0, port, 1000, 58, 60)
    assert rec["verdict"] == "perturbed starts"
    assert not ok and rec["permutation_p"] < tp.PERM_ALPHA


@pytest.mark.parametrize("jax_spread,port_spread,K", [(0.0, 3e-2, 16), (1.5, 0.0, 16),
                                                        (0.0, 0.0, 8)])
def test_goal_dependent_or_short_runs_keep_the_single_init_verdict(jax_spread, port_spread, K):
    """A start that differs between goals in either half, or fewer than
    PERTURBED_MIN perturbed counts, keeps the Wilson verdict on the
    own-start count."""
    counts = JAX_DH19[:K]
    ok, rec = tp.shared_start_verdict(_stats(counts, jax_spread), port_spread, counts, 1000,
                                      58, 24)
    assert rec["verdict"] == "single init" and not ok
    assert rec["goal_independent_start"] == (jax_spread == 0.0 and port_spread == 0.0)
    ok, rec = tp.shared_start_verdict(_stats(counts, jax_spread), port_spread, counts, 1000,
                                      58, 60)
    assert ok and rec["own_start"]["port_inside_jax_interval"]
