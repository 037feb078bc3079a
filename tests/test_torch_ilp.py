"""The port's exact IRS solvers (``repro_torch.core.ilp``) against the
reference's (``repro.core.ilp``): the same optimum, order and greedy JCT on
the instances of ``tests/test_core_irs.py`` and on seeded random ones."""
import math
import random

import numpy as np
import pytest

from repro.core import ilp as ref
from repro_torch.core import ilp as port


def _irs_instances():
    """``test_heuristic_near_optimal_small_instances``'s twelve instances
    (``random.Random(0)``, two atoms, 2-4 jobs) and
    ``test_permutation_matches_bruteforce_tiny``'s."""
    rng = random.Random(0)
    out = []
    for _ in range(12):
        m = rng.randint(2, 4)
        demands, elig = [], []
        for _ in range(m):
            demands.append(rng.randint(1, 4))
            elig.append([0, 1] if rng.random() < 0.5 else [1])
        q = sum(demands) + rng.randint(0, 3)
        arrivals = [(i + 1.0, rng.choice([0, 1, 1])) for i in range(q * 2)]
        out.append((demands, elig, arrivals))
    out.append(([1, 2], [[0, 1], [1]],
                [(1.0, 0), (2.0, 1), (3.0, 1), (4.0, 1)]))
    return out


def _random_instance(seed):
    """A small instance from a seed: 1-4 jobs, 1-3 atoms, a few arrivals
    (q·m small enough for the brute force)."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 5))
    atoms = int(rng.integers(1, 4))
    demands = [int(rng.integers(1, 3)) for _ in range(m)]
    elig = [sorted({int(a) for a in rng.integers(0, atoms,
                                                 int(rng.integers(1, atoms + 1)))})
            for _ in range(m)]
    q = int(rng.integers(1, 8))
    arrivals = [(float(t), int(rng.integers(0, atoms)))
                for t in np.sort(rng.uniform(0, 10, q)).round(3)]
    return demands, elig, arrivals


def _same(a, b):
    assert a == b or (isinstance(a, float) and math.isinf(a) and a == b)


@pytest.mark.parametrize("case", range(13))
def test_solvers_equal_the_reference_on_the_irs_instances(case):
    demands, elig, arrivals = _irs_instances()[case]
    _same(port.optimal_by_permutation(demands, elig, arrivals),
          ref.optimal_by_permutation(demands, elig, arrivals))
    _same(port.optimal_bruteforce(demands, elig, arrivals[:7]),
          ref.optimal_bruteforce(demands, elig, arrivals[:7]))
    for order in ([*range(len(demands))], [*range(len(demands))][::-1]):
        assert port.greedy_order_jct(order, demands, elig, arrivals) == \
            ref.greedy_order_jct(order, demands, elig, arrivals)


@pytest.mark.parametrize("seed", range(24))
def test_solvers_equal_the_reference_on_random_instances(seed):
    demands, elig, arrivals = _random_instance(seed)
    best, order = port.optimal_by_permutation(demands, elig, arrivals)
    assert (best, order) == ref.optimal_by_permutation(demands, elig,
                                                       arrivals)
    brute = port.optimal_bruteforce(demands, elig, arrivals)
    assert brute == ref.optimal_bruteforce(demands, elig, arrivals)
    # the exchange argument of the module's docstring: some order attains
    # the optimum of the assignment problem
    assert math.isinf(best) == math.isinf(brute)
    if not math.isinf(brute):
        assert best == pytest.approx(brute)
    assert port.greedy_order_jct(order, demands, elig, arrivals) == \
        ref.greedy_order_jct(order, demands, elig, arrivals)
