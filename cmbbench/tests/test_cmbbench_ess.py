"""The frozen ESS arithmetic against the package's diagnostics.mcmc."""

import numpy as np
import pytest

from cmbbench import ess


def _ar1(rho, m, n, seed):
    rng = np.random.default_rng(seed)
    x = np.empty((m, n))
    x[:, 0] = rng.standard_normal(m)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + np.sqrt(1 - rho ** 2) \
            * rng.standard_normal(m)
    return x


@pytest.mark.parametrize("rho,m,n", [(0.0, 16, 200), (0.5, 128, 300),
                                     (0.9, 32, 500), (0.99, 8, 1000)])
def test_ess_matches_package(rho, m, n):
    from gibbssampler_tpu_torch.diagnostics.mcmc import effective_sample_size
    x = _ar1(rho, m, n, seed=int(rho * 100) + m)
    assert ess.effective_sample_size(x) == effective_sample_size(x)


def test_ess_of_ar1_near_theory():
    rho, m, n = 0.8, 64, 2000
    got = ess.effective_sample_size(_ar1(rho, m, n, 3))
    want = m * n * (1 - rho) / (1 + rho)
    assert abs(got / want - 1) < 0.1


def test_summary_rules():
    ee = np.arange(1.0, 11.0)
    bb = np.array([5.0, 7.0, 100.0, 200.0, 300.0])
    bb_edges = [2, 100, 299, 300, 400, 513]
    s = ess.summary([ee, bb], bb_edges)
    allb = np.concatenate([ee, bb])
    assert s["median"] == np.median(allb)
    assert s["p05"] == np.percentile(allb, 5)
    assert s["bb_tail"] == np.median([200.0, 300.0])


def test_bb_tail_without_bins_is_zero():
    s = ess.summary([np.ones(3), np.ones(2)], [2, 10, 20])
    assert s["bb_tail"] == 0.0
