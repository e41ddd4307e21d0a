"""The port's chain sharding, cross-chain collectives and pod launcher
(counterparts of tests/test_parallel.py's chain-axis tests), in gloo
processes on the CPU (tests/torch_parallel_workers.py)."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as tpw
from torch_parity import jax_model_arrays
from gibbssampler_tpu.diagnostics import split_rhat as jax_split_rhat
from gibbssampler_tpu.inference import example_dl, simulate_dataset
from gibbssampler_tpu.parallel import (acceptance_mean as jax_acceptance,
                                       pooled_moments as jax_pooled,
                                       split_rhat_device as jax_rhat)
from gibbssampler_tpu_torch.diagnostics import effective_sample_size
from gibbssampler_tpu_torch.parallel import (acceptance_mean, chain_seed,
                                             ess_device, pooled_moments,
                                             split_rhat_device)

LMAX = 8
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def spin0_arrays():
    """tests/test_parallel.py's spin-0 dataset, as numpy."""
    dl = example_dl(LMAX, amp=10.0)
    model, _ = simulate_dataset(jax.random.PRNGKey(0), LMAX, spin=0,
                                dl_fields=dl[None], noise_sigma2=1.0,
                                dtype=jnp.float64)
    return jax_model_arrays(model), (dl[2:],)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_run_equals_each_ranks_unsharded_run(tmp_path, spin0_arrays,
                                                    world):
    """Rank by rank, sharded_run equals scheme.run of that rank's chains
    with its generator, bit for bit; gather_chains stacks the ranks' chains
    in coordinate order; on one process it is plain run."""
    arrays, dl0 = spin0_arrays
    nchains, n_iter = 4, 12
    res = tpw.spawn(tpw.chain_run, world, tmp_path, arrays, dl0, n_iter,
                    nchains, 5)
    k = nchains // world
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["range"], [r * k, (r + 1) * k])
        for key in ("dl0", "cr_accept", "s"):
            np.testing.assert_array_equal(out[f"s_{key}"], out[f"u_{key}"])
            np.testing.assert_array_equal(
                out[f"g_{key}"],
                np.concatenate([o[f"s_{key}"] for o in res]))
        assert out["s_dl0"].shape == (k, n_iter, LMAX - 1)
        assert np.isfinite(out["s_dl0"]).all()
    if world == 2:   # the two ranks draw different chains
        assert not np.array_equal(res[0]["s_dl0"], res[1]["s_dl0"])


def test_chain_seed_rule():
    assert chain_seed(11, 0) == 11
    assert chain_seed(11, 3) == 11 + 3 * 0x9E3779B9 - 2 ** 32
    # distinct within 32 bits, which the CPU generator keeps
    assert len({chain_seed(7, c) for c in range(4096)}) == 4096
    assert all(0 <= chain_seed(2 ** 32 - 1, c) < 2 ** 32 for c in range(8))


def _chains(seed=3):
    rng = np.random.default_rng(seed)
    chains = rng.normal(size=(8, 60, 3))
    chains[2] += 0.5   # between-chain spread, as tests/test_parallel.py
    chains[5] -= 0.3
    chains = chains + 0.3 * np.cumsum(chains, axis=1) / 8.0
    accepts = rng.random(size=(8, 60, 2)) < 0.4
    return chains, accepts


def _jax_refs(chains, accepts):
    m, v = jax_pooled(jnp.asarray(chains))
    return {"mean": np.asarray(m), "var": np.asarray(v),
            "rhat": np.asarray(jax_rhat(jnp.asarray(chains))),
            "acc": np.asarray(jax_acceptance(jnp.asarray(accepts)))}


def test_collectives_one_process_match_jax():
    """With group=None each collective is the plain reduction, equal to the
    JAX function on the same array; split R-hat equals diagnostics'."""
    chains, accepts = _chains()
    ref = _jax_refs(chains, accepts)
    x = torch.as_tensor(chains)
    m, v = pooled_moments(x)
    got = {"mean": m.numpy(), "var": v.numpy(),
           "rhat": split_rhat_device(x).numpy(),
           "acc": acceptance_mean(torch.as_tensor(accepts)).numpy()}
    for k, want in ref.items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-12)
    for p in range(chains.shape[-1]):
        assert abs(got["rhat"][p] - jax_split_rhat(chains[:, :, p])) < 1e-12
        assert abs(float(ess_device(x)[p])
                   - effective_sample_size(chains[:, :, p])) < 1e-9


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_sharded_match_jax_on_whole_array(tmp_path, world):
    """Chains sharded over 2 and 4 processes: every process gets the JAX
    function's value on the whole array (<= 1e-12), split R-hat also equal
    to diagnostics.split_rhat and the pooled ESS to the whole array's."""
    chains, accepts = _chains(world)
    ref = _jax_refs(chains, accepts)
    res = tpw.spawn(tpw.collectives, world, tmp_path, chains, accepts)
    for out in res:
        for k, want in ref.items():
            np.testing.assert_allclose(out[k], want, rtol=0, atol=1e-12)
        for p in range(chains.shape[-1]):
            assert abs(out["rhat"][p]
                       - jax_split_rhat(chains[:, :, p])) < 1e-12
            np.testing.assert_allclose(
                out["ess"][p], effective_sample_size(chains[:, :, p]),
                rtol=1e-10)


def test_launch_pod_writes_the_jax_launchers_keys(tmp_path):
    """torchrun, two gloo processes: process 0 writes a finite npz with
    tools/launch_pod.py's keys and the gathered chains."""
    out = tmp_path / "pod.npz"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "gibbssampler_tpu_torch.launch_pod",
           "--device", "cpu", "--lmax", "8", "--nchains", "4",
           "--n-iter", "10", "--out", str(out)]
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert run.returncode == 0, run.stderr[-4000:]
    assert "median ESS" in run.stdout and "max R-hat" in run.stdout
    with np.load(out) as z:
        assert sorted(z.files) == ["config", "dl_chain_0", "ess", "rhat",
                                   "wall"]
        assert z["dl_chain_0"].shape == (4, 10, LMAX - 1)
        for k in ("dl_chain_0", "ess", "rhat", "wall"):
            assert np.isfinite(z[k]).all(), k
        assert json.loads(str(z["config"]))["device"] == "cpu"
