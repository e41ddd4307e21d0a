"""The PyTorch port stands alone: it never imports jax, and its entry
points run on the card unless the caller asks for the CPU."""

import inspect
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import t64, tri_table
from gibbssampler_tpu_torch import flagship, tune
from gibbssampler_tpu_torch.inference import (load_checkpoint, run_experiment,
                                              simulate_dataset)
from gibbssampler_tpu_torch.interop import model_from_numpy, state_from_numpy
from gibbssampler_tpu_torch.ops import NoiseModel
from gibbssampler_tpu_torch.samplers import synfast_joint
from gibbssampler_tpu_torch.sht import (SHT, HealpixSHT, PointSHT,
                                        make_healpix_sht, make_sht)
from gibbssampler_tpu_torch.sht import legendre_kernels as lk

PKG = pathlib.Path(__file__).resolve().parent.parent / "gibbssampler_tpu_torch"


def test_import_leaves_jax_out():
    code = ("import importlib, pkgutil, sys\n"
            "import gibbssampler_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] == 'jax'"
            " or k.startswith('gibbssampler_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    bad = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not bad, bad


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    lk.reset_launch_counts()
    rng = np.random.default_rng(0)
    lam = t64(tri_table(5, 3))
    x = t64(rng.normal(size=(5, 2, 5)))
    g = t64(rng.normal(size=(5, 3, 2)))
    assert torch.equal(lk.legendre_synth_tri(lam, x),
                       lk.legendre_synth_tri_plain(lam, x))
    assert torch.equal(lk.legendre_adj_tri(lam, g),
                       lk.legendre_adj_tri_plain(lam, g))
    assert (lk.legendre_synth_tri.launches, lk.legendre_adj_tri.launches) \
        == (0, 0)


def test_wrappers_reject_mismatched_shapes():
    lam = t64(tri_table(5, 3))
    with pytest.raises(ValueError):
        lk.legendre_synth_tri(lam, t64(np.zeros((5, 2, 4))))
    with pytest.raises(ValueError):
        lk.legendre_adj_tri(lam, t64(np.zeros((5, 4, 2))))


ENTRY_POINTS = {"SHT": SHT, "make_sht": make_sht, "PointSHT": PointSHT,
                "HealpixSHT": HealpixSHT,
                "make_healpix_sht": make_healpix_sht,
                "simulate_dataset": simulate_dataset,
                "synfast_joint": synfast_joint,
                "run_experiment": run_experiment,
                "load_checkpoint": load_checkpoint,
                "NoiseModel.white": NoiseModel.white,
                "NoiseModel.white_healpix": NoiseModel.white_healpix,
                "model_from_numpy": model_from_numpy,
                "state_from_numpy": state_from_numpy,
                "flagship.flagship_sht": flagship.flagship_sht,
                "flagship.dataset": flagship.dataset,
                "flagship.build": flagship.build,
                "tune.tune": tune.tune}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    """Every entry point that places tensors takes device="cuda" by
    default; the CPU is used only where the caller asks for it."""
    params = inspect.signature(ENTRY_POINTS[name]).parameters
    assert params["device"].default == "cuda"


def test_default_device_has_no_cpu_fallback():
    """Without a card the default fails loudly, as torch does; with one the
    tables land on it."""
    if torch.cuda.is_available():
        assert make_sht(4).lam0.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make_sht(4)


def _jax_all(subpackage):
    """The names the JAX package's ``subpackage/__init__.py`` exports, read
    from its source (jax need not be installed)."""
    import ast
    src = (PKG.parent / "gibbssampler_tpu" / subpackage / "__init__.py")
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {src}")


@pytest.mark.parametrize("subpackage", ["harmonics", "inference", "sht",
                                        "parallel"])
def test_exports_cover_the_jax_package(subpackage):
    """Every name of the JAX package's harmonics, inference, sht and
    parallel exports is exported by the port (the flat alm interface,
    synfast; the mesh, the sharding and the collectives)."""
    import importlib
    mod = importlib.import_module(f"gibbssampler_tpu_torch.{subpackage}")
    missing = _jax_all(subpackage) - set(mod.__all__)
    assert not missing, missing
    assert all(hasattr(mod, name) for name in mod.__all__)


def test_synfast_follows_the_transform_device():
    """synfast places its draw on the transform's device and takes no
    device argument of its own; the flat methods keep their input's
    device."""
    from gibbssampler_tpu_torch.inference import synfast
    assert "device" not in inspect.signature(synfast).parameters
    sht = make_sht(4, dtype=torch.float64, spin2=True, device="cpu")
    alm, maps = synfast(np.ones((2, 5)), sht, 2,
                        gen=torch.Generator().manual_seed(0))
    assert alm.device.type == maps.device.type == "cpu"
    assert sht.analysis(sht.synthesis(torch.zeros(25, dtype=torch.float64))
                        ).device.type == "cpu"


def test_parallel_layer_and_launcher_import_no_jax():
    """The parallel layer and the pod launcher, imported alone in a fresh
    interpreter, bring in neither jax nor the JAX package."""
    code = ("import sys\n"
            "import gibbssampler_tpu_torch.parallel as p\n"
            "import gibbssampler_tpu_torch.launch_pod\n"
            "assert {'make_mesh', 'chain_sharding', 'shard_sht', "
            "'sharded_run', 'pooled_moments', 'split_rhat_device', "
            "'acceptance_mean'} <= set(p.__all__)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] == 'jax'"
            " or k.startswith('gibbssampler_tpu.')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_parallel_defaults_to_the_card():
    """launch_pod runs NCCL on the cards unless --device cpu is given; the
    mesh is a CUDA mesh unless the caller asks for a CPU one."""
    from gibbssampler_tpu_torch import launch_pod
    from gibbssampler_tpu_torch.parallel import make_mesh
    assert launch_pod.parser().parse_args([]).device == "cuda"
    assert launch_pod.parser().parse_args(["--device", "cpu"]).device \
        == "cpu"
    assert inspect.signature(make_mesh).parameters["device_type"].default \
        == "cuda"
