"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the measured package (top-level names compared whole)."""

import json
import os
import subprocess
import sys

import pytest

from cmbbench.tests import tiny

REFERENCE = ["cmbbench.reference.sphere", "cmbbench.reference.posterior",
             "cmbbench.reference.check", "cmbbench.inputs", "cmbbench.ess",
             "cmbbench.roofline"]


def _loaded(code):
    env = dict(os.environ, PYTHONPATH=str(tiny.REPO))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tiny.REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("mod", REFERENCE)
def test_reference_imports_nothing_of_the_package(mod):
    tops = _loaded(f"import json, sys, {mod}; print(json.dumps(sorted("
                   "{m.split('.')[0] for m in sys.modules})))")
    assert not tops & {"gibbssampler_tpu_torch", "gibbssampler_tpu", "jax",
                       "jaxlib", "flax"}


def test_run_loads_no_jax(tmp_path):
    root = tiny.make_checkout(tmp_path)
    res = tiny.run_cell(root, "tiny_hp.asis")
    assert res["modules"] == []
    assert res["correct"]
