"""Whole runs of tiny cells on the CPU, each in a fresh process, with the
harness's look for a card skipped: the reference agrees with the measured
package, the control and every planted fault read ``correct`` false, the
run loads nothing of JAX, and the result's line keeps its keys."""

import pytest

from cmbbench.tests import tiny

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cells_correct(checkout, cell, trace):
    res = tiny.run_cell(checkout, cell, trace=trace)
    assert res["correct"], res["checked"]
    assert res["failed"] == 0
    assert REQUIRED <= set(res)
    assert ("breakdown" in res) == trace
    assert list(res)[-2:] == ["checked", "modules"]
    assert res["modules"] == []
    want = {"ms_per_iter", "ess_per_s", "ess_p05_per_s",
            "bb_tail_ess_per_s", "setup_s"} if not trace else {
        "cr_step_ms", "cr_accept_pct", "cls_step_ms"}
    assert want <= set(res["metrics"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "flipped"])
def test_planted_faults_fail(checkout, fault):
    res = tiny.run_cell(checkout, "tiny_gl.asis", fault=fault)
    assert not res["correct"], res["checked"]
    assert res["failed"] > 0


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_fails(checkout, cell):
    """The reference in float32 with TF32 products, in the program's place,
    exceeds the cell's limits."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json; from pathlib import Path; "
            "from cmbbench.control import control_numbers; "
            f"print(json.dumps(control_numbers(Path.cwd(), {cell!r}, 7, "
            "'cpu')))")
    env = dict(os.environ, GIBBSSAMPLER_TORCH_TABLE_CACHE="0",
               PYTHONPATH=os.pathsep.join([str(checkout), str(tiny.REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    nums = json.loads(out.stdout.strip().splitlines()[-1])
    assert any(nums[k] > v for k, v in tiny.LIMITS.items()), nums
