"""The attribution of the program's spans (``cmbbench.spans``): its
arithmetic on hand-made traces (busy time charged by launch time, idle
time by the middle of each gap, the operators' self time, the join of
device ops to their launching calls, nothing where nothing was recorded),
and a tiny cell's traced window on the CPU, which records the spans and
counts the host reads."""

import json
import os
import subprocess
import sys

import pytest

from cmbbench import spans
from cmbbench.tests import tiny


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """One iteration in a 102 us window: gibbs.step [0, 100) holds gibbs.cr
    [0, 50), with op.synthesis_cut [10, 40) and its sht.legendre [20, 30),
    and gibbs.cls [50, 100), with sync.gamma.round [60, 75).  Kernels
    (launch -> run): k1 at 15 -> [15, 25) under the op; k2 at 22 -> [25,
    55), the Legendre kernel, launched under sht.legendre and running into
    gibbs.cls; k3 at 45 -> [60, 62) under gibbs.cr; k4 at 80 -> [80, 90)
    under gibbs.cls, launched by a driver call.  Idle: [0, 15) (middle
    7.5, gibbs.cr), [55, 60) (57.5, gibbs.cls), [62, 80) (71,
    sync.gamma.round in gibbs.cls), [90, 102) (96, gibbs.cls).  One stream
    synchronize at 65 (counted), one at 101 (the window's, outside the
    program)."""
    ev = [_x("user_annotation", spans.MARKER, 0, 102),
          _x("user_annotation", "gs.gibbs.step step=7", 0, 100),
          _x("user_annotation", "gs.gibbs.cr", 0, 50),
          _x("user_annotation", "gs.op.synthesis_cut", 10, 30),
          _x("user_annotation", "gs.sht.legendre kind=synth nr=65 C=256 "
             "table=float32", 20, 10),
          _x("user_annotation", "gs.gibbs.cls", 50, 50),
          _x("user_annotation", "gs.sync.gamma.round", 60, 15),
          _x("gpu_user_annotation", "gs.gibbs.cr", 0, 60),
          _x("cpu_op", "aten::mul", 14, 3, **{"External id": 9}),
          _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 45, 1, correlation=3),
          _x("cuda_driver", "cuLaunchKernel", 80, 1, correlation=4),
          _x("cuda_runtime", "cudaStreamSynchronize", 65, 2, correlation=5),
          _x("cuda_runtime", "cudaDeviceSynchronize", 101, 1,
             correlation=6),
          _x("kernel", "elementwise_kernel", 15, 10, correlation=1,
             **{"External id": 9}),
          _x("kernel", "synth_tri_3xtf32", 25, 30, correlation=2),
          _x("kernel", "reduce_kernel", 60, 2, correlation=3),
          _x("kernel", "gemm_kernel", 80, 10, correlation=4)]
    return spans.tables(ev, {"sync.gamma.round": 1})


def test_tables_join_launches_by_correlation():
    t = _trace()
    assert t["window"] == (0.0, 102.0)
    assert [s[0] for s in t["spans"]] == [
        "gibbs.step", "gibbs.cr", "op.synthesis_cut", "sht.legendre",
        "gibbs.cls", "sync.gamma.round"]
    assert t["spans"][0][1] == "step=7"
    assert t["spans"][3][1] == "kind=synth nr=65 C=256 table=float32"
    assert [d[3] for d in t["device_ops"]] == [15.0, 22.0, 45.0, 80.0]
    assert t["launch_in_host"] == (1, 1)


def test_attribution_arithmetic():
    """Busy by launch time (k2 runs mostly in gibbs.cls but counts to the
    CR step), idle by the gap's middle, the op's self time without its
    nested Legendre kernel, the SHT share with it; per iteration."""
    res = spans.attribute(_trace(), n_iter=1)
    m = res["metrics"]
    us = 1e-3
    assert m["cr_busy_ms"] == pytest.approx((10 + 30 + 2) * us)
    assert m["cls_busy_ms"] == pytest.approx(10 * us)
    assert m["cr_idle_ms"] == pytest.approx(15 * us)
    assert m["cls_idle_ms"] == pytest.approx((5 + 18 + 12) * us)
    assert m["cut_ops_device_pct"] == pytest.approx(100 * 10 / 52)
    assert m["sht_device_pct"] == pytest.approx(100 * 30 / 52)
    assert m["host_syncs_per_iter"] == 1
    by = res["by_span"]
    assert by["sht.legendre"]["busy_ms"] == pytest.approx(30 * us)
    assert by["gibbs.cls"]["idle_ms"] == pytest.approx((5 + 12) * us)
    assert by["sync.gamma.round"]["idle_ms"] == pytest.approx(18 * us)
    c = res["checks"]
    assert c["sync_calls_per_iter"] == 1 and c["sync_calls_outside"] == 1
    assert c["sync_calls_uncounted"] == {}
    assert c["legendre_outside_span"] == 0
    assert c["device_charged_pct"] == pytest.approx(100.0)
    assert c["idle_in_span_pct"] == pytest.approx(100.0)
    assert c["launch_before_start_pct"] == pytest.approx(100.0)
    assert c["spans_outside_step"] == {}
    half = spans.attribute(_trace(), n_iter=2)["metrics"]
    assert half["cr_busy_ms"] == pytest.approx(m["cr_busy_ms"] / 2)


def test_uncounted_sync_and_stray_legendre_are_named():
    """A synchronize inside a program span but outside every sync.* span
    names that span; a Legendre kernel launched outside sht.legendre is
    counted."""
    t = _trace()
    t["runtime"].append(("cudaStreamSynchronize", 12.0, 13.0))
    t["device_ops"].append(("adj_tri_3xtf32", 92.0, 93.0, 91.0))
    c = spans.attribute(t, 1)["checks"]
    assert c["sync_calls_uncounted"] == {"op.synthesis_cut": 1}
    assert c["legendre_outside_span"] == 1


@pytest.mark.parametrize("drop", ["spans", "window", "device_ops"])
def test_absent_data_gives_nothing(drop):
    """No spans (tracing off), no window or no device ops (a CPU run):
    the device readings are left out, never zero."""
    t = _trace()
    t[drop] = [] if drop != "window" else None
    m = spans.attribute(t, 1)["metrics"]
    assert not {"cr_busy_ms", "cls_busy_ms", "cr_idle_ms", "cls_idle_ms",
                "cut_ops_device_pct", "sht_device_pct"} & set(m)
    assert ("host_syncs_per_iter" in m) == (drop != "spans")


def test_tiny_cell_records_spans(tmp_path):
    """A tiny ASIS cell's traced window on the CPU: every iteration's
    gibbs.step, the layers' spans under it, the harness's gamma draws
    outside it, and the host reads counted (two fields, each an alpha
    check and at least one rejection round, per iteration)."""
    root = tiny.make_checkout(tmp_path)
    code = ("import json; from pathlib import Path; "
            "from cmbbench import spans; "
            "spans.harness.TRACE_ITERS = 2; "
            "spans.ON_COST_PAIRS, spans.ON_COST_SECONDS = 2, 0.0; "
            "r = spans.run(Path.cwd(), 'tiny_gl.asis', 2**31 + 5, "
            "device='cpu', log=lambda m: None); "
            "print(json.dumps(r))")
    env = dict(os.environ, GIBBSSAMPLER_TORCH_TABLE_CACHE="0",
               PYTHONPATH=os.pathsep.join([str(root), str(tiny.REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["host_syncs_per_iter"] >= 4
    assert set(res["counters"]) >= {"sync.gamma.alpha", "sync.gamma.round"}
    assert {"gibbs.step", "gibbs.cr", "cr.aux", "cr.mala", "gibbs.cls",
            "cls.conjugate", "cls.whiten", "cls.mh", "mh.big", "mh.singles",
            "cls.recenter", "op.synthesis_cut_sp", "sht.legendre",
            "sht.rings", "sht.pack"} <= set(res["checks"]["spans"])
    assert res["checks"]["spans"]["gibbs.step"] == 2
    assert res["later_session"]["checks"]["spans"]["gibbs.step"] == 2
    assert res["on_cost_iters"] == 2
    assert [len(v) for v in res["ms_per_iter"].values()] == [2, 2]
    assert set(res["checks"]["spans_outside_step"]) <= {
        "cls.gamma", "sync.gamma.alpha", "sync.gamma.round"}


def test_device_clock_offset_leaves_idle_out():
    """Every device time 8 us early on the host clock (a session's own
    offset): three of the four ops read as starting before their
    launches, the idle readings are left out, and the busy ones, which
    follow the launch, are the unshifted trace's."""
    t = _trace()
    t["device_ops"] = [(n, s - 8.0, e - 8.0, la)
                       for n, s, e, la in t["device_ops"]]
    res = spans.attribute(t, 1)
    ref = spans.attribute(_trace(), 1)
    assert ref["checks"]["clock_ok"] and not res["checks"]["clock_ok"]
    assert res["checks"]["launch_before_start_pct"] == 25.0
    assert res["checks"]["launch_lead_us"][0] == pytest.approx(-8.0)
    assert res["checks"]["idle_ms_per_iter"] is None
    idle = {"cr_idle_ms", "cls_idle_ms"}
    assert idle <= set(ref["metrics"]) and not idle & set(res["metrics"])
    assert res["metrics"] == pytest.approx(
        {k: v for k, v in ref["metrics"].items() if k not in idle})
    assert all(v["idle_ms"] is None for v in res["by_span"].values())
