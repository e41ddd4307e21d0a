"""A configuration, a cell and a metric are added by files alone: the
harness lists and loads them with no edit to a file it already has."""

import json

from cmbbench.tests import tiny


def test_new_files_only(tmp_path):
    root = tiny.make_checkout(tmp_path)
    pkg = root / "cmbbench"
    before = {p: p.read_bytes() for p in pkg.rglob("*")
              if p.is_file() and "tests" not in p.parts
              and "__pycache__" not in p.parts}
    cfg = json.loads((pkg / "configs" / "tiny_gl.json").read_text())
    cfg.update(name="tiny_gl_wide", fwhm_deg=8.0)
    (pkg / "configs" / "tiny_gl_wide.json").write_text(json.dumps(cfg))
    cell = json.loads((pkg / "workloads" / "tiny_gl.asis.json").read_text())
    cell.update(config="tiny_gl_wide", nchains=6)
    (pkg / "workloads" / "tiny_gl_wide.asis.json").write_text(
        json.dumps(cell))
    (pkg / "metrics" / "window_iters.py").write_text(
        '"""Iterations in the window."""\n\n\ndef read(ctx):\n'
        '    return float(ctx["n_iter"])\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_gl_wide", "source": "test",
                             "file": "cmbbench/configs/tiny_gl_wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_gl_wide.asis",
                               "config": "tiny_gl_wide", "traffic": "asis",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "window_iters", "unit": "iter",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny_gl_wide.asis"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        res = tiny.run_cell(root, "tiny_gl_wide.asis", trace=trace)
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        if trace:
            keys.append("breakdown")
        assert [k for k in res if k in keys + ["breakdown"]] == keys
        assert res["correct"]
        assert res["attempted"] % 6 == 0
        if not trace:
            assert res["metrics"]["window_iters"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
