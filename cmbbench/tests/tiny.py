"""Tiny cells for the CPU tests: a copy of the benchmark in a temporary
checkout, with configurations at lmax 16 (a Gauss-Legendre band and a
HEALPix nside-8 planckish mask with wide holes, so that the hole-point
operator is on the path) and cells of 4 chains, run in a subprocess on the
CPU with the harness's look for a card skipped."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "cmbbench"
LIMITS = json.loads((PKG / "workloads" / "gl_band.asis.json").read_text())[
    "limits"]
CELLS = {"tiny_gl.asis": ("tiny_gl", "asis"),
         "tiny_gl.centered": ("tiny_gl", "centered"),
         "tiny_hp.asis": ("tiny_hp", "asis")}


def _config(name, grid, mask, lmax=16):
    sys.path.insert(0, str(REPO))
    from cmbbench.inputs import binned_mean, fiducial_dl
    edges = list(range(2, lmax + 2))
    nb = len(edges) - 1
    big = (2 * nb) // 3
    blocks = [[[0, nb]], [[0, big]] + [[i, i + 1] for i in range(big, nb)]]
    sig = [list(0.05 * binned_mean(fiducial_dl(lmax, k, 1000.0), edges))
           for k in ("ee", "bb")]
    return {"name": name, "source": "test", "lmax": lmax, "grid": grid,
            "mask": mask, "sigma2": 0.04, "fwhm_deg": 5.0, "amp": 1000.0,
            "data_seed": 5, "dtype": "float32", "bins": [edges, edges],
            "blocks": blocks,
            "prop_sigma": sig}


def make_checkout(tmp: Path) -> Path:
    """A checkout at ``tmp``: BENCHMARK.json of the tiny cells and a copy
    of cmbbench/ with their files added."""
    root = Path(tmp)
    shutil.copytree(PKG, root / "cmbbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfgs = {"tiny_gl": _config("tiny_gl", {"kind": "gl"},
                               {"kind": "band", "band_rad": 0.2}),
            "tiny_hp": _config("tiny_hp", {"kind": "healpix", "nside": 8},
                               {"kind": "planckish", "band_deg": 11.5,
                                "apo_deg": 3.0, "nholes": 12,
                                "hole_deg": 6.0, "seed": 5})}
    for name, c in cfgs.items():
        (root / "cmbbench" / "configs" / f"{name}.json").write_text(
            json.dumps(c))
    for name, (cfg, scheme) in CELLS.items():
        (root / "cmbbench" / "workloads" / f"{name}.json").write_text(
            json.dumps({"config": cfg, "traffic": scheme, "scheme": scheme,
                        "cr": "aux_mala",
                        "cr_options": {"n_gibbs": 1, "tau": 0.02},
                        "nchains": 4, "burn_in": 2, "limits": LIMITS,
                        "why": "test"}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "test",
                         "file": f"cmbbench/configs/{n}.json",
                         "reduced": [], "why": "test"} for n in cfgs]
    bench["workloads"] = [{"name": n, "config": c, "traffic": s, "chips": 1,
                           "why": "test"} for n, (c, s) in CELLS.items()]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, s) in CELLS.items()
                              if s == "asis"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


DRIVER = """
import json, sys
from pathlib import Path
from cmbbench import harness
import cmbbench.tests.faults as faults
name, seed, secs, trace, fault = sys.argv[1:6]
res = harness.execute(Path.cwd(), name, int(seed), float(secs),
                      bool(int(trace)), device="cpu",
                      sabotage=faults.FAULTS.get(fault))
res["modules"] = harness.forbidden_modules()
print(json.dumps(res))
"""


def run_cell(root: Path, name: str, seed: int = 2 ** 31 + 11,
             seconds: float = 1.0, trace: bool = False,
             fault: str = "none") -> dict:
    """One CPU run of a tiny cell in a fresh process; the result object,
    with the forbidden modules it found loaded under "modules"."""
    env = dict(os.environ, GIBBSSAMPLER_TORCH_TABLE_CACHE="0",
               PYTHONPATH=os.pathsep.join([str(root), str(REPO)]))
    tests = root / "cmbbench" / "tests"
    tests.mkdir(exist_ok=True)
    (tests / "__init__.py").write_text("")
    shutil.copy(Path(__file__).with_name("faults.py"), tests / "faults.py")
    out = subprocess.run(
        [sys.executable, "-c", DRIVER, name, str(seed), str(seconds),
         str(int(trace)), fault], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])
