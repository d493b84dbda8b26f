"""Every module of the port imports on a machine without pandas, JAX, h5py,
matplotlib or skimage, as the card's machine may be: one subprocess imports
every module of the port's packages, its root modules, the command line and
the checkpoint drill, with those names blocked in `sys.modules` (an import
of any of them raises there).  No torch is imported in this process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = "crowded_scenes_ensemble_classification_tpu_torch"
# package (or root module) → how many modules it holds at least
PACKAGES = {"data": 3, "ensemble": 3, "train": 3, "core": 2, "ops": 9, "reports": 2, "parallel": 1, "utils": 2,
            "orchestration": 1, "cli": 2, "models.checkpoint_drill": 1}
BLOCKED = ("pandas", "jax", "h5py", "matplotlib", "skimage")


@pytest.fixture(scope="module")
def imported():
    """{module: None if it imported, else the error}, and the top-level
    names loaded, from one subprocess."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for pkg in PACKAGES
        for path in [REPO / PORT / pkg.replace(".", "/")]
        for p in (path.rglob("*.py") if path.is_dir() else [path.with_suffix(".py")])
    )
    code = (
        "import importlib, json, sys\n"
        f"for name in {BLOCKED!r}: sys.modules[name] = None\n"
        "out = {}\n"
        f"for m in {modules!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "        out[m] = None\n"
        "    except Exception as e:\n"
        "        out[m] = repr(e)\n"
        "print(json.dumps({'modules': out, 'loaded': sorted({k.split('.')[0] for k in sys.modules})}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("package", PACKAGES)
def test_port_package_imports_without_pandas_jax_h5py(imported, package):
    mods = {m: e for m, e in imported["modules"].items()
            if m == f"{PORT}.{package}" or m.startswith(f"{PORT}.{package}.")}
    assert len(mods) >= PACKAGES[package]
    assert {m: e for m, e in mods.items() if e is not None} == {}
    assert not {"jaxlib", "flax", "crowded_scenes_ensemble_classification_tpu"} & set(imported["loaded"])
