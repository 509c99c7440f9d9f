"""An installed port builds its kernels: the wheel carries the CUDA sources
and headers as package data, and an installed copy builds into a writable
cache directory, never beside site-packages.

The wheel is built offline from a copy of the package's files in a
temporary directory (``pip wheel --no-deps --no-build-isolation
--no-index``), installed there with ``--target``, and imported in a
child process whose ``HOME`` is temporary too.  Nothing is built in the
repository's tree and no ``nvcc`` runs: ``library_path`` only names the
library a build would write.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import torch

from recursivefactorization_jl_tpu_torch.ops import _kernels

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FILES = ("pyproject.toml", "README.md", "LICENSE")
PACKAGES = ("recursivefactorization_jl_tpu", "recursivefactorization_jl_tpu_torch")

PROBE = """
import json, sys
from pathlib import Path
from recursivefactorization_jl_tpu_torch.ops import _kernels
from recursivefactorization_jl_tpu_torch.utils.warmup import enable_persistent_cache
out = {"package": str(_kernels.PACKAGE_DIR), "build_dir": str(_kernels.BUILD_DIR),
       "headers": [h.name for h in _kernels.HEADERS],
       "sources": {n: p.is_file() for n, p in _kernels.SOURCES.items()},
       "libraries": {n: str(_kernels.library_path(n)) for n in _kernels.SOURCES}}
enable_persistent_cache(sys.argv[1])
out["moved"] = {n: str(_kernels.library_path(n).parent) for n in _kernels.SOURCES}
print(json.dumps(out))
"""


def run(cmd, cwd, env=None):
    done = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr
    return done.stdout


def test_wheel_carries_the_kernel_sources_and_builds_into_a_user_cache(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in FILES:
        shutil.copy2(REPO / name, src / name)
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in PACKAGES:
        shutil.copytree(REPO / name, src / name, ignore=ignore)
    run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(tmp_path / "dist"), "."], cwd=src)
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        csrc = {Path(n).name for n in z.namelist()
                if n.startswith("recursivefactorization_jl_tpu_torch/csrc/")}
    sources = {p.name for p in set(_kernels.SOURCES.values())}
    headers = {h.name for h in _kernels.HEADERS}
    assert len(sources) == 8 and headers == {"panel_cluster.cuh", "rf_common.cuh"}
    assert csrc == sources | headers

    site = tmp_path / "site"
    run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index", "-q",
         "--target", str(site), str(wheel)], cwd=tmp_path)
    home = tmp_path / "home"
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(home))
    moved = tmp_path / "elsewhere"
    got = json.loads(run([sys.executable, "-c", PROBE, str(moved)], cwd=tmp_path, env=env))
    assert Path(got["package"]) == site / "recursivefactorization_jl_tpu_torch"
    assert all(got["sources"].values()) and set(got["headers"]) == headers
    cache = home / ".cache" / "recursivefactorization_jl_tpu_torch" / "kernels"
    assert Path(got["build_dir"]) == cache
    for name, lib in got["libraries"].items():
        assert Path(lib).parent == cache and Path(lib).name.startswith(name + "-")
        assert not Path(lib).is_relative_to(site)
    # the same sources name the same libraries as in the checkout
    assert {n: Path(p).name for n, p in got["libraries"].items()} == {
        n: _kernels.library_path(n).name for n in _kernels.SOURCES}
    assert set(got["moved"].values()) == {str(moved)} and moved.is_dir()


def test_a_checkout_builds_into_its_build_directory():
    """The package in this checkout builds where ``.gitignore`` lists it."""
    assert _kernels.default_build_dir() == REPO / "build" / "kernels"
    assert "build/" in (REPO / ".gitignore").read_text().split()
