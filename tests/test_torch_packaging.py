"""An installed port carries every native source it builds: the CUDA
kernels and their shared header (``_build.SOURCE_DIRS``, the ``kernels``
and ``probes`` libraries) and the host code of ``dataio``
(``dataio/native.py::SOURCES``), 14 files.  (a) each matches a
``package-data`` glob of ``pyproject.toml``; (b) an offline wheel built from
a copy of the tree holds each of them."""

import os
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import chip_smoke
from gaussian_splatting_torch import _build
from gaussian_splatting_torch.dataio import native
from tests.torch_testutil import one_intra_op_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ("gaussian_splatting_tpu", "gaussian_splatting_torch")


def native_sources():
    """Every source file the port compiles, relative to the repo's root."""
    files = [src for name in _build.SOURCE_DIRS for src in _build.sources(name)]
    files += sorted(_build.SRC_DIR.glob("*.cuh"))  # included by every library
    files += list(native.SOURCES.values())
    return sorted(f.resolve().relative_to(ROOT).as_posix() for f in files)


def test_package_data_names_every_native_source():
    """Each source matches a glob of ``[tool.setuptools.package-data]`` under
    the key of the package whose directory holds it."""
    sources = native_sources()
    assert len(sources) == 14, sources
    with open(ROOT / "pyproject.toml", "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    matched = set()
    for package, globs in package_data.items():
        pkg_dir = ROOT / package.replace(".", "/")
        for pattern in globs:
            matched.update(p.relative_to(ROOT).as_posix() for p in pkg_dir.glob(pattern))
    missing = [s for s in sources if s not in matched]
    assert not missing, f"no package-data glob names {missing}"


def test_offline_wheel_holds_every_native_source(tmp_path):
    """``pip wheel --no-deps --no-build-isolation --no-index`` of a copy of
    pyproject.toml and both packages (without ``_build_cache``): the wheel
    holds all 14 sources.  setuptools writes ``build/`` and ``*.egg-info``
    into its source tree, hence the copy."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(ROOT / "pyproject.toml", src)
    ignore = shutil.ignore_patterns("_build_cache", "__pycache__")
    for package in PACKAGES:
        shutil.copytree(ROOT / package, src / package, ignore=ignore)
    env = dict(os.environ, PIP_NO_INDEX="1", PIP_DISABLE_PIP_VERSION_CHECK="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-w", str(tmp_path / "dist"), str(src)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    with zipfile.ZipFile(wheel) as zf:
        names = set(zf.namelist())
    missing = [s for s in native_sources() if s not in names]
    assert not missing, f"{wheel.name} lacks {len(missing)} of 14: {missing}"


def test_chip_smoke_copies_what_an_install_ships(tmp_path):
    """chip_smoke.py's install phase imports a copy of the package made by
    ``shipped_tree``: every .py file of the package and its subpackages
    and the 14 sources, no build output."""
    data = chip_smoke.shipped_tree(str(tmp_path))
    assert data == native_sources()
    package = ROOT / "gaussian_splatting_torch"
    py = sorted(p.relative_to(ROOT).as_posix() for p in package.rglob("*.py")
                if "_build_cache" not in p.parts)
    copied = sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")
                    if p.is_file())
    assert copied == sorted(py + data)
