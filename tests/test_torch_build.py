"""Where the CUDA kernels' libraries are built (`ops._build.build_dir`),
checked on the CPU without running nvcc: the package's own `_build/` when
it can be written, else the user cache directory, else a clear error.

Each case copies the package into pytest's `tmp_path` and loads that
copy's `_build` module, whose paths follow its own file. A read-only copy
has no write permission bit anywhere, which `_build` honours even for
root.
"""

import importlib.util
import os
import shutil
import stat
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "quantpy_tpu_torch"


def _copy_package(tmp_path, read_only: bool):
    """A copy of the package under tmp_path and its `_build` module."""
    pkg = tmp_path / "site" / "quantpy_tpu_torch"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "_build"))
    spec = importlib.util.spec_from_file_location("_build_copy", pkg / "ops" / "_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if read_only:
        _chmod_tree(pkg, writable=False)
    return pkg, module


def _chmod_tree(root: Path, writable: bool):
    for path in [root, *root.rglob("*")]:
        mode = path.stat().st_mode
        bits = stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH
        path.chmod(mode | stat.S_IWUSR if writable else mode & ~bits)


@pytest.fixture
def cache_home(tmp_path, monkeypatch):
    home = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(home))
    return home


def test_writable_package_builds_in_place(tmp_path, cache_home):
    pkg, module = _copy_package(tmp_path, read_only=False)
    assert module.build_dir() == pkg / "_build"


def test_read_only_package_builds_in_the_user_cache(tmp_path, cache_home):
    pkg, module = _copy_package(tmp_path, read_only=True)
    try:
        assert module.build_dir() == cache_home / "quantpy_tpu_torch"
        assert not (pkg / "_build").exists()
    finally:
        _chmod_tree(pkg, writable=True)


def test_no_writable_directory_raises(tmp_path, cache_home, monkeypatch):
    pkg, module = _copy_package(tmp_path, read_only=True)
    cache_home.mkdir()
    os.chmod(cache_home, 0o555)
    try:
        with pytest.raises(RuntimeError, match="no writable directory"):
            module.build_dir()
    finally:
        os.chmod(cache_home, 0o755)
        _chmod_tree(pkg, writable=True)


def test_default_cache_is_under_home(tmp_path, monkeypatch):
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    pkg, module = _copy_package(tmp_path, read_only=True)
    try:
        assert module.build_dir() == tmp_path / "home" / ".cache" / "quantpy_tpu_torch"
    finally:
        _chmod_tree(pkg, writable=True)
