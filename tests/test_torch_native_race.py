"""The native library is in place before the JAX package's loader looks.

``ocn_tpu/utils/native.py`` runs ``make`` in place when
``native/libgraphcore.so`` is missing; a process that loads the file while
another one's compiler is still writing it keeps the NumPy fallbacks for its
life, and their negative sampling draws another stream.  The tests' helper
module (tests/torch_parity.py ``place_native_library``, run when pytest
imports it) renames a whole library into place first.  Here the JAX loader
runs in a copy of the repository's layout whose ``native/`` has no library,
several processes at once, with a ``make`` on PATH that only records that it
ran; the race itself is never waited for."""
import os
import shutil
import subprocess
import sys

import pytest

from ocn_tpu_torch.utils import toolchain
from torch_parity import place_native_library

LOADERS = 6
LOAD = ("import sys; sys.path.insert(0, sys.argv[1]); "
        "from ocn_tpu.utils import native; "
        "print('native' if native.load() is not None else 'fallback')")


@pytest.fixture
def layout(tmp_path):
    """(repository copy, environment): ``ocn_tpu`` linked in, ``native/``
    copied without its library, and a ``make`` that leaves a mark and fails."""
    root = tmp_path / "repo"
    native = root / "native"
    native.mkdir(parents=True)
    for name in ("Makefile", "graphcore.cpp"):
        shutil.copy(os.path.join(toolchain.REPO_DIR, "native", name), native)
    os.symlink(os.path.join(toolchain.REPO_DIR, "ocn_tpu"), root / "ocn_tpu")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    make = bin_dir / "make"
    make.write_text('#!/bin/sh\ntouch "$MAKE_MARK.$$"\nexit 1\n')
    make.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "MAKE_MARK": str(tmp_path / "make_ran")}
    env.pop("OCN_TPU_NO_NATIVE", None)
    return root, env


def _load_at_once(root, env):
    """Start LOADERS processes that load through the JAX loader, together;
    returns what each reports."""
    procs = [subprocess.Popen([sys.executable, "-c", LOAD, str(root)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(LOADERS)]
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        out.append(stdout.strip())
    return out


def _make_runs(tmp_path):
    return [p for p in os.listdir(tmp_path) if p.startswith("make_ran")]


def test_placed_library_serves_every_loader(layout, tmp_path):
    root, env = layout
    placed = place_native_library(str(root / "native"))
    assert placed == str(root / "native" / "libgraphcore.so")
    with open(placed, "rb") as f, open(toolchain.build_graphcore(), "rb") as g:
        assert f.read() == g.read()  # the port's build of the same source
    assert not [p for p in os.listdir(root / "native") if p.endswith(".tmp")]
    assert _load_at_once(root, env) == ["native"] * LOADERS
    assert _make_runs(tmp_path) == []


def test_without_the_library_every_loader_runs_make(layout, tmp_path):
    """The control: the same loaders on the bare copy each run ``make`` in
    place (here one that fails), and each is left on the fallbacks."""
    root, env = layout
    assert _load_at_once(root, env) == ["fallback"] * LOADERS
    assert len(_make_runs(tmp_path)) == LOADERS


def test_placing_keeps_a_library_that_is_there(layout):
    root, _ = layout
    lib = root / "native" / "libgraphcore.so"
    lib.write_bytes(b"present")
    assert place_native_library(str(root / "native")) == str(lib)
    assert lib.read_bytes() == b"present"
