"""`voxtpu_torch._build.build` on the CPU, with a stand-in for nvcc.

The stand-in writes each output file named by ``-o`` and a ptxas-like
line to stderr, and fails on a source that contains ``FAIL``; so the
parallel compile, the link, the log and the clean-up are checked where
no CUDA toolkit exists.
"""

import os
import stat
import sys

import pytest

import tests.torch_threads  # noqa: F401  (caps torch's threads under pytest-xdist)
from voxtpu_torch import _build

FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
if "-c" in args and "FAIL" in open(src).read():
    sys.stderr.write("error in " + src + "\\n")
    sys.exit(1)
sys.stderr.write("ptxas info    : Used 1 registers (" + src.rsplit("/", 1)[-1] + ")\\n")
open(out, "w").write(" ".join(args))
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    return csrc


def test_build_compiles_each_source_then_links(fake_toolkit):
    built = _build.build()
    assert built.path.exists() and built.seconds > 0
    link = built.path.read_text()
    assert "-shared" in link and link.count(".o") == 2
    assert "(a.cu)" in built.log and "(b.cu)" in built.log
    # only the library is left, and a second call reuses it
    assert [p.name for p in (fake_toolkit / "build").iterdir()] == [built.path.name]
    assert _build.build() == _build.Build(built.path, 0.0, "")


def test_build_failure_names_the_source_and_leaves_nothing(fake_toolkit):
    (fake_toolkit / "b.cu").write_text("FAIL\n")
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed:.*b\.cu\nerror in .*b\.cu"):
        _build.build()
    assert list((fake_toolkit / "build").iterdir()) == []
