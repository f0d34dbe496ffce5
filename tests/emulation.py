"""Build csrc sources for the host against `cuda_emulation.h`.

Shared by the emulated kernel tests (`test_torch_*_emulated.py`): a
source's cuda_runtime.h include becomes the shim (which also holds the
cooperative_groups cluster calls), each dynamic shared array the
block's buffer in the shim, each
`<<<...>>>` launch and each cp.async helper's asm a call into the shim.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

SHIM = Path(__file__).with_name("cuda_emulation.h")


def host_source(src: str) -> str:
    """A csrc file for the host: the shim for cuda_runtime.h, dynamic
    shared memory as the shim's buffer, launches and cp.async through
    the shim."""
    src = src.replace("#include <cuda_runtime.h>", f'#include "{SHIM}"')
    src = src.replace("#include <cooperative_groups.h>\n", "")
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];", r"\1* \2 = (\1*)emu_smem;", src)
    src = re.sub(r"(\w+(?:<\w+>)?)<<<(.+?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.ca.*?"memory"\);', "emu_copy(dst, src);", src,
                 flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.commit_group.*?"memory"\);', "emu_commit();", src,
                 flags=re.S)
    src = re.sub(r'asm volatile\("cp\.async\.wait_group.*?"memory"\);', "emu_wait(kPending);",
                 src, flags=re.S)
    src = src.replace("(unsigned)__cvta_generic_to_shared(dst)", "0u")
    code = re.sub(r"//.*", "", src)
    for left in ("asm volatile", "<<<", "extern __shared__", "cuda_runtime.h>",
                 "cooperative_groups.h>"):
        assert left not in code, f"the host rewrite missed {left!r}: update host_source"
    return src


def build_host_library(out: Path, files: dict, sources: list, name: str) -> Path:
    """Write `files` (name -> text, rewritten by `host_source`) into
    `out`, compile `sources` (names among them) into one shared library
    and return its path; skip the test where no C++20 compiler exists."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 host compiler")
    for fname, text in files.items():
        (out / fname).write_text(host_source(text))
    so = out / f"lib{name}.so"
    cmd = [cxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
           "-w", "-x", "c++", *(str(out / s) for s in sources), "-o", str(so)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise AssertionError(f"host build failed:\n{done.stderr[-4000:]}")
    return so
