"""ctypes bindings for the native C++/OpenMP host library.

Port of `voxtpu/native/__init__.py` on the port's own copy of its
source (`voxnative.cpp`, line for line voxtpu's). The library builds at
first use with voxtpu's Makefile flags (``g++ -O3 -march=native
-fopenmp -fPIC -shared -std=c++17 -Wall``, ~2 s) into ``build/`` beside
the source (git-ignored), under a name that holds a hash of the source,
the flags and the host's CPU model (``-march=native`` code may not run
on another CPU), so that a changed source or a copy of the tree on
another machine builds anew, and ranks or test workers that build at
once do not collide.

There is no fallback here: when the library cannot build or load, every
entry point raises `NativeUnavailable` (`voxtpu_torch.mesh.obj_io.
import_mesh` alone then takes its Python parser, as voxtpu's does).

The computation runs on the host, as voxtpu's ``-t 3`` does; the
wrappers take and return NumPy arrays, and their callers in the port
(`ops/vox.py`, `ops/jfa.py`, `ops/csg.py`) put the results on the
device the call names.

- native_import_mesh / native_export_mesh: OBJ I/O
- native_voxelize: OpenMP solid voxelizer (dense bool out)
- native_jfa: OpenMP jump-flooding signed squared distances
- native_csg: OpenMP packed CSG word fold
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "voxnative.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
CXXFLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared", "-std=c++17", "-Wall")
CSG_OPS = {"void": 0, "union": 1, "intersection": 2, "difference": 3}

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


class _VoxMesh(ctypes.Structure):
    _fields_ = [
        ("coords", ctypes.POINTER(ctypes.c_float)),
        ("num_vertices", ctypes.c_int32),
        ("normals", ctypes.POINTER(ctypes.c_float)),
        ("num_normals", ctypes.c_int32),
        ("colors", ctypes.POINTER(ctypes.c_uint8)),
        ("has_colors", ctypes.c_int32),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("faces_normals", ctypes.POINTER(ctypes.c_int32)),
        ("num_faces", ctypes.c_int32),
    ]


_P = ctypes.c_void_p
_SIGNATURES = {
    "vox_import_obj": ([ctypes.c_char_p, ctypes.POINTER(_VoxMesh)], ctypes.c_int),
    "vox_free_mesh": ([ctypes.POINTER(_VoxMesh)], None),
    "vox_export_obj": ([ctypes.c_char_p, _P, _P, ctypes.c_int32, _P, ctypes.c_int32, _P, _P,
                        ctypes.c_int32], ctypes.c_int),
    "vox_voxelize": ([_P, _P, ctypes.c_int32, ctypes.c_int32, _P, ctypes.c_float, _P],
                     ctypes.c_int),
    "vox_jfa": ([_P, ctypes.c_int32, _P, ctypes.c_float, _P], ctypes.c_int),
    "vox_csg": ([_P, _P, ctypes.c_int64, ctypes.c_int32], ctypes.c_int),
}


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("model name")), "")
    except OSError:
        return platform.processor()


def library_path() -> str:
    """Where the library for this source, these flags and this CPU lives."""
    with open(_SOURCE, "rb") as f:
        key = f.read() + " ".join(CXXFLAGS).encode() + _cpu_model().encode()
    return os.path.join(BUILD_DIR, f"libvoxnative-{hashlib.sha1(key).hexdigest()[:12]}.so")


def compilers() -> list:
    """The C++ compilers a build tries, in order: ``$CXX`` (where set),
    then ``g++`` on the PATH (voxtpu's Makefile's default; a ``$CXX``
    toolchain may lack OpenMP's libgomp)."""
    found = [os.environ.get("CXX"), shutil.which("g++")]
    return [c for i, c in enumerate(found) if c and c not in found[:i]]


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    failed = []
    try:
        for cxx in compilers():
            try:
                done = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SOURCE], capture_output=True,
                                      text=True)
            except OSError as e:
                failed.append(f"{cxx}: {e}")
                continue
            if done.returncode == 0:
                os.replace(tmp, path)  # atomic: a process building at once finds a whole file
                return
            failed.append(f"{cxx}:\n{done.stderr[-2000:]}")
        raise NativeUnavailable("building voxnative.cpp failed with every compiler tried: "
                                + ("\n".join(failed) or "no C++ compiler (g++)"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The loaded library (built first where needed); raises
    `NativeUnavailable` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise NativeUnavailable(f"loading {path} failed: {e}") from e
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def native_import_mesh(path: str):
    """The mesh of an OBJ file, or None where the native parser hands
    off (a non-triangular face, junk where an index belongs, an
    unreadable file), for the Python parser to raise its error."""
    from voxtpu_torch.mesh.mesh import Mesh

    lib = load()
    out = _VoxMesh()
    if lib.vox_import_obj(os.fspath(path).encode(), ctypes.byref(out)) != 0:
        return None
    try:
        nv, nn, nf = out.num_vertices, out.num_normals, out.num_faces

        def rows(ptr, count, width, dtype):
            if not count:
                return np.zeros((0, width), dtype)
            return np.ctypeslib.as_array(ptr, (count, width)).copy()

        coords = rows(out.coords, nv, 3, np.float32)
        normals = rows(out.normals, nn, 3, np.float32)
        faces = rows(out.faces, nf, 3, np.int32)
        fnormals = rows(out.faces_normals, nf, 3, np.int32)
        colors = rows(out.colors, nv if out.has_colors else 0, 4, np.uint8)
    finally:
        lib.vox_free_mesh(ctypes.byref(out))
    mesh = Mesh(name=os.fspath(path), coords=coords, normals=normals, colors=colors,
                faces=faces, faces_normals=fnormals)
    # Out-of-range (or OBJ-relative negative) indices raise here, before
    # they reach the C++ voxelizer's pointer arithmetic.
    mesh.validate()
    return mesh


def native_export_mesh(path: str, mesh) -> bool:
    """Write `mesh` as OBJ; False where the file cannot be opened."""
    lib = load()
    nv, nf = mesh.num_vertices, mesh.num_faces
    colors = mesh.colors
    if colors is None or colors.shape[0] != nv:
        colors = np.full((nv, 4), 255, np.uint8)
    colors = np.ascontiguousarray(colors, np.uint8)
    coords = _as_f32(mesh.coords)
    normals = _as_f32(mesh.normals)
    fn = mesh.faces_normals
    if fn is None or fn.shape[0] != nf:
        fn = mesh.faces
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    fn = np.ascontiguousarray(fn, np.int32)
    rc = lib.vox_export_obj(os.fspath(path).encode(), _ptr(coords), _ptr(colors), nv,
                            _ptr(normals), int(normals.shape[0]), _ptr(faces), _ptr(fn), nf)
    return rc == 0


def native_voxelize(mesh, spec) -> np.ndarray:
    """OpenMP solid voxelization -> dense bool (z, y, x); N % 32 == 0."""
    lib = load()
    n = spec.n
    coords = _as_f32(mesh.coords)
    faces = np.ascontiguousarray(mesh.faces, np.int32)
    origin = _as_f32(spec.origin)
    occ = np.zeros((n, n, n), np.uint8)
    rc = lib.vox_voxelize(_ptr(coords), _ptr(faces), int(mesh.num_faces), n, _ptr(origin),
                          float(spec.voxel_size), _ptr(occ))
    if rc != 0:
        raise ValueError(f"vox_voxelize refused N={n} (rc={rc}): N must be a multiple of 32")
    return occ.view(np.bool_)  # 0/1 bytes: the view is copy-free


def native_jfa(occ: np.ndarray, spec) -> np.ndarray:
    """OpenMP JFA: float32 signed squared distances (z, y, x)."""
    if spec.n > (1 << 21):
        raise ValueError("native JFA seeds pack 21-bit coordinate fields "
                         "(N <= 2^21); host memory is the practical limit")
    lib = load()
    n = spec.n
    occ8 = np.ascontiguousarray(occ, np.uint8)
    origin = _as_f32(spec.origin)
    sdf = np.empty((n, n, n), np.float32)
    rc = lib.vox_jfa(_ptr(occ8), n, _ptr(origin), float(spec.voxel_size), _ptr(sdf))
    if rc != 0:
        raise RuntimeError(f"vox_jfa failed rc={rc}")
    return sdf


def native_csg(words1: np.ndarray, words2: np.ndarray, op: str) -> np.ndarray:
    """words1 op words2 on packed words (a new array of words1's shape
    and dtype)."""
    lib = load()
    w1 = np.ascontiguousarray(words1).view(np.uint32).copy()
    w2 = np.ascontiguousarray(words2).view(np.uint32)
    if w1.shape != w2.shape:
        raise ValueError(f"CSG words differ in shape: {w1.shape} vs {w2.shape}")
    rc = lib.vox_csg(_ptr(w1), _ptr(w2), w1.size, CSG_OPS[op])
    if rc != 0:
        raise RuntimeError(f"vox_csg failed rc={rc}")
    return w1.view(np.asarray(words1).dtype).reshape(np.shape(words1))
