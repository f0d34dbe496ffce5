"""Wavefront OBJ import/export — port of `voxtpu/mesh/obj_io.py`.

With ``use_native=True`` (the default, as in voxtpu) both go through the
C++ library of `voxtpu_torch.native`. The reader keeps voxtpu's
pure-Python parser as its fallback: where the library cannot be built
or loaded, or the native parser hands a file off (a non-triangular
face, junk where an index belongs), the Python parser runs, and the
parser that ran is logged (info level, `VOXTPU_LOG`). The writer has no
fallback: ``use_native=True`` raises where the library cannot be built
or loaded; only a file the library cannot open goes on to the Python
writer, which raises the error.

- Imports ``v x y z`` with the optional per-vertex RGB color extension
  (``v x y z r g b``), ``vn``, and triangular faces in the ``v``,
  ``v/vt``, ``v//vn`` and ``v/vt/vn`` forms (missing normal indices
  default to the vertex index).
- Exports colored vertices, normals and ``f v//vn`` faces with fixed
  6-decimal precision, text identical to voxtpu's Python writer.
"""

from __future__ import annotations

import os

import numpy as np

from voxtpu_torch.mesh.mesh import Mesh
from voxtpu_torch.utils.logging import log_info

_CHUNK = 1 << 20  # rows formatted per write


def _parse_float_block(lines: list[str], width_choices=(3, 6)) -> np.ndarray:
    if not lines:
        return np.zeros((0, 3), np.float32)
    tokens = " ".join(lines).split()
    try:
        vals = np.array(tokens, dtype=np.float32)
    except ValueError:
        vals = None  # non-numeric tokens somewhere: per-row fallback
    if vals is not None:
        for w in width_choices:
            if vals.size % w == 0 and len(lines) * w == vals.size:
                return vals.reshape(-1, w)
    # Ragged rows (a file mixing "v x y z" and "v x y z r g b", or
    # 4-component "v x y z w"): parse per line, keep coords, and keep
    # colors only when every row carries three numeric channels.
    rows = [ln.split() for ln in lines]
    bad = next((i for i, r in enumerate(rows) if len(r) < 3), None)
    if bad is not None:
        raise ValueError(
            f"OBJ float row {bad + 1} has {len(rows[bad])} component(s); "
            "expected at least 3 (x y z)"
        )
    try:
        coords = np.array([r[:3] for r in rows], np.float32)
    except ValueError as e:
        raise ValueError(f"non-numeric OBJ vertex/normal component: {e}") from None
    if all(len(r) >= 6 for r in rows):
        try:
            rgb = np.array([r[3:6] for r in rows], np.float32)
        except ValueError:
            return coords  # trailing tokens are not colors (e.g. comments)
        return np.concatenate([coords, rgb], axis=1)
    return coords


def _parse_faces(f_lines: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """(vertex, normal) index rows, 1-based, int64."""
    # Fast path: every vertex token of every line uses the same form;
    # normalize to whitespace-separated ints.
    forms = {tok.count("/") * 10 + ("//" in tok)
             for ln in f_lines for tok in ln.split()}
    uniform = len(forms) == 1 and bool(f_lines[0].split())
    if uniform:
        probe = f_lines[0].split()[0]
        n_slash = probe.count("/")
        text = " \n".join(f_lines)
        vals = np.array(text.replace("//", " ").replace("/", " ").split(),
                        dtype=np.int64)
        ints_per_vert = {0: 1, 1: 2}.get(n_slash, 2 if "//" in probe else 3)
        if vals.size == len(f_lines) * 3 * ints_per_vert:
            if n_slash == 0:
                vi = vals.reshape(-1, 3)
                return vi, vi
            if n_slash == 1:
                vi = vals.reshape(-1, 6)[:, 0::2]
                return vi, vi
            per_vert = ints_per_vert
            tri = vals.reshape(-1, 3 * per_vert)
            return tri[:, 0::per_vert], tri[:, per_vert - 1::per_vert]
    # Mixed forms within one file (or a malformed line): per token.
    vi_rows, ni_rows = [], []
    for lineno, ln in enumerate(f_lines, 1):
        toks = ln.split()
        if len(toks) != 3:
            raise ValueError(
                f"face {lineno} has {len(toks)} vertices; only triangular "
                "faces are supported (triangulate quads/ngons before import)"
            )
        vs, ns = [], []
        for tok in toks:
            parts = tok.split("/")
            vs.append(int(parts[0]))
            ns.append(int(parts[2]) if len(parts) == 3 and parts[2]
                      else int(parts[0]))
        vi_rows.append(vs)
        ni_rows.append(ns)
    return np.asarray(vi_rows, np.int64), np.asarray(ni_rows, np.int64)


def import_mesh(filename: str | os.PathLike, use_native: bool = True) -> Mesh:
    """Parse an .obj file into a :class:`Mesh`. Triangular faces only."""
    filename = os.fspath(filename)
    ext = os.path.splitext(filename)[1].lower()
    if ext != ".obj":
        raise ValueError(f"{ext!r} is a wrong file extension. It must be .obj")

    if use_native:
        from voxtpu_torch.native import NativeUnavailable, native_import_mesh

        try:
            mesh = native_import_mesh(filename)
        except NativeUnavailable as e:
            log_info("import_mesh(%s): native parser unavailable (%s); Python parser",
                     filename, str(e).splitlines()[0])
        else:
            if mesh is not None:
                log_info("import_mesh(%s): native parser", filename)
                return mesh
            log_info("import_mesh(%s): the native parser handed the file off; "
                     "Python parser", filename)
    else:
        log_info("import_mesh(%s): Python parser", filename)

    v_lines: list[str] = []
    vn_lines: list[str] = []
    f_lines: list[str] = []
    with open(filename, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                v_lines.append(line[2:])
            elif line.startswith("vn "):
                vn_lines.append(line[3:])
            elif line.startswith("f "):
                f_lines.append(line[2:])

    coords = np.zeros((0, 3), np.float32)
    colors = np.zeros((0, 4), np.uint8)
    if v_lines:
        block = _parse_float_block(v_lines)
        coords = block[:, :3].astype(np.float32)
        if block.shape[1] >= 6:
            rgb = np.clip(np.round(block[:, 3:6] * 255.0), 0, 255).astype(np.uint8)
            colors = np.concatenate(
                [rgb, np.full((rgb.shape[0], 1), 255, np.uint8)], axis=1
            )

    normals = (_parse_float_block(vn_lines)[:, :3] if vn_lines
               else np.zeros((0, 3), np.float32))

    faces = np.zeros((0, 3), np.int32)
    faces_normals = np.zeros((0, 3), np.int32)
    if f_lines:
        vi, ni = _parse_faces(f_lines)
        faces = (vi - 1).astype(np.int32)
        faces_normals = (ni - 1).astype(np.int32)

    mesh = Mesh(name=filename, coords=coords, normals=normals, colors=colors,
                faces=faces, faces_normals=faces_normals)
    mesh.validate()
    return mesh


def export_mesh(filename: str | os.PathLike, mesh: Mesh, use_native: bool = True) -> None:
    """Write a Mesh as .obj (colored vertices, normals, ``f v//vn`` faces)."""
    filename = os.fspath(filename)
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)

    if use_native:
        from voxtpu_torch.native import native_export_mesh

        if native_export_mesh(filename, mesh):
            return

    V = mesh.num_vertices
    F = mesh.num_faces
    colors = mesh.colors
    if colors is None or colors.shape[0] != V:
        colors = np.full((V, 4), 255, np.uint8)

    fn = mesh.faces_normals
    if fn is None or fn.shape[0] != F:
        fn = mesh.faces
    # Rows are formatted from Python floats/ints (`tolist`), which
    # prints the same text as formatting NumPy scalars, several times
    # faster, in chunks that bound the memory of the Python rows: the
    # SDF cube export writes tens of millions of lines.
    with open(filename, "w") as fh:
        fh.write("# OBJ file written by voxtpu\n"
                 f"# Vertices: {V}\n"
                 f"# Faces: {F}\n")
        for i in range(0, V, _CHUNK):
            vblock = np.concatenate(
                [mesh.coords[i:i + _CHUNK].astype(np.float64),
                 colors[i:i + _CHUNK, :3].astype(np.float64) / 255.0], axis=1)
            fh.write("".join(
                f"v {a:.6f} {b:.6f} {c:.6f} {r:.6f} {g:.6f} {bl:.6f}\n"
                for a, b, c, r, g, bl in vblock.tolist()))
        if V:
            fh.write("\n")
        if mesh.normals.shape[0]:
            fh.write("".join(
                f"vn {a:.6f} {b:.6f} {c:.6f}\n"
                for a, b, c in mesh.normals.astype(np.float64).tolist()) + "\n")
        for i in range(0, F, _CHUNK):
            rows = np.concatenate([mesh.faces[i:i + _CHUNK].astype(np.int64) + 1,
                                   fn[i:i + _CHUNK].astype(np.int64) + 1], axis=1)
            fh.write("".join(
                f"f {a}//{na} {b}//{nb} {c}//{nc}\n"
                for a, b, c, na, nb, nc in rows.tolist()))
