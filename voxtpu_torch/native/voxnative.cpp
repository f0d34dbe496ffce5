// voxnative — C ABI host library: fast OBJ I/O + OpenMP CPU backends.
//
// voxtpu_torch's copy of voxtpu/native/voxnative.cpp, kept line for line
// so that both packages build the same code: the host-side runtime, the
// counterpart of the reference's OpenMP backends (vox/openmp.cpp,
// jfa/openmp.cpp, csg/openmp.cpp) and OBJ parser (mesh/mesh_io.cpp).
// Semantics follow the NumPy oracle (voxtpu_torch/ops/reference.py, which
// matches the reference's sequential backends); every function is tested
// against that oracle and against voxtpu's library from Python via ctypes
// (tests/test_torch_native.py).
//
// Grids are dense [z, y, x] row-major; the voxelizer fills bit-packed
// uint32 words internally with atomic XOR suffix masks (the lock-free
// analog of the reference's word-wise atomicXor fill) and expands to
// bytes on output.
//
// Built at first use by voxtpu_torch/native/__init__.py with voxtpu's
// Makefile flags (g++ -O3 -march=native -fopenmp -fPIC -shared -std=c++17).

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ import/export
// ---------------------------------------------------------------------------

struct VoxMesh {
  float* coords;        // (V, 3)
  std::int32_t num_vertices;
  float* normals;       // (Vn, 3)
  std::int32_t num_normals;
  std::uint8_t* colors; // (V, 4) RGBA or nullptr
  std::int32_t has_colors;
  std::int32_t* faces;         // (F, 3)
  std::int32_t* faces_normals; // (F, 3)
  std::int32_t num_faces;
};

static float parse_float(const char*& p) {
  char* end;
  float v = strtof(p, &end);
  p = end;
  return v;
}

static long parse_int(const char*& p) {
  char* end;
  long v = strtol(p, &end, 10);
  p = end;
  return v;
}

int vox_import_obj(const char* path, VoxMesh* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  if (size < 0) {  // unseekable stream: -1 would heap-overflow below
    fclose(f);
    return -1;
  }
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -1;
  }
  fclose(f);
  buf[size] = '\0';

  std::vector<float> coords, normals;
  std::vector<float> colors;
  std::vector<std::int32_t> faces, fnormals;
  // Colors only count when EVERY vertex row carries r g b — the Python
  // spec's ragged-block rule (obj_io._parse_float_block): a file mixing
  // plain and colored rows has no per-vertex colors.
  bool any_color = false;
  bool all_color = true;

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    // find line
    const char* line = p;
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    if (line[0] == 'v' && line[1] == ' ') {
      const char* q = line + 2;
      float x = parse_float(q), y = parse_float(q), z = parse_float(q);
      coords.push_back(x);
      coords.push_back(y);
      coords.push_back(z);
      // Optional vertex-color extension (mesh_io.cpp:57-59 reads r g b).
      // Only treat the tail as colors when THREE numeric tokens parse:
      // a lone 4th value ("v x y z w") or a trailing comment is not RGB.
      const char* save = q;
      char* e1;
      char* e2;
      char* e3;
      float r = strtof(q, &e1);
      float g = strtof(e1, &e2);
      float b = strtof(e2, &e3);
      if (e1 != q && e2 != e1 && e3 != e2) {
        colors.push_back(r);
        colors.push_back(g);
        colors.push_back(b);
        any_color = true;
      } else {
        q = save;
        colors.push_back(1.f);
        colors.push_back(1.f);
        colors.push_back(1.f);
        all_color = false;
      }
    } else if (line[0] == 'v' && line[1] == 'n' && line[2] == ' ') {
      const char* q = line + 3;
      normals.push_back(parse_float(q));
      normals.push_back(parse_float(q));
      normals.push_back(parse_float(q));
    } else if (line[0] == 'f' && line[1] == ' ') {
      // Exactly 3 vertex tokens per face — quads/ngons/short lines are
      // a parse error (rc=-2), matching the Python spec's ValueError
      // instead of silently truncating to the first triangle.
      const char* q = line + 2;
      const char* line_end = p;  // start of the next line
      int ntok = 0;
      while (true) {
        while (q < line_end && (*q == ' ' || *q == '\t' || *q == '\r' ||
                                *q == '\n'))
          ++q;
        if (q >= line_end || *q == '\n') break;
        char* tok_end;
        long vi = strtol(q, &tok_end, 10);
        if (tok_end == q)  // non-numeric junk where an index belongs
          return -2;
        q = tok_end;
        long ni = vi;
        if (*q == '/') {
          ++q;
          if (*q == '/') {
            ++q;
            ni = parse_int(q);
          } else {
            long ti = parse_int(q);
            (void)ti;
            if (*q == '/') {
              ++q;
              ni = parse_int(q);
            }
          }
        }
        if (ntok >= 3)  // 4th vertex: non-triangular face
          return -2;
        faces.push_back((std::int32_t)(vi - 1));
        fnormals.push_back((std::int32_t)(ni - 1));
        ++ntok;
      }
      if (ntok != 3) return -2;
    }
  }

  std::int32_t nv = (std::int32_t)(coords.size() / 3);
  out->num_vertices = nv;
  out->coords = (float*)malloc(coords.size() * sizeof(float));
  memcpy(out->coords, coords.data(), coords.size() * sizeof(float));
  out->num_normals = (std::int32_t)(normals.size() / 3);
  out->normals = (float*)malloc(normals.size() * sizeof(float));
  memcpy(out->normals, normals.data(), normals.size() * sizeof(float));
  out->has_colors = (any_color && all_color) ? 1 : 0;
  out->colors = (std::uint8_t*)malloc((size_t)nv * 4);
  for (std::int32_t i = 0; i < nv; ++i) {
    for (int c = 0; c < 3; ++c) {
      float v = colors[(size_t)i * 3 + c] * 255.f;
      v = v < 0 ? 0 : (v > 255 ? 255 : v);
      // nearbyintf = round-half-even, matching the spec's np.round
      // quantization (126.5/255 -> 126 on both paths).
      out->colors[(size_t)i * 4 + c] = (std::uint8_t)nearbyintf(v);
    }
    out->colors[(size_t)i * 4 + 3] = 255;
  }
  out->num_faces = (std::int32_t)(faces.size() / 3);
  out->faces = (std::int32_t*)malloc(faces.size() * sizeof(std::int32_t));
  memcpy(out->faces, faces.data(), faces.size() * sizeof(std::int32_t));
  out->faces_normals =
      (std::int32_t*)malloc(fnormals.size() * sizeof(std::int32_t));
  memcpy(out->faces_normals, fnormals.data(),
         fnormals.size() * sizeof(std::int32_t));
  return 0;
}

void vox_free_mesh(VoxMesh* m) {
  free(m->coords);
  free(m->normals);
  free(m->colors);
  free(m->faces);
  free(m->faces_normals);
  memset(m, 0, sizeof(*m));
}

int vox_export_obj(const char* path, const float* coords,
                   const std::uint8_t* colors, std::int32_t nv,
                   const float* normals, std::int32_t nn,
                   const std::int32_t* faces,
                   const std::int32_t* faces_normals, std::int32_t nf) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "# OBJ file written by voxtpu (native)\n# Vertices: %d\n# Faces: %d\n",
          nv, nf);
  for (std::int32_t i = 0; i < nv; ++i) {
    fprintf(f, "v %.6f %.6f %.6f %.6f %.6f %.6f\n", coords[i * 3],
            coords[i * 3 + 1], coords[i * 3 + 2], colors[i * 4] / 255.0,
            colors[i * 4 + 1] / 255.0, colors[i * 4 + 2] / 255.0);
  }
  fputc('\n', f);
  for (std::int32_t i = 0; i < nn; ++i) {
    fprintf(f, "vn %.6f %.6f %.6f\n", normals[i * 3], normals[i * 3 + 1],
            normals[i * 3 + 2]);
  }
  fputc('\n', f);
  for (std::int32_t i = 0; i < nf; ++i) {
    fprintf(f, "f %d//%d %d//%d %d//%d\n", faces[i * 3] + 1,
            faces_normals[i * 3] + 1, faces[i * 3 + 1] + 1,
            faces_normals[i * 3 + 1] + 1, faces[i * 3 + 2] + 1,
            faces_normals[i * 3 + 2] + 1);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Solid voxelization (OpenMP, atomic word-XOR suffix fill)
// ---------------------------------------------------------------------------

static inline float edge_zy(const float* v0, const float* v1, float y,
                            float z) {
  return (z - v0[2]) * (v1[1] - v0[1]) - (y - v0[1]) * (v1[2] - v0[2]);
}

int vox_voxelize(const float* coords, const std::int32_t* faces,
                 std::int32_t num_faces, std::int32_t n, const float* origin,
                 float voxel_size, std::uint8_t* occ_out) {
  if (n % 32 != 0) return -2;
  const std::int64_t nn = (std::int64_t)n * n;
  const std::int32_t nw = n / 32;
  std::vector<std::uint32_t> words((size_t)nn * nw, 0u);
  std::uint32_t* w = words.data();
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float vs = voxel_size;

#pragma omp parallel for schedule(dynamic, 64)
  for (std::int32_t t = 0; t < num_faces; ++t) {
    const float* a = coords + (size_t)faces[t * 3] * 3;
    const float* b = coords + (size_t)faces[t * 3 + 1] * 3;
    const float* c = coords + (size_t)faces[t * 3 + 2] * 3;
    // normal = cross(b-a, c-b); only sign of X used
    float nx = (b[1] - a[1]) * (c[2] - b[2]) - (b[2] - a[2]) * (c[1] - b[1]);
    float sign = nx >= 0 ? 1.f : -1.f;

    float minY = fminf(fminf(a[1], b[1]), c[1]);
    float maxY = fmaxf(fmaxf(a[1], b[1]), c[1]);
    float minZ = fminf(fminf(a[2], b[2]), c[2]);
    float maxZ = fmaxf(fmaxf(a[2], b[2]), c[2]);
    int sy = (int)floorf((minY - oy) / vs);
    int ey = (int)ceilf((maxY - oy) / vs);
    int sz = (int)floorf((minZ - oz) / vs);
    int ez = (int)ceilf((maxZ - oz) / vs);
    sy = sy < 0 ? 0 : sy;
    sz = sz < 0 ? 0 : sz;
    ey = ey > n ? n : ey;
    ez = ez > n ? n : ez;

    float e0x = b[0] - a[0], e0y = b[1] - a[1], e0z = b[2] - a[2];
    float e1x = c[0] - a[0], e1y = c[1] - a[1], e1z = c[2] - a[2];
    float A = e0y * e1z - e0z * e1y;
    float B = e0z * e1x - e0x * e1z;
    float C = e0x * e1y - e0y * e1x;
    float D = A * a[0] + B * a[1] + C * a[2];

    for (int y = sy; y < ey; ++y) {
      float cy = oy + ((float)y * vs + vs / 2.f);
      for (int z = sz; z < ez; ++z) {
        float cz = oz + ((float)z * vs + vs / 2.f);
        float E0 = edge_zy(a, b, cy, cz) * sign;
        float E1 = edge_zy(b, c, cy, cz) * sign;
        float E2 = edge_zy(c, a, cy, cz) * sign;
        if (!(E0 >= 0 && E1 >= 0 && E2 >= 0)) continue;
        float xf = ((D - B * cy - C * cz) / A - ox) / vs;
        if (!(xf < (float)n) || !std::isfinite(xf)) continue;
        int x = (int)xf;  // trunc toward zero
        if (x < 0) x = 0;
        std::uint32_t* row = w + ((std::int64_t)z * n + y) * nw;
        for (int wi = x / 32; wi < nw; ++wi) {
          int s = x - wi * 32;
          std::uint32_t mask =
              s <= 0 ? 0xFFFFFFFFu : (0xFFFFFFFFu << (s & 31));
          __atomic_fetch_xor(&row[wi], mask, __ATOMIC_RELAXED);
        }
      }
    }
  }

// expand packed words to bytes
#pragma omp parallel for
  for (std::int64_t c = 0; c < nn; ++c) {
    const std::uint32_t* row = w + c * nw;
    std::uint8_t* out = occ_out + c * n;
    for (std::int32_t wi = 0; wi < nw; ++wi) {
      std::uint32_t word = row[wi];
      for (int bit = 0; bit < 32; ++bit)
        out[wi * 32 + bit] = (word >> bit) & 1u;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JFA signed squared distance field (OpenMP)
// ---------------------------------------------------------------------------

int vox_jfa(const std::uint8_t* occ, std::int32_t n, const float* origin,
            float voxel_size, float* sdf_out) {
  const std::int64_t total = (std::int64_t)n * n * n;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float vs = voxel_size;
  const float INF = INFINITY;
  // 21-bit (z, y, x) fields in an int64 seed: N up to 2^21 — memory,
  // not the encoding, is the practical limit (reference jfa/naive.cu:160).
  std::vector<std::int64_t> seed(total, 0), seed2(total, 0);
  std::vector<float> sdf(total), sdf2(total);

  auto at = [n](std::int64_t z, std::int64_t y, std::int64_t x) {
    return (z * n + y) * n + x;
  };

// init: boundary detect (26-neighborhood touching empty or out-of-grid)
#pragma omp parallel for collapse(2)
  for (std::int32_t z = 0; z < n; ++z) {
    for (std::int32_t y = 0; y < n; ++y) {
      for (std::int32_t x = 0; x < n; ++x) {
        std::int64_t i = at(z, y, x);
        if (!occ[i]) {
          sdf[i] = -INF;
          continue;
        }
        bool found = false;
        for (int dz = -1; dz <= 1 && !found; ++dz)
          for (int dy = -1; dy <= 1 && !found; ++dy)
            for (int dx = -1; dx <= 1 && !found; ++dx) {
              if (!dz && !dy && !dx) continue;
              int zz = z + dz, yy = y + dy, xx = x + dx;
              if (zz < 0 || zz >= n || yy < 0 || yy >= n || xx < 0 ||
                  xx >= n || !occ[at(zz, yy, xx)])
                found = true;
            }
        if (found) {
          sdf[i] = 0.f;
          seed[i] = ((std::int64_t)z << 42) | ((std::int64_t)y << 21) | x;
        } else {
          sdf[i] = INF;
        }
      }
    }
  }

  for (std::int32_t k = n / 2; k >= 1; k /= 2) {
#pragma omp parallel for collapse(2)
    for (std::int32_t z = 0; z < n; ++z) {
      for (std::int32_t y = 0; y < n; ++y) {
        for (std::int32_t x = 0; x < n; ++x) {
          std::int64_t i = at(z, y, x);
          float best = sdf[i];
          float babs = fabsf(best);
          float sign = std::signbit(best) ? -1.f : 1.f;
          std::int64_t bseed = seed[i];
          float px = ox + x * vs, py = oy + y * vs, pz = oz + z * vs;
          for (int dz = -1; dz <= 1; ++dz)
            for (int dy = -1; dy <= 1; ++dy)
              for (int dx = -1; dx <= 1; ++dx) {
                if (!dz && !dy && !dx) continue;
                int zz = z + dz * k, yy = y + dy * k, xx = x + dx * k;
                if (zz < 0 || zz >= n || yy < 0 || yy >= n || xx < 0 ||
                    xx >= n)
                  continue;
                std::int64_t j = at(zz, yy, xx);
                float s = sdf[j];
                if (!(fabsf(s) < INF)) continue;
                std::int64_t sj = seed[j];
                float wx = ox + (float)(sj & 0x1FFFFF) * vs;
                float wy = oy + (float)((sj >> 21) & 0x1FFFFF) * vs;
                float wz = oz + (float)((sj >> 42) & 0x1FFFFF) * vs;
                float d2 = (px - wx) * (px - wx) + (py - wy) * (py - wy) +
                           (pz - wz) * (pz - wz);
                if (d2 < babs) {
                  babs = d2;
                  best = sign * d2;
                  bseed = sj;
                }
              }
          sdf2[i] = best;
          seed2[i] = bseed;
        }
      }
    }
    sdf.swap(sdf2);
    seed.swap(seed2);
  }
  memcpy(sdf_out, sdf.data(), total * sizeof(float));
  return 0;
}

// ---------------------------------------------------------------------------
// CSG word fold (OpenMP)
// ---------------------------------------------------------------------------

int vox_csg(std::uint32_t* w1, const std::uint32_t* w2, std::int64_t nwords,
            std::int32_t op) {
#pragma omp parallel for
  for (std::int64_t i = 0; i < nwords; ++i) {
    switch (op) {
      case 1: w1[i] |= w2[i]; break;   // union
      case 2: w1[i] &= w2[i]; break;   // intersection
      case 3: w1[i] &= ~w2[i]; break;  // difference
      default: break;
    }
  }
  return 0;
}

}  // extern "C"
