// Iso-surface extraction (marching tetrahedra) for voxel visualization.
//
// The port's own copy of genre_shapehd_tpu/native/isosurface.cpp (same
// algorithm, same output); it stands in for skimage.measure.marching_cubes.
// Each cell is split into 6 tetrahedra sharing the main diagonal; each
// tetrahedron contributes 0-2 triangles with linearly interpolated
// crossing vertices.  Deterministic, watertight across shared faces,
// no lookup-table transcription to get wrong.
//
// C ABI (consumed via ctypes from genre_shapehd_tpu_torch/viz/mcubes.py):
//   iso_extract(vol, nx, ny, nz, iso, spacing, &mesh) -> 0 on success
//   iso_free(&mesh)
//   iso_write_obj(path, verts, nverts, tris, ntris) -> 0 on success
//     (added in this copy: the .obj text numpy.savetxt would write with
//     "v %.6f %.6f %.6f" / "f %d %d %d", 1-based faces, without holding
//     the interpreter lock for millions of lines)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct IsoMesh {
  float* verts;     // nverts * 3
  int64_t nverts;
  int32_t* tris;    // ntris * 3 (indices into verts)
  int64_t ntris;
};

}  // extern "C"

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp_edge(const V3& a, const V3& b, float va, float vb, float iso) {
  float denom = vb - va;
  float t = (denom == 0.0f) ? 0.5f : (iso - va) / denom;
  if (t < 0.0f) t = 0.0f;
  if (t > 1.0f) t = 1.0f;
  return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z)};
}

// The 6 tetrahedra of a cube, as corner indices (cube corner bit order:
// bit0=x, bit1=y, bit2=z), all sharing the 0-7 diagonal.
constexpr int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

void emit_tet(const V3 p[4], const float v[4], float iso,
              std::vector<float>& verts, std::vector<int32_t>& tris) {
  int mask = 0;
  for (int i = 0; i < 4; ++i)
    if (v[i] > iso) mask |= 1 << i;
  if (mask == 0 || mask == 15) return;

  auto push_tri = [&](V3 a, V3 b, V3 c) {
    int32_t base = static_cast<int32_t>(verts.size() / 3);
    const V3 pts[3] = {a, b, c};
    for (const V3& p_ : pts) {
      verts.push_back(p_.x);
      verts.push_back(p_.y);
      verts.push_back(p_.z);
    }
    tris.push_back(base);
    tris.push_back(base + 1);
    tris.push_back(base + 2);
  };
  auto E = [&](int i, int j) { return lerp_edge(p[i], p[j], v[i], v[j], iso); };

  // one corner inside (or its complement): one triangle
  // two corners inside: a quad, split into two triangles
  switch (mask) {
    case 1:  push_tri(E(0, 1), E(0, 2), E(0, 3)); break;
    case 14: push_tri(E(0, 1), E(0, 3), E(0, 2)); break;
    case 2:  push_tri(E(1, 0), E(1, 3), E(1, 2)); break;
    case 13: push_tri(E(1, 0), E(1, 2), E(1, 3)); break;
    case 4:  push_tri(E(2, 0), E(2, 1), E(2, 3)); break;
    case 11: push_tri(E(2, 0), E(2, 3), E(2, 1)); break;
    case 8:  push_tri(E(3, 0), E(3, 2), E(3, 1)); break;
    case 7:  push_tri(E(3, 0), E(3, 1), E(3, 2)); break;
    case 3:   // corners 0,1 inside
      push_tri(E(0, 2), E(1, 2), E(1, 3));
      push_tri(E(0, 2), E(1, 3), E(0, 3));
      break;
    case 12:
      push_tri(E(0, 2), E(1, 3), E(1, 2));
      push_tri(E(0, 2), E(0, 3), E(1, 3));
      break;
    case 5:   // corners 0,2 inside
      push_tri(E(0, 1), E(1, 2), E(2, 3));
      push_tri(E(0, 1), E(2, 3), E(0, 3));
      break;
    case 10:
      push_tri(E(0, 1), E(2, 3), E(1, 2));
      push_tri(E(0, 1), E(0, 3), E(2, 3));
      break;
    case 6:   // corners 1,2 inside
      push_tri(E(0, 1), E(0, 2), E(2, 3));
      push_tri(E(0, 1), E(2, 3), E(1, 3));
      break;
    case 9:
      push_tri(E(0, 1), E(2, 3), E(0, 2));
      push_tri(E(0, 1), E(1, 3), E(2, 3));
      break;
    default: break;
  }
}

}  // namespace

extern "C" {

int iso_extract(const float* vol, int64_t nx, int64_t ny, int64_t nz,
                float iso, float sx, float sy, float sz, IsoMesh* out) {
  if (!vol || !out || nx < 2 || ny < 2 || nz < 2) return 1;
  std::vector<float> verts;
  std::vector<int32_t> tris;
  verts.reserve(1 << 16);
  tris.reserve(1 << 14);

  auto at = [&](int64_t x, int64_t y, int64_t z) {
    return vol[(x * ny + y) * nz + z];
  };

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      for (int64_t z = 0; z + 1 < nz; ++z) {
        V3 corner[8];
        float value[8];
        for (int c = 0; c < 8; ++c) {
          int64_t cx = x + (c & 1), cy = y + ((c >> 1) & 1),
                  cz = z + ((c >> 2) & 1);
          corner[c] = V3{cx * sx, cy * sy, cz * sz};
          value[c] = at(cx, cy, cz);
        }
        // quick reject: all same side
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c)
          (value[c] > iso ? any_in : any_out) = true;
        if (!any_in || !any_out) continue;

        for (const auto& tet : kTets) {
          V3 p[4];
          float v[4];
          for (int i = 0; i < 4; ++i) {
            p[i] = corner[tet[i]];
            v[i] = value[tet[i]];
          }
          emit_tet(p, v, iso, verts, tris);
        }
      }
    }
  }

  out->nverts = static_cast<int64_t>(verts.size() / 3);
  out->ntris = static_cast<int64_t>(tris.size() / 3);
  out->verts = static_cast<float*>(std::malloc(verts.size() * sizeof(float)));
  out->tris =
      static_cast<int32_t*>(std::malloc(tris.size() * sizeof(int32_t)));
  if ((!out->verts && !verts.empty()) || (!out->tris && !tris.empty())) {
    std::free(out->verts);
    std::free(out->tris);
    return 2;
  }
  if (!verts.empty())
    std::memcpy(out->verts, verts.data(), verts.size() * sizeof(float));
  if (!tris.empty())
    std::memcpy(out->tris, tris.data(), tris.size() * sizeof(int32_t));
  return 0;
}

void iso_free(IsoMesh* mesh) {
  if (!mesh) return;
  std::free(mesh->verts);
  std::free(mesh->tris);
  mesh->verts = nullptr;
  mesh->tris = nullptr;
  mesh->nverts = mesh->ntris = 0;
}

int iso_write_obj(const char* path, const float* verts, int64_t nverts,
                  const int32_t* tris, int64_t ntris) {
  std::FILE* f = std::fopen(path, "w");
  if (!f) return 1;
  std::vector<char> buf(1 << 20);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  bool ok = true;
  for (int64_t i = 0; i < nverts && ok; ++i)
    ok = std::fprintf(f, "v %.6f %.6f %.6f\n", (double)verts[3 * i],
                      (double)verts[3 * i + 1], (double)verts[3 * i + 2]) > 0;
  for (int64_t i = 0; i < ntris && ok; ++i)
    ok = std::fprintf(f, "f %lld %lld %lld\n", (long long)tris[3 * i] + 1,
                      (long long)tris[3 * i + 1] + 1,
                      (long long)tris[3 * i + 2] + 1) > 0;
  return (std::fclose(f) == 0 && ok) ? 0 : 2;
}

}  // extern "C"
