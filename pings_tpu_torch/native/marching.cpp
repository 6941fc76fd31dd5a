// Native isosurface extraction for pings_tpu_torch: a copy of
// pings_tpu/native/marching.cpp, built by pings_tpu_torch/native/__init__.py.
//
// Plays the role of skimage.measure.marching_cubes in the reference
// (utils/mesher.py:363-391): extract the zero level set of a sampled SDF
// grid with an optional validity mask. Implemented as marching
// *tetrahedra* (6 tets per cube): table-free, watertight on shared faces,
// and branch-light — a good fit for a small dependency-free native lib.
// Vertices on shared edges are deduplicated via an edge-key hash map so
// the output is an indexed mesh.
//
// Grid layout: sdf[(x * ny + y) * nz + z], world pos = origin + idx * res.
// mask: 1 = trustworthy sample (reference mc_mask, mesher.py:100-166);
// a tet contributes only if all 4 corners are masked valid.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// the 6 tetrahedra of a cube, as corner indices (0..7, bit order x|y|z)
static const int kTets[6][4] = {
    {0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
    {0, 2, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// cube corner offsets (x, y, z) for bit-coded corners
static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

inline uint64_t EdgeKey(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if output capacity was exceeded (results are
// truncated but consistent).
int marching_tetrahedra(
    const float* sdf, const uint8_t* mask, int nx, int ny, int nz,
    float iso, float ox, float oy, float oz, float res,
    float* out_verts /* (max_verts,3) */, int32_t* out_tris /* (max_tris,3) */,
    int32_t max_verts, int32_t max_tris,
    int32_t* n_verts_out, int32_t* n_tris_out) {
  std::unordered_map<uint64_t, int32_t> edge_to_vert;
  edge_to_vert.reserve(1 << 16);
  int32_t nv = 0, nt = 0;
  bool overflow = false;

  auto lin = [&](int x, int y, int z) -> uint64_t {
    return ((uint64_t)x * ny + y) * nz + z;
  };

  auto emit_vertex = [&](uint64_t ia, uint64_t ib, float va,
                         float vb) -> int32_t {
    uint64_t key = EdgeKey(ia, ib);
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;
    if (nv >= max_verts) {
      overflow = true;
      return -1;
    }
    // positions of the two grid points
    uint64_t a = (ia < ib) ? ia : ib;
    uint64_t b = (ia < ib) ? ib : ia;
    float fa = (ia < ib) ? va : vb;
    float fb = (ia < ib) ? vb : va;
    int az = (int)(a % nz), ay = (int)((a / nz) % ny), ax = (int)(a / ((uint64_t)ny * nz));
    int bz = (int)(b % nz), by = (int)((b / nz) % ny), bx = (int)(b / ((uint64_t)ny * nz));
    float t = (fb - fa) != 0.0f ? (iso - fa) / (fb - fa) : 0.5f;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    out_verts[3 * nv + 0] = ox + (ax + t * (bx - ax)) * res;
    out_verts[3 * nv + 1] = oy + (ay + t * (by - ay)) * res;
    out_verts[3 * nv + 2] = oz + (az + t * (bz - az)) * res;
    edge_to_vert.emplace(key, nv);
    return nv++;
  };

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        // gather cube corners
        float v[8];
        uint64_t gi[8];
        bool ok = true;
        for (int c = 0; c < 8; ++c) {
          int cx = x + kCorner[c][0];
          int cy = y + kCorner[c][1];
          int cz = z + kCorner[c][2];
          gi[c] = lin(cx, cy, cz);
          v[c] = sdf[gi[c]];
          if (mask && !mask[gi[c]]) ok = false;
        }
        if (!ok) continue;
        // quick reject: all same side
        bool any_neg = false, any_pos = false;
        for (int c = 0; c < 8; ++c) {
          if (v[c] < iso) any_neg = true; else any_pos = true;
        }
        if (!any_neg || !any_pos) continue;

        for (int t = 0; t < 6; ++t) {
          const int* tet = kTets[t];
          int inside[4], ni = 0;
          for (int c = 0; c < 4; ++c)
            if (v[tet[c]] < iso) inside[ni++] = c;
          if (ni == 0 || ni == 4) continue;

          // collect crossing-edge vertices with consistent orientation
          int32_t tri[4];
          int ntv = 0;
          auto cross = [&](int a, int b) {
            tri[ntv++] = emit_vertex(gi[tet[a]], gi[tet[b]], v[tet[a]],
                                     v[tet[b]]);
          };
          if (ni == 1) {
            int a = inside[0];
            int o[3], k = 0;
            for (int c = 0; c < 4; ++c)
              if (c != a) o[k++] = c;
            cross(a, o[0]); cross(a, o[1]); cross(a, o[2]);
          } else if (ni == 3) {
            int a = -1;  // the single outside corner
            for (int c = 0; c < 4; ++c) {
              bool is_in = false;
              for (int q = 0; q < 3; ++q) is_in |= (inside[q] == c);
              if (!is_in) a = c;
            }
            int o[3], k = 0;
            for (int c = 0; c < 4; ++c)
              if (c != a) o[k++] = c;
            cross(a, o[0]); cross(a, o[2]); cross(a, o[1]);
          } else {  // ni == 2: quad -> two triangles
            int a0 = inside[0], a1 = inside[1];
            int o[2], k = 0;
            for (int c = 0; c < 4; ++c)
              if (c != a0 && c != a1) o[k++] = c;
            int32_t q0, q1, q2, q3;
            q0 = emit_vertex(gi[tet[a0]], gi[tet[o[0]]], v[tet[a0]], v[tet[o[0]]]);
            q1 = emit_vertex(gi[tet[a0]], gi[tet[o[1]]], v[tet[a0]], v[tet[o[1]]]);
            q2 = emit_vertex(gi[tet[a1]], gi[tet[o[1]]], v[tet[a1]], v[tet[o[1]]]);
            q3 = emit_vertex(gi[tet[a1]], gi[tet[o[0]]], v[tet[a1]], v[tet[o[0]]]);
            if (q0 < 0 || q1 < 0 || q2 < 0 || q3 < 0) { overflow = true; continue; }
            if (nt + 2 <= max_tris) {
              out_tris[3 * nt + 0] = q0; out_tris[3 * nt + 1] = q1;
              out_tris[3 * nt + 2] = q2; ++nt;
              out_tris[3 * nt + 0] = q0; out_tris[3 * nt + 1] = q2;
              out_tris[3 * nt + 2] = q3; ++nt;
            } else {
              overflow = true;
            }
            continue;
          }
          if (tri[0] < 0 || tri[1] < 0 || tri[2] < 0) { overflow = true; continue; }
          if (nt < max_tris) {
            out_tris[3 * nt + 0] = tri[0];
            out_tris[3 * nt + 1] = tri[1];
            out_tris[3 * nt + 2] = tri[2];
            ++nt;
          } else {
            overflow = true;
          }
        }
      }
    }
  }
  *n_verts_out = nv;
  *n_tris_out = nt;
  return overflow ? 1 : 0;
}

// Brute-force-free nearest-neighbor distances between two point clouds via
// a uniform grid — used by mesh evaluation (chamfer/F-score; plays the
// role of open3d KDTree in eval/eval_mesh_utils.py:8-183).
int nn_distances(const float* query, int nq, const float* ref, int nr,
                 float cell, float* out_dist) {
  if (nr == 0) {
    for (int i = 0; i < nq; ++i) out_dist[i] = 1e9f;
    return 0;
  }
  // build grid hash
  std::unordered_map<uint64_t, std::vector<int>> grid;
  grid.reserve(nr);
  // exact packed key (21 bits per axis) — no hash collisions
  auto key = [&](float x, float y, float z) -> uint64_t {
    uint64_t cx = (uint64_t)((int64_t)std::floor(x / cell) + (1 << 20)) & 0x1FFFFF;
    uint64_t cy = (uint64_t)((int64_t)std::floor(y / cell) + (1 << 20)) & 0x1FFFFF;
    uint64_t cz = (uint64_t)((int64_t)std::floor(z / cell) + (1 << 20)) & 0x1FFFFF;
    return (cx << 42) | (cy << 21) | cz;
  };
  for (int i = 0; i < nr; ++i)
    grid[key(ref[3 * i], ref[3 * i + 1], ref[3 * i + 2])].push_back(i);

  for (int i = 0; i < nq; ++i) {
    float qx = query[3 * i], qy = query[3 * i + 1], qz = query[3 * i + 2];
    float best = 1e18f;
    // search expanding shells of cells until a hit ring is fully covered
    for (int ring = 0; ring < 4; ++ring) {
      for (int dx = -ring; dx <= ring; ++dx)
        for (int dy = -ring; dy <= ring; ++dy)
          for (int dz = -ring; dz <= ring; ++dz) {
            if (std::max(std::max(abs(dx), abs(dy)), abs(dz)) != ring)
              continue;
            auto it = grid.find(key(qx + dx * cell, qy + dy * cell,
                                    qz + dz * cell));
            if (it == grid.end()) continue;
            for (int j : it->second) {
              float ddx = ref[3 * j] - qx;
              float ddy = ref[3 * j + 1] - qy;
              float ddz = ref[3 * j + 2] - qz;
              float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d2 < best) best = d2;
            }
          }
      if (best < (float)(ring * ring) * cell * cell && ring > 0) break;
    }
    out_dist[i] = best < 1e17f ? std::sqrt(best) : 1e9f;
  }
  return 0;
}

}  // extern "C"
