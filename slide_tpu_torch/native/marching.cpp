// Native marching tetrahedra — the hot host-side post-processing step of the
// mesh pipeline (capability match: reference skimage marching_cubes usage,
// `dpsr_utils/utils.py:246-287`); a copy of slide_tpu/native/marching.cpp.
// Same algorithm as the numpy route in slide_tpu_torch/sap/marching.py (6-tet cube decomposition, iso-vertices on edges,
// gradient normals, gradient-consistent winding), rewritten as a single
// cache-friendly pass with O(1) exact edge dedup: every edge of the 6-tet
// decomposition around the 0-6 diagonal points from its componentwise-min
// corner P by an offset d in {0,1}^3 \ {0} (3 axes, 3 positive face
// diagonals, 1 main diagonal), so (lin(P), class(d)) is a perfect key into a
// flat int32 table — no hashing, no sort.
//
// Built at first use by slide_tpu_torch/_build.py (`load_host_library`) with
// g++; exported C ABI consumed via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// cube corner offsets, standard numbering (matches marching.py _CORNERS)
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

// 6-tetrahedra decomposition around the 0-6 diagonal (marching.py _TETS)
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};

// tetrahedron edges by local vertex pair (marching.py _EDGES)
const int EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// case table: inside-bitmask -> up to 2 triangles of edge ids, -1 padded
// (marching.py _CASES)
const int CASES[16][6] = {
    /* 0000 */ {-1, -1, -1, -1, -1, -1},
    /* 0001 */ {0, 1, 2, -1, -1, -1},
    /* 0010 */ {0, 4, 3, -1, -1, -1},
    /* 0011 */ {1, 3, 4, 1, 4, 2},
    /* 0100 */ {1, 3, 5, -1, -1, -1},
    /* 0101 */ {0, 3, 5, 0, 5, 2},
    /* 0110 */ {0, 4, 5, 0, 5, 1},
    /* 0111 */ {2, 4, 5, -1, -1, -1},
    /* 1000 */ {2, 5, 4, -1, -1, -1},
    /* 1001 */ {0, 5, 4, 0, 1, 5},
    /* 1010 */ {0, 5, 3, 0, 2, 5},
    /* 1011 */ {1, 5, 3, -1, -1, -1},
    /* 1100 */ {1, 4, 3, 1, 2, 4},
    /* 1101 */ {0, 3, 4, -1, -1, -1},
    /* 1110 */ {0, 2, 1, -1, -1, -1},
    /* 1111 */ {-1, -1, -1, -1, -1, -1}};

// edge-class index of offset d in {0,1}^3 \ {0}: class = d0*4 + d1*2 + d2 - 1
// -> (0,0,1)=0 (0,1,0)=1 (0,1,1)=2 (1,0,0)=3 (1,0,1)=4 (1,1,0)=5 (1,1,1)=6

struct Result {
  std::vector<float> verts;     // (V, 3) grid-index coords
  std::vector<float> normals;   // (V, 3) unit, -grad
  std::vector<int64_t> faces;   // (F, 3)
};

// central-difference gradient of vol at voxel (i, j, k) along each axis,
// one-sided at the borders — matches np.gradient
inline void gradient_at(const float* vol, int r0, int r1, int r2,
                        int i, int j, int k, float g[3]) {
  const int64_t s0 = (int64_t)r1 * r2, s1 = r2;
  const int64_t p = (int64_t)i * s0 + (int64_t)j * s1 + k;
  g[0] = (i == 0)      ? vol[p + s0] - vol[p]
       : (i == r0 - 1) ? vol[p] - vol[p - s0]
                       : 0.5f * (vol[p + s0] - vol[p - s0]);
  g[1] = (j == 0)      ? vol[p + s1] - vol[p]
       : (j == r1 - 1) ? vol[p] - vol[p - s1]
                       : 0.5f * (vol[p + s1] - vol[p - s1]);
  g[2] = (k == 0)      ? vol[p + 1] - vol[p]
       : (k == r2 - 1) ? vol[p] - vol[p - 1]
                       : 0.5f * (vol[p + 1] - vol[p - 1]);
}

}  // namespace

extern "C" {

void* mt_run(const float* vol, int r0, int r1, int r2, float level) {
  const int64_t s0 = (int64_t)r1 * r2, s1 = r2;
  const int64_t n_vox = (int64_t)r0 * s0;

  // perfect edge-vertex dedup table: (voxel, class) -> vertex id or -1
  std::vector<int32_t> edge_vert(n_vox * 7, -1);

  Result* res = new Result();
  std::vector<float>& verts = res->verts;
  std::vector<float>& normals = res->normals;
  std::vector<int64_t>& faces = res->faces;

  // cube corner linear-offset table
  int64_t corner_off[8];
  for (int c = 0; c < 8; ++c)
    corner_off[c] = (int64_t)CORNERS[c][0] * s0 +
                    (int64_t)CORNERS[c][1] * s1 + CORNERS[c][2];

  int64_t tri_vid[3];
  for (int x = 0; x < r0 - 1; ++x) {
    for (int y = 0; y < r1 - 1; ++y) {
      const float* row = vol + (int64_t)x * s0 + (int64_t)y * s1;
      for (int z = 0; z < r2 - 1; ++z) {
        // cube inside-mask prefilter
        const float* cb = row + z;
        unsigned cube_mask = 0;
        for (int c = 0; c < 8; ++c)
          cube_mask |= (cb[corner_off[c]] > level) << c;
        if (cube_mask == 0u || cube_mask == 255u) continue;

        const int64_t base = (int64_t)x * s0 + (int64_t)y * s1 + z;
        for (int t = 0; t < 6; ++t) {
          const int* tet = TETS[t];
          unsigned tcase = ((cube_mask >> tet[0]) & 1u)
                         | (((cube_mask >> tet[1]) & 1u) << 1)
                         | (((cube_mask >> tet[2]) & 1u) << 2)
                         | (((cube_mask >> tet[3]) & 1u) << 3);
          const int* tris = CASES[tcase];
          if (tris[0] < 0) continue;

          for (int tri0 = 0; tri0 < 6 && tris[tri0] >= 0; tri0 += 3) {
            for (int e = 0; e < 3; ++e) {
              const int edge = tris[tri0 + e];
              int ca = tet[EDGES[edge][0]], cb2 = tet[EDGES[edge][1]];
              // direct from componentwise-min corner: offsets are {0,1}^3 so
              // min corner == the one with the subset bitmask at every axis
              int ax = CORNERS[ca][0], ay = CORNERS[ca][1], az = CORNERS[ca][2];
              int bx = CORNERS[cb2][0], by = CORNERS[cb2][1], bz = CORNERS[cb2][2];
              int px = ax < bx ? ax : bx, py = ay < by ? ay : by,
                  pz = az < bz ? az : bz;
              int dx = (ax > bx ? ax : bx) - px, dy2 = (ay > by ? ay : by) - py,
                  dz = (az > bz ? az : bz) - pz;
              const int cls = dx * 4 + dy2 * 2 + dz - 1;
              const int64_t p_lin =
                  base + (int64_t)px * s0 + (int64_t)py * s1 + pz;
              int32_t& slot = edge_vert[p_lin * 7 + cls];
              if (slot < 0) {
                // create the iso-vertex on edge P -> P+d
                const int64_t q_lin =
                    p_lin + (int64_t)dx * s0 + (int64_t)dy2 * s1 + dz;
                const float v0 = vol[p_lin], v1 = vol[q_lin];
                float dv = v1 - v0;
                if (std::fabs(dv) < 1e-12f) dv = 1e-12f;
                float tt = (level - v0) / dv;
                tt = tt < 0.f ? 0.f : (tt > 1.f ? 1.f : tt);
                const float vx = (x + px) + tt * dx, vy = (y + py) + tt * dy2,
                            vz = (z + pz) + tt * dz;
                slot = (int32_t)(verts.size() / 3);
                verts.push_back(vx);
                verts.push_back(vy);
                verts.push_back(vz);
                // normal: -gradient at the nearest voxel (rounded vertex,
                // half to even as numpy's np.round: a vertex at .5 takes the
                // numpy oracle's voxel; std::lround rounds it away from 0)
                int ni = (int)std::nearbyint(vx), nj = (int)std::nearbyint(vy),
                    nk = (int)std::nearbyint(vz);
                ni = ni < 0 ? 0 : (ni > r0 - 1 ? r0 - 1 : ni);
                nj = nj < 0 ? 0 : (nj > r1 - 1 ? r1 - 1 : nj);
                nk = nk < 0 ? 0 : (nk > r2 - 1 ? r2 - 1 : nk);
                float g[3];
                gradient_at(vol, r0, r1, r2, ni, nj, nk, g);
                float nrm = std::sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
                if (nrm < 1e-12f) nrm = 1.f;
                normals.push_back(-g[0] / nrm);
                normals.push_back(-g[1] / nrm);
                normals.push_back(-g[2] / nrm);
              }
              tri_vid[e] = slot;
            }
            // drop degenerate faces
            if (tri_vid[0] == tri_vid[1] || tri_vid[1] == tri_vid[2] ||
                tri_vid[0] == tri_vid[2])
              continue;
            // gradient-consistent winding: face normal . sum(vertex normals)
            const float* pa = &verts[tri_vid[0] * 3];
            const float* pb = &verts[tri_vid[1] * 3];
            const float* pc = &verts[tri_vid[2] * 3];
            const float e1x = pb[0] - pa[0], e1y = pb[1] - pa[1],
                        e1z = pb[2] - pa[2];
            const float e2x = pc[0] - pa[0], e2y = pc[1] - pa[1],
                        e2z = pc[2] - pa[2];
            const float fnx = e1y * e2z - e1z * e2y,
                        fny = e1z * e2x - e1x * e2z,
                        fnz = e1x * e2y - e1y * e2x;
            float rx = 0.f, ry = 0.f, rz = 0.f;
            for (int e = 0; e < 3; ++e) {
              const float* nn = &normals[tri_vid[e] * 3];
              rx += nn[0]; ry += nn[1]; rz += nn[2];
            }
            const bool flip = fnx * rx + fny * ry + fnz * rz < 0.f;
            faces.push_back(tri_vid[0]);
            faces.push_back(flip ? tri_vid[2] : tri_vid[1]);
            faces.push_back(flip ? tri_vid[1] : tri_vid[2]);
          }
        }
      }
    }
  }

  if (faces.empty()) {
    delete res;
    return nullptr;  // empty level surface
  }
  return res;
}

int64_t mt_num_verts(void* h) {
  return h ? (int64_t)((Result*)h)->verts.size() / 3 : 0;
}

int64_t mt_num_faces(void* h) {
  return h ? (int64_t)((Result*)h)->faces.size() / 3 : 0;
}

void mt_copy(void* h, float* verts, int64_t* faces, float* normals) {
  if (!h) return;
  Result* r = (Result*)h;
  std::memcpy(verts, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(faces, r->faces.data(), r->faces.size() * sizeof(int64_t));
  std::memcpy(normals, r->normals.data(), r->normals.size() * sizeof(float));
}

void mt_free(void* h) { delete (Result*)h; }

}  // extern "C"
