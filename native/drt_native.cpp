// Native runtime components for distributed_raytracer.
//
// The reference's "native" layer is its Go runtime (OBJ parsing via gwob,
// R-tree builds via rtreego — SURVEY.md §2 C5/C22). Here the host-side
// heavy lifting — Wavefront OBJ/MTL parsing and the Morton ordering that
// underpins the block BVH — is C++ behind a C ABI consumed via ctypes
// (models/native.py), with a pure-Python fallback kept for portability.
//
// Semantics match models/objparse.py exactly:
//   - fan triangulation of polygons
//   - exact-value vertex/normal dedup, first-seen order (mesh.go:146-148)
//   - normals normalized on load (mesh.go:199)
//   - per-face material index resolved from usemtl against the MTL library,
//     default material Ka=0x10 grey / Kd=white / Ks=black / Ns=0 (mesh.go:151)
//   - MTL colours clamped to [0,1] (colour.go:33-35)

#include <algorithm>
#include <array>
#include <cmath>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
  bool operator==(const Vec3 &o) const { return x == o.x && y == o.y && z == o.z; }
};

struct Vec3Hash {
  size_t operator()(const Vec3 &v) const {
    auto h = [](double d) {
      uint64_t u;
      std::memcpy(&u, &d, sizeof(u));
      return std::hash<uint64_t>()(u);
    };
    size_t s = h(v.x);
    s ^= h(v.y) + 0x9e3779b97f4a7c15ULL + (s << 6) + (s >> 2);
    s ^= h(v.z) + 0x9e3779b97f4a7c15ULL + (s << 6) + (s >> 2);
    return s;
  }
};

struct Material {
  std::array<double, 3> ka{0x10 / 255.0, 0x10 / 255.0, 0x10 / 255.0};
  std::array<double, 3> kd{1.0, 1.0, 1.0};
  std::array<double, 3> ks{0.0, 0.0, 0.0};
  double ns = 0.0;
  bool operator==(const Material &o) const {
    return ka == o.ka && kd == o.kd && ks == o.ks && ns == o.ns;
  }
};

struct Mesh {
  std::vector<Vec3> vertices;
  std::vector<Vec3> normals;
  std::vector<std::array<int32_t, 3>> faces_v;
  std::vector<std::array<int32_t, 3>> faces_n;
  std::vector<int32_t> face_mat;
  std::vector<Material> materials;
  std::string error;
};

double clamp01(double v) { return v < 0.0 ? 0.0 : (v > 1.0 ? 1.0 : v); }

std::string dirname_of(const std::string &path) {
  size_t pos = path.find_last_of("/\\");
  return pos == std::string::npos ? std::string() : path.substr(0, pos + 1);
}

bool parse_mtl(const std::string &path,
               std::unordered_map<std::string, Material> &lib) {
  std::ifstream in(path);
  if (!in.good()) return false;
  std::string line, name;
  Material cur;
  bool have = false;
  auto flush = [&]() {
    if (have) lib[name] = cur;
  };
  while (std::getline(in, line)) {
    std::istringstream ss(line);
    std::string key;
    if (!(ss >> key) || key[0] == '#') continue;
    if (key == "newmtl") {
      flush();
      ss >> name;
      cur = Material{};
      have = true;
    } else if (key == "Ka" || key == "Kd" || key == "Ks") {
      double r, g, b;
      if (ss >> r >> g >> b) {
        std::array<double, 3> v{clamp01(r), clamp01(g), clamp01(b)};
        if (key == "Ka") cur.ka = v;
        else if (key == "Kd") cur.kd = v;
        else cur.ks = v;
      }
    } else if (key == "Ns") {
      ss >> cur.ns;
    }
  }
  flush();
  return true;
}

int resolve_index(long idx, size_t count) {
  return idx > 0 ? static_cast<int>(idx - 1)
                 : static_cast<int>(static_cast<long>(count) + idx);
}

}  // namespace

extern "C" {

Mesh *drt_parse_obj(const char *path_c) {
  auto *mesh = new Mesh();
  std::string path(path_c);
  std::ifstream in(path);
  if (!in.good()) {
    mesh->error = "cannot open " + path;
    return mesh;
  }

  std::vector<Vec3> raw_v, raw_n;
  std::string mtllib;
  std::string cur_usemtl;
  bool have_usemtl = false;

  struct FaceRec {
    std::array<int32_t, 3> v, n;
    int usemtl;  // index into usemtl_names, -1 = none
  };
  std::vector<FaceRec> faces;
  std::vector<std::string> usemtl_names;
  int cur_usemtl_id = -1;

  std::string line;
  std::vector<int> cv, cn;
  while (std::getline(in, line)) {
    if (line.empty()) continue;
    std::istringstream ss(line);
    std::string key;
    if (!(ss >> key) || key[0] == '#') continue;
    if (key == "v") {
      Vec3 p{};
      ss >> p.x >> p.y >> p.z;
      raw_v.push_back(p);
    } else if (key == "vn") {
      Vec3 p{};
      ss >> p.x >> p.y >> p.z;
      raw_n.push_back(p);
    } else if (key == "mtllib") {
      std::getline(ss >> std::ws, mtllib);
      while (!mtllib.empty() && std::isspace(mtllib.back())) mtllib.pop_back();
    } else if (key == "usemtl") {
      ss >> cur_usemtl;
      have_usemtl = true;
      usemtl_names.push_back(cur_usemtl);
      cur_usemtl_id = static_cast<int>(usemtl_names.size()) - 1;
    } else if (key == "f") {
      cv.clear();
      cn.clear();
      std::string tok;
      while (ss >> tok) {
        long vi = 0, ni = 0;
        bool has_n = false;
        size_t s1 = tok.find('/');
        if (s1 == std::string::npos) {
          vi = std::strtol(tok.c_str(), nullptr, 10);
        } else {
          vi = std::strtol(tok.substr(0, s1).c_str(), nullptr, 10);
          size_t s2 = tok.find('/', s1 + 1);
          if (s2 != std::string::npos && s2 + 1 < tok.size()) {
            ni = std::strtol(tok.substr(s2 + 1).c_str(), nullptr, 10);
            has_n = true;
          }
        }
        cv.push_back(resolve_index(vi, raw_v.size()));
        cn.push_back(has_n ? resolve_index(ni, raw_n.size()) : -1);
      }
      for (size_t k = 1; k + 1 < cv.size(); ++k) {  // fan triangulation
        FaceRec f;
        f.v = {static_cast<int32_t>(cv[0]), static_cast<int32_t>(cv[k]),
               static_cast<int32_t>(cv[k + 1])};
        f.n = {static_cast<int32_t>(cn[0]), static_cast<int32_t>(cn[k]),
               static_cast<int32_t>(cn[k + 1])};
        f.usemtl = have_usemtl ? cur_usemtl_id : -1;
        faces.push_back(f);
      }
    }
  }

  // MTL library: relative to the OBJ, then as given (mesh.go:118-127).
  std::unordered_map<std::string, Material> mtl_lib;
  if (!mtllib.empty()) {
    if (!parse_mtl(dirname_of(path) + mtllib, mtl_lib)) parse_mtl(mtllib, mtl_lib);
  }

  // Dedup vertices / normals by exact value, first-seen order.
  std::unordered_map<Vec3, int32_t, Vec3Hash> vmap, nmap;
  std::vector<int32_t> vremap(raw_v.size()), nremap(raw_n.size(), -1);
  for (size_t i = 0; i < raw_v.size(); ++i) {
    auto it = vmap.find(raw_v[i]);
    if (it == vmap.end()) {
      int32_t id = static_cast<int32_t>(mesh->vertices.size());
      vmap.emplace(raw_v[i], id);
      mesh->vertices.push_back(raw_v[i]);
      vremap[i] = id;
    } else {
      vremap[i] = it->second;
    }
  }
  bool all_have_normals = !raw_n.empty();
  for (const auto &f : faces)
    for (int c = 0; c < 3; ++c)
      if (f.n[c] < 0) all_have_normals = false;
  if (all_have_normals) {
    for (size_t i = 0; i < raw_n.size(); ++i) {
      Vec3 n = raw_n[i];
      double len = std::sqrt(n.x * n.x + n.y * n.y + n.z * n.z);
      if (len > 0) { n.x /= len; n.y /= len; n.z /= len; }
      auto it = nmap.find(n);
      if (it == nmap.end()) {
        int32_t id = static_cast<int32_t>(mesh->normals.size());
        nmap.emplace(n, id);
        mesh->normals.push_back(n);
        nremap[i] = id;
      } else {
        nremap[i] = it->second;
      }
    }
  }

  // Materials: per distinct usemtl (or default), deduped by value.
  std::vector<int32_t> usemtl_to_mat(usemtl_names.size() + 1, -1);
  auto intern_material = [&](const Material &m) -> int32_t {
    for (size_t i = 0; i < mesh->materials.size(); ++i)
      if (mesh->materials[i] == m) return static_cast<int32_t>(i);
    mesh->materials.push_back(m);
    return static_cast<int32_t>(mesh->materials.size()) - 1;
  };

  mesh->faces_v.reserve(faces.size());
  for (const auto &f : faces) {
    std::array<int32_t, 3> fv{vremap[f.v[0]], vremap[f.v[1]], vremap[f.v[2]]};
    std::array<int32_t, 3> fn{-1, -1, -1};
    if (all_have_normals)
      fn = {nremap[f.n[0]], nremap[f.n[1]], nremap[f.n[2]]};
    mesh->faces_v.push_back(fv);
    mesh->faces_n.push_back(fn);
    Material m;  // default (mesh.go:151)
    if (f.usemtl >= 0) {
      auto it = mtl_lib.find(usemtl_names[f.usemtl]);
      if (it != mtl_lib.end()) m = it->second;
    }
    mesh->face_mat.push_back(intern_material(m));
  }
  if (mesh->materials.empty()) mesh->materials.push_back(Material{});
  return mesh;
}

const char *drt_mesh_error(Mesh *m) {
  return m->error.empty() ? nullptr : m->error.c_str();
}

void drt_mesh_counts(Mesh *m, int64_t *nv, int64_t *nn, int64_t *nf,
                     int64_t *nmat) {
  *nv = static_cast<int64_t>(m->vertices.size());
  *nn = static_cast<int64_t>(m->normals.size());
  *nf = static_cast<int64_t>(m->faces_v.size());
  *nmat = static_cast<int64_t>(m->materials.size());
}

void drt_mesh_fill(Mesh *m, double *verts, double *norms, int32_t *fv,
                   int32_t *fn, int32_t *fmat, double *mats) {
  for (size_t i = 0; i < m->vertices.size(); ++i) {
    verts[3 * i] = m->vertices[i].x;
    verts[3 * i + 1] = m->vertices[i].y;
    verts[3 * i + 2] = m->vertices[i].z;
  }
  for (size_t i = 0; i < m->normals.size(); ++i) {
    norms[3 * i] = m->normals[i].x;
    norms[3 * i + 1] = m->normals[i].y;
    norms[3 * i + 2] = m->normals[i].z;
  }
  for (size_t i = 0; i < m->faces_v.size(); ++i) {
    for (int c = 0; c < 3; ++c) {
      fv[3 * i + c] = m->faces_v[i][c];
      fn[3 * i + c] = m->faces_n[i][c];
    }
    fmat[i] = m->face_mat[i];
  }
  for (size_t i = 0; i < m->materials.size(); ++i) {
    const Material &mt = m->materials[i];
    double *row = mats + 10 * i;
    row[0] = mt.ka[0]; row[1] = mt.ka[1]; row[2] = mt.ka[2];
    row[3] = mt.kd[0]; row[4] = mt.kd[1]; row[5] = mt.kd[2];
    row[6] = mt.ks[0]; row[7] = mt.ks[1]; row[8] = mt.ks[2];
    row[9] = mt.ns;
  }
}

void drt_mesh_free(Mesh *m) { delete m; }

// ---- Morton ordering (block-BVH build) -----------------------------------

static inline uint64_t spread3(uint64_t x) {
  x &= 0x1FFFFFULL;
  x = (x | (x << 32)) & 0x1F00000000FFFFULL;
  x = (x | (x << 16)) & 0x1F0000FF0000FFULL;
  x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
  x = (x | (x << 2)) & 0x1249249249249249ULL;
  return x;
}

// Morton codes of 3D points normalized to their AABB — the same math as
// models/bvh.py morton_codes (21 bits per axis).
void drt_morton_codes(const double *pts, int64_t n, uint64_t *codes) {
  if (n <= 0) return;
  double lo[3] = {pts[0], pts[1], pts[2]};
  double hi[3] = {pts[0], pts[1], pts[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c) {
      double v = pts[3 * i + c];
      if (v < lo[c]) lo[c] = v;
      if (v > hi[c]) hi[c] = v;
    }
  double ext[3];
  for (int c = 0; c < 3; ++c) {
    ext[c] = hi[c] - lo[c];
    if (ext[c] <= 0) ext[c] = 1.0;
  }
  const double scale = static_cast<double>((1ULL << 21) - 1);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int c = 0; c < 3; ++c)
      q[c] = static_cast<uint64_t>((pts[3 * i + c] - lo[c]) / ext[c] * scale);
    codes[i] = (spread3(q[0]) << 2) | (spread3(q[1]) << 1) | spread3(q[2]);
  }
}

// Morton-argsort of 3D points (centroids); writes the permutation into
// `order`. Matches models/bvh.py morton_codes/morton_order (stable sort).
void drt_morton_argsort(const double *pts, int64_t n, int64_t *order) {
  if (n <= 0) return;
  double lo[3] = {pts[0], pts[1], pts[2]};
  double hi[3] = {pts[0], pts[1], pts[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c) {
      double v = pts[3 * i + c];
      if (v < lo[c]) lo[c] = v;
      if (v > hi[c]) hi[c] = v;
    }
  double ext[3];
  for (int c = 0; c < 3; ++c) {
    ext[c] = hi[c] - lo[c];
    if (ext[c] <= 0) ext[c] = 1.0;
  }
  const double scale = static_cast<double>((1ULL << 21) - 1);
  std::vector<std::pair<uint64_t, int64_t>> keyed(n);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int c = 0; c < 3; ++c) {
      double t = (pts[3 * i + c] - lo[c]) / ext[c] * scale;
      q[c] = static_cast<uint64_t>(t);
    }
    keyed[i] = {(spread3(q[0]) << 2) | (spread3(q[1]) << 1) | spread3(q[2]), i};
  }
  std::stable_sort(keyed.begin(), keyed.end(),
                   [](const auto &a, const auto &b) { return a.first < b.first; });
  for (int64_t i = 0; i < n; ++i) order[i] = keyed[i].second;
}

// ---- Native scene bake (block-BVH layout) --------------------------------
//
// The array analog of the reference building its meshes + R-trees at load
// time in compiled Go (mesh.go:109-213): the whole per-triangle bake loop —
// world-space placement, Baldwin-Weber precompute (f64, cast f32), normals,
// and the per-triangle AABBs with the bound-epsilon floor (util.go:7) —
// runs here in one OpenMP pass per object, writing rows directly at their
// final Morton/gap-aligned slots. The NumPy implementation (Scene.bake +
// bvh.reorder_scene + bvh.build_block_bvh) remains the behavioral
// reference and fallback; models/scene.py dispatches to this when the
// library is available. At 5.24M triangles this path is ~20x faster than
// the NumPy chain (which allocates a dozen full-size f64 temporaries).

// Per-object world-space centroids: (v[f0] + v[f1] + v[f2]) / 3 + pos.
void drt_centroids(const double *verts, const int32_t *faces, int64_t nf,
                   const double *pos, double *out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nf; ++i) {
    const int32_t *f = faces + 3 * i;
    for (int c = 0; c < 3; ++c)
      out[3 * i + c] = (verts[3 * f[0] + c] + verts[3 * f[1] + c] +
                        verts[3 * f[2] + c]) / 3.0 + pos[c];
  }
}

// Bake one object's triangles into the global slot layout.
//
// slot_src maps output slot -> GLOBAL source triangle id (-1 = padding);
// this call processes slots whose source falls in [src_lo, src_hi) — the
// object's contiguous run in the global triangle order — and writes their
// rows. All math in double, outputs cast to float exactly as the NumPy
// bake; tri_lo/tri_hi are the per-slot AABBs over the FLOAT32-cast
// geometry (build_block_bvh's convention) with the 5e-5 half-epsilon floor.
void drt_bake_object(
    const double *verts, const int32_t *faces_v, const int32_t *faces_n,
    const double *norms, int32_t has_normals, const int32_t *face_mat,
    const double *pos, const int64_t *slot_src, int64_t n_slots,
    int64_t src_lo, int64_t src_hi,
    float *p0, float *e1, float *e2, float *geo_n, float *plane_d,
    float *k_u, float *k_v, float *c_u, float *c_v,
    float *n0, float *n1, float *n2, int32_t *mat_id,
    double *tri_lo, double *tri_hi) {
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_slots; ++s) {
    int64_t src = slot_src[s];
    if (src < src_lo || src >= src_hi) continue;
    int64_t t = src - src_lo;
    const int32_t *fv = faces_v + 3 * t;
    double P0[3], P1[3], P2[3], E1[3], E2[3];
    for (int c = 0; c < 3; ++c) {
      P0[c] = verts[3 * fv[0] + c] + pos[c];
      P1[c] = verts[3 * fv[1] + c] + pos[c];
      P2[c] = verts[3 * fv[2] + c] + pos[c];
      E1[c] = P1[c] - P0[c];
      E2[c] = P2[c] - P0[c];
    }
    double N[3] = {E1[1] * E2[2] - E1[2] * E2[1],
                   E1[2] * E2[0] - E1[0] * E2[2],
                   E1[0] * E2[1] - E1[1] * E2[0]};
    double pd = N[0] * P0[0] + N[1] * P0[1] + N[2] * P0[2];
    double nn = N[0] * N[0] + N[1] * N[1] + N[2] * N[2];
    double KU[3] = {E2[1] * N[2] - E2[2] * N[1],
                    E2[2] * N[0] - E2[0] * N[2],
                    E2[0] * N[1] - E2[1] * N[0]};
    double KV[3] = {N[1] * E1[2] - N[2] * E1[1],
                    N[2] * E1[0] - N[0] * E1[2],
                    N[0] * E1[1] - N[1] * E1[0]};
    if (nn > 0.0) {
      for (int c = 0; c < 3; ++c) { KU[c] /= nn; KV[c] /= nn; }
    } else {
      for (int c = 0; c < 3; ++c) { KU[c] = 0.0; KV[c] = 0.0; }
    }
    double CU = -(P0[0] * KU[0] + P0[1] * KU[1] + P0[2] * KU[2]);
    double CV = -(P0[0] * KV[0] + P0[1] * KV[1] + P0[2] * KV[2]);

    for (int c = 0; c < 3; ++c) {
      p0[3 * s + c] = static_cast<float>(P0[c]);
      e1[3 * s + c] = static_cast<float>(E1[c]);
      e2[3 * s + c] = static_cast<float>(E2[c]);
      geo_n[3 * s + c] = static_cast<float>(N[c]);
      k_u[3 * s + c] = static_cast<float>(KU[c]);
      k_v[3 * s + c] = static_cast<float>(KV[c]);
    }
    plane_d[s] = static_cast<float>(pd);
    c_u[s] = static_cast<float>(CU);
    c_v[s] = static_cast<float>(CV);
    mat_id[s] = face_mat[t];

    if (has_normals) {
      const int32_t *fn = faces_n + 3 * t;
      for (int c = 0; c < 3; ++c) {
        n0[3 * s + c] = static_cast<float>(norms[3 * fn[0] + c]);
        n1[3 * s + c] = static_cast<float>(norms[3 * fn[1] + c]);
        n2[3 * s + c] = static_cast<float>(norms[3 * fn[2] + c]);
      }
    } else {
      // Flat shading: the normalized face normal in all three slots
      // (triangle.go:24-26 vs :29-31; degenerate faces get zeros, the
      // NumPy path's nan_to_num).
      double len = std::sqrt(nn);
      double FN[3] = {0.0, 0.0, 0.0};
      if (len > 0.0)
        for (int c = 0; c < 3; ++c) FN[c] = N[c] / len;
      for (int c = 0; c < 3; ++c) {
        float f = static_cast<float>(FN[c]);
        n0[3 * s + c] = f;
        n1[3 * s + c] = f;
        n2[3 * s + c] = f;
      }
    }

    // Per-triangle AABB over the f32-cast geometry (what the kernels
    // intersect), with the reference's bound-epsilon floor
    // (util.go:7, mesh.go:44 — half-width 5e-5 per side).
    for (int c = 0; c < 3; ++c) {
      double a = static_cast<double>(p0[3 * s + c]);
      double b = a + static_cast<double>(e1[3 * s + c]);
      double d = a + static_cast<double>(e2[3 * s + c]);
      double lo = std::min(a, std::min(b, d));
      double hi = std::max(a, std::max(b, d));
      double center = (lo + hi) / 2.0;
      tri_lo[3 * s + c] = std::min(lo, center - 5e-5);
      tri_hi[3 * s + c] = std::max(hi, center + 5e-5);
    }
  }
}

// Leaf-block AABB reduction over per-slot bounds (padding slots carry
// (+inf, -inf) and vanish from the min/max; all-padding blocks stay
// inverted, which the interval cull rejects explicitly).
void drt_block_bounds(const double *tri_lo, const double *tri_hi,
                      int64_t n_slots, int64_t block_size,
                      float *block_lo, float *block_hi) {
  int64_t nb = n_slots / block_size;
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < nb; ++b) {
    double lo[3] = {HUGE_VAL, HUGE_VAL, HUGE_VAL};
    double hi[3] = {-HUGE_VAL, -HUGE_VAL, -HUGE_VAL};
    for (int64_t s = b * block_size; s < (b + 1) * block_size; ++s)
      for (int c = 0; c < 3; ++c) {
        lo[c] = std::min(lo[c], tri_lo[3 * s + c]);
        hi[c] = std::max(hi[c], tri_hi[3 * s + c]);
      }
    for (int c = 0; c < 3; ++c) {
      block_lo[3 * b + c] = static_cast<float>(lo[c]);
      block_hi[3 * b + c] = static_cast<float>(hi[c]);
    }
  }
}

}  // extern "C"
