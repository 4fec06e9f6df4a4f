// Native runtime components for pathtracer.
//
// The reference keeps its scene IO and BVH builder in host C++
// (reference/include/utils/file_manager.h, rendering/bvh.h); these are
// the host-side equivalents, exposed through a plain C ABI consumed via
// ctypes (no pybind11 in this image). Python fallbacks exist for both, so
// the shared library is an accelerator, not a hard dependency.
//
//   * tpt_load_obj: Wavefront OBJ/MTL parser with the same semantics as the
//     Python loader (v/vn/mtllib/usemtl/f with v, v//vn, v/vt, v/vt/vn
//     forms; tris + quads; Kd/Ke; Ks/illum mirror extension).
//   * tpt_build_bvh: largest-axis midpoint-split builder (leaf <= 4,
//     degenerate-extent median fallback) over Morton-presorted triangles,
//     emitting the same flat arrays as pathtracer.ops.bvh.build_bvh.
//
// Build: make -C native   (produces libtpt_native.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <array>
#include <cmath>
#include <fstream>
#include <map>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader
// ---------------------------------------------------------------------------

struct TptMesh {
  std::vector<float> corners;    // N * 4 * 3
  std::vector<uint8_t> is_quad;  // N
  std::vector<float> albedo;     // N * 3
  std::vector<float> emission;   // N * 3
  std::vector<int32_t> material; // N
  std::vector<float> normal;     // N * 3 (zeros when not provided)
  std::string error;
};

struct Mtl {
  float kd[3] = {0.8f, 0.8f, 0.8f};
  float ke[3] = {0.f, 0.f, 0.f};
  float ks[3] = {0.f, 0.f, 0.f};
  int illum = 2;
  int kind() const {
    float ksmax = std::max(ks[0], std::max(ks[1], ks[2]));
    return (illum == 5 || (illum >= 3 && ksmax > 0.5f)) ? 1 : 0;
  }
  const float* bsdf() const { return kind() == 1 ? ks : kd; }
};

static std::map<std::string, Mtl> load_mtl(const std::string& path) {
  std::map<std::string, Mtl> mats;
  std::ifstream f(path);
  if (!f.is_open()) return mats;
  std::string line, name;
  Mtl cur;
  auto flush = [&]() {
    if (!name.empty()) mats[name] = cur;
  };
  while (std::getline(f, line)) {
    std::istringstream iss(line);
    std::string key;
    iss >> key;
    if (key == "newmtl") {
      flush();
      iss >> name;
      cur = Mtl();
    } else if (key == "Kd") {
      iss >> cur.kd[0] >> cur.kd[1] >> cur.kd[2];
    } else if (key == "Ke") {
      iss >> cur.ke[0] >> cur.ke[1] >> cur.ke[2];
    } else if (key == "Ks") {
      iss >> cur.ks[0] >> cur.ks[1] >> cur.ks[2];
    } else if (key == "illum") {
      iss >> cur.illum;
    }
  }
  flush();
  return mats;
}

static void parse_face_token(const std::string& tok, long& v, long& vn) {
  v = vn = 0;
  size_t s1 = tok.find('/');
  v = std::strtol(tok.c_str(), nullptr, 10);
  if (s1 == std::string::npos) return;
  size_t s2 = tok.find('/', s1 + 1);
  if (s2 == std::string::npos) return;  // v/vt
  vn = std::strtol(tok.c_str() + s2 + 1, nullptr, 10);
}

TptMesh* tpt_load_obj(const char* path_c) {
  auto* m = new TptMesh();
  std::string path(path_c);
  std::ifstream f(path);
  if (!f.is_open()) {
    m->error = "cannot open " + path;
    return m;
  }
  std::string base;
  size_t slash = path.find_last_of("/\\");
  if (slash != std::string::npos) base = path.substr(0, slash + 1);

  std::vector<std::array<float, 3>> verts, norms;
  std::map<std::string, Mtl> mats;
  Mtl cur;

  std::string line;
  while (std::getline(f, line)) {
    size_t hash = line.find('#');          // inline comments too
    if (hash != std::string::npos) line.resize(hash);
    if (line.empty()) continue;
    char c0 = line[0];
    if (c0 == 'o' || c0 == 's') continue;
    std::istringstream iss(line);
    std::string key;
    iss >> key;
    if (key == "v") {
      std::array<float, 3> v{};
      if (iss >> v[0] >> v[1] >> v[2]) verts.push_back(v);
    } else if (key == "vn") {
      std::array<float, 3> n{};
      if (iss >> n[0] >> n[1] >> n[2]) {
        float l = std::sqrt(n[0]*n[0] + n[1]*n[1] + n[2]*n[2]);
        if (l > 0) { n[0]/=l; n[1]/=l; n[2]/=l; }
        norms.push_back(n);
      }
    } else if (key == "mtllib") {
      std::string mf;
      iss >> mf;
      mats = load_mtl(base + mf);
    } else if (key == "usemtl") {
      std::string name;
      iss >> name;
      auto it = mats.find(name);
      cur = (it != mats.end()) ? it->second : Mtl();
    } else if (key == "f") {
      std::vector<long> vi, ni;
      std::string tok;
      while (iss >> tok) {
        long v, vn;
        parse_face_token(tok, v, vn);
        vi.push_back(v);
        ni.push_back(vn);
      }
      size_t nvert = vi.size();
      if (nvert != 3 && nvert != 4) continue;
      bool ok = true;
      for (long v : vi)
        if (v <= 0 || (size_t)v > verts.size()) ok = false;
      if (!ok) continue;

      std::array<std::array<float, 3>, 4> c{};
      for (size_t k = 0; k < nvert; k++) c[k] = verts[vi[k] - 1];
      if (nvert == 3) c[3] = c[2];  // triangle (a,b,c,c) encoding

      for (int k = 0; k < 4; k++)
        for (int j = 0; j < 3; j++) m->corners.push_back(c[k][j]);
      m->is_quad.push_back(nvert == 4 ? 1 : 0);
      for (int j = 0; j < 3; j++) m->albedo.push_back(cur.bsdf()[j]);
      for (int j = 0; j < 3; j++) m->emission.push_back(cur.ke[j]);
      m->material.push_back(cur.kind());
      if (ni[0] > 0 && (size_t)ni[0] <= norms.size()) {
        const auto& n = norms[ni[0] - 1];
        m->normal.insert(m->normal.end(), n.begin(), n.end());
      } else {
        m->normal.insert(m->normal.end(), {0.f, 0.f, 0.f});
      }
    }
  }
  if (m->is_quad.empty()) m->error = "no valid primitives in " + path;
  return m;
}

int32_t tpt_mesh_num_prims(TptMesh* m) { return (int32_t)m->is_quad.size(); }
const char* tpt_mesh_error(TptMesh* m) {
  return m->error.empty() ? nullptr : m->error.c_str();
}
void tpt_mesh_fill(TptMesh* m, float* corners, uint8_t* is_quad,
                   float* albedo, float* emission, int32_t* material,
                   float* normal) {
  std::memcpy(corners, m->corners.data(), m->corners.size() * 4);
  std::memcpy(is_quad, m->is_quad.data(), m->is_quad.size());
  std::memcpy(albedo, m->albedo.data(), m->albedo.size() * 4);
  std::memcpy(emission, m->emission.data(), m->emission.size() * 4);
  std::memcpy(material, m->material.data(), m->material.size() * 4);
  std::memcpy(normal, m->normal.data(), m->normal.size() * 4);
}
void tpt_mesh_free(TptMesh* m) { delete m; }

// ---------------------------------------------------------------------------
// BVH builder
// ---------------------------------------------------------------------------

struct TptBvh {
  std::vector<float> node_min, node_max;   // M * 3
  std::vector<int32_t> node_left, node_right, node_count;  // M
  std::vector<int32_t> tri_order;          // T
};

static uint64_t expand_bits(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

TptBvh* tpt_build_bvh(int32_t t, const float* tmin, const float* tmax,
                      int32_t leaf_size) {
  auto* b = new TptBvh();
  std::vector<std::array<float, 3>> cen(t);
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int i = 0; i < t; i++)
    for (int j = 0; j < 3; j++) {
      cen[i][j] = 0.5f * (tmin[i * 3 + j] + tmax[i * 3 + j]);
      lo[j] = std::min(lo[j], cen[i][j]);
      hi[j] = std::max(hi[j], cen[i][j]);
    }
  // Morton pre-sort (stable), matching ops/bvh.py
  std::vector<uint64_t> codes(t);
  for (int i = 0; i < t; i++) {
    uint64_t code = 0;
    uint64_t q[3];
    for (int j = 0; j < 3; j++) {
      float ext = std::max(hi[j] - lo[j], 1e-12f);
      float n = (cen[i][j] - lo[j]) / ext;
      q[j] = (uint64_t)std::min(std::max(n * 1023.0f, 0.0f), 1023.0f);
    }
    code = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
           expand_bits(q[2]);
    codes[i] = code;
  }
  b->tri_order.resize(t);
  std::iota(b->tri_order.begin(), b->tri_order.end(), 0);
  std::stable_sort(b->tri_order.begin(), b->tri_order.end(),
                   [&](int a, int c) { return codes[a] < codes[c]; });

  auto new_node = [&]() {
    b->node_min.insert(b->node_min.end(), {0, 0, 0});
    b->node_max.insert(b->node_max.end(), {0, 0, 0});
    b->node_left.push_back(0);
    b->node_right.push_back(0);
    b->node_count.push_back(0);
    return (int32_t)b->node_count.size() - 1;
  };

  struct Task { int32_t node, start, end; };
  std::vector<Task> tasks;
  int32_t root = new_node();
  tasks.push_back({root, 0, t});
  while (!tasks.empty()) {
    Task tk = tasks.back();
    tasks.pop_back();
    float bbmin[3] = {1e30f, 1e30f, 1e30f};
    float bbmax[3] = {-1e30f, -1e30f, -1e30f};
    float cmin[3] = {1e30f, 1e30f, 1e30f};
    float cmax[3] = {-1e30f, -1e30f, -1e30f};
    for (int32_t i = tk.start; i < tk.end; i++) {
      int32_t tri = b->tri_order[i];
      for (int j = 0; j < 3; j++) {
        bbmin[j] = std::min(bbmin[j], tmin[tri * 3 + j]);
        bbmax[j] = std::max(bbmax[j], tmax[tri * 3 + j]);
        cmin[j] = std::min(cmin[j], cen[tri][j]);
        cmax[j] = std::max(cmax[j], cen[tri][j]);
      }
    }
    for (int j = 0; j < 3; j++) {
      b->node_min[tk.node * 3 + j] = bbmin[j];
      b->node_max[tk.node * 3 + j] = bbmax[j];
    }
    int32_t count = tk.end - tk.start;
    if (count <= leaf_size) {
      b->node_left[tk.node] = tk.start;
      b->node_count[tk.node] = count;
      continue;
    }
    int axis = 0;
    float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1],
                    cmax[2] - cmin[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    int32_t mid;
    if (ext[axis] < 1e-12f) {
      mid = tk.start + count / 2;
    } else {
      float cut = 0.5f * (cmin[axis] + cmax[axis]);
      auto* first = b->tri_order.data() + tk.start;
      auto* last = b->tri_order.data() + tk.end;
      auto* p = std::stable_partition(
          first, last, [&](int32_t tri) { return cen[tri][axis] < cut; });
      mid = tk.start + (int32_t)(p - first);
      if (mid == tk.start || mid == tk.end) mid = tk.start + count / 2;
    }
    int32_t left = new_node();
    int32_t right = new_node();
    b->node_left[tk.node] = left;
    b->node_right[tk.node] = right;
    tasks.push_back({left, tk.start, mid});
    tasks.push_back({right, mid, tk.end});
  }
  return b;
}

int32_t tpt_bvh_num_nodes(TptBvh* b) {
  return (int32_t)b->node_count.size();
}
void tpt_bvh_fill(TptBvh* b, float* node_min, float* node_max,
                  int32_t* node_left, int32_t* node_right,
                  int32_t* node_count, int32_t* tri_order) {
  std::memcpy(node_min, b->node_min.data(), b->node_min.size() * 4);
  std::memcpy(node_max, b->node_max.data(), b->node_max.size() * 4);
  std::memcpy(node_left, b->node_left.data(), b->node_left.size() * 4);
  std::memcpy(node_right, b->node_right.data(), b->node_right.size() * 4);
  std::memcpy(node_count, b->node_count.data(), b->node_count.size() * 4);
  std::memcpy(tri_order, b->tri_order.data(), b->tri_order.size() * 4);
}
void tpt_bvh_free(TptBvh* b) { delete b; }

}  // extern "C"
