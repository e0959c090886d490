// Frozen copy of glaze_tpu_torch/native/glaze_native.cpp for the benchmark's plain reference.
// Native runtime components for glaze_tpu.
//
// The reference implementation is fully native (Rust); this library provides
// the CPU-side hot paths of the TPU rebuild as C++ with a plain C ABI loaded
// through ctypes:
//   - xxHash64 (scene file integrity, lib/src/parser/v1.rs:40-47 equivalent)
//   - a binned-SAH BVH builder producing a threaded (skip-link) layout that
//     the JAX/Pallas traversal kernels consume directly.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 glaze_native.cpp -o libglaze_native.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// xxHash64
// ---------------------------------------------------------------------------

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t read64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
static inline uint32_t read32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
static inline uint64_t xxh_round(uint64_t acc, uint64_t inp) {
  acc += inp * P2; acc = rotl64(acc, 31); acc *= P1; return acc;
}
static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = xxh_round(0, val); acc ^= val; acc = acc * P1 + P4; return acc;
}

uint64_t glaze_xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    const uint8_t* limit = end - 32;
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    do {
      v1 = xxh_round(v1, read64(p)); p += 8;
      v2 = xxh_round(v2, read64(p)); p += 8;
      v3 = xxh_round(v3, read64(p)); p += 8;
      v4 = xxh_round(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1); h = merge_round(h, v2);
    h = merge_round(h, v3); h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) { h ^= xxh_round(0, read64(p)); h = rotl64(h, 27) * P1 + P4; p += 8; }
  if (p + 4 <= end) { h ^= (uint64_t)read32(p) * P1; h = rotl64(h, 23) * P2 + P3; p += 4; }
  while (p < end) { h ^= (*p) * P5; h = rotl64(h, 11) * P1; p++; }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder with threaded (skip-link) output layout.
//
// Input : triangle vertices (N,3,3) float32 (world space).
// Output: depth-first node arrays. Internal node's "hit" successor is node+1
//         implicitly; "miss" successor is skip[i]. Leaves reference a
//         contiguous range of the reordered triangle index array.
// ---------------------------------------------------------------------------

struct BuildPrim { float bmin[3], bmax[3], centroid[3]; uint32_t index; };

struct BuildNode {
  float bmin[3], bmax[3];
  int32_t left = -1, right = -1;  // child node ids, -1 for leaf
  uint32_t first = 0, count = 0;  // triangle range for leaves
};

static const int NUM_BINS = 16;

static void grow(float* bmin, float* bmax, const float* pmin, const float* pmax) {
  for (int k = 0; k < 3; k++) {
    if (pmin[k] < bmin[k]) bmin[k] = pmin[k];
    if (pmax[k] > bmax[k]) bmax[k] = pmax[k];
  }
}

static float half_area(const float* bmin, const float* bmax) {
  float dx = bmax[0] - bmin[0], dy = bmax[1] - bmin[1], dz = bmax[2] - bmin[2];
  if (dx < 0 || dy < 0 || dz < 0) return 0.0f;
  return dx * dy + dy * dz + dz * dx;
}

static void build_recursive(std::vector<BuildPrim>& prims, uint32_t begin, uint32_t end,
                            std::vector<BuildNode>& nodes, int node_id, uint32_t leaf_size) {
  BuildNode& node = nodes[node_id];
  node.bmin[0] = node.bmin[1] = node.bmin[2] = 1e30f;
  node.bmax[0] = node.bmax[1] = node.bmax[2] = -1e30f;
  float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
  for (uint32_t i = begin; i < end; i++) {
    grow(node.bmin, node.bmax, prims[i].bmin, prims[i].bmax);
    grow(cmin, cmax, prims[i].centroid, prims[i].centroid);
  }
  uint32_t count = end - begin;
  if (count <= leaf_size) { node.first = begin; node.count = count; return; }

  // binned SAH over the centroid extent's longest axes; pick the best split
  int best_axis = -1, best_bin = -1;
  float best_cost = 1e30f;
  float parent_area = half_area(node.bmin, node.bmax);
  for (int axis = 0; axis < 3; axis++) {
    float extent = cmax[axis] - cmin[axis];
    if (extent <= 0.0f) continue;
    float scale = NUM_BINS / extent;
    float bin_min[NUM_BINS][3], bin_max[NUM_BINS][3];
    uint32_t bin_count[NUM_BINS];
    for (int b = 0; b < NUM_BINS; b++) {
      bin_count[b] = 0;
      for (int k = 0; k < 3; k++) { bin_min[b][k] = 1e30f; bin_max[b][k] = -1e30f; }
    }
    for (uint32_t i = begin; i < end; i++) {
      int b = (int)((prims[i].centroid[axis] - cmin[axis]) * scale);
      if (b >= NUM_BINS) b = NUM_BINS - 1;
      if (b < 0) b = 0;
      bin_count[b]++;
      grow(bin_min[b], bin_max[b], prims[i].bmin, prims[i].bmax);
    }
    // sweep
    float lmin[3] = {1e30f, 1e30f, 1e30f}, lmax[3] = {-1e30f, -1e30f, -1e30f};
    float left_area[NUM_BINS];
    uint32_t left_cnt[NUM_BINS];
    uint32_t acc = 0;
    for (int b = 0; b < NUM_BINS - 1; b++) {
      acc += bin_count[b];
      grow(lmin, lmax, bin_min[b], bin_max[b]);
      left_cnt[b] = acc;
      left_area[b] = (acc > 0) ? half_area(lmin, lmax) : 0.0f;
    }
    float rmin[3] = {1e30f, 1e30f, 1e30f}, rmax[3] = {-1e30f, -1e30f, -1e30f};
    uint32_t racc = 0;
    for (int b = NUM_BINS - 1; b >= 1; b--) {
      racc += bin_count[b];
      grow(rmin, rmax, bin_min[b], bin_max[b]);
      uint32_t lc = left_cnt[b - 1];
      uint32_t rc = racc;
      if (lc == 0 || rc == 0) continue;
      float cost = left_area[b - 1] * lc + half_area(rmin, rmax) * rc;
      if (cost < best_cost) { best_cost = cost; best_axis = axis; best_bin = b - 1; }
    }
  }

  uint32_t mid;
  if (best_axis < 0 || best_cost >= parent_area * count) {
    // SAH says don't split (or degenerate): median split on longest axis
    int axis = 0;
    float ext[3] = {cmax[0] - cmin[0], cmax[1] - cmin[1], cmax[2] - cmin[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;
    mid = begin + count / 2;
    // identical centroids (ext == 0): split by index so leaves never
    // exceed leaf_size (an oversized leaf overflows the 3-bit count
    // field and misaligns every later padded leaf range)
    if (ext[axis] > 0.0f)
      std::nth_element(prims.begin() + begin, prims.begin() + mid, prims.begin() + end,
                       [axis](const BuildPrim& a, const BuildPrim& b) {
                         return a.centroid[axis] < b.centroid[axis];
                       });
  } else {
    float extent = cmax[best_axis] - cmin[best_axis];
    float scale = NUM_BINS / extent;
    float cmin_axis = cmin[best_axis];
    int axis = best_axis, split_bin = best_bin;
    auto it = std::partition(prims.begin() + begin, prims.begin() + end,
                             [=](const BuildPrim& p) {
                               int b = (int)((p.centroid[axis] - cmin_axis) * scale);
                               if (b >= NUM_BINS) b = NUM_BINS - 1;
                               if (b < 0) b = 0;
                               return b <= split_bin;
                             });
    mid = (uint32_t)(it - prims.begin());
    if (mid == begin || mid == end) mid = begin + count / 2;  // safety
  }

  int left_id = (int)nodes.size();
  nodes.emplace_back();
  nodes.emplace_back();
  nodes[node_id].left = left_id;
  nodes[node_id].right = left_id + 1;
  build_recursive(prims, begin, mid, nodes, left_id, leaf_size);
  build_recursive(prims, mid, end, nodes, left_id + 1, leaf_size);
}

// Flatten to DFS order with skip links.
struct FlatOut {
  std::vector<float> bmin, bmax;       // (M,3)
  std::vector<int32_t> first, count, skip;
};

static void flatten2(const std::vector<BuildNode>& nodes, int id, int32_t skip_id,
                     FlatOut& out, const std::vector<int>& sizes) {
  const BuildNode& n = nodes[id];
  int32_t my_id = (int32_t)(out.skip.size());
  for (int k = 0; k < 3; k++) { out.bmin.push_back(n.bmin[k]); out.bmax.push_back(n.bmax[k]); }
  out.skip.push_back(skip_id);
  if (n.left < 0) {
    out.first.push_back((int32_t)n.first);
    out.count.push_back((int32_t)n.count);
  } else {
    out.first.push_back(-1);
    out.count.push_back(0);
    int32_t right_slot = my_id + 1 + sizes[n.left];
    flatten2(nodes, n.left, right_slot, out, sizes);
    flatten2(nodes, n.right, skip_id, out, sizes);
  }
}

struct BvhHandle {
  FlatOut flat;
  std::vector<uint32_t> tri_order;
  int32_t node_count = 0;
};

// Builds the BVH. Returns an opaque handle; query with glaze_bvh_* functions.
void* glaze_bvh_build(const float* tri_verts, uint64_t n_tris, uint32_t leaf_size) {
  auto* h = new BvhHandle();
  if (n_tris == 0) return h;
  std::vector<BuildPrim> prims(n_tris);
  for (uint64_t i = 0; i < n_tris; i++) {
    const float* v = tri_verts + i * 9;
    BuildPrim& p = prims[i];
    for (int k = 0; k < 3; k++) {
      float a = v[k], b = v[3 + k], c = v[6 + k];
      p.bmin[k] = std::min(a, std::min(b, c));
      p.bmax[k] = std::max(a, std::max(b, c));
      p.centroid[k] = (p.bmin[k] + p.bmax[k]) * 0.5f;
    }
    p.index = (uint32_t)i;
  }
  std::vector<BuildNode> nodes;
  nodes.reserve(2 * n_tris);
  nodes.emplace_back();
  build_recursive(prims, 0, (uint32_t)n_tris, nodes, 0, leaf_size);

  std::vector<int> sizes(nodes.size());
  // compute subtree sizes iteratively (post-order)
  {
    std::vector<int> stack = {0};
    std::vector<int> post;
    post.reserve(nodes.size());
    while (!stack.empty()) {
      int id = stack.back(); stack.pop_back();
      post.push_back(id);
      if (nodes[id].left >= 0) { stack.push_back(nodes[id].left); stack.push_back(nodes[id].right); }
    }
    for (auto it = post.rbegin(); it != post.rend(); ++it) {
      int id = *it;
      if (nodes[id].left < 0) sizes[id] = 1;
      else sizes[id] = 1 + sizes[nodes[id].left] + sizes[nodes[id].right];
    }
  }
  h->flat.bmin.reserve(nodes.size() * 3);
  flatten2(nodes, 0, -1, h->flat, sizes);
  h->node_count = (int32_t)h->flat.skip.size();
  h->tri_order.resize(n_tris);
  for (uint64_t i = 0; i < n_tris; i++) h->tri_order[i] = prims[i].index;
  return h;
}

int32_t glaze_bvh_node_count(void* handle) { return ((BvhHandle*)handle)->node_count; }

void glaze_bvh_export(void* handle, float* bmin, float* bmax, int32_t* first,
                      int32_t* count, int32_t* skip, uint32_t* tri_order) {
  auto* h = (BvhHandle*)handle;
  size_t m = h->node_count;
  memcpy(bmin, h->flat.bmin.data(), m * 3 * sizeof(float));
  memcpy(bmax, h->flat.bmax.data(), m * 3 * sizeof(float));
  memcpy(first, h->flat.first.data(), m * sizeof(int32_t));
  memcpy(count, h->flat.count.data(), m * sizeof(int32_t));
  memcpy(skip, h->flat.skip.data(), m * sizeof(int32_t));
  memcpy(tri_order, h->tri_order.data(), h->tri_order.size() * sizeof(uint32_t));
}

void glaze_bvh_free(void* handle) { delete (BvhHandle*)handle; }

// ---------------------------------------------------------------------------
// Octant-ordered flat layouts.
//
// Re-emits the SAME tree in 8 depth-first orders, one per ray-direction
// octant, with children ordered near-first along that direction (box
// centroid dot octant sign vector). Skip-link traversal then visits front-
// to-back, so closest-hit t pruning fires early without a stack. Leaves
// are padded to exactly `leaf_size` triangles at aligned offsets so the
// traversal kernel loads one packed row per leaf; padding slots are
// 0xFFFFFFFF in tri_order (callers emit degenerate triangles for them).
// ---------------------------------------------------------------------------

struct Oct8Handle {
  // per octant: (M,3) bmin/bmax, (M,) first/count/skip
  std::vector<float> bmin, bmax;       // 8*M*3
  std::vector<int32_t> first, count, skip;  // 8*M
  std::vector<uint32_t> tri_order;     // padded to n_leaves*leaf_size
  int32_t node_count = 0;
  uint64_t padded_tris = 0;
};

// Build the 8-octant layouts from an existing BVH handle.
void* glaze_bvh_octants(void* handle, uint32_t leaf_size) {
  auto* src = (BvhHandle*)handle;
  auto* out = new Oct8Handle();
  int32_t m = src->node_count;
  out->node_count = m;
  if (m == 0) return out;
  const auto& f = src->flat;

  // reconstruct children: internal node i has left = i+1, right = skip[i+1]
  // (left child's skip link always points at its right sibling)
  // assign padded leaf ranges in DFS order of the ORIGINAL layout
  std::vector<int32_t> new_first(m, -1);
  uint64_t pos = 0;
  for (int32_t i = 0; i < m; i++) {
    if (f.first[i] >= 0) {
      new_first[i] = (int32_t)pos;
      // count can never exceed leaf_size (builder invariant); clamp anyway
      // so a violation cannot misalign leaves or overflow the export buffer
      int32_t cnt = f.count[i] > (int32_t)leaf_size ? (int32_t)leaf_size : f.count[i];
      for (int32_t k = 0; k < cnt; k++)
        out->tri_order.push_back(src->tri_order[f.first[i] + k]);
      for (int32_t k = cnt; k < (int32_t)leaf_size; k++)
        out->tri_order.push_back(0xFFFFFFFFu);
      pos += leaf_size;
    }
  }
  out->padded_tris = pos;

  out->bmin.resize((size_t)8 * m * 3);
  out->bmax.resize((size_t)8 * m * 3);
  out->first.resize((size_t)8 * m);
  out->count.resize((size_t)8 * m);
  out->skip.resize((size_t)8 * m);

  std::vector<int32_t> order(m);   // DFS emit order per octant
  std::vector<int32_t> subtree(m); // subtree sizes (same for all octants)
  // subtree sizes via reverse pass over original DFS order
  for (int32_t i = m - 1; i >= 0; i--) {
    if (f.first[i] >= 0) subtree[i] = 1;
    else {
      int32_t left = i + 1;
      int32_t right = f.skip[left];
      subtree[i] = 1 + subtree[left] + subtree[right];
    }
  }

  for (int oct = 0; oct < 8; oct++) {
    float dx = (oct & 1) ? 1.f : -1.f;
    float dy = (oct & 2) ? 1.f : -1.f;
    float dz = (oct & 4) ? 1.f : -1.f;
    float* ob_min = out->bmin.data() + (size_t)oct * m * 3;
    float* ob_max = out->bmax.data() + (size_t)oct * m * 3;
    int32_t* o_first = out->first.data() + (size_t)oct * m;
    int32_t* o_count = out->count.data() + (size_t)oct * m;
    int32_t* o_skip = out->skip.data() + (size_t)oct * m;
    // iterative DFS emitting (node, skip_slot) pairs
    struct Item { int32_t node; int32_t skip_slot; };
    std::vector<Item> stack;
    stack.push_back({0, m});
    int32_t slot = 0;
    while (!stack.empty()) {
      Item it = stack.back(); stack.pop_back();
      int32_t i = it.node;
      int32_t my = slot++;
      for (int k = 0; k < 3; k++) {
        ob_min[(size_t)my * 3 + k] = f.bmin[(size_t)i * 3 + k];
        ob_max[(size_t)my * 3 + k] = f.bmax[(size_t)i * 3 + k];
      }
      o_skip[my] = it.skip_slot;
      if (f.first[i] >= 0) {
        o_first[my] = new_first[i];
        o_count[my] = f.count[i] > (int32_t)leaf_size ? (int32_t)leaf_size
                                                      : f.count[i];
      } else {
        o_first[my] = -1;
        o_count[my] = 0;
        int32_t left = i + 1;
        int32_t right = f.skip[left];
        // near child first: smaller centroid projection along (dx,dy,dz)
        auto proj = [&](int32_t n) {
          float cx = 0.5f * (f.bmin[(size_t)n * 3] + f.bmax[(size_t)n * 3]);
          float cy = 0.5f * (f.bmin[(size_t)n * 3 + 1] + f.bmax[(size_t)n * 3 + 1]);
          float cz = 0.5f * (f.bmin[(size_t)n * 3 + 2] + f.bmax[(size_t)n * 3 + 2]);
          return cx * dx + cy * dy + cz * dz;
        };
        int32_t near_c = left, far_c = right;
        if (proj(right) < proj(left)) { near_c = right; far_c = left; }
        // DFS: near child at my+1 (skip -> far child's slot), far child
        // after near's subtree (skip -> our skip)
        int32_t far_slot = my + 1 + subtree[near_c];
        stack.push_back({far_c, it.skip_slot});
        stack.push_back({near_c, far_slot});
      }
    }
  }
  return out;
}

int32_t glaze_oct8_node_count(void* h) { return ((Oct8Handle*)h)->node_count; }
uint64_t glaze_oct8_padded_tris(void* h) { return ((Oct8Handle*)h)->padded_tris; }

void glaze_oct8_export(void* h, float* bmin, float* bmax, int32_t* first,
                       int32_t* count, int32_t* skip, uint32_t* tri_order) {
  auto* o = (Oct8Handle*)h;
  size_t m = o->node_count;
  memcpy(bmin, o->bmin.data(), 8 * m * 3 * sizeof(float));
  memcpy(bmax, o->bmax.data(), 8 * m * 3 * sizeof(float));
  memcpy(first, o->first.data(), 8 * m * sizeof(int32_t));
  memcpy(count, o->count.data(), 8 * m * sizeof(int32_t));
  memcpy(skip, o->skip.data(), 8 * m * sizeof(int32_t));
  memcpy(tri_order, o->tri_order.data(), o->tri_order.size() * sizeof(uint32_t));
}

void glaze_oct8_free(void* h) { delete (Oct8Handle*)h; }

// ---------------------------------------------------------------------------
// Walker/Vose alias tables for O(1) discrete sampling (replaces the GPU
// binary-search CDF inversion of the sky importance tables).
// Builds tables for `rows` independent distributions of `n` entries each.
// prob[i] in [0,1]: accept entry i, else take alias[i].
// ---------------------------------------------------------------------------

void glaze_alias_build(const float* weights, uint64_t rows, uint64_t n,
                       float* prob, int32_t* alias) {
  std::vector<int32_t> small, large;
  std::vector<double> scaled(n);
  for (uint64_t r = 0; r < rows; r++) {
    const float* w = weights + r * n;
    float* p = prob + r * n;
    int32_t* a = alias + r * n;
    double total = 0.0;
    for (uint64_t i = 0; i < n; i++) total += (w[i] > 0 ? w[i] : 0.0);
    if (total <= 0.0) {
      for (uint64_t i = 0; i < n; i++) { p[i] = 1.0f; a[i] = (int32_t)i; }
      continue;
    }
    small.clear(); large.clear();
    for (uint64_t i = 0; i < n; i++) {
      scaled[i] = (w[i] > 0 ? w[i] : 0.0) * n / total;
      if (scaled[i] < 1.0) small.push_back((int32_t)i);
      else large.push_back((int32_t)i);
    }
    while (!small.empty() && !large.empty()) {
      int32_t s = small.back(); small.pop_back();
      int32_t l = large.back(); large.pop_back();
      p[s] = (float)scaled[s];
      a[s] = l;
      scaled[l] = (scaled[l] + scaled[s]) - 1.0;
      if (scaled[l] < 1.0) small.push_back(l);
      else large.push_back(l);
    }
    while (!large.empty()) { int32_t l = large.back(); large.pop_back(); p[l] = 1.0f; a[l] = l; }
    while (!small.empty()) { int32_t s = small.back(); small.pop_back(); p[s] = 1.0f; a[s] = s; }
  }
}

}  // extern "C"
