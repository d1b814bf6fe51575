// rtk_oracle: clean-room CPU reference tracer with corrected-rtk semantics.
//
// Purpose (SURVEY.md §4): an independent third implementation — besides the
// JAX production path and the f64 Möller–Trumbore oracle — used for
// bit-comparison testing and CPU baseline numbers.  It implements the
// *intended* semantics of the reference (rtk.c) with its defects fixed
// (SURVEY.md §2.9): real any-hit, portable code, correct axis selection.
//
// Deliberately different structure from the reference: C++17, scalar math
// (no SIMD), a binned-SAH BVH2 with std::vector storage and an explicit
// stack traversal.  Matching behaviours (watertight shear-space test with
// f64 fallback, open t-window, strict nearest-hit compare, first-hit ties)
// are the *spec*, not the code.
//
// C ABI:
//   rtko_build(tris[n*9], n) -> handle
//   rtko_trace(handle, rays[n*8], n, mode, out_t[n], out_u, out_v, out_idx)
//   rtko_free(handle)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Vec3 {
  float x = 0, y = 0, z = 0;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis(const Vec3& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

struct Box {
  Vec3 lo{kInf, kInf, kInf};
  Vec3 hi{-kInf, -kInf, -kInf};
  void grow(const Vec3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
  void grow(const Box& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  Box box;
  int32_t left = -1;    // child node index; -1 => leaf
  int32_t right = -1;
  int32_t first = 0;    // leaf: first item in order[]
  int32_t count = 0;    // leaf: item count
};

struct Scene {
  std::vector<float> tris;     // n*9
  std::vector<int32_t> order;  // build item order
  std::vector<Node> nodes;
  int32_t root = 0;
};

struct BuildItem {
  Box box;
  Vec3 centroid;
  int32_t index;
};

constexpr int kLeafMax = 4;
static int g_leaf_max = kLeafMax;  // rtko_build2 override
constexpr int kBins = 16;

// Step-quantized SAH (rtko_build3): the traversal kernel tests leaves
// in fixed K-row tiles (trace/packed.py pads every leaf to leaf_size
// rows), so a visited leaf costs ceil(count/K) STEPS regardless of how
// full it is.  Weighting the greedy SAH by leaf steps instead of
// triangle count drives children toward full-K leaves: fewer leaves,
// fewer leaf pops, shallower trees.  0 = classic count-weighted cost.
static int g_step_quant = 0;
constexpr int kExactSweep = 256;  // full object sweep below this count

static inline float wq(int n) {
  return g_step_quant > 0
             ? (float)((n + g_step_quant - 1) / g_step_quant)
             : (float)n;
}

static int32_t build_node(Scene& s, std::vector<BuildItem>& items,
                          int32_t first, int32_t count, int depth) {
  Node node;
  Box cb;  // centroid bounds
  for (int32_t i = first; i < first + count; ++i) {
    node.box.grow(items[i].box);
    cb.grow(items[i].centroid);
  }
  const int32_t me = (int32_t)s.nodes.size();
  s.nodes.push_back(node);

  bool make_leaf = count <= g_leaf_max || depth >= 64;
  int32_t mid = first;
  if (!make_leaf && g_step_quant > 0 && count <= kExactSweep) {
    // Exact object-split sweep (all 3 axes, every split index) with
    // step-quantized weights: near the leaves the split INDEX is what
    // aligns children to full-K multiples, and bin boundaries are too
    // coarse to find it.
    float best = kInf;
    int best_ax = 0;
    int32_t best_i = count / 2;
    std::vector<float> rarea((size_t)count);
    for (int ax3 = 0; ax3 < 3; ++ax3) {
      std::sort(items.begin() + first, items.begin() + first + count,
                [ax3](const BuildItem& a, const BuildItem& b) {
                  return axis(a.centroid, ax3) < axis(b.centroid, ax3);
                });
      Box acc;
      for (int32_t i = count - 1; i >= 1; --i) {
        acc.grow(items[first + i].box);
        rarea[i] = acc.area();
      }
      acc = Box();
      for (int32_t i = 1; i < count; ++i) {
        acc.grow(items[first + i - 1].box);
        float c = acc.area() * wq(i) + rarea[i] * wq(count - i);
        if (c < best) { best = c; best_ax = ax3; best_i = i; }
      }
    }
    if (best_ax != 2) {  // items are left sorted on axis 2 from the loop
      std::sort(items.begin() + first, items.begin() + first + count,
                [best_ax](const BuildItem& a, const BuildItem& b) {
                  return axis(a.centroid, best_ax)
                         < axis(b.centroid, best_ax);
                });
    }
    mid = first + best_i;
    int32_t l = build_node(s, items, first, mid - first, depth + 1);
    int32_t r = build_node(s, items, mid, first + count - mid, depth + 1);
    s.nodes[me].left = l;
    s.nodes[me].right = r;
    return me;
  }
  if (!make_leaf) {
    // Binned SAH over the widest centroid axis.
    Vec3 ext{cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int ax = ext.x >= ext.y ? (ext.x >= ext.z ? 0 : 2)
                            : (ext.y >= ext.z ? 1 : 2);
    float lo = axis(cb.lo, ax), hi = axis(cb.hi, ax);
    if (hi - lo < 1e-12f) {
      mid = first + count / 2;  // degenerate: median split
      std::nth_element(items.begin() + first, items.begin() + mid,
                       items.begin() + first + count,
                       [ax](const BuildItem& a, const BuildItem& b) {
                         return axis(a.centroid, ax) < axis(b.centroid, ax);
                       });
    } else {
      Box bin_box[kBins];
      int bin_n[kBins] = {0};
      float scale = kBins / (hi - lo);
      auto bin_of = [&](const BuildItem& it) {
        int b = (int)((axis(it.centroid, ax) - lo) * scale);
        return std::min(b, kBins - 1);
      };
      for (int32_t i = first; i < first + count; ++i) {
        int b = bin_of(items[i]);
        bin_box[b].grow(items[i].box);
        bin_n[b]++;
      }
      float right_area[kBins] = {0};
      Box acc;
      int acc_n = 0;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_box[b]);
        acc_n += bin_n[b];
        right_area[b] = acc_n ? acc.area() * wq(acc_n) : 0.f;
      }
      float best = kInf;
      int best_bin = -1;
      acc = Box();
      acc_n = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        acc.grow(bin_box[b]);
        acc_n += bin_n[b];
        if (acc_n == 0 || acc_n == count) continue;
        float cost = acc.area() * wq(acc_n) + right_area[b + 1];
        if (cost < best) { best = cost; best_bin = b; }
      }
      float leaf_cost = node.box.area() * count;
      if (best_bin < 0 || (count <= g_leaf_max && best >= leaf_cost)) {
        mid = first + count / 2;
        std::nth_element(items.begin() + first, items.begin() + mid,
                         items.begin() + first + count,
                         [ax](const BuildItem& a, const BuildItem& b) {
                           return axis(a.centroid, ax) < axis(b.centroid, ax);
                         });
      } else {
        auto it = std::partition(
            items.begin() + first, items.begin() + first + count,
            [&](const BuildItem& x) { return bin_of(x) <= best_bin; });
        mid = (int32_t)(it - items.begin());
        if (mid == first || mid == first + count) mid = first + count / 2;
      }
    }
    int32_t l = build_node(s, items, first, mid - first, depth + 1);
    int32_t r = build_node(s, items, mid, first + count - mid, depth + 1);
    s.nodes[me].left = l;
    s.nodes[me].right = r;
  } else {
    s.nodes[me].first = first;
    s.nodes[me].count = count;
  }
  return me;
}

// Watertight shear-space triangle intersection, corrected-rtk semantics:
// edge functions in f32, exact-zero lanes redone in f64; all-same-sign
// accept (zero allowed); open t-window with strict compares.
struct Ray {
  Vec3 o, d;
  float mint, maxt;
  int kx, ky, kz;
  float sx, sy, sz;
};

static inline void ray_setup(Ray& r) {
  float ax = std::fabs(r.d.x), ay = std::fabs(r.d.y), az = std::fabs(r.d.z);
  float m = std::max(ax, std::max(ay, az));
  int kz = (ax == m) ? 0 : (ay == m ? 1 : 2);  // x, then y, then z priority
  r.kz = kz;
  r.kx = (kz + 1) % 3;
  r.ky = (kz + 2) % 3;
  float dz = axis(r.d, r.kz);
  r.sx = -axis(r.d, r.kx) / dz;
  r.sy = -axis(r.d, r.ky) / dz;
  r.sz = 1.0f / dz;
}

static inline bool tri_hit(const Ray& r, const float* v9, float cur_t,
                           float* t_out, float* u_out, float* v_out) {
  float X[3], Y[3], Z[3];
  for (int j = 0; j < 3; ++j) {
    Vec3 p{v9[3 * j] - r.o.x, v9[3 * j + 1] - r.o.y, v9[3 * j + 2] - r.o.z};
    float px = axis(p, r.kx), py = axis(p, r.ky), pz = axis(p, r.kz);
    X[j] = px + r.sx * pz;
    Y[j] = py + r.sy * pz;
    Z[j] = r.sz * pz;
  }
  float u = X[1] * Y[2] - Y[1] * X[2];
  float v = X[2] * Y[0] - Y[2] * X[0];
  float w = X[0] * Y[1] - Y[0] * X[1];
  if (u == 0.f || v == 0.f || w == 0.f) {
    u = (float)((double)X[1] * Y[2] - (double)Y[1] * X[2]);
    v = (float)((double)X[2] * Y[0] - (double)Y[2] * X[0]);
    w = (float)((double)X[0] * Y[1] - (double)Y[0] * X[1]);
  }
  float mn = std::min(u, std::min(v, w));
  float mx = std::max(u, std::max(v, w));
  if (mn < 0.f && mx > 0.f) return false;
  float det = u + v + w;
  float rcp = 1.0f / det;
  float t = (u * Z[0] + v * Z[1] + w * Z[2]) * rcp;
  if (!(t > r.mint && t < cur_t)) return false;
  *t_out = t;
  *u_out = u * rcp;
  *v_out = v * rcp;
  return true;
}

static inline bool box_hit(const Ray& r, const Box& b, float cur_t) {
  auto slab = [&](float lo, float hi, float o, float d, float& n, float& f) {
    float r0 = 1.0f / d;
    float t0 = (lo - o) * r0, t1 = (hi - o) * r0;
    if (t0 > t1) std::swap(t0, t1);
    // NaN (0*inf) behaves as "unconstrained", matching the reference's
    // NaN-dropping SSE max/min folds (rtk.c:458-465).
    if (t0 == t0) n = std::max(n, t0);
    if (t1 == t1) f = std::min(f, t1);
  };
  float n = r.mint, f = cur_t;
  slab(b.lo.x, b.hi.x, r.o.x, r.d.x, n, f);
  slab(b.lo.y, b.hi.y, r.o.y, r.d.y, n, f);
  slab(b.lo.z, b.hi.z, r.o.z, r.d.z, n, f);
  return n <= f;
}

}  // namespace

extern "C" {

void* rtko_build(const float* tris, int64_t n) {
  auto* s = new Scene();
  s->tris.assign(tris, tris + n * 9);
  std::vector<BuildItem> items((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    BuildItem& it = items[(size_t)i];
    it.index = (int32_t)i;
    for (int j = 0; j < 3; ++j) {
      Vec3 p{tris[i * 9 + 3 * j], tris[i * 9 + 3 * j + 1],
             tris[i * 9 + 3 * j + 2]};
      it.box.grow(p);
    }
    it.centroid = {(it.box.lo.x + it.box.hi.x) * 0.5f,
                   (it.box.lo.y + it.box.hi.y) * 0.5f,
                   (it.box.lo.z + it.box.hi.z) * 0.5f};
  }
  s->nodes.reserve((size_t)(2 * n));
  s->root = build_node(*s, items, 0, (int32_t)n, 0);
  s->order.resize((size_t)n);
  for (int64_t i = 0; i < n; ++i) s->order[(size_t)i] = items[(size_t)i].index;
  return s;
}

// mode: 0 = closest hit, 1 = any hit (first accepted).
void rtko_trace(const void* scene, const float* rays, int64_t n, int mode,
                float* out_t, float* out_u, float* out_v, int32_t* out_idx) {
  const Scene& s = *(const Scene*)scene;
  for (int64_t i = 0; i < n; ++i) {
    Ray r;
    r.o = {rays[i * 8 + 0], rays[i * 8 + 1], rays[i * 8 + 2]};
    r.d = {rays[i * 8 + 3], rays[i * 8 + 4], rays[i * 8 + 5]};
    r.mint = rays[i * 8 + 6];
    r.maxt = rays[i * 8 + 7];
    ray_setup(r);
    float best_t = r.maxt, best_u = 0, best_v = 0;
    int32_t best = -1;
    int32_t stack[128];
    int sp = 0;
    stack[sp++] = s.root;
    while (sp) {
      const Node& nd = s.nodes[(size_t)stack[--sp]];
      if (!box_hit(r, nd.box, best_t)) continue;
      if (nd.left < 0) {
        for (int32_t k = nd.first; k < nd.first + nd.count; ++k) {
          int32_t tri = s.order[(size_t)k];
          float t, u, v;
          if (tri_hit(r, &s.tris[(size_t)tri * 9], best_t, &t, &u, &v)) {
            best_t = t;
            best_u = u;
            best_v = v;
            best = tri;
            if (mode == 1) { sp = 0; break; }
          }
        }
      } else {
        if (sp + 2 <= 128) {
          stack[sp++] = nd.right;
          stack[sp++] = nd.left;
        }
      }
    }
    out_t[i] = best_t;
    out_u[i] = best_u;
    out_v[i] = best_v;
    out_idx[i] = best;
  }
}

void rtko_free(void* scene) { delete (Scene*)scene; }

// Tree export: lets the device packer run a host-SAH topology through the
// same traversal kernel (topology-quality experiments and the SAH build
// option).  Arrays sized rtko_node_count / n triangles.
int64_t rtko_node_count(const void* scene) {
  return (int64_t)((const Scene*)scene)->nodes.size();
}

void rtko_export(const void* scene, int32_t* left, int32_t* right,
                 int32_t* first, int32_t* count, float* box_lo,
                 float* box_hi, int32_t* order, int32_t* root) {
  const Scene& s = *(const Scene*)scene;
  for (size_t i = 0; i < s.nodes.size(); ++i) {
    const Node& nd = s.nodes[i];
    left[i] = nd.left;
    right[i] = nd.right;
    first[i] = nd.first;
    count[i] = nd.count;
    box_lo[i * 3 + 0] = nd.box.lo.x;
    box_lo[i * 3 + 1] = nd.box.lo.y;
    box_lo[i * 3 + 2] = nd.box.lo.z;
    box_hi[i * 3 + 0] = nd.box.hi.x;
    box_hi[i * 3 + 1] = nd.box.hi.y;
    box_hi[i * 3 + 2] = nd.box.hi.z;
  }
  for (size_t i = 0; i < s.order.size(); ++i) order[i] = s.order[i];
  *root = s.root;
}

// Build with an explicit leaf-size cap (rtko_build keeps the historical
// kLeafMax=4 behaviour).
void* rtko_build2(const float* tris, int64_t n, int leaf_max) {
  g_leaf_max = leaf_max < 1 ? 1 : leaf_max;
  void* s = rtko_build(tris, n);
  g_leaf_max = kLeafMax;
  return s;
}

// Step-quantized SAH build: greedy cost counts ceil(count/quant) leaf
// steps per side (the packet kernel's real unit — every leaf pop tests
// exactly leaf_size padded rows), with an exact aligned object-split
// sweep below kExactSweep items.  quant <= 0 behaves like rtko_build2.
void* rtko_build3(const float* tris, int64_t n, int leaf_max, int quant) {
  g_leaf_max = leaf_max < 1 ? 1 : leaf_max;
  g_step_quant = quant > 0 ? quant : 0;
  void* s = rtko_build(tris, n);
  g_leaf_max = kLeafMax;
  g_step_quant = 0;
  return s;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SSE BVH4 path (r5): the honest CPU baseline.  The reference's trace
// kernel is a 4-wide SSE BVH4 (rtk.c:181-539); the scalar BVH2 above
// under-states what a corrected build of it would score, so the "vs one
// CPU core" ratio quoted against it was inflated.  This is a clean-room
// 4-wide design in this file's own style: the BVH2 above collapsed two
// levels per node into SoA BVH4 rows, leaf triangles pre-transposed
// into padded 4-tri SoA chunks, SSE slab tests with near-to-far child
// ordering, and the same watertight shear semantics (f64 fallback on
// exact-zero lanes) as the scalar path — the *behaviour* matches the
// corrected reference; the code shares nothing with it.
// ---------------------------------------------------------------------------

#include <smmintrin.h>

namespace {

struct Node4 {
  // SoA child bounds: component-major, 4 lanes per component.
  alignas(16) float lox[4], hix[4], loy[4], hiy[4], loz[4], hiz[4];
  int32_t child[4];   // >= 0: Node4 index; -1: empty; <= -2: leaf id -c-2
};

struct Leaf4 {
  int32_t chunk_first;  // index into Scene4::chunks (each = 4 tris SoA)
  int32_t chunk_count;
};

struct Chunk4 {
  // 4 triangles, component-major: v[vertex][axis][lane].
  alignas(16) float v[3][3][4];
  int32_t idx[4];  // original triangle id, -1 = padding (NaN coords)
};

struct Scene4 {
  std::vector<Node4> nodes;
  std::vector<Leaf4> leaves;
  std::vector<Chunk4> chunks;
  std::vector<float> tris;  // n*9 (f64 fallback reads original coords)
};

// Pack a BVH2 leaf's triangles into padded 4-tri SoA chunks; returns the
// encoded leaf id.  (Shared by collapse4 and the degenerate root-leaf
// path in rtko_build4 — one copy so padding/transpose policy cannot
// diverge between them.)
static int32_t pack_leaf4(const Scene& s2, Scene4& s4, const Node& c) {
  int32_t lf = (int32_t)s4.leaves.size();
  int32_t c0 = (int32_t)s4.chunks.size();
  int32_t nch = (c.count + 3) / 4;
  for (int32_t g = 0; g < nch; ++g) {
    Chunk4 ch;
    for (int l = 0; l < 4; ++l) {
      int32_t k = c.first + g * 4 + l;
      if (k < c.first + c.count) {
        int32_t tri = s2.order[(size_t)k];
        ch.idx[l] = tri;
        for (int vtx = 0; vtx < 3; ++vtx)
          for (int ax = 0; ax < 3; ++ax)
            ch.v[vtx][ax][l] = s2.tris[(size_t)tri * 9 + vtx * 3 + ax];
      } else {
        ch.idx[l] = -1;
        for (int vtx = 0; vtx < 3; ++vtx)
          for (int ax = 0; ax < 3; ++ax)
            ch.v[vtx][ax][l] = std::numeric_limits<float>::quiet_NaN();
      }
    }
    s4.chunks.push_back(ch);
  }
  s4.leaves.push_back({c0, nch});
  return -lf - 2;
}

// Collapse the BVH2 into BVH4 by pulling grandchildren; BVH2 leaves met
// on the way become direct children.
static int32_t collapse4(const Scene& s2, Scene4& s4, int32_t n2) {
  const Node& nd = s2.nodes[(size_t)n2];
  int32_t slots[4];
  Box boxes[4];
  int cnt = 0;
  if (nd.left < 0) {
    // Root-is-leaf degenerate: single-slot node over one packed leaf.
    int32_t self = (int32_t)s4.nodes.size();
    s4.nodes.emplace_back();
    int32_t enc = pack_leaf4(s2, s4, nd);
    Node4& out = s4.nodes[(size_t)self];
    for (int i = 0; i < 4; ++i) {
      out.child[i] = -1;
      out.lox[i] = 1.f; out.hix[i] = -1.f;
      out.loy[i] = 1.f; out.hiy[i] = -1.f;
      out.loz[i] = 1.f; out.hiz[i] = -1.f;
    }
    out.child[0] = enc;
    out.lox[0] = nd.box.lo.x; out.hix[0] = nd.box.hi.x;
    out.loy[0] = nd.box.lo.y; out.hiy[0] = nd.box.hi.y;
    out.loz[0] = nd.box.lo.z; out.hiz[0] = nd.box.hi.z;
    return self;
  }
  int32_t two[2] = {nd.left, nd.right};
  for (int h = 0; h < 2; ++h) {
    const Node& c = s2.nodes[(size_t)two[h]];
    if (c.left < 0) {
      slots[cnt] = two[h];
      boxes[cnt++] = c.box;
    } else {
      slots[cnt] = c.left;
      boxes[cnt++] = s2.nodes[(size_t)c.left].box;
      slots[cnt] = c.right;
      boxes[cnt++] = s2.nodes[(size_t)c.right].box;
    }
  }
  int32_t self = (int32_t)s4.nodes.size();
  s4.nodes.emplace_back();
  for (int i = 0; i < 4; ++i) {
    Node4& out = s4.nodes[(size_t)self];
    if (i >= cnt) {
      out.child[i] = -1;  // empty slot: inverted bounds fail every slab
      out.lox[i] = 1.f; out.hix[i] = -1.f;
      out.loy[i] = 1.f; out.hiy[i] = -1.f;
      out.loz[i] = 1.f; out.hiz[i] = -1.f;
      continue;
    }
    out.lox[i] = boxes[i].lo.x; out.hix[i] = boxes[i].hi.x;
    out.loy[i] = boxes[i].lo.y; out.hiy[i] = boxes[i].hi.y;
    out.loz[i] = boxes[i].lo.z; out.hiz[i] = boxes[i].hi.z;
  }
  for (int i = 0; i < cnt; ++i) {
    const Node& c = s2.nodes[(size_t)slots[i]];
    int32_t enc;
    if (c.left < 0) {
      enc = pack_leaf4(s2, s4, c);
    } else {
      enc = collapse4(s2, s4, slots[i]);
    }
    s4.nodes[(size_t)self].child[i] = enc;
  }
  return self;
}

// 4-triangle watertight intersector: shear-space edge functions on all
// lanes at once; exact-zero edge lanes re-resolved through the scalar
// f64 path (identical semantics to tri_hit above).
static inline void leaf4_hit(const Ray& r, const Scene4& s4,
                             const Leaf4& lf, float& best_t, float& best_u,
                             float& best_v, int32_t& best, int mode) {
  const __m128 sx = _mm_set1_ps(r.sx);
  const __m128 sy = _mm_set1_ps(r.sy);
  const __m128 sz = _mm_set1_ps(r.sz);
  const float ox = axis(r.o, r.kx), oy = axis(r.o, r.ky),
              oz = axis(r.o, r.kz);
  for (int32_t g = 0; g < lf.chunk_count; ++g) {
    const Chunk4& ch = s4.chunks[(size_t)(lf.chunk_first + g)];
    __m128 X[3], Y[3], Z[3];
    for (int vtx = 0; vtx < 3; ++vtx) {
      __m128 px = _mm_sub_ps(_mm_load_ps(ch.v[vtx][r.kx]),
                             _mm_set1_ps(ox));
      __m128 py = _mm_sub_ps(_mm_load_ps(ch.v[vtx][r.ky]),
                             _mm_set1_ps(oy));
      __m128 pz = _mm_sub_ps(_mm_load_ps(ch.v[vtx][r.kz]),
                             _mm_set1_ps(oz));
      X[vtx] = _mm_add_ps(px, _mm_mul_ps(sx, pz));
      Y[vtx] = _mm_add_ps(py, _mm_mul_ps(sy, pz));
      Z[vtx] = _mm_mul_ps(sz, pz);
    }
    __m128 U = _mm_sub_ps(_mm_mul_ps(X[1], Y[2]), _mm_mul_ps(Y[1], X[2]));
    __m128 V = _mm_sub_ps(_mm_mul_ps(X[2], Y[0]), _mm_mul_ps(Y[2], X[0]));
    __m128 W = _mm_sub_ps(_mm_mul_ps(X[0], Y[1]), _mm_mul_ps(Y[0], X[1]));
    const __m128 zero = _mm_setzero_ps();
    int zmask = _mm_movemask_ps(_mm_or_ps(
        _mm_cmpeq_ps(U, zero),
        _mm_or_ps(_mm_cmpeq_ps(V, zero), _mm_cmpeq_ps(W, zero))));
    if (zmask) {
      // Exact-sign fallback lanes go through the scalar f64 path (skip
      // NaN padding: its compares are already false).
      for (int l = 0; l < 4; ++l) {
        if (!((zmask >> l) & 1) || ch.idx[l] < 0) continue;
        float t, u, v;
        if (tri_hit(r, &s4.tris[(size_t)ch.idx[l] * 9], best_t, &t, &u,
                    &v)) {
          best_t = t; best_u = u; best_v = v; best = ch.idx[l];
        }
      }
    }
    __m128 mn = _mm_min_ps(U, _mm_min_ps(V, W));
    __m128 mx = _mm_max_ps(U, _mm_max_ps(V, W));
    __m128 signs_ok = _mm_or_ps(_mm_cmpge_ps(mn, zero),
                                _mm_cmple_ps(mx, zero));
    __m128 det = _mm_add_ps(U, _mm_add_ps(V, W));
    __m128 rcp = _mm_div_ps(_mm_set1_ps(1.f), det);
    __m128 tnum = _mm_add_ps(
        _mm_mul_ps(U, Z[0]),
        _mm_add_ps(_mm_mul_ps(V, Z[1]), _mm_mul_ps(W, Z[2])));
    __m128 t = _mm_mul_ps(tnum, rcp);
    __m128 ok = _mm_and_ps(
        signs_ok,
        _mm_and_ps(_mm_cmpgt_ps(t, _mm_set1_ps(r.mint)),
                   _mm_cmplt_ps(t, _mm_set1_ps(best_t))));
    int m = _mm_movemask_ps(ok) & ~zmask;
    while (m) {
      int l = __builtin_ctz((unsigned)m);
      m &= m - 1;
      if (ch.idx[l] < 0) continue;
      alignas(16) float ts[4], us[4], vs[4], rs[4];
      _mm_store_ps(ts, t);
      _mm_store_ps(us, U);
      _mm_store_ps(vs, V);
      _mm_store_ps(rs, rcp);
      if (ts[l] < best_t) {
        best_t = ts[l];
        best_u = us[l] * rs[l];
        best_v = vs[l] * rs[l];
        best = ch.idx[l];
        // tighten the window for remaining lanes
        __m128 ok2 = _mm_and_ps(ok, _mm_cmplt_ps(t, _mm_set1_ps(best_t)));
        m &= _mm_movemask_ps(ok2);
      }
      if (mode == 1 && best >= 0) return;
    }
    if (mode == 1 && best >= 0) return;
  }
}

}  // namespace

extern "C" {

void* rtko_build4(const float* tris, int64_t n, int leaf_max) {
  g_leaf_max = leaf_max < 1 ? 1 : leaf_max;
  Scene* s2 = (Scene*)rtko_build(tris, n);
  g_leaf_max = kLeafMax;
  auto* s4 = new Scene4();
  s4->tris = s2->tris;
  collapse4(*s2, *s4, s2->root);
  delete s2;
  return s4;
}

void rtko_trace4(const void* scene, const float* rays, int64_t n, int mode,
                 float* out_t, float* out_u, float* out_v,
                 int32_t* out_idx) {
  const Scene4& s4 = *(const Scene4*)scene;
  for (int64_t i = 0; i < n; ++i) {
    Ray r;
    r.o = {rays[i * 8 + 0], rays[i * 8 + 1], rays[i * 8 + 2]};
    r.d = {rays[i * 8 + 3], rays[i * 8 + 4], rays[i * 8 + 5]};
    r.mint = rays[i * 8 + 6];
    r.maxt = rays[i * 8 + 7];
    ray_setup(r);
    float best_t = r.maxt, best_u = 0, best_v = 0;
    int32_t best = -1;
    // Precompute slab operands: per-axis sign-selected plane pick.
    const float dx = r.d.x, dy = r.d.y, dz = r.d.z;
    const __m128 rx = _mm_set1_ps(1.0f / dx);
    const __m128 ry = _mm_set1_ps(1.0f / dy);
    const __m128 rz = _mm_set1_ps(1.0f / dz);
    const __m128 px = _mm_set1_ps(r.o.x), py = _mm_set1_ps(r.o.y),
                 pz = _mm_set1_ps(r.o.z);
    struct Ent { int32_t node; float t; };
    // Bound: build_node caps BVH2 depth at 64, collapse4 never deepens,
    // and each visit pops 1 and pushes <= 4, so live entries <= 3*64+1.
    // 512 gives slack; the push guard below is then unreachable (a
    // silent drop here would corrupt the parity baseline).
    Ent stack[512];
    int sp = 0;
    stack[sp++] = {0, r.mint};
    while (sp) {
      Ent e = stack[--sp];
      if (e.t >= best_t) continue;  // stale-subtree pop cull
      if (e.node <= -2) {
        leaf4_hit(r, s4, s4.leaves[(size_t)(-e.node - 2)], best_t, best_u,
                  best_v, best, mode);
        if (mode == 1 && best >= 0) break;
        continue;
      }
      const Node4& nd = s4.nodes[(size_t)e.node];
      __m128 nlo_x = _mm_load_ps(dx >= 0 ? nd.lox : nd.hix);
      __m128 nhi_x = _mm_load_ps(dx >= 0 ? nd.hix : nd.lox);
      __m128 nlo_y = _mm_load_ps(dy >= 0 ? nd.loy : nd.hiy);
      __m128 nhi_y = _mm_load_ps(dy >= 0 ? nd.hiy : nd.loy);
      __m128 nlo_z = _mm_load_ps(dz >= 0 ? nd.loz : nd.hiz);
      __m128 nhi_z = _mm_load_ps(dz >= 0 ? nd.hiz : nd.loz);
      __m128 t0 = _mm_mul_ps(_mm_sub_ps(nlo_x, px), rx);
      __m128 t1 = _mm_mul_ps(_mm_sub_ps(nhi_x, px), rx);
      // NaN (0*inf) lanes must stay unconstrained: MINPS/MAXPS return
      // their SECOND operand when either input is NaN, so folding with
      // the accumulator second drops NaN plane distances.
      __m128 tn = _mm_set1_ps(r.mint);
      __m128 tf = _mm_set1_ps(best_t);
      tn = _mm_max_ps(t0, tn);
      tf = _mm_min_ps(t1, tf);
      __m128 t0y = _mm_mul_ps(_mm_sub_ps(nlo_y, py), ry);
      __m128 t1y = _mm_mul_ps(_mm_sub_ps(nhi_y, py), ry);
      tn = _mm_max_ps(t0y, tn);
      tf = _mm_min_ps(t1y, tf);
      __m128 t0z = _mm_mul_ps(_mm_sub_ps(nlo_z, pz), rz);
      __m128 t1z = _mm_mul_ps(_mm_sub_ps(nhi_z, pz), rz);
      tn = _mm_max_ps(t0z, tn);
      tf = _mm_min_ps(t1z, tf);
      int hitm = _mm_movemask_ps(_mm_cmple_ps(tn, tf));
      if (!hitm) continue;
      alignas(16) float tns[4];
      _mm_store_ps(tns, tn);
      // Collect hit children, insertion-sort far-to-near so the nearest
      // pops first.
      Ent add[4];
      int na = 0;
      for (int l = 0; l < 4; ++l) {
        if (!((hitm >> l) & 1)) continue;
        if (nd.child[l] == -1) continue;
        add[na++] = {nd.child[l], tns[l]};
      }
      for (int a = 1; a < na; ++a) {
        Ent key = add[a];
        int b = a - 1;
        while (b >= 0 && add[b].t < key.t) { add[b + 1] = add[b]; --b; }
        add[b + 1] = key;
      }
      for (int a = 0; a < na && sp < 512; ++a) stack[sp++] = add[a];
    }
    out_t[i] = best_t;
    out_u[i] = best_u;
    out_v[i] = best_v;
    out_idx[i] = best;
  }
}

void rtko_free4(void* scene) { delete (Scene4*)scene; }

}  // extern "C"
