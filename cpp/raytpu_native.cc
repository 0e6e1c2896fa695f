// Native runtime components for raytracer_tpu (C API, loaded via ctypes).
//
// The reference renderer is compiled Go throughout; this rebuild keeps the
// hot compute path in Pallas/XLA and implements the host-side runtime pieces
// natively here (SURVEY.md §2.3): the scene compiler (BVH build — the analog
// of NewBVH, /root/reference/internal/bvh.go:142-185) and image output
// (the PPM encoder, camera.go:183-191 + vec3.go:141-152).
//
// Array contracts mirror raytracer_tpu/geometry/bvh.py exactly (DFS-preorder
// nodes, skip links, leaf ranges over a primitive permutation); the Python
// and C++ builders are deterministic and byte-identical (tested in
// tests/test_native.py), so either can feed the device traversal.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BVH builder.
//
// Inputs: per-primitive AABBs (n x 3 each, row-major); invalid primitives are
// marked by bmin[i][0] == +inf. Outputs are preallocated by the caller:
//   box_min/box_max: (2n, 3) f32;  skip/leaf_start/leaf_count: (2n,) i32;
//   prim_order: (n,) i32.
// Returns the node count (<= 2n), or -1 on error.
// Algorithm: longest-centroid-extent axis, stable sort by centroid, median
// split, leaves of <= leaf_size — identical to the NumPy builder.
// ---------------------------------------------------------------------------

namespace {

struct BuildCtx {
  const float* bmin;
  const float* bmax;
  int leaf_size;
  std::vector<float> node_min, node_max;
  std::vector<int32_t> skip, leaf_start, leaf_count, order;
};

void emit(BuildCtx& ctx, std::vector<int32_t>& ids, size_t lo, size_t hi) {
  const size_t idx = ctx.skip.size();
  float mn[3] = {std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity()};
  float mx[3] = {-mn[0], -mn[1], -mn[2]};
  for (size_t k = lo; k < hi; ++k) {
    const int32_t p = ids[k];
    for (int a = 0; a < 3; ++a) {
      mn[a] = std::min(mn[a], ctx.bmin[3 * p + a]);
      mx[a] = std::max(mx[a], ctx.bmax[3 * p + a]);
    }
  }
  for (int a = 0; a < 3; ++a) {
    ctx.node_min.push_back(mn[a]);
    ctx.node_max.push_back(mx[a]);
  }
  ctx.skip.push_back(-1);  // patched below
  if (hi - lo <= static_cast<size_t>(ctx.leaf_size)) {
    ctx.leaf_start.push_back(static_cast<int32_t>(ctx.order.size()));
    ctx.leaf_count.push_back(static_cast<int32_t>(hi - lo));
    for (size_t k = lo; k < hi; ++k) ctx.order.push_back(ids[k]);
  } else {
    ctx.leaf_start.push_back(-1);
    ctx.leaf_count.push_back(0);
    // Longest axis of the centroid extent (first max wins, like np.argmax).
    float cmin[3], cmax[3];
    for (int a = 0; a < 3; ++a) {
      cmin[a] = std::numeric_limits<float>::infinity();
      cmax[a] = -cmin[a];
    }
    for (size_t k = lo; k < hi; ++k) {
      const int32_t p = ids[k];
      for (int a = 0; a < 3; ++a) {
        const float c = 0.5f * (ctx.bmin[3 * p + a] + ctx.bmax[3 * p + a]);
        cmin[a] = std::min(cmin[a], c);
        cmax[a] = std::max(cmax[a], c);
      }
    }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a) {
      const float e = cmax[a] - cmin[a];
      if (e > best) {
        best = e;
        axis = a;
      }
    }
    std::stable_sort(ids.begin() + lo, ids.begin() + hi,
                     [&](int32_t x, int32_t y) {
                       const float cx = ctx.bmin[3 * x + axis] + ctx.bmax[3 * x + axis];
                       const float cy = ctx.bmin[3 * y + axis] + ctx.bmax[3 * y + axis];
                       return cx < cy;
                     });
    const size_t mid = lo + (hi - lo) / 2;
    emit(ctx, ids, lo, mid);
    emit(ctx, ids, mid, hi);
  }
  ctx.skip[idx] = static_cast<int32_t>(ctx.skip.size());
}

}  // namespace

int32_t rt_build_bvh(const float* bmin, const float* bmax, int32_t n,
                     int32_t leaf_size, float* out_box_min, float* out_box_max,
                     int32_t* out_skip, int32_t* out_leaf_start,
                     int32_t* out_leaf_count, int32_t* out_prim_order,
                     int32_t* out_order_len) {
  if (n <= 0 || leaf_size <= 0) return -1;
  BuildCtx ctx{bmin, bmax, leaf_size, {}, {}, {}, {}, {}, {}};
  std::vector<int32_t> ids;
  ids.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    if (std::isfinite(bmin[3 * i])) ids.push_back(i);
  }
  if (ids.empty()) ids.push_back(0);
  emit(ctx, ids, 0, ids.size());
  const int32_t m = static_cast<int32_t>(ctx.skip.size());
  std::memcpy(out_box_min, ctx.node_min.data(), sizeof(float) * 3 * m);
  std::memcpy(out_box_max, ctx.node_max.data(), sizeof(float) * 3 * m);
  std::memcpy(out_skip, ctx.skip.data(), sizeof(int32_t) * m);
  std::memcpy(out_leaf_start, ctx.leaf_start.data(), sizeof(int32_t) * m);
  std::memcpy(out_leaf_count, ctx.leaf_count.data(), sizeof(int32_t) * m);
  std::memcpy(out_prim_order, ctx.order.data(),
              sizeof(int32_t) * ctx.order.size());
  *out_order_len = static_cast<int32_t>(ctx.order.size());
  return m;
}

// ---------------------------------------------------------------------------
// Tonemap: linear mean radiance -> 8-bit, reference pipeline
// (gamma-2 sqrt, clamp [0,1], *255.999, truncate; vec3.go:145-166).
// ---------------------------------------------------------------------------
void rt_tonemap(const float* rgb, int64_t count, uint8_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    float v = rgb[i];
    v = v > 0.0f ? std::sqrt(v) : 0.0f;
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    out[i] = static_cast<uint8_t>(v * 255.999f);
  }
}

// ---------------------------------------------------------------------------
// PPM writer: P3 header + one "r g b" triple per line (camera.go:183-191,
// vec3.go:141-143). Returns 0 on success.
// ---------------------------------------------------------------------------
int32_t rt_write_ppm(const uint8_t* img, int32_t w, int32_t h,
                     const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "P3\n%d %d\n255\n", w, h);
  std::vector<char> buf;
  buf.reserve(static_cast<size_t>(w) * h * 12 + 16);
  char tmp[16];
  for (int64_t i = 0; i < static_cast<int64_t>(w) * h; ++i) {
    const int len = std::snprintf(tmp, sizeof(tmp), "%d %d %d\n", img[3 * i],
                                  img[3 * i + 1], img[3 * i + 2]);
    buf.insert(buf.end(), tmp, tmp + len);
  }
  const size_t written = std::fwrite(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return written == buf.size() ? 0 : -2;
}

}  // extern "C"
