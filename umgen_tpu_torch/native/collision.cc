// BEV box collision kernels — native C++ core.
//
// The reference JIT-compiles these with numba on host
// (ref:plugin/misc/misc.py:181-311).  The in-graph decode path uses the
// vectorized jnp implementation (umgen_tpu/ops/collision.py); this C++
// extension serves the HOST-side metrics path (BoxOverlap collision-rate
// over whole decoded scenes, ref:misc.py:561-736) where numba's role was
// to make the O(N^2 * 16 edge tests) loop fast without vector hardware.
//
// Exposed via a plain C ABI and loaded with ctypes (no pybind11 needed).
//
// Geometry: proper segment crossing (strict orientation tests) OR strict
// containment of clockwise rectangles — identical semantics to
// ops/collision.py::pairwise_collision (see tests/test_native_collision.py
// which cross-checks all three implementations).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Pt { float x, y; };

inline double orient(const Pt& a, const Pt& b, const Pt& c) {
  // > 0 if c is strictly left of ab.  Double precision so that exactly
  // coincident float32 inputs give an exact 0 (identical boxes must not
  // self-collide under the strict semantics).
  const double ax = a.x, ay = a.y, bx = b.x, by = b.y, cx = c.x, cy = c.y;
  return (cy - ay) * (bx - ax) - (by - ay) * (cx - ax);
}

inline bool segments_cross(const Pt& A, const Pt& B, const Pt& C,
                           const Pt& D) {
  const bool acd = orient(A, D, C) > 0.0;
  const bool bcd = orient(B, D, C) > 0.0;
  const bool abc = orient(A, B, C) > 0.0;
  const bool abd = orient(A, B, D) > 0.0;
  return acd != bcd && abc != abd;
}

// all pts of `q` strictly inside clockwise rectangle `r`
inline bool contains(const Pt r[4], const Pt q[4]) {
  for (int k = 0; k < 4; ++k) {
    const double vx = -(double(r[k].x) - double(r[(k + 1) & 3].x));
    const double vy = -(double(r[k].y) - double(r[(k + 1) & 3].y));
    for (int l = 0; l < 4; ++l) {
      const double cross =
          vy * (double(r[k].x) - double(q[l].x)) -
          vx * (double(r[k].y) - double(q[l].y));
      if (cross >= 0.0) return false;
    }
  }
  return true;
}

inline bool collide(const Pt a[4], const Pt b[4]) {
  // cheap AABB reject first (the reference's "standup" test,
  // ref:misc.py:226-235)
  float ax0 = a[0].x, ax1 = a[0].x, ay0 = a[0].y, ay1 = a[0].y;
  float bx0 = b[0].x, bx1 = b[0].x, by0 = b[0].y, by1 = b[0].y;
  for (int i = 1; i < 4; ++i) {
    ax0 = std::fmin(ax0, a[i].x); ax1 = std::fmax(ax1, a[i].x);
    ay0 = std::fmin(ay0, a[i].y); ay1 = std::fmax(ay1, a[i].y);
    bx0 = std::fmin(bx0, b[i].x); bx1 = std::fmax(bx1, b[i].x);
    by0 = std::fmin(by0, b[i].y); by1 = std::fmax(by1, b[i].y);
  }
  if (std::fmin(ax1, bx1) - std::fmax(ax0, bx0) <= 0.f) return false;
  if (std::fmin(ay1, by1) - std::fmax(ay0, by0) <= 0.f) return false;

  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      if (segments_cross(a[i], a[(i + 1) & 3], b[j], b[(j + 1) & 3]))
        return true;
  return contains(a, b) || contains(b, a);
}

}  // namespace

extern "C" {

// boxes (n, 7): x y z l w h yaw → corners (n, 4, 2), clockwise-from-min
// (ref:misc.py:143-177)
void umgen_bev_corners(const float* boxes, int64_t n, float* corners) {
  static const float base[4][2] = {
      {-0.5f, -0.5f}, {-0.5f, 0.5f}, {0.5f, 0.5f}, {0.5f, -0.5f}};
  for (int64_t i = 0; i < n; ++i) {
    const float cx = boxes[i * 7 + 0], cy = boxes[i * 7 + 1];
    const float l = boxes[i * 7 + 3], w = boxes[i * 7 + 4];
    const float yaw = boxes[i * 7 + 6];
    const float c = std::cos(yaw), s = std::sin(yaw);
    for (int k = 0; k < 4; ++k) {
      const float ux = base[k][0] * l, uy = base[k][1] * w;
      // rotate with [[cos, sin], [-sin, cos]] applied as corners @ M
      corners[(i * 4 + k) * 2 + 0] = ux * c - uy * s + cx;
      corners[(i * 4 + k) * 2 + 1] = ux * s + uy * c + cy;
    }
  }
}

// corners_a (n, 4, 2) vs corners_b (m, 4, 2) → out (n, m) uint8
void umgen_box_collision(const float* corners_a, int64_t n,
                         const float* corners_b, int64_t m, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const Pt* a = reinterpret_cast<const Pt*>(corners_a + i * 8);
    for (int64_t j = 0; j < m; ++j) {
      const Pt* b = reinterpret_cast<const Pt*>(corners_b + j * 8);
      out[i * m + j] = collide(a, b) ? 1 : 0;
    }
  }
}

// full metric: boxes (n, 10) x y z l w h yaw vx vy vz → (n, n) uint8,
// diagonal forced 0 (self-collision excluded)
void umgen_collision_matrix(const float* boxes10, int64_t n, uint8_t* out) {
  if (n <= 0) return;
  float* corners = new float[n * 8];
  float* b7 = new float[n * 7];
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(b7 + i * 7, boxes10 + i * 10, 7 * sizeof(float));
  }
  umgen_bev_corners(b7, n, corners);
  umgen_box_collision(corners, n, corners, n, out);
  for (int64_t i = 0; i < n; ++i) out[i * n + i] = 0;
  delete[] corners;
  delete[] b7;
}

}  // extern "C"
