// Host J / boundary-F library of the PyTorch port (ivosw_tpu_torch), a copy
// of the JAX package's native/metrics.cpp whose (frame, object) loops run on
// std::threads instead of OpenMP: not every g++ install carries libgomp.
// OMP_NUM_THREADS still bounds the threads (default: the host's cores).
// Built at first use with g++ by ivosw_tpu_torch/kernels/_build.py::load_host
// and bound with ctypes by ivosw_tpu_torch/ops/metrics_native.py.
//
// The interactive session evaluates per-frame J / boundary-F against ground
// truth every round (host side, like the reference's davisinteractive
// metrics). The boundary F-measure dominates host time: per (frame, object)
// it needs a 1-px boundary map and a disk-tolerance dilation at 480p.
//
// This implementation replaces the disk dilation with an EXACT squared
// Euclidean distance transform (Felzenszwalb & Huttenlocher two-pass 1-D
// parabola method, O(HW)) thresholded at r^2 — identical semantics to
// dilating with the {x^2+y^2 <= r^2} structuring element — and parallelises
// over the (frame, object) batch.
//
// Exposed through a C interface for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// OMP_NUM_THREADS when set to a positive count, else the host's cores.
int thread_count() {
  const char* env = std::getenv("OMP_NUM_THREADS");
  const int requested = env ? std::atoi(env) : 0;
  if (requested > 0) return requested;
  const unsigned cores = std::thread::hardware_concurrency();
  return cores ? (int)cores : 1;
}

// fn(i) for i in [0, n), items handed out one at a time (dynamic schedule)
// to up to thread_count() threads, the calling thread among them.
template <class Fn>
void parallel_for(int n, Fn fn) {
  const int threads = std::min(n, thread_count());
  if (threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  for (int k = 1; k < threads; ++k) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
}

constexpr double kInf = std::numeric_limits<double>::infinity();
// large FINITE sentinel for "no seed pixel": keeps the parabola
// intersection arithmetic NaN-free on all-empty rows/columns
// (inf - inf would poison the transform); far above any real H^2+W^2.
constexpr double kFar = 1e15;

// 1-D squared distance transform (Felzenszwalb & Huttenlocher).
void dt1d(const double* f, double* d, int n, int* v, double* z) {
  int k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  for (int q = 1; q < n; ++q) {
    double s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
               (2.0 * q - 2.0 * v[k]);
    while (s <= z[k]) {
      --k;
      s = ((f[q] + q * (double)q) - (f[v[k]] + v[k] * (double)v[k])) /
          (2.0 * q - 2.0 * v[k]);
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    double dq = q - (double)v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

// 2-D squared EDT of a boolean mask (distance to nearest true pixel).
void edt2d(const uint8_t* mask, double* dist, int h, int w,
           std::vector<double>& buf_f, std::vector<double>& buf_d,
           std::vector<int>& buf_v, std::vector<double>& buf_z) {
  // columns
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y)
      buf_f[y] = mask[y * w + x] ? 0.0 : kFar;
    dt1d(buf_f.data(), buf_d.data(), h, buf_v.data(), buf_z.data());
    for (int y = 0; y < h; ++y) dist[y * w + x] = buf_d[y];
  }
  // rows
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) buf_f[x] = dist[y * w + x];
    dt1d(buf_f.data(), buf_d.data(), w, buf_v.data(), buf_z.data());
    for (int x = 0; x < w; ++x) dist[y * w + x] = buf_d[x];
  }
}

// DAVIS seg2bmap: transitions against east/south/south-east neighbours mark
// the lower-index pixel; the last row/col use east/south only; the corner is
// never boundary.
void seg2bmap(const uint8_t* seg, uint8_t* b, int h, int w) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t s = seg[y * w + x];
      const uint8_t e = (x + 1 < w) ? seg[y * w + x + 1] : s;
      const uint8_t so = (y + 1 < h) ? seg[(y + 1) * w + x] : s;
      const uint8_t se = (y + 1 < h && x + 1 < w) ? seg[(y + 1) * w + x + 1] : s;
      uint8_t val;
      if (y == h - 1 && x == w - 1) {
        val = 0;
      } else if (y == h - 1) {
        val = s ^ e;
      } else if (x == w - 1) {
        val = s ^ so;
      } else {
        val = (uint8_t)((s ^ e) | (s ^ so) | (s ^ se));
      }
      b[y * w + x] = val;
    }
  }
}

double f_measure_pair(const uint8_t* pred_b, const uint8_t* gt_b, int h,
                      int w, double r2) {
  std::vector<uint8_t> fg_bnd(h * w), gt_bnd(h * w);
  seg2bmap(pred_b, fg_bnd.data(), h, w);
  seg2bmap(gt_b, gt_bnd.data(), h, w);

  long n_fg = 0, n_gt = 0;
  for (int i = 0; i < h * w; ++i) {
    n_fg += fg_bnd[i];
    n_gt += gt_bnd[i];
  }
  if (n_fg == 0 && n_gt == 0) return 1.0;
  if (n_fg == 0 || n_gt == 0) return 0.0;

  const int m = std::max(h, w);
  std::vector<double> dist(h * w), bf(m), bd(m), bz(m + 1);
  std::vector<int> bv(m);

  // gt boundary pixels within r of a pred-boundary pixel (recall numerator)
  edt2d(fg_bnd.data(), dist.data(), h, w, bf, bd, bv, bz);
  long gt_match = 0;
  for (int i = 0; i < h * w; ++i)
    if (gt_bnd[i] && dist[i] <= r2) ++gt_match;

  edt2d(gt_bnd.data(), dist.data(), h, w, bf, bd, bv, bz);
  long fg_match = 0;
  for (int i = 0; i < h * w; ++i)
    if (fg_bnd[i] && dist[i] <= r2) ++fg_match;

  const double precision = (double)fg_match / (double)n_fg;
  const double recall = (double)gt_match / (double)n_gt;
  if (precision + recall == 0.0) return 0.0;
  return 2.0 * precision * recall / (precision + recall);
}

}  // namespace

extern "C" {

// gt/pred: [T, H, W] int32 label masks. out: [T, n_objects] doubles.
void boundary_f_measure_batch(const int32_t* gt, const int32_t* pred, int t,
                              int h, int w, int n_objects, double bound_th,
                              double* out) {
  const double bound_pix =
      bound_th >= 1.0 ? bound_th
                      : std::ceil(bound_th * std::sqrt((double)h * h +
                                                       (double)w * w));
  const double r2 = bound_pix * bound_pix;
  const long hw = (long)h * w;

  parallel_for(t * n_objects, [&](int item) {
    const int ti = item / n_objects, o = item % n_objects;
    const int obj = o + 1;
    std::vector<uint8_t> gt_b(hw), pr_b(hw);
    const int32_t* gt_f = gt + (long)ti * hw;
    const int32_t* pr_f = pred + (long)ti * hw;
    for (long i = 0; i < hw; ++i) {
      gt_b[i] = gt_f[i] == obj;
      pr_b[i] = pr_f[i] == obj;
    }
    out[(long)ti * n_objects + o] =
        f_measure_pair(pr_b.data(), gt_b.data(), h, w, r2);
  });
}

// gt/pred: [T, H, W] int32. out: [T, n_objects] doubles (IoU; empty∪empty=1)
void jaccard_batch(const int32_t* gt, const int32_t* pred, int t, int h,
                   int w, int n_objects, double* out) {
  const long hw = (long)h * w;
  parallel_for(t * n_objects, [&](int item) {
    const int ti = item / n_objects, o = item % n_objects;
    const int obj = o + 1;
    const int32_t* gt_f = gt + (long)ti * hw;
    const int32_t* pr_f = pred + (long)ti * hw;
    long inter = 0, uni = 0;
    for (long i = 0; i < hw; ++i) {
      const bool a = gt_f[i] == obj;
      const bool b = pr_f[i] == obj;
      inter += a && b;
      uni += a || b;
    }
    out[(long)ti * n_objects + o] =
        uni == 0 ? 1.0 : (double)inter / (double)uni;
  });
}

int native_num_threads() { return thread_count(); }

}  // extern "C"
