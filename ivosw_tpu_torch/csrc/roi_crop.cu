// ROI crop with given boxes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pallas (ivosw_tpu/kernels/roi_pallas.py:67;
// body _kernel :36), which AssessNet training reaches through roi_crop_best
// (:233) from assess_forward.
//
// What it computes: for every image b of a batch and its (y, x, h, w) box,
// first (ymin, ymax, xmin, xmax) = (y - h/2, y + h/2, x - w/2, x + w/2) in
// the float32 op order of ops/roi.py::yxhw_to_minmax, then the S x S
// align_corners bilinear crop of all C channels, zeros outside the image.
// Output row i samples at cy = ymin + (ymax - ymin) * (i / (S - 1)), column
// j at the same formula in x; each tap s weighs max(0, 1 - |c - s|). Input
// NHWC [B, H, W, C] f32, output NHWC [B, S, S, C] f32.
//
// Bound: memory bandwidth. At the training path's shape (B=32, 480x854,
// C=4, S=256, chip_smoke.py's boxes) the kernel must write
// 32*256^2*16 B = 33.6 MB and read the input pixels its taps touch, about
// 68 MB: 0.0304 ms at 3.35 TB/s. It does 4 taps x C channels of
// multiply-adds per output pixel, far below the card's rate.
//
// Device time per call at that shape, NVIDIA H100 80GB HBM3, 700.00 W, the
// earlier design and this one timed side by side in one run (PERF.md §6): 0.0725 ms
// before (the kernel 0.0688 ms, the rest the six torch launches that
// converted the boxes; 0.21 ms of wall time), 0.0477 ms after (0.050 ms of
// wall time), so 0.64 of the bound.
//
// Design:
//   - One launch per call: the kernel reads the [B, 4] yxhw boxes through
//     their strides and converts them itself. The file is built with
//     --fmad=false, so every coordinate rounds after each operation as the
//     reference's do.
//   - Whole pixels: at C=4 a tap is one 16-byte load of the NHWC pixel and
//     an output pixel one 16-byte store (the wrapper checks the images' base
//     is 16-byte aligned; the 16-byte pixel stride keeps every pixel so).
//     Other C run a scalar variant of the same kernel, chosen by C.
//   - Loads in flight: a block of 128 threads covers 128 output columns of
//     kRows output rows; each thread issues the 4 taps of all its kRows
//     pixels (16 loads of 16 bytes at C=4) through the read-only path before
//     the first multiply. Taps outside the image load a clamped in-image
//     pixel with weight 0, so no load waits behind a branch. A warp stores
//     32 neighbouring pixels, 512 contiguous bytes per row.
//   - Sums in f32, rows contracted first (Ry @ img, then @ Rx^T), as the
//     reference does. The TPU kernel's dense interpolation matrices (2*S*H*W
//     multiply-adds per channel, almost all on zeros) are not built: each of
//     their rows has at most two non-zero taps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // output rows per thread

// Taps of one output coordinate: the first source index and the weights of
// it and its successor, a weight set to 0 where its tap lies outside the
// image (the tap's index is then clamped into the image, so it can be
// loaded unconditionally and adds 0 * pixel = 0).
struct Taps {
  int idx[2];
  float w[2];
};

__device__ __forceinline__ Taps taps(float lo, float hi, int k, float denom, int n) {
  const float c = lo + (hi - lo) * ((float)k / denom);
  const float f = floorf(c);
  // coordinates far outside the image are pulled in to just outside it
  // before the int cast, where both taps are dropped anyway
  const int first = (int)fminf(fmaxf(f, -2.0f), (float)n + 1.0f);
  Taps t;
  const float w0 = fmaxf(0.0f, 1.0f - fabsf(c - f));
  const float w1 = fmaxf(0.0f, 1.0f - fabsf(c - (f + 1.0f)));
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int s = first + d;
    const bool inside = s >= 0 && s < n;
    t.idx[d] = min(max(s, 0), n - 1);
    t.w[d] = inside ? (d == 0 ? w0 : w1) : 0.0f;
  }
  return t;
}

struct Box {
  float ymin, ymax, xmin, xmax;
};

// (y, x, h, w) -> (ymin, ymax, xmin, xmax), ops/roi.py::yxhw_to_minmax
__device__ __forceinline__ Box load_box(const float* __restrict__ yxhw, int64_t stride) {
  const float y = __ldg(yxhw), x = __ldg(yxhw + stride);
  const float h = __ldg(yxhw + 2 * stride), w = __ldg(yxhw + 3 * stride);
  return {y - h / 2.0f, y + h / 2.0f, x - w / 2.0f, x + w / 2.0f};
}

__device__ __forceinline__ float4 axpy4(float a, const float4& x, const float4& y) {
  return make_float4(y.x + a * x.x, y.y + a * x.y, y.z + a * x.z, y.w + a * x.w);
}

// kPixel4: C == 4, whole-pixel 16-byte loads and stores; otherwise any C,
// one channel at a time.
template <bool kPixel4>
__global__ void __launch_bounds__(kThreads) roi_crop_kernel(
    const float* __restrict__ images, int H, int W, int C, int S,
    const float* __restrict__ yxhw, int64_t box_stride0, int64_t box_stride1,
    float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;  // output column
  const int i0 = blockIdx.y * kRows;                  // first output row
  const int b = blockIdx.z;                           // image
  if (j >= S) return;
  const Box box = load_box(yxhw + (int64_t)b * box_stride0, box_stride1);
  const float denom = (float)(S - 1);
  const Taps tx = taps(box.xmin, box.xmax, j, denom, W);
  Taps ty[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)  // rows past S repeat row S-1, not stored
    ty[r] = taps(box.ymin, box.ymax, min(i0 + r, S - 1), denom, H);
  const float* img = images + (int64_t)b * H * W * C;
  float* ocol = out + ((int64_t)b * S * S + j) * C;

  if constexpr (kPixel4) {
    const float4* px = reinterpret_cast<const float4*>(img);
    float4 v[kRows][2][2];  // [row][dy][dx]
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          v[r][dy][dx] = __ldg(px + (int64_t)ty[r].idx[dy] * W + tx.idx[dx]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= S) break;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        float4 col = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        col = axpy4(ty[r].w[0], v[r][0][dx], col);
        col = axpy4(ty[r].w[1], v[r][1][dx], col);
        acc = axpy4(tx.w[dx], col, acc);
      }
      *reinterpret_cast<float4*>(ocol + (int64_t)(i0 + r) * S * 4) = acc;
    }
  } else {
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= S) break;
      const float* row0 = img + (int64_t)ty[r].idx[0] * W * C;
      const float* row1 = img + (int64_t)ty[r].idx[1] * W * C;
      float* o = ocol + (int64_t)(i0 + r) * S * C;
      for (int ch = 0; ch < C; ++ch) {
        const float v00 = __ldg(row0 + tx.idx[0] * C + ch);
        const float v01 = __ldg(row0 + tx.idx[1] * C + ch);
        const float v10 = __ldg(row1 + tx.idx[0] * C + ch);
        const float v11 = __ldg(row1 + tx.idx[1] * C + ch);
        float col0 = 0.0f, col1 = 0.0f;
        col0 += ty[r].w[0] * v00;
        col0 += ty[r].w[1] * v10;
        col1 += ty[r].w[0] * v01;
        col1 += ty[r].w[1] * v11;
        float acc = 0.0f;
        acc += tx.w[0] * col0;
        acc += tx.w[1] * col1;
        o[ch] = acc;
      }
    }
  }
}

}  // namespace

// images [B, H, W, C] f32, yxhw boxes [B, 4] f32 with element strides
// (box_stride0, box_stride1), out [B, S, S, C] f32. pixel4 picks the C=4
// variant (the wrapper has checked that the images' base is 16-byte
// aligned); the scalar variant takes any C. Returns the launch's CUDA error.
extern "C" int ivosw_roi_crop(const void* images, int B, int H, int W, int C, int S,
                              int pixel4, const void* yxhw, long long box_stride0,
                              long long box_stride1, void* out, void* stream) {
  if (B == 0) return 0;
  if (pixel4 && C != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kThreads - 1) / kThreads, (S + kRows - 1) / kRows, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* img = static_cast<const float*>(images);
  const float* boxes = static_cast<const float*>(yxhw);
  float* o = static_cast<float*>(out);
  if (pixel4)
    roi_crop_kernel<true><<<grid, kThreads, 0, st>>>(img, H, W, C, S, boxes, box_stride0,
                                                     box_stride1, o);
  else
    roi_crop_kernel<false><<<grid, kThreads, 0, st>>>(img, H, W, C, S, boxes, box_stride0,
                                                      box_stride1, o);
  return (int)cudaGetLastError();
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
