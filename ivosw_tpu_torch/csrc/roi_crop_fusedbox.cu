// Fused-box ROI crop for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pairs_pallas_fusedbox
// (ivosw_tpu/kernels/roi_pallas.py:461; body _pair_kernel_fusedbox :427 with
// _bbox_minmax_inkernel :362 and _mats_from_scalars :414).
//
// What it computes, for every (frame t, object o) pair of a clip:
//   1. the ROI box of prob[t, o] > 0.5: min/max row and column holding a
//      foreground pixel (an empty mask gives the whole image), a 128 px
//      minimum side with floor(res/2) added at each end, 1.5x context,
//      clamped to [-5, H+5] x [-5, W+5], recentred through (y, x, h, w);
//   2. the S x S align_corners bilinear crop of the frame's 3 channels and
//      the prob plane inside that box, zeros outside the image.
// Inputs: frames NHWC [T, H, W, 3] and prob planes [T, P, H, W], each f32 or
// bf16 (assess_net.bf16_inputs keeps both in bf16 on the card). Output NHWC
// [T*O, S, S, 4] (rgb + prob), bf16 or f32; boxes [T*O, 4] f32 as
// (ymin, ymax, xmin, xmax).
//
// Bound: memory bandwidth. The box needs every prob pixel: at T=64, O=3,
// 480x854 that is 315 MB of f32 (157 MB of bf16) read once, plus 101 MB of
// bf16 crops written, about 0.12 ms (0.08 ms) at 3.35 TB/s. The crop does 16 multiply-adds per
// output pixel (4 taps x 4 channels), about 0.8 GFLOP in all, far below the
// card's rate.
//
// Design: two launches from one call.
//   box_kernel: one block per pair reads its f32 prob plane once, row by
//     row (a warp per row, lanes on neighbouring columns), reduces the
//     foreground rows and columns to min/max indices, and one thread does
//     the box arithmetic in the same float32 op order as the reference.
//     The file is built with --fmad=false, so no multiply-add is contracted
//     and the boxes equal the reference bit for bit.
//   crop_kernel: one block per (output row, pair). Each row of the TPU
//     kernel's interpolation matrices Ry/Rx has at most two non-zero taps,
//     so each output pixel is a 4-tap gather: taps floor(c) and floor(c)+1
//     with weights max(0, 1 - |c - s|), taps outside the image dropped.
//     Frames and prob planes are read in their own layout and type (no
//     cast pass; a bf16 value widens to f32 exactly, so the > 0.5 test on a
//     bf16 plane is the reference's test on its f32 upcast), sums run in
//     f32 and round once on store. No dense interpolation
//     matrix product is done (the TPU form spends 2*S*H*W MACs per channel,
//     nearly all on zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBoxThreads = 512;
constexpr int kCropThreads = 128;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void expand_min_side(float& lo, float& hi, float min_side) {
  const float res = min_side - (hi - lo);
  const float half = floorf(res / 2.0f);
  if (res > 0.0f) {
    lo = lo - half;
    hi = hi + half;
  }
}

template <typename ProbT>
__global__ void __launch_bounds__(kBoxThreads) box_kernel(
    const ProbT* __restrict__ probs, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, float min_side, float grow,
    float* __restrict__ boxes) {
  const int pair = blockIdx.x;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const ProbT* plane =
      probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)H * W;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int ymin = INT_MAX, ymax = -1, xmin = INT_MAX, xmax = -1;
  for (int y = warp; y < H; y += nwarps) {
    const ProbT* row = plane + (int64_t)y * W;
    bool hit = false;
#pragma unroll 8
    for (int x = lane; x < W; x += 32) {
      if (ld(row + x) > 0.5f) {
        hit = true;
        xmin = min(xmin, x);
        xmax = max(xmax, x);
      }
    }
    // every lane of the warp walks the same rows, so the vote is uniform
    if (__any_sync(0xffffffffu, hit)) {
      ymin = min(ymin, y);
      ymax = max(ymax, y);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
    xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
  }
  __shared__ int red[4][kBoxThreads / 32];
  if (lane == 0) {
    red[0][warp] = ymin;
    red[1][warp] = ymax;
    red[2][warp] = xmin;
    red[3][warp] = xmax;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < nwarps; ++w) {
    ymin = min(ymin, red[0][w]);
    ymax = max(ymax, red[1][w]);
    xmin = min(xmin, red[2][w]);
    xmax = max(xmax, red[3][w]);
  }

  // box arithmetic: the op order of ops/roi.py::mask_to_yxhw followed by
  // yxhw_to_minmax, one float32 rounding per operation
  const bool any_fg = ymax >= 0;
  float y0 = any_fg ? (float)ymin : 0.0f;
  float y1 = any_fg ? (float)ymax : (float)H;
  float x0 = any_fg ? (float)xmin : 0.0f;
  float x1 = any_fg ? (float)xmax : (float)W;
  expand_min_side(y0, y1, min_side);
  expand_min_side(x0, x1, min_side);
  const float orig_h = y1 - y0 + 1.0f;
  const float orig_w = x1 - x0 + 1.0f;
  y0 = fmaxf(-5.0f, y0 - grow * orig_h);
  y1 = fminf((float)H + 5.0f, y1 + grow * orig_h);
  x0 = fmaxf(-5.0f, x0 - grow * orig_w);
  x1 = fminf((float)W + 5.0f, x1 + grow * orig_w);
  const float yc = (y1 + y0) / 2.0f;
  const float xc = (x1 + x0) / 2.0f;
  const float hh = y1 - y0 + 1.0f;
  const float ww = x1 - x0 + 1.0f;
  float* box = boxes + (int64_t)pair * 4;
  box[0] = yc - hh / 2.0f;
  box[1] = yc + hh / 2.0f;
  box[2] = xc - ww / 2.0f;
  box[3] = xc + ww / 2.0f;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <typename FrameT, typename ProbT, typename OutT>
__global__ void __launch_bounds__(kCropThreads) crop_kernel(
    const FrameT* __restrict__ frames, const ProbT* __restrict__ probs,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const float* __restrict__ boxes, OutT* __restrict__ out) {
  const int i = blockIdx.x;  // output row
  const int pair = blockIdx.y;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const float* box = boxes + (int64_t)pair * 4;
  const float ymin = box[0], ymax = box[1], xmin = box[2], xmax = box[3];
  const float denom = (float)(S - 1);

  // row taps: coordinate ymin + (ymax - ymin) * i/(S-1), as _interp_matrix
  const float cy = ymin + (ymax - ymin) * ((float)i / denom);
  const float fy = floorf(cy);
  const int ty = (int)fy;
  const float wy[2] = {fmaxf(0.0f, 1.0f - fabsf(cy - fy)),
                       fmaxf(0.0f, 1.0f - fabsf(cy - (fy + 1.0f)))};

  const FrameT* frame = frames + (int64_t)t * H * W * 3;
  const ProbT* plane =
      probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)H * W;
  OutT* orow = out + ((int64_t)pair * S + i) * S * 4;

  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const float cx = xmin + (xmax - xmin) * ((float)j / denom);
    const float fx = floorf(cx);
    const int tx = (int)fx;
    const float wx[2] = {fmaxf(0.0f, 1.0f - fabsf(cx - fx)),
                         fmaxf(0.0f, 1.0f - fabsf(cx - (fx + 1.0f)))};
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int x = tx + dx;
      if (x < 0 || x >= W) continue;
      // contract rows first (Ry @ img), then columns, as the reference
      float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = ty + dy;
        if (y < 0 || y >= H) continue;
        const int64_t pix = (int64_t)y * W + x;
        const FrameT* px = frame + pix * 3;
        col[0] += wy[dy] * ld(px);
        col[1] += wy[dy] * ld(px + 1);
        col[2] += wy[dy] * ld(px + 2);
        col[3] += wy[dy] * ld(plane + pix);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += wx[dx] * col[c];
    }
    store4(orow + (int64_t)j * 4, acc);
  }
}

template <typename FrameT, typename ProbT>
int launch(const void* frames, const void* probs, int T, int planes_per_frame,
           int obj_offset, int num_objects, int H, int W, int S, float min_side,
           float grow, float* boxes, void* out, int out_bf16, cudaStream_t st) {
  const int pairs = T * num_objects;
  const FrameT* f = static_cast<const FrameT*>(frames);
  const ProbT* p = static_cast<const ProbT*>(probs);
  box_kernel<ProbT><<<pairs, kBoxThreads, 0, st>>>(
      p, planes_per_frame, obj_offset, num_objects, H, W, min_side, grow, boxes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(S, pairs);
  if (out_bf16) {
    crop_kernel<FrameT, ProbT, __nv_bfloat16><<<grid, kCropThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<__nv_bfloat16*>(out));
  } else {
    crop_kernel<FrameT, ProbT, float><<<grid, kCropThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ivosw_roi_crop_pairs_fusedbox(
    const void* frames, const void* probs, int frames_bf16, int probs_bf16, int T,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    float min_side, float grow, void* boxes, void* out, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  float* b = static_cast<float*>(boxes);
  if (frames_bf16 && probs_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, min_side, grow, b, out, out_bf16, st);
  if (frames_bf16)
    return launch<__nv_bfloat16, float>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, min_side, grow, b, out, out_bf16, st);
  if (probs_bf16)
    return launch<float, __nv_bfloat16>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, min_side, grow, b, out, out_bf16, st);
  return launch<float, float>(frames, probs, T, planes_per_frame,
      obj_offset, num_objects, H, W, S, min_side, grow, b, out, out_bf16, st);
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
