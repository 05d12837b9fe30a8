// Given-box T x O pair crop for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pairs_pallas
// (ivosw_tpu/kernels/roi_pallas.py:299; body _pair_kernel :267, matrices
// _interp_mats :252), which the two-stage scoring round reaches through
// roi_crop_pairs (:639): boxes from mask_to_yxhw first, then this crop.
//
// What it computes: pair i = t*O + o crops frame t's 3 channels and prob
// plane (t, obj_offset + o) inside box i (ymin, ymax, xmin, xmax) to S x S:
// output row r samples at cy = ymin + (ymax - ymin) * (r / (S - 1)), column
// j at the same formula in x, each tap s weighs max(0, 1 - |c - s|), zeros
// outside the image. Inputs: frames NHWC [T, H, W, 3] and planes
// [T, P, H, W], each f32 or bf16. Output NHWC [T*O, S, S, 4] (rgb + prob)
// in the working type (f32 or bf16).
//
// Rounding: in bf16 the TPU kernel rounds its inputs, both interpolation
// matrices and the row-contracted intermediate (Ry @ img) to bf16 and
// accumulates in f32 (:279-291). Here the same values are rounded at the
// same points: each input pixel and each tap weight to the working type,
// the row sum of one column to the working type before the column stage,
// the output on store. A bf16 x bf16 product is exact in f32 and each sum
// has two terms, so the kernel equals the plain einsum (rounded the same
// way) bit for bit in bf16. The file is built with --fmad=false, so the
// coordinates round after every operation in the JAX op order.
//
// Bound: memory bandwidth. At T=32, O=3, 480x854, S=256, bf16 it writes
// 32*3*256^2*4*2 B = 50 MB and reads the frame and plane pixels its taps
// touch (at most the 39 MB of bf16 frames and 79 MB of bf16 planes):
// 0.02-0.05 ms at 3.35 TB/s. It does 4 taps x 4 channels of multiply-adds
// per output pixel (0.2 GFLOP), far below the card's rate.
//
// Design: the TPU kernel spends two dense matrix products per channel
// (2*S*H*W MACs, nearly all on zeros). Each row of Ry/Rx has at most two
// non-zero taps, floor(c) and floor(c)+1, so an output pixel is a 2 x 2
// gather over its 4 channels. One block per (output row, pair); its threads
// walk the output columns. Frames and planes are read in place in their
// own type through obj_offset, so no strided copy of the object planes and
// no cast pass is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// a float32 value rounded to the working type and widened back
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// Taps of one output coordinate: the first source index and the weights of
// it and its successor, rounded to the working type. Coordinates far
// outside the image are pulled in to just outside it before the int cast,
// where both taps are dropped anyway.
struct Taps {
  int first;
  float w[2];
};

template <typename OutT>
__device__ __forceinline__ Taps taps(float lo, float hi, int k, float denom, int n) {
  const float c = lo + (hi - lo) * ((float)k / denom);
  const float f = floorf(c);
  Taps t;
  t.w[0] = rnd<OutT>(fmaxf(0.0f, 1.0f - fabsf(c - f)));
  t.w[1] = rnd<OutT>(fmaxf(0.0f, 1.0f - fabsf(c - (f + 1.0f))));
  t.first = (int)fminf(fmaxf(f, -2.0f), (float)n + 1.0f);
  return t;
}

template <typename FrameT, typename ProbT, typename OutT>
__global__ void __launch_bounds__(kThreads) pair_crop_kernel(
    const FrameT* __restrict__ frames, const ProbT* __restrict__ probs,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const float* __restrict__ boxes, OutT* __restrict__ out) {
  const int r = blockIdx.x;  // output row
  const int pair = blockIdx.y;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const float* box = boxes + (int64_t)pair * 4;
  const float denom = (float)(S - 1);
  const Taps ty = taps<OutT>(box[0], box[1], r, denom, H);
  const FrameT* frame = frames + (int64_t)t * H * W * 3;
  const ProbT* plane =
      probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)H * W;
  OutT* orow = out + ((int64_t)pair * S + r) * S * 4;

  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const Taps tx = taps<OutT>(box[2], box[3], j, denom, W);
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int x = tx.first + dx;
      if (x < 0 || x >= W) continue;
      // the row-contracted intermediate (Ry @ img)[r, x], then rounded
      float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = ty.first + dy;
        if (y < 0 || y >= H) continue;
        const int64_t pix = (int64_t)y * W + x;
        const FrameT* px = frame + pix * 3;
        col[0] += ty.w[dy] * rnd<OutT>(ld(px));
        col[1] += ty.w[dy] * rnd<OutT>(ld(px + 1));
        col[2] += ty.w[dy] * rnd<OutT>(ld(px + 2));
        col[3] += ty.w[dy] * rnd<OutT>(ld(plane + pix));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += tx.w[dx] * rnd<OutT>(col[c]);
    }
    store4(orow + (int64_t)j * 4, acc);
  }
}

template <typename FrameT, typename ProbT>
int launch(const void* frames, const void* probs, int T, int planes_per_frame,
           int obj_offset, int num_objects, int H, int W, int S, const float* boxes,
           void* out, int out_bf16, cudaStream_t st) {
  const dim3 grid(S, T * num_objects);
  const FrameT* f = static_cast<const FrameT*>(frames);
  const ProbT* p = static_cast<const ProbT*>(probs);
  if (out_bf16) {
    pair_crop_kernel<FrameT, ProbT, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<__nv_bfloat16*>(out));
  } else {
    pair_crop_kernel<FrameT, ProbT, float><<<grid, kThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ivosw_roi_crop_pairs(
    const void* frames, const void* probs, int frames_bf16, int probs_bf16, int T,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const void* boxes, void* out, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  const float* b = static_cast<const float*>(boxes);
  if (frames_bf16 && probs_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, b, out, out_bf16, st);
  if (frames_bf16)
    return launch<__nv_bfloat16, float>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, b, out, out_bf16, st);
  if (probs_bf16)
    return launch<float, __nv_bfloat16>(frames, probs, T, planes_per_frame,
        obj_offset, num_objects, H, W, S, b, out, out_bf16, st);
  return launch<float, float>(frames, probs, T, planes_per_frame,
      obj_offset, num_objects, H, W, S, b, out, out_bf16, st);
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
