// Pair crop with given interpolation matrices for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pairs_pallas_premat
// (ivosw_tpu/kernels/roi_pallas.py:584; body _pair_kernel_premat :559).
// Only tests reach it there; it is the pair crop of roi_crop_pairs.cu with
// the matrices built outside the kernel (ops/roi.py::_interp_matrix, cast
// to the working type) and read from device memory.
//
// What it computes, for pair i = t*O + o and channel c (frame t's r, g, b,
// then prob plane (t, obj_offset + o)):
//   tmp[i, c] = round(Ry[i] @ img_c)        Ry [S, H], img_c [H, W] -> [S, W]
//   out[i, :, :, c] = round(tmp[i, c] @ Rx[i]^T)   Rx [S, W] -> [S, S]
// with float32 accumulation and round() to the working type (f32 or bf16),
// inputs rounded to it on load, as the TPU kernel's two dots per channel.
// It does not assume that Ry/Rx are bilinear: every entry is read.
//
// Bound: operations. At T=32, O=3, 480x854, S=256 the two stages are
// 2*T*O*(S*H*W + S*S*W)*4 = 124 GFLOP against ~0.4 GB of bytes; in bf16 that
// is 0.13 ms at the card's 989 TFLOP/s dense bf16 rate.
//
// Design: a simple tiled product, right before fast. Both stages are one
// batched, strided GEMM C[m, n] = sum_k A[m, k] B[k, n] over z = (pair,
// channel); each block computes a 64 x 64 tile of one z, staging 64 x 16
// slices of A and 16 x 64 slices of B in shared memory as float32 (rounded
// to the working type on load) and accumulating 4 x 4 outputs per thread
// with fused multiply-adds (products of bf16 values are exact in float32, so
// the fma rounds as the reference's products and sums do). Stage 1 writes
// the intermediate [T*O, 4, S, W] in the working type to a scratch buffer
// the wrapper allocates; stage 2 reads it and writes the NHWC output. No
// tensor cores yet: a wgmma pipeline is a later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One 64 x 64 tile of C = A @ B (element strides given), rounded to OutT.
// WorkT is the working type every operand is rounded to on load.
template <typename WorkT, typename AT, typename BT, typename OutT>
__device__ __forceinline__ void gemm_tile(
    const AT* __restrict__ A, int64_t a_m, int64_t a_k,
    const BT* __restrict__ B, int64_t b_k, int64_t b_n,
    OutT* __restrict__ C, int64_t c_m, int64_t c_n, int M, int N, int K) {
  __shared__ float As[kDepth][kTile + 1];
  __shared__ float Bs[kDepth][kTile + 1];
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int e = threadIdx.x; e < kDepth * kTile; e += kThreads) {
      // A: k fastest (rows of A are contiguous in k when a_k == 1)
      const int ka = e % kDepth, ma = e / kDepth;
      const int m = m0 + ma, k = k0 + ka;
      As[ka][ma] = (m < M && k < K) ? rnd<WorkT>(ld(A + m * a_m + k * a_k)) : 0.0f;
      // B: n fastest when its columns are the short stride, else k fastest
      int kb, nb;
      if (b_n <= b_k) {
        nb = e % kTile; kb = e / kTile;
      } else {
        kb = e % kDepth; nb = e / kDepth;
      }
      const int n = n0 + nb, kk = k0 + kb;
      Bs[kb][nb] = (n < N && kk < K) ? rnd<WorkT>(ld(B + kk * b_k + n * b_n)) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tr + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tc + 16 * j;
      if (n < N) st(C + m * c_m + n * c_n, acc[i][j]);
    }
  }
}

// stage 1: tmp[z] = Ry[pair] @ img_c, z = pair * 4 + c
template <typename WorkT, typename FrameT, typename ProbT>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const WorkT* __restrict__ ry, const FrameT* __restrict__ frames,
    const ProbT* __restrict__ probs, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, int S, WorkT* __restrict__ tmp) {
  const int z = blockIdx.z;
  const int pair = z / 4, c = z % 4;
  const int t = pair / num_objects, o = pair - t * num_objects;
  const WorkT* a = ry + (int64_t)pair * S * H;
  WorkT* out = tmp + (int64_t)z * S * W;
  if (c < 3) {
    const FrameT* img = frames + (int64_t)t * H * W * 3 + c;
    gemm_tile<WorkT>(a, H, 1, img, (int64_t)W * 3, 3, out, W, 1, S, W, H);
  } else {
    const ProbT* img = probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)H * W;
    gemm_tile<WorkT>(a, H, 1, img, W, 1, out, W, 1, S, W, H);
  }
}

// stage 2: out[pair, :, :, c] = tmp[z] @ Rx[pair]^T
template <typename WorkT>
__global__ void __launch_bounds__(kThreads) cols_kernel(
    const WorkT* __restrict__ tmp, const WorkT* __restrict__ rx, int W, int S,
    WorkT* __restrict__ out) {
  const int z = blockIdx.z;
  const int pair = z / 4, c = z % 4;
  gemm_tile<WorkT>(tmp + (int64_t)z * S * W, W, 1, rx + (int64_t)pair * S * W, 1, W,
                   out + (int64_t)pair * S * S * 4 + c, (int64_t)S * 4, 4, S, S, W);
}

template <typename WorkT, typename FrameT, typename ProbT>
int launch(const void* ry, const void* rx, const void* frames, const void* probs, int T,
           int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
           void* tmp, void* out, cudaStream_t st) {
  const int z = T * num_objects * 4;
  const dim3 grid1((W + kTile - 1) / kTile, (S + kTile - 1) / kTile, z);
  rows_kernel<WorkT, FrameT, ProbT><<<grid1, kThreads, 0, st>>>(
      static_cast<const WorkT*>(ry), static_cast<const FrameT*>(frames),
      static_cast<const ProbT*>(probs), planes_per_frame, obj_offset, num_objects, H, W,
      S, static_cast<WorkT*>(tmp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((S + kTile - 1) / kTile, (S + kTile - 1) / kTile, z);
  cols_kernel<WorkT><<<grid2, kThreads, 0, st>>>(
      static_cast<const WorkT*>(tmp), static_cast<const WorkT*>(rx), W, S,
      static_cast<WorkT*>(out));
  return (int)cudaGetLastError();
}

template <typename WorkT>
int launch_work(const void* ry, const void* rx, const void* frames, const void* probs,
                int frames_bf16, int probs_bf16, int T, int planes_per_frame,
                int obj_offset, int num_objects, int H, int W, int S, void* tmp,
                void* out, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (frames_bf16 && probs_bf16)
    return launch<WorkT, bf16, bf16>(ry, rx, frames, probs, T, planes_per_frame,
                                     obj_offset, num_objects, H, W, S, tmp, out, st);
  if (frames_bf16)
    return launch<WorkT, bf16, float>(ry, rx, frames, probs, T, planes_per_frame,
                                      obj_offset, num_objects, H, W, S, tmp, out, st);
  if (probs_bf16)
    return launch<WorkT, float, bf16>(ry, rx, frames, probs, T, planes_per_frame,
                                      obj_offset, num_objects, H, W, S, tmp, out, st);
  return launch<WorkT, float, float>(ry, rx, frames, probs, T, planes_per_frame,
                                     obj_offset, num_objects, H, W, S, tmp, out, st);
}

}  // namespace

// ry [T*O, S, H], rx [T*O, S, W] and tmp [T*O, 4, S, W] in the working type;
// out NHWC [T*O, S, S, 4] in the working type.
extern "C" int ivosw_roi_crop_pairs_premat(
    const void* ry, const void* rx, const void* frames, const void* probs,
    int frames_bf16, int probs_bf16, int T, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, int S, void* tmp, void* out, int work_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  if (work_bf16)
    return launch_work<__nv_bfloat16>(ry, rx, frames, probs, frames_bf16, probs_bf16, T,
                                      planes_per_frame, obj_offset, num_objects, H, W, S,
                                      tmp, out, st);
  return launch_work<float>(ry, rx, frames, probs, frames_bf16, probs_bf16, T,
                            planes_per_frame, obj_offset, num_objects, H, W, S, tmp, out,
                            st);
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
