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
// Bound: memory bandwidth. At one launch of the scoring round (T=32, O=3,
// 480x854, S=256, bf16 output) the box needs every prob pixel, 79 MB of
// bf16 planes (157 MB of f32); the crops write 50 MB and read the frame
// pixels their taps touch, about 47 MB of bf16 (94 MB of f32) for
// chip_smoke.py's masks: 176 MB, 0.0526 ms at 3.35 TB/s with bf16 inputs
// (302 MB, 0.0903 ms with f32 inputs). The crop does 16 multiply-adds per
// output pixel, far below the card's rate.
//
// Device time per call at that shape, NVIDIA H100 80GB HBM3, 700.00 W, the
// earlier design and this one timed side by side in one run (PERF.md §6): bf16
// inputs 0.1485 ms before (box pass 0.0866, crop pass 0.0620), 0.0980 ms
// after (0.0311 + 0.0017 + 0.0652); f32 inputs 0.1901 ms before
// (0.0982 + 0.0918), 0.1484 ms after (0.0526 + 0.0022 + 0.0934).
//
// Design: three launches per call, no atomics, no memset.
//   fusedbox_box_kernel: each prob plane is split into bands of band_vecs
//     loads, one 256-thread block per (band, pair): at T=32, O=3 that is
//     26 bands x 96 pairs = 2496 blocks with bf16 planes (4896 with f32)
//     on 132 SMs, where one 512-thread block per pair gave 96. The plane is
//     read as a flat array with the widest load (16, 8, 4 or 2 bytes, a
//     template parameter) that divides both the probs' base address and a
//     plane's byte size: every plane then starts on a load boundary and
//     ends on one (480x854 takes 16 bytes in both types; 49x71 takes 4 or
//     2). Each thread issues kBoxUnroll loads before testing any. A load
//     holding a foreground value recovers its row and column from the flat
//     index (one division); the block reduces the foreground's first and
//     last flat index and min/max column, and writes one int4 partial
//     (ymin, ymax, xmin, xmax) per band to a scratch [T*O, bands, 4].
//   fusedbox_reduce_kernel: a warp per pair reduces its band partials and
//     one lane does the box arithmetic in the same float32 op order as the
//     reference. The file is built with --fmad=false, so no multiply-add is
//     contracted and the boxes equal the reference bit for bit. Reducing
//     the partials at the head of every crop block instead made every block
//     wait on it (a crop pass of 0.097 ms against 0.083 for the same pass
//     fed by this launch).
//   fusedbox_crop_kernel: one block per (kCropRows output rows, pair), its
//     threads on the output columns; each column's taps serve both rows.
//     Each output pixel is a 4-tap gather: taps floor(c) and floor(c)+1
//     with weights max(0, 1 - |c - s|), a tap outside the image skipped.
//     Sums run in f32 with rows contracted first and round once on store
//     (8 bytes per bf16 pixel, 16 per f32 pixel). Measured and dropped:
//     loading a frame tap's 3 channels as one 4-byte pair plus one value
//     (0.079 ms against 0.062 for three 2-byte loads), and issuing all taps
//     of several pixels before the first multiply (0.071 ms and up: more
//     registers, fewer warps). No dense interpolation matrix product is
//     done (the TPU form spends 2*S*H*W MACs per channel, nearly all on
//     zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBoxThreads = 256;
constexpr int kBoxUnroll = 4;  // loads in flight per thread in the box pass
constexpr int kCropThreads = 128;
constexpr int kCropRows = 2;  // output rows per crop block
constexpr int kReduceThreads = 128;  // a warp per pair in the box reduction

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int kBytes> struct Raw;
template <> struct Raw<16> { using T = uint4; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<2> { using T = unsigned short; };

__device__ __forceinline__ void warp_reduce(int& ymin, int& ymax, int& xmin, int& xmax) {
  for (int off = 16; off > 0; off >>= 1) {
    ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
    xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
  }
}

// Box pass: one block per (band, pair), pairs in reverse order, so that the
// planes the crop pass reads first are the last ones read here (still in
// L2). fmin/fmax are flat indices of the band's first and last foreground
// value; rows follow as fmin / W, fmax / W.
template <typename ProbT, int kVecBytes>
__global__ void __launch_bounds__(kBoxThreads) fusedbox_box_kernel(
    const ProbT* __restrict__ probs, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, int band_vecs, int4* __restrict__ partial) {
  constexpr int kV = kVecBytes / (int)sizeof(ProbT);  // values per load
  static_assert(kV >= 1 && kV <= 32, "load narrower than a value");
  using Vec = typename Raw<kVecBytes>::T;
  const int band = blockIdx.x;
  const int pair = gridDim.y - 1 - blockIdx.y;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const int hw = H * W;
  const Vec* plane = reinterpret_cast<const Vec*>(
      probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)hw);
  const int v_end = min((band + 1) * band_vecs, hw / kV);

  int fmin = INT_MAX, fmax = -1, xmin = INT_MAX, xmax = -1;
  for (int v0 = band * band_vecs + threadIdx.x; v0 < v_end; v0 += kBoxThreads * kBoxUnroll) {
    Vec raw[kBoxUnroll];
#pragma unroll
    for (int u = 0; u < kBoxUnroll; ++u) {
      const int v = v0 + u * kBoxThreads;
      if (v < v_end) raw[u] = __ldg(plane + v);
    }
#pragma unroll
    for (int u = 0; u < kBoxUnroll; ++u) {
      const int v = v0 + u * kBoxThreads;
      if (v >= v_end) continue;
      ProbT vals[kV];
      memcpy(vals, &raw[u], kVecBytes);
      unsigned mask = 0;
#pragma unroll
      for (int k = 0; k < kV; ++k) mask |= (f32(vals[k]) > 0.5f ? 1u : 0u) << k;
      if (mask == 0) continue;
      const int f0 = v * kV;
      const int y0 = f0 / W;
      const int x0 = f0 - y0 * W;
      const int first = __ffs(mask) - 1, last = 31 - __clz(mask);
      fmin = min(fmin, f0 + first);
      fmax = max(fmax, f0 + last);
      if (x0 + kV <= W) {  // the vector lies in one row: columns rise with k
        xmin = min(xmin, x0 + first);
        xmax = max(xmax, x0 + last);
        continue;
      }
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if (!(mask >> k & 1u)) continue;
        int x = x0 + k;
        while (x >= W) x -= W;  // the vector ran past the end of row y0
        xmin = min(xmin, x);
        xmax = max(xmax, x);
      }
    }
  }
  warp_reduce(fmin, fmax, xmin, xmax);
  __shared__ int4 red[kBoxThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = make_int4(fmin, fmax, xmin, xmax);
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kBoxThreads / 32; ++w) {
    fmin = min(fmin, red[w].x);
    fmax = max(fmax, red[w].y);
    xmin = min(xmin, red[w].z);
    xmax = max(xmax, red[w].w);
  }
  partial[(int64_t)pair * gridDim.x + band] =
      make_int4(fmax >= 0 ? fmin / W : INT_MAX, fmax >= 0 ? fmax / W : -1, xmin, xmax);
}

__device__ __forceinline__ void expand_min_side(float& lo, float& hi, float min_side) {
  const float res = min_side - (hi - lo);
  const float half = floorf(res / 2.0f);
  if (res > 0.0f) {
    lo = lo - half;
    hi = hi + half;
  }
}

// Box reduction: one warp per pair reduces the pair's band partials, and
// lane 0 does the box arithmetic in the op order of ops/roi.py::mask_to_yxhw
// followed by yxhw_to_minmax, one float32 rounding per operation.
__global__ void __launch_bounds__(kReduceThreads) fusedbox_reduce_kernel(
    const int4* __restrict__ partial, int pairs, int bands, int H, int W, float min_side,
    float grow, float4* __restrict__ boxes) {
  const int pair = (blockIdx.x * kReduceThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= pairs) return;  // whole warps leave together
  int ymin = INT_MAX, ymax = -1, xmin = INT_MAX, xmax = -1;
  for (int k = lane; k < bands; k += 32) {
    const int4 p = partial[(int64_t)pair * bands + k];
    ymin = min(ymin, p.x);
    ymax = max(ymax, p.y);
    xmin = min(xmin, p.z);
    xmax = max(xmax, p.w);
  }
  warp_reduce(ymin, ymax, xmin, xmax);
  if (lane != 0) return;
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
  boxes[pair] = make_float4(yc - hh / 2.0f, yc + hh / 2.0f, xc - ww / 2.0f, xc + ww / 2.0f);
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// Crop pass: one block per (kCropRows output rows, pair); its threads walk
// the output columns, and each column's taps serve all kCropRows rows.
template <typename FrameT, typename ProbT, typename OutT>
__global__ void __launch_bounds__(kCropThreads) fusedbox_crop_kernel(
    const FrameT* __restrict__ frames, const ProbT* __restrict__ probs,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const float4* __restrict__ boxes, OutT* __restrict__ out) {
  const int i0 = blockIdx.x * kCropRows;  // first output row
  const int pair = blockIdx.y;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const float4 box = boxes[pair];  // (ymin, ymax, xmin, xmax)
  const float denom = (float)(S - 1);

  // row taps (as _interp_matrix): floor(c) and floor(c)+1, weights
  // max(0, 1 - |c - s|); rows past S are not computed
  int ty[kCropRows];
  float wy[kCropRows][2];
#pragma unroll
  for (int r = 0; r < kCropRows; ++r) {
    const float cy = box.x + (box.y - box.x) * ((float)min(i0 + r, S - 1) / denom);
    const float fy = floorf(cy);
    ty[r] = (int)fy;
    wy[r][0] = fmaxf(0.0f, 1.0f - fabsf(cy - fy));
    wy[r][1] = fmaxf(0.0f, 1.0f - fabsf(cy - (fy + 1.0f)));
  }
  // offsets inside one frame and one plane fit 32 bits (the wrapper checks)
  const FrameT* frame = frames + (int64_t)t * H * W * 3;
  const ProbT* plane = probs + ((int64_t)t * planes_per_frame + obj_offset + o) * H * W;
  OutT* opair = out + (int64_t)pair * S * S * 4;

  for (int j = threadIdx.x; j < S; j += kCropThreads) {
    const float cx = box.z + (box.w - box.z) * ((float)j / denom);
    const float fx = floorf(cx);
    const int tx = (int)fx;
    const float wx[2] = {fmaxf(0.0f, 1.0f - fabsf(cx - fx)),
                         fmaxf(0.0f, 1.0f - fabsf(cx - (fx + 1.0f)))};
#pragma unroll
    for (int r = 0; r < kCropRows; ++r) {
      if (i0 + r >= S) break;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = tx + dx;
        if (x < 0 || x >= W) continue;  // a tap outside the image adds 0
        // contract rows first (Ry @ img), then columns, as the reference
        float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int y = ty[r] + dy;
          if (y < 0 || y >= H) continue;
          const int pix = y * W + x;
          const FrameT* px = frame + pix * 3;
          col[0] += wy[r][dy] * ld(px);
          col[1] += wy[r][dy] * ld(px + 1);
          col[2] += wy[r][dy] * ld(px + 2);
          col[3] += wy[r][dy] * ld(plane + pix);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += wx[dx] * col[c];
      }
      store4(opair + ((int64_t)(i0 + r) * S + j) * 4, acc);
    }
  }
}

template <typename ProbT>
cudaError_t launch_box(const void* probs, int T, int planes_per_frame, int obj_offset,
                       int num_objects, int H, int W, int load_bytes, int band_vecs,
                       int bands, int4* partial, cudaStream_t st) {
  const dim3 grid(bands, T * num_objects);
  const ProbT* p = static_cast<const ProbT*>(probs);
#define IVOSW_BOX(BYTES)                                                           \
  fusedbox_box_kernel<ProbT, BYTES><<<grid, kBoxThreads, 0, st>>>(                 \
      p, planes_per_frame, obj_offset, num_objects, H, W, band_vecs, partial)
  switch (load_bytes) {
    case 16: IVOSW_BOX(16); break;
    case 8: IVOSW_BOX(8); break;
    case 4: IVOSW_BOX(4); break;
    case 2:
      if constexpr (sizeof(ProbT) == 2) {
        IVOSW_BOX(2);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef IVOSW_BOX
  return cudaGetLastError();
}

template <typename FrameT, typename ProbT>
cudaError_t launch_crop(const void* frames, const void* probs, int T, int planes_per_frame,
                        int obj_offset, int num_objects, int H, int W, int S,
                        const float4* boxes, void* out, int out_bf16, cudaStream_t st) {
  const dim3 grid((S + kCropRows - 1) / kCropRows, T * num_objects);
  const FrameT* f = static_cast<const FrameT*>(frames);
  const ProbT* p = static_cast<const ProbT*>(probs);
  if (out_bf16)
    fusedbox_crop_kernel<FrameT, ProbT, __nv_bfloat16><<<grid, kCropThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<__nv_bfloat16*>(out));
  else
    fusedbox_crop_kernel<FrameT, ProbT, float><<<grid, kCropThreads, 0, st>>>(
        f, p, planes_per_frame, obj_offset, num_objects, H, W, S, boxes,
        static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename FrameT, typename ProbT>
int launch(const void* frames, const void* probs, int T, int planes_per_frame,
           int obj_offset, int num_objects, int H, int W, int S, float min_side,
           float grow, int load_bytes, int band_vecs, int bands, int4* partial,
           float* boxes, void* out, int out_bf16, cudaStream_t st) {
  cudaError_t err = launch_box<ProbT>(probs, T, planes_per_frame, obj_offset, num_objects,
                                      H, W, load_bytes, band_vecs, bands, partial, st);
  if (err != cudaSuccess) return (int)err;
  const int pairs = T * num_objects;
  float4* box4 = reinterpret_cast<float4*>(boxes);
  fusedbox_reduce_kernel<<<(pairs * 32 + kReduceThreads - 1) / kReduceThreads, kReduceThreads,
                           0, st>>>(partial, pairs, bands, H, W, min_side, grow, box4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_crop<FrameT, ProbT>(frames, probs, T, planes_per_frame, obj_offset,
                                         num_objects, H, W, S, box4, out, out_bf16, st);
}

}  // namespace

// frames [T, H, W, 3] and probs [T, planes_per_frame, H, W] (f32 or bf16,
// flags), planes obj_offset .. obj_offset+num_objects-1 cropped. The box
// pass reads each plane in loads of load_bytes (dividing the probs' base
// address and H*W times the value size), bands of band_vecs loads each,
// into partial [T*num_objects, bands] int4 (bands = ceil(H*W*size /
// load_bytes / band_vecs)). boxes [T*num_objects, 4] f32, out
// [T*num_objects, S, S, 4] bf16 or f32. Returns the first CUDA error code.
extern "C" int ivosw_roi_crop_pairs_fusedbox(
    const void* frames, const void* probs, int frames_bf16, int probs_bf16, int T,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    float min_side, float grow, int load_bytes, int band_vecs, int bands, void* partial,
    void* boxes, void* out, int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  float* b = static_cast<float*>(boxes);
  int4* part = static_cast<int4*>(partial);
#define IVOSW_LAUNCH(F, P)                                                              \
  launch<F, P>(frames, probs, T, planes_per_frame, obj_offset, num_objects, H, W, S,    \
               min_side, grow, load_bytes, band_vecs, bands, part, b, out, out_bf16, st)
  if (frames_bf16 && probs_bf16) return IVOSW_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  if (frames_bf16) return IVOSW_LAUNCH(__nv_bfloat16, float);
  if (probs_bf16) return IVOSW_LAUNCH(float, __nv_bfloat16);
  return IVOSW_LAUNCH(float, float);
#undef IVOSW_LAUNCH
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
