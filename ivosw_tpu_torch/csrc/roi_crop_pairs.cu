// Given-box T x O pair crop for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pairs_pallas
// (ivosw_tpu/kernels/roi_pallas.py:299; body _pair_kernel :267, matrices
// _interp_mats :252), which the two-stage scoring round reaches through
// roi_crop_pairs (:639): boxes from mask_to_yxhw first, then this crop.
//
// What it computes: pair i = t*O + o crops frame t's 3 channels and prob
// plane (t, obj_offset + o) inside yxhw box i, first turned into (ymin, ymax,
// xmin, xmax) in the float32 op order of ops/roi.py::yxhw_to_minmax (as the
// TPU function does inside its jitted body, :320-321), to S x S: output row
// r samples at cy = ymin + (ymax - ymin) * (r / (S - 1)), column j at the
// same formula in x, each tap s weighs max(0, 1 - |c - s|), zeros outside
// the image. Inputs: frames NHWC [T, H, W, 3] and planes [T, P, H, W], each
// f32 or bf16, and yxhw [T*O, 4] f32 or bf16 read through its two strides
// (bf16 boxes: each edge y -+ h/2, x -+ w/2 rounded to bf16, as the TPU
// function computes yxhw_to_minmax in the boxes' type before its float32
// cast, :320-321, then widened). Output NHWC [T*O, S, S, 4] (rgb + prob)
// in the working type (f32 or bf16).
//
// Rounding: in bf16 the TPU kernel rounds its inputs, both interpolation
// matrices and the row-contracted intermediate (Ry @ img) to bf16 and
// accumulates in f32 (:279-291). Here the same values are rounded at the
// same points: each input value and each tap weight to the working type,
// the row-contracted intermediate (Ry @ img)[r, x] of each column tap to
// the working type before the column stage, the output on store. A
// bf16 x bf16 product is exact in f32 and each sum has two terms, so the
// kernel equals the plain einsum (rounded the same way) bit for bit in
// bf16. The file is built with --fmad=false, so the boxes and coordinates
// round after every operation in the JAX op order.
//
// Bound: memory bandwidth. At T=32, O=3, 480x854, S=256, bf16 it writes
// 32*3*256^2*4*2 B = 50 MB and reads the frame and plane pixels its taps
// touch (at most the 79 MB of bf16 frames and the 79 MB of the selected
// bf16 planes; chip_smoke.py's boxes need ~70 MB of them): 0.036 ms at
// 3.35 TB/s. It does 4 taps x 4 channels of multiply-adds per output pixel
// (0.2 GFLOP), far below the card's rate.
//
// Device time per call at that shape, NVIDIA H100 80GB HBM3, 700.00 W, the
// earlier design and this one timed side by side in one run
// (scripts/pair_crop_variants.py, PERF.md §6): 0.0930 ms before (its kernel
// 0.0822 ms, one block per output row gathering from device memory, the rest
// the torch launches that converted the boxes), 0.0669 ms after. Alone, the
// copies and stores take 0.062 ms and the gathers and stores 0.053 ms.
//
// Design:
//   - One launch per call: each block reads its box through the yxhw
//     strides and converts it itself (load_box, as csrc/roi_crop.cu), so
//     the wrapper does no tensor work besides allocating the output.
//   - One block of kThreads threads per (band of kRows output rows, pair),
//     bands fastest, so the O pairs of one frame run side by side and share
//     its rows in L2. Each thread keeps the x-taps of its columns in
//     registers for the whole band.
//   - Rows staged through shared memory: for each output row the block
//     copies the span [xa, xb] of source rows y0 and y0+1 of the frame and
//     the plane (xa, xb: the first and last column any tap of the pair
//     reaches, clamped to the image), its start aligned down and its end up
//     to the load width and the head skipped in shared memory (480x854 bf16
//     rows are 5124 and 1708 B, 4-byte but not 16-byte aligned). With
//     16-byte loads (the wrapper's span_load_bytes: the tensors' bases and
//     image sizes allow them, as on the path) one thread issues the four
//     spans as bulk asynchronous copies (the TMA's non-tensor form) on an
//     mbarrier, kStages - 1 rows ahead of the row the block gathers, and
//     leaves the row's tap weights and span heads in shared memory (RowInfo)
//     for the other threads. Otherwise the threads copy with one load each
//     (cp.async of 16, 8 or 4 bytes, or 2 through a register) before the
//     row's gathers.
//   - Each thread then gathers its columns' 2 x 2 taps from shared memory,
//     where a warp's scattered 2-byte reads take one or two bank wavefronts,
//     against five or six cache-line wavefronts for the same reads from
//     device memory.
//   - Shared memory bounds the blocks per SM (seven at 480x854 bf16), and
//     with them both the copies in flight and the warps gathering: 64
//     threads, 8 rows and 2 buffers were fastest. Measured and dropped
//     (PERF.md §6): contracting the rows over the whole span into a shared
//     intermediate first (0.187 ms: at 854 px a span holds 3.3 pixels per
//     output column, each contracted at the cost of a whole output pixel),
//     more buffers, L2 prefetches of later rows, the thread's columns
//     interleaved, frame taps read as 32-bit words.
//   - The TPU kernel's dense interpolation matrices (2*S*H*W MACs per
//     channel, nearly all on zeros) are not built: each of their rows has
//     at most two non-zero taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 64;
constexpr int kRows = 8;  // output rows per block
constexpr int kStages = 2;  // row buffers: the copies run kStages - 1 rows ahead
constexpr int kCachedCols = (256 + kThreads - 1) / kThreads;  // taps kept for S <= 256

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// a float32 value rounded to the working type and widened back
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// an input value rounded to the working type (a no-op unless f32 -> bf16)
template <typename OutT, typename InT>
__device__ __forceinline__ float rnd_in(InT v) {
  if constexpr (std::is_same_v<InT, float> && std::is_same_v<OutT, bf16>) return rnd<bf16>(v);
  return f32(v);
}

struct Box {
  float ymin, ymax, xmin, xmax;
};

// (y, x, h, w) -> (ymin, ymax, xmin, xmax), ops/roi.py::yxhw_to_minmax in
// the boxes' type: f32, or bf16 with each edge rounded to bf16 (h / 2 is
// exact) and then widened to f32
__device__ __forceinline__ Box load_box(const void* __restrict__ yxhw, int64_t stride,
                                        int box_bf16) {
  if (box_bf16) {
    const bf16* b = static_cast<const bf16*>(yxhw);
    const float y = f32(b[0]), x = f32(b[stride]), h = f32(b[2 * stride]), w = f32(b[3 * stride]);
    return {rnd<bf16>(y - h / 2.0f), rnd<bf16>(y + h / 2.0f), rnd<bf16>(x - w / 2.0f),
            rnd<bf16>(x + w / 2.0f)};
  }
  const float* b = static_cast<const float*>(yxhw);
  const float y = __ldg(b), x = __ldg(b + stride);
  const float h = __ldg(b + 2 * stride), w = __ldg(b + 3 * stride);
  return {y - h / 2.0f, y + h / 2.0f, x - w / 2.0f, x + w / 2.0f};
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one load of `bytes` (16, 8, 4: cp.async; 2: through a register)
__device__ __forceinline__ void copy_piece(char* dst, const char* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
  else
    *reinterpret_cast<unsigned short*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a bulk asynchronous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) that completes on `bar`
__device__ __forceinline__ void bulk_copy(char* dst, const char* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A span of one source row in device memory: from `start` (its first byte
// aligned down to the load width) n loads, the span's first byte `head`
// bytes in. n = 0 for a row outside the image (nothing copied, the row adds
// nothing).
struct Span {
  const char* start;
  int head, n;
};

__device__ __forceinline__ Span span(const char* src, int bytes, int load, bool inside) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t start = a & ~(uintptr_t)(load - 1);
  const int head = (int)(a - start);
  return {reinterpret_cast<const char*>(start), head,
          inside ? (head + bytes + load - 1) / load : 0};
}

// What the gathers of one output row need besides its spans: the weights of
// its row taps and each staged span's head in its slot (a frame head of -1:
// the source row lies outside the image and adds nothing).
struct RowInfo {
  float w[2];
  int frame_head[2], plane_head[2];
};

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared memory: kStages buffers, each the spans of source rows y0 and y0+1
// of one output row, frame rows in slots of frame_cap bytes, then plane
// rows in slots of plane_cap bytes.
template <typename FrameT, typename ProbT, typename OutT>
__global__ void __launch_bounds__(kThreads) pair_crop_kernel(
    const FrameT* __restrict__ frames, const ProbT* __restrict__ probs,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const char* __restrict__ yxhw, int64_t box_stride0, int64_t box_stride1, int box_bf16,
    int frame_load, int plane_load, int frame_cap, int plane_cap, OutT* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  __shared__ uint64_t bars[kStages];
  __shared__ RowInfo rows[kStages];
  const int buffer_bytes = 2 * (frame_cap + plane_cap);
  const bool bulk = frame_load == 16 && plane_load == 16;

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int r_end = min(r0 + kRows, S);
  const int pair = blockIdx.y;
  const int t = pair / num_objects;
  const int o = pair - t * num_objects;
  const Box box = load_box(yxhw + (int64_t)pair * box_stride0 * (box_bf16 ? 2 : 4),
                           box_stride1, box_bf16);
  const float denom = (float)(S - 1);

  // the span of columns any tap reaches: the first tap moves monotonically
  // with the column, so its ends come from columns 0 and S-1
  const int fa = taps<OutT>(box.xmin, box.xmax, 0, denom, W).first;
  const int fb = taps<OutT>(box.xmin, box.xmax, S - 1, denom, W).first;
  const int xa = max(0, min(fa, fb));
  const int nx = min(W - 1, max(fa, fb) + 1) - xa + 1;  // <= 0: no tap inside

  Taps tx[kCachedCols];
#pragma unroll
  for (int k = 0; k < kCachedCols; ++k)
    tx[k] = taps<OutT>(box.xmin, box.xmax, min(tid + k * kThreads, S - 1), denom, W);

  const char* frame = reinterpret_cast<const char*>(frames + (int64_t)t * H * W * 3);
  const char* plane = reinterpret_cast<const char*>(
      probs + ((int64_t)t * planes_per_frame + obj_offset + o) * H * W);
  const int frame_row = W * 3 * (int)sizeof(FrameT), plane_row = W * (int)sizeof(ProbT);
  const int frame_x0 = xa * 3 * (int)sizeof(FrameT), plane_x0 = xa * (int)sizeof(ProbT);
  const int frame_bytes = nx * 3 * (int)sizeof(FrameT), plane_bytes = nx * (int)sizeof(ProbT);

  // the spans of output row r: frame rows y0, y0+1 (f[0], f[1]), plane
  // rows y0, y0+1 (p[0], p[1])
  struct Spans {
    Span f[2], p[2];
  };
  auto spans = [&](int y0) {
    Spans s;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int y = y0 + d;
      const bool inside = nx > 0 && y >= 0 && y < H;
      const int yy = inside ? y : 0;
      s.f[d] = span(frame + (int64_t)yy * frame_row + frame_x0, frame_bytes, frame_load, inside);
      s.p[d] = span(plane + (int64_t)yy * plane_row + plane_x0, plane_bytes, plane_load, inside);
    }
    return s;
  };
  auto slot_f = [&](int b, int d) { return smem + b * buffer_bytes + d * frame_cap; };
  auto slot_p = [&](int b, int d) {
    return smem + b * buffer_bytes + 2 * frame_cap + d * plane_cap;
  };
  // the copies of output row r into buffer b, and its row taps and span
  // heads in rows[b] for the gathers: by one thread (bulk copies completing
  // on bars[b]) or by every thread (cp.async, waited for here)
  auto stage = [&](int r, int b) {
    const Taps ty = taps<OutT>(box.ymin, box.ymax, r, denom, H);
    const Spans s = spans(ty.first);
    if (tid == 0)
      rows[b] = {{ty.w[0], ty.w[1]},
                 {s.f[0].n ? s.f[0].head : -1, s.f[1].n ? s.f[1].head : -1},
                 {s.p[0].head, s.p[1].head}};
    if (bulk) {
      const int bytes = 16 * (s.f[0].n + s.f[1].n + s.p[0].n + s.p[1].n);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the reads of b
      bar_expect(&bars[b], bytes);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (s.f[d].n) bulk_copy(slot_f(b, d), s.f[d].start, 16 * s.f[d].n, &bars[b]);
        if (s.p[d].n) bulk_copy(slot_p(b, d), s.p[d].start, 16 * s.p[d].n, &bars[b]);
      }
      return;
    }
    const int n0 = s.f[0].n, n1 = n0 + s.f[1].n, n2 = n1 + s.p[0].n, n3 = n2 + s.p[1].n;
    for (int k = tid; k < n3; k += kThreads) {
      if (k < n1) {
        const bool d = k >= n0;
        const int q = k - (d ? n0 : 0);
        const char* src = (d ? s.f[1].start : s.f[0].start) + q * frame_load;
        copy_piece(slot_f(b, d) + q * frame_load, src, frame_load);
      } else {
        const bool d = k >= n2;
        const int q = k - (d ? n2 : n1);
        const char* src = (d ? s.p[1].start : s.p[0].start) + q * plane_load;
        copy_piece(slot_p(b, d) + q * plane_load, src, plane_load);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  if (bulk) {
    if (tid == 0) {
      for (int b = 0; b < kStages; ++b) bar_init(&bars[b]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int r = r0; r < min(r0 + kStages - 1, r_end); ++r) stage(r, r - r0);
  }

  OutT* opair = out + (int64_t)pair * S * S * 4;
  for (int r = r0; r < r_end; ++r) {
    const int b = (r - r0) % kStages;
    if (kStages == 1) {
      __syncthreads();  // every thread is done with row r-1, in the one buffer
      if (bulk && tid == 0) stage(r, 0);
    }
    if (bulk)
      bar_wait(&bars[b], ((r - r0) / kStages) & 1);
    else
      stage(r, b);
    __syncthreads();  // row r has landed; every thread is done with row r-1
    const int ahead = r + kStages - 1;  // into the buffer row r-1 used
    if (kStages > 1 && bulk && tid == 0 && ahead < r_end) stage(ahead, (ahead - r0) % kStages);

    const RowInfo row = rows[b];
    const FrameT* frow[2];
    const ProbT* prow[2];
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      frow[d] = reinterpret_cast<const FrameT*>(slot_f(b, d) + row.frame_head[d]);
      prow[d] = reinterpret_cast<const ProbT*>(slot_p(b, d) + row.plane_head[d]);
    }
    OutT* orow = opair + (int64_t)r * S * 4;
    // one output pixel: per column tap, the row-contracted value
    // (Ry @ img)[r, x] of its 4 channels, rounded, then the column sum
    auto column = [&](int j, const Taps& t) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = t.first + dx;
        if (x < 0 || x >= W) continue;  // a tap outside the image adds 0
        const int i = x - xa;
        float col[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          if (row.frame_head[dy] < 0) continue;  // a row outside the image adds 0
          const FrameT* px = frow[dy] + i * 3;
          col[0] += row.w[dy] * rnd_in<OutT>(px[0]);
          col[1] += row.w[dy] * rnd_in<OutT>(px[1]);
          col[2] += row.w[dy] * rnd_in<OutT>(px[2]);
          col[3] += row.w[dy] * rnd_in<OutT>(prow[dy][i]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += t.w[dx] * rnd<OutT>(col[c]);
      }
      store4(orow + (int64_t)j * 4, acc);
    };
#pragma unroll
    for (int k = 0; k < kCachedCols; ++k) {
      const int j = tid + k * kThreads;
      if (j < S) column(j, tx[k]);
    }
    for (int j = tid + kCachedCols * kThreads; j < S; j += kThreads)
      column(j, taps<OutT>(box.xmin, box.xmax, j, denom, W));
  }
}

template <typename FrameT, typename ProbT, typename OutT>
int launch_typed(const void* frames, const void* probs, int T, int planes_per_frame,
                 int obj_offset, int num_objects, int H, int W, int S, const char* yxhw,
                 long long box_stride0, long long box_stride1, int box_bf16, int frame_load,
                 int plane_load, int frame_cap, int plane_cap, void* out, cudaStream_t st) {
  auto kernel = pair_crop_kernel<FrameT, ProbT, OutT>;
  const int smem = kStages * 2 * (frame_cap + plane_cap);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, T * num_objects);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const FrameT*>(frames), static_cast<const ProbT*>(probs), planes_per_frame,
      obj_offset, num_objects, H, W, S, yxhw, box_stride0, box_stride1, box_bf16, frame_load,
      plane_load, frame_cap, plane_cap, static_cast<OutT*>(out));
  return (int)cudaGetLastError();
}

template <typename FrameT, typename ProbT>
int launch(int out_bf16, const void* frames, const void* probs, int T, int planes_per_frame,
           int obj_offset, int num_objects, int H, int W, int S, const char* yxhw,
           long long box_stride0, long long box_stride1, int box_bf16, int frame_load,
           int plane_load, int frame_cap, int plane_cap, void* out, cudaStream_t st) {
  if (out_bf16)
    return launch_typed<FrameT, ProbT, bf16>(frames, probs, T, planes_per_frame, obj_offset,
        num_objects, H, W, S, yxhw, box_stride0, box_stride1, box_bf16, frame_load,
        plane_load, frame_cap, plane_cap, out, st);
  return launch_typed<FrameT, ProbT, float>(frames, probs, T, planes_per_frame, obj_offset,
      num_objects, H, W, S, yxhw, box_stride0, box_stride1, box_bf16, frame_load, plane_load,
      frame_cap, plane_cap, out, st);
}

bool load_width(int bytes, int itemsize) {
  return (bytes == 16 || bytes == 8 || bytes == 4 || bytes == 2) && bytes >= itemsize;
}

}  // namespace

// frames [T, H, W, 3] and probs [T, planes_per_frame, H, W] (f32 or bf16,
// flags), planes obj_offset .. obj_offset+num_objects-1 cropped; yxhw
// [T*num_objects, 4] f32 or bf16 (box_bf16) with element strides
// (box_stride0, box_stride1);
// out [T*num_objects, S, S, 4] bf16 or f32. frame_load and plane_load: the
// load widths (16, 8, 4 or 2 bytes, each dividing its tensor's base and one
// frame's or plane's byte size); frame_cap and plane_cap: the shared-memory
// slot of one source row's span (16-byte multiples, at least a row's bytes
// plus two loads). A block takes kStages buffers of two slots of each as
// dynamic shared memory. Returns the launch's CUDA error.
extern "C" int ivosw_roi_crop_pairs(
    const void* frames, const void* probs, int frames_bf16, int probs_bf16, int T,
    int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
    const void* yxhw, long long box_stride0, long long box_stride1, int box_bf16,
    int frame_load, int plane_load, int frame_cap, int plane_cap, void* out, int out_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  const int frame_size = frames_bf16 ? 2 : 4, prob_size = probs_bf16 ? 2 : 4;
  if (!load_width(frame_load, frame_size) || !load_width(plane_load, prob_size) ||
      frame_cap % 16 || plane_cap % 16 || frame_cap < W * 3 * frame_size + 2 * frame_load ||
      plane_cap < W * prob_size + 2 * plane_load)
    return (int)cudaErrorInvalidValue;
  const char* b = static_cast<const char*>(yxhw);
#define IVOSW_LAUNCH(F, P)                                                                \
  launch<F, P>(out_bf16, frames, probs, T, planes_per_frame, obj_offset, num_objects, H, W, \
               S, b, box_stride0, box_stride1, box_bf16, frame_load, plane_load, frame_cap, \
               plane_cap, out, st)
  if (frames_bf16 && probs_bf16) return IVOSW_LAUNCH(bf16, bf16);
  if (frames_bf16) return IVOSW_LAUNCH(bf16, float);
  if (probs_bf16) return IVOSW_LAUNCH(float, bf16);
  return IVOSW_LAUNCH(float, float);
#undef IVOSW_LAUNCH
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
