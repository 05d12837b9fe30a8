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
// is 0.125 ms at the card's 989 TFLOP/s dense bf16 rate.
//
// bf16 working type: tensor cores. Both stages are batched products on
// mma.sync.m16n8k16 (bf16 operands, float32 accumulators; a bf16 x bf16
// product is exact in float32, so only the order of the sums differs from
// the plain version). A block of 8 warps computes a 128 x 128 tile, 32 deep
// per step, each warp a 64 x 32 sub-tile (4 x 4 fragments) whose operands
// come from shared memory through ldmatrix. A 3-stage ring of cp.async
// copies keeps two k-steps of A and B in flight while the third is
// multiplied; operands stay bf16 in shared memory, with rows padded by 16
// bytes so that ldmatrix reads no bank twice. Each thread works out where
// its copies come from once, before the loop (KCopy, NCopy).
//   Stage 1 reads frame t, NHWC, as one row-major [H, 3W] matrix (B, its n
//   contiguous: ldmatrix.trans), so one product Ry[i] @ frame_t gives all
//   three colour channels; the plane is a second B of width W. Tiles of
//   the two kinds share one grid. The epilogue rounds the tile to bf16 in
//   shared memory and writes it planar to tmp[i, c, S, ldt], a scratch
//   whose row stride ldt is W rounded up to 8 (16-byte rows). A frame tile
//   keeps 120 of its 128 columns, 40 whole pixels: 8 pixels x 3 colours
//   (48 bytes) then become three 16-byte stores, one per colour plane,
//   de-interleaved with byte permutes.
//   Stage 2 multiplies [4 channels x 32 rows of tmp] (A) by 128 rows of
//   Rx[i] (B, k contiguous: the .col operand, read once for all four
//   channels), so each thread holds all four channels of its pixels and
//   stores them NHWC, 16 bytes at a time.
// Alignment: rows of 854 bf16 values (1708 bytes) or 3*854 (5124 bytes)
// and planes at odd multiples of H*W are only 4-byte aligned, so an operand
// the caller gives is copied in 16-byte pieces when its base and row stride
// allow it (the scratch always does; Ry at H=480 does) and in 4-byte pieces
// otherwise; the wrapper pads odd H or W to even with zeros and copies a
// tensor that starts off a 4-byte boundary. Copies past a row's end (the K
// tail: K = 480, then 854, neither a multiple of 32) or past the last row
// (S = 32 or 64 against 128-row tiles; W against 128 columns) read nothing
// and zero-fill (cp.async's source size); stores past the edges are masked.
//
// float32 working type: the SIMT tiled product of the first port (64 x 64
// tiles, 16 deep, 4 x 4 outputs per thread with __fmaf_rn, operands staged
// as float32). The TPU kernel runs float32 at Precision.HIGHEST; TF32 tensor
// cores keep a 10-bit mantissa and would not match it.
//
// Measured (chip_smoke.py's kernel_roi_crop_pairs_premat, T=32, O=3,
// 480x854, S=256, bf16, on NVIDIA H100 80GB HBM3 at a 700.00 W limit):
// 0.632-0.638 ms, 194-195 TFLOP/s, a fifth of the operation bound; stage 1
// 0.430 ms, stage 2 0.199 ms; torch.bmm of the two stages 0.658-0.663 ms.
// The SIMT bf16 path it replaces took 6.640 ms. Details in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------ float32 working type (SIMT) --
constexpr int kTile = 64;
constexpr int kDepth = 16;
constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// One 64 x 64 tile of C = A @ B (element strides given) in float32.
template <typename AT, typename BT>
__device__ __forceinline__ void gemm_tile(
    const AT* __restrict__ A, int64_t a_m, int64_t a_k,
    const BT* __restrict__ B, int64_t b_k, int64_t b_n,
    float* __restrict__ C, int64_t c_m, int64_t c_n, int M, int N, int K) {
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
      As[ka][ma] = (m < M && k < K) ? ld(A + m * a_m + k * a_k) : 0.0f;
      // B: n fastest when its columns are the short stride, else k fastest
      int kb, nb;
      if (b_n <= b_k) {
        nb = e % kTile; kb = e / kTile;
      } else {
        kb = e % kDepth; nb = e / kDepth;
      }
      const int n = n0 + nb, kk = k0 + kb;
      Bs[kb][nb] = (n < N && kk < K) ? ld(B + kk * b_k + n * b_n) : 0.0f;
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
      if (n < N) C[m * c_m + n * c_n] = acc[i][j];
    }
  }
}

// stage 1: tmp[z] = Ry[pair] @ img_c, z = pair * 4 + c
template <typename FrameT, typename ProbT>
__global__ void __launch_bounds__(kThreads) rows_kernel(
    const float* __restrict__ ry, const FrameT* __restrict__ frames,
    const ProbT* __restrict__ probs, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, int S, float* __restrict__ tmp) {
  const int z = blockIdx.z;
  const int pair = z / 4, c = z % 4;
  const int t = pair / num_objects, o = pair - t * num_objects;
  const float* a = ry + (int64_t)pair * S * H;
  float* out = tmp + (int64_t)z * S * W;
  if (c < 3) {
    const FrameT* img = frames + (int64_t)t * H * W * 3 + c;
    gemm_tile(a, H, 1, img, (int64_t)W * 3, 3, out, W, 1, S, W, H);
  } else {
    const ProbT* img = probs + ((int64_t)t * planes_per_frame + obj_offset + o) * (int64_t)H * W;
    gemm_tile(a, H, 1, img, W, 1, out, W, 1, S, W, H);
  }
}

// stage 2: out[pair, :, :, c] = tmp[z] @ Rx[pair]^T
__global__ void __launch_bounds__(kThreads) cols_kernel(
    const float* __restrict__ tmp, const float* __restrict__ rx, int W, int S,
    float* __restrict__ out) {
  const int z = blockIdx.z;
  const int pair = z / 4, c = z % 4;
  gemm_tile(tmp + (int64_t)z * S * W, W, 1, rx + (int64_t)pair * S * W, 1, W,
            out + (int64_t)pair * S * S * 4 + c, (int64_t)S * 4, 4, S, S, W);
}

template <typename FrameT, typename ProbT>
int launch_f32(const void* ry, const void* rx, const void* frames, const void* probs, int T,
               int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
               void* tmp, void* out, cudaStream_t st) {
  const int z = T * num_objects * 4;
  const dim3 grid1((W + kTile - 1) / kTile, (S + kTile - 1) / kTile, z);
  rows_kernel<FrameT, ProbT><<<grid1, kThreads, 0, st>>>(
      static_cast<const float*>(ry), static_cast<const FrameT*>(frames),
      static_cast<const ProbT*>(probs), planes_per_frame, obj_offset, num_objects, H, W,
      S, static_cast<float*>(tmp));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((S + kTile - 1) / kTile, (S + kTile - 1) / kTile, z);
  cols_kernel<<<grid2, kThreads, 0, st>>>(static_cast<const float*>(tmp),
                                          static_cast<const float*>(rx), W, S,
                                          static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------- bf16 working type (tensor cores) --
constexpr int kBM = 128;          // tile rows (stage 2: 4 channels x 32 rows)
constexpr int kBN = 128;          // tile columns
constexpr int kBK = 32;           // depth of one pipeline step
constexpr int kStages = 3;        // cp.async ring
constexpr int kMmaThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kRows2 = kBM / 4;   // stage 2: output rows per tile
constexpr int kFramePixels = 40;  // stage 1: a frame tile writes 3 x 40 of its 128 columns
constexpr int kLdK = kBK + 8;     // shared row of a k-contiguous tile (+16 bytes)
constexpr int kLdN = kBN + 8;     // shared row of an n-contiguous tile (272 bytes)
constexpr int kATile = kBM * kLdK;
constexpr int kBTileKN = kBK * kLdN;  // stage 1 B: [k][n]
constexpr int kBTileNK = kBN * kLdK;  // stage 2 B: [n][k]
constexpr int kSmem1 = kStages * (kATile + kBTileKN) * 2;
constexpr int kSmem2 = kStages * (kATile + kBTileNK) * 2;
static_assert(kBM * kLdN * 2 <= kSmem1, "stage 1 epilogue tile fits the ring");
static_assert(3 * kFramePixels <= kBN && kFramePixels % 8 == 0, "frame tile chunks");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` bytes (0 reads nothing) into a 16- or 4-byte piece of
// shared memory, zero-filling the rest of the piece
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(bf16* dst, const bf16* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a @ b for one m16n8k16 fragment
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// How the 256 threads share the copies of a ROWS x COLS tile: pieces of
// kVec values (16 bytes, or 4 when rows are only 4-byte aligned); a
// thread's piece i is tile row row0() + i * kRowStep at column col().
template <int ROWS, int COLS, bool VEC16>
struct Pieces {
  static constexpr int kVec = VEC16 ? 8 : 2;
  static constexpr int kPerRow = COLS / kVec;
  static constexpr int kRowStep = kMmaThreads / kPerRow;
  static constexpr int kCount = ROWS / kRowStep;
  static_assert(kMmaThreads % kPerRow == 0 && ROWS % kRowStep == 0, "whole rounds");
  __device__ static int row0() { return threadIdx.x / kPerRow; }
  __device__ static int col() { return threadIdx.x % kPerRow * kVec; }
  __device__ static void copy(bf16* dst, const bf16* src, int bytes) {
    if (VEC16)
      cp_async16(dst, src, bytes);
    else
      cp_async4(dst, src, bytes);
  }
};

// A thread's copies of a [ROWS][kBK] tile whose rows are fixed and whose
// columns (k) advance by kBK a step; the rows of its pieces are evenly
// spaced in memory. Columns at or past K read nothing and are zero-filled.
template <int ROWS, bool VEC16>
struct KCopy {
  using P = Pieces<ROWS, kBK, VEC16>;
  const bf16* src;   // piece 0 at k = 0
  int64_t step;      // elements between consecutive pieces' rows
  uint32_t rows_in;  // bit i: piece i's row lies in the matrix
  int col, dst;

  // row_ptr(r): tile row r's start in memory; row_in(r): it exists
  template <typename RowPtr, typename RowIn>
  __device__ KCopy(RowPtr row_ptr, RowIn row_in) {
    const int r0 = P::row0();
    col = P::col();
    src = row_ptr(r0) + col;
    step = P::kCount > 1 ? row_ptr(r0 + P::kRowStep) - row_ptr(r0) : 0;
    dst = r0 * kLdK + col;
    rows_in = 0;
#pragma unroll
    for (int i = 0; i < P::kCount; ++i) rows_in |= uint32_t(row_in(r0 + i * P::kRowStep)) << i;
  }
  __device__ void issue(bf16* tile, int k0, int K, const bf16* any) const {
    const int n = min(max(K - k0 - col, 0), P::kVec);
#pragma unroll
    for (int i = 0; i < P::kCount; ++i) {
      const bool in = (rows_in >> i & 1) && n > 0;
      P::copy(tile + dst + i * P::kRowStep * kLdK, in ? src + i * step + k0 : any,
              in ? 2 * n : 0);
    }
  }
};

// A thread's copies of a [kBK][kBN] tile of a row-major matrix whose rows
// (k) advance by kBK a step, columns n0 .. n0 + kBN - 1 of which those
// below N exist. Rows at or past K read nothing and are zero-filled.
template <bool VEC16>
struct NCopy {
  using P = Pieces<kBK, kBN, VEC16>;
  const bf16* src;  // piece 0 at k = 0
  int64_t ld;
  int row0, bytes, dst;

  __device__ NCopy(const bf16* b, int64_t ld_, int n0, int N) : ld(ld_) {
    row0 = P::row0();
    const int col = P::col();
    src = b + row0 * ld + n0 + col;
    bytes = 2 * min(max(N - n0 - col, 0), P::kVec);
    dst = row0 * kLdN + col;
  }
  __device__ void issue(bf16* tile, int k0, int K, const bf16* any) const {
#pragma unroll
    for (int i = 0; i < P::kCount; ++i) {
      const bool in = k0 + row0 + i * P::kRowStep < K && bytes > 0;
      P::copy(tile + dst + i * P::kRowStep * kLdN,
              in ? src + (k0 + i * P::kRowStep) * ld : any, in ? bytes : 0);
    }
  }
};

// The pipelined product of one block: load(stage, kt) issues k-step kt's
// copies of A ([m][k] tiles, kLdK) and B ([k][n] tiles, kLdN, when B_KN;
// else [n][k], kLdK) into ring slot `stage`. The warp accumulates its
// 4 x 4 fragments: fragment row i starts at A tile row a_row0 + i * a_step,
// fragment column j at B tile column b_col0 + 8 * j.
template <bool B_KN, typename Load>
__device__ __forceinline__ void mma_mainloop(float (&acc)[4][4][4], const bf16* sA,
                                             const bf16* sB, int K, Load load, int a_row0,
                                             int a_step, int b_col0) {
  constexpr int kBTile = B_KN ? kBTileKN : kBTileNK;
  const int lane = threadIdx.x % 32;
  const int ksteps = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ksteps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread; slot kt-1 is free
    const int next = kt + kStages - 1;
    if (next < ksteps) load(next % kStages, next);
    cp_async_commit();
    const bf16* tA = sA + (kt % kStages) * kATile;
    const bf16* tB = sB + (kt % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(fa[i], tA + (a_row0 + i * a_step + lane % 16) * kLdK + kk + lane / 16 * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t r[4];
        const int n = b_col0 + jj * 16;
        if (B_KN)
          ldsm_x4_trans(r, tB + (kk + lane % 16) * kLdN + n + lane / 16 * 8);
        else
          ldsm_x4(r, tB + (n + lane / 16 * 8 + lane % 8) * kLdK + kk + lane / 8 % 2 * 8);
        fb[2 * jj][0] = r[0];
        fb[2 * jj][1] = r[1];
        fb[2 * jj + 1][0] = r[2];
        fb[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], fa[i], fb[j][0], fb[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may be reused by the epilogue
}

// 16-bit half `e % 2` of word e / 2 of `w`, as byte-permute selector nibbles
__host__ __device__ constexpr uint32_t half_sel(int e, int base) {
  return e % 2 ? (base + 2) | (base + 3) << 4 : base | (base + 1) << 4;
}

// stage 1: grid (frame tiles + plane tiles, S tiles, pairs). Frame tile j
// multiplies Ry[pair] by columns 120 j .. 120 j + 127 of frame_t ([H, 3W],
// colours interleaved) and writes the first 120 (pixels 40 j .. 40 j + 39,
// all three colours); plane tile j writes columns 128 j .. 128 j + 127 of
// Ry[pair] @ plane. Both go planar into tmp[pair, c, S, ldt].
template <bool RY16, bool B16>
__global__ void __launch_bounds__(kMmaThreads, 2) rows_mma_kernel(
    const bf16* __restrict__ ry, const bf16* __restrict__ frames,
    const bf16* __restrict__ probs, int planes_per_frame, int obj_offset, int num_objects,
    int H, int W, int S, int frame_tiles, bf16* __restrict__ tmp, int ldt) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kATile;
  const int pair = blockIdx.z;
  const int t = pair / num_objects, o = pair - t * num_objects;
  const int m0 = blockIdx.y * kBM;
  const bool frame_tile = blockIdx.x < frame_tiles;
  const int n0 = frame_tile ? blockIdx.x * 3 * kFramePixels : (blockIdx.x - frame_tiles) * kBN;
  const int ldb = frame_tile ? 3 * W : W;
  const bf16* a = ry + (int64_t)pair * S * H;
  const bf16* b = frame_tile
                      ? frames + (int64_t)t * H * 3 * W
                      : probs + ((int64_t)t * planes_per_frame + obj_offset + o) * H * W;

  const KCopy<kBM, RY16> copy_a([&](int r) { return a + (int64_t)(m0 + r) * H; },
                                [&](int r) { return m0 + r < S; });
  const NCopy<B16> copy_b(b, ldb, n0, ldb);
  auto load = [&](int stage, int kt) {
    copy_a.issue(sA + stage * kATile, kt * kBK, H, a);
    copy_b.issue(sB + stage * kBTileKN, kt * kBK, H, b);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
  mma_mainloop<true>(acc, sA, sB, H, load, wm * 64, 16, wn * 32);

  // round to bf16 into a [128][kLdN] tile of shared memory
  bf16* sC = sA;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 64 + i * 16 + g, c = wn * 32 + j * 8 + 2 * q;
      *reinterpret_cast<uint32_t*>(sC + r * kLdN + c) = pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(sC + (r + 8) * kLdN + c) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  bf16* out = tmp + (int64_t)pair * 4 * S * ldt;
  if (!frame_tile) {  // plane: 16-byte pieces of tmp[pair, 3] (columns >= W are zeros)
    out += (int64_t)3 * S * ldt;
    for (int e = threadIdx.x; e < kBM * kBN / 8; e += kMmaThreads) {
      const int r = e / (kBN / 8), c = e % (kBN / 8) * 8;
      const int m = m0 + r, n = n0 + c;
      if (m < S && n < W)
        *reinterpret_cast<uint4*>(out + (int64_t)m * ldt + n) =
            *reinterpret_cast<const uint4*>(sC + r * kLdN + c);
    }
    return;
  }
  // frame: 8 pixels x 3 colours (48 bytes) of a row become three 16-byte
  // pieces, one per colour plane (pixels >= W past the row's end are zeros)
  constexpr int kChunks = kFramePixels / 8;
  const int w0 = blockIdx.x * kFramePixels;
  for (int e = threadIdx.x; e < kBM * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, w = w0 + e % kChunks * 8, m = m0 + r;
    if (m >= S || w >= W) continue;
    const uint4* src = reinterpret_cast<const uint4*>(sC + r * kLdN + 3 * (w - w0));
    uint32_t v[12];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint4 x = src[i];
      v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z, v[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      uint32_t p[4];  // pixels 2j, 2j + 1 of colour c: values 6j + c and 6j + 3 + c
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e0 = 6 * j + c, e1 = e0 + 3;
        p[j] = __byte_perm(v[e0 / 2], v[e1 / 2], half_sel(e0, 0) | half_sel(e1, 4) << 8);
      }
      *reinterpret_cast<uint4*>(out + ((int64_t)c * S + m) * ldt + w) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
}

// stage 2: grid (S/128 output columns, S/32 output rows, pairs). The A tile
// is 4 channels x 32 rows of tmp[pair]; warp (wm, wn) holds rows
// 16 wm .. 16 wm + 15 of every channel, columns 32 wn .. 32 wn + 31.
template <bool RX16>
__global__ void __launch_bounds__(kMmaThreads, 2) cols_mma_kernel(
    const bf16* __restrict__ tmp, int ldt, const bf16* __restrict__ rx, int W, int S,
    bf16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + kStages * kATile;
  const int pair = blockIdx.z;
  const int x0 = blockIdx.x * kBN, s0 = blockIdx.y * kRows2;
  const bf16* a = tmp + (int64_t)pair * 4 * S * ldt;
  const bf16* b = rx + (int64_t)pair * S * W;

  static_assert(Pieces<kBM, kBK, true>::kRowStep % kRows2 == 0,
                "a thread's A pieces share one row of tmp's channels");
  const KCopy<kBM, true> copy_a(
      [&](int r) { return a + ((int64_t)(r / kRows2) * S + s0 + r % kRows2) * ldt; },
      [&](int r) { return s0 + r % kRows2 < S; });
  const KCopy<kBN, RX16> copy_b([&](int r) { return b + (int64_t)(x0 + r) * W; },
                                [&](int r) { return x0 + r < S; });
  auto load = [&](int stage, int kt) {
    copy_a.issue(sA + stage * kATile, kt * kBK, W, a);
    copy_b.issue(sB + stage * kBTileNK, kt * kBK, W, b);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
  mma_mainloop<false>(acc, sA, sB, W, load, wm * 16, kRows2, wn * 32);

  // fragment i is channel i: a thread holds the 4 channels of pixels
  // (s, x) and (s, x + 1), 16 bytes of the NHWC output
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = s0 + wm * 16 + g + 8 * h;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + wn * 32 + j * 8 + 2 * q;
      if (x >= S) continue;
      const uint2 p0 = make_uint2(pack_bf16(acc[0][j][2 * h], acc[1][j][2 * h]),
                                  pack_bf16(acc[2][j][2 * h], acc[3][j][2 * h]));
      const uint2 p1 = make_uint2(pack_bf16(acc[0][j][2 * h + 1], acc[1][j][2 * h + 1]),
                                  pack_bf16(acc[2][j][2 * h + 1], acc[3][j][2 * h + 1]));
      bf16* dst = out + (((int64_t)pair * S + s) * S + x) * 4;
      if (x + 1 < S && S % 2 == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(p0.x, p0.y, p1.x, p1.y);
      } else {
        *reinterpret_cast<uint2*>(dst) = p0;
        if (x + 1 < S) *reinterpret_cast<uint2*>(dst + 4) = p1;
      }
    }
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

// launches `kernel` with `smem` bytes of dynamic shared memory
template <typename... Params, typename... Args>
int launch_mma(void (*kernel)(Params...), dim3 grid, int smem, cudaStream_t st,
               Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kMmaThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

int launch_bf16(const bf16* ry, const bf16* rx, const bf16* frames, const bf16* probs, int T,
                int planes_per_frame, int obj_offset, int num_objects, int H, int W, int S,
                bf16* tmp, int ldt, bf16* out, cudaStream_t st) {
  // the wrapper's guarantees: even H and W, 4-byte aligned operands, a
  // 16-byte aligned scratch with rows of ldt (a multiple of 8, >= W) values
  if (H % 2 || W % 2 || ldt % 8 || ldt < W || !aligned(tmp, 16) || !aligned(ry, 4) ||
      !aligned(rx, 4) || !aligned(frames, 4) || !aligned(probs, 4))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies where the base and the row stride allow them
  const bool ry16 = aligned(ry, 16) && H % 8 == 0;
  const bool b16 = aligned(frames, 16) && aligned(probs, 16) && W % 8 == 0;
  const bool rx16 = aligned(rx, 16) && W % 8 == 0;
  const int pairs = T * num_objects;
  const int frame_tiles = (W + kFramePixels - 1) / kFramePixels;
  const dim3 grid1(frame_tiles + (W + kBN - 1) / kBN, (S + kBM - 1) / kBM, pairs);
  auto rows = ry16 ? (b16 ? rows_mma_kernel<true, true> : rows_mma_kernel<true, false>)
                   : (b16 ? rows_mma_kernel<false, true> : rows_mma_kernel<false, false>);
  int err = launch_mma(rows, grid1, kSmem1, st, ry, frames, probs, planes_per_frame, obj_offset,
                       num_objects, H, W, S, frame_tiles, tmp, ldt);
  if (err != 0) return err;
  const dim3 grid2((S + kBN - 1) / kBN, (S + kRows2 - 1) / kRows2, pairs);
  return launch_mma(rx16 ? cols_mma_kernel<true> : cols_mma_kernel<false>, grid2, kSmem2, st,
                    static_cast<const bf16*>(tmp), ldt, rx, W, S, out);
}

}  // namespace

// ry [T*O, S, H], rx [T*O, S, W] in the working type; tmp [T*O, 4, S, tmp_ld]
// scratch in the working type; out NHWC [T*O, S, S, 4] in the working type.
// A bf16 working type takes bf16 frames and probs only (the wrapper rounds
// float32 ones), even H and W, and tmp_ld a multiple of 8; float32 takes
// either input type and tmp_ld == W.
extern "C" int ivosw_roi_crop_pairs_premat(
    const void* ry, const void* rx, const void* frames, const void* probs,
    int frames_bf16, int probs_bf16, int T, int planes_per_frame, int obj_offset,
    int num_objects, int H, int W, int S, void* tmp, int tmp_ld, void* out, int work_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T * num_objects == 0) return 0;
  if (work_bf16) {
    if (!frames_bf16 || !probs_bf16) return (int)cudaErrorInvalidValue;
    return launch_bf16(static_cast<const bf16*>(ry), static_cast<const bf16*>(rx),
                       static_cast<const bf16*>(frames), static_cast<const bf16*>(probs), T,
                       planes_per_frame, obj_offset, num_objects, H, W, S,
                       static_cast<bf16*>(tmp), tmp_ld, static_cast<bf16*>(out), st);
  }
  if (tmp_ld != W) return (int)cudaErrorInvalidValue;
  if (frames_bf16 && probs_bf16)
    return launch_f32<bf16, bf16>(ry, rx, frames, probs, T, planes_per_frame, obj_offset,
                                  num_objects, H, W, S, tmp, out, st);
  if (frames_bf16)
    return launch_f32<bf16, float>(ry, rx, frames, probs, T, planes_per_frame, obj_offset,
                                   num_objects, H, W, S, tmp, out, st);
  if (probs_bf16)
    return launch_f32<float, bf16>(ry, rx, frames, probs, T, planes_per_frame, obj_offset,
                                   num_objects, H, W, S, tmp, out, st);
  return launch_f32<float, float>(ry, rx, frames, probs, T, planes_per_frame, obj_offset,
                                  num_objects, H, W, S, tmp, out, st);
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
