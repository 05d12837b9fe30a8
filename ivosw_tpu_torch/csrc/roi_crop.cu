// ROI crop with given boxes for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel roi_crop_pallas (ivosw_tpu/kernels/roi_pallas.py:67;
// body _kernel :36), which AssessNet training reaches through roi_crop_best
// (:233) from assess_forward.
//
// What it computes: for every image b of a batch and its box
// (ymin, ymax, xmin, xmax), the S x S align_corners bilinear crop of all C
// channels, zeros outside the image. Output row i samples at
// cy = ymin + (ymax - ymin) * (i / (S - 1)), column j at the same formula in x;
// each tap s weighs max(0, 1 - |c - s|). Input NHWC [B, H, W, C] f32, output
// NHWC [B, S, S, C] f32.
//
// Bound: memory bandwidth. At B=32, 480x854, C=4, S=256 the kernel writes
// 32*256^2*4*4 B = 33.6 MB and reads only the input pixels its taps touch
// (about 0.6 MB for a 192 px box, at most the whole 6.6 MB frame): about
// 0.015-0.07 ms at 3.35 TB/s. It does 4 taps x C channels of multiply-adds
// per output pixel, far below the card's rate.
//
// Design: the TPU kernel builds dense interpolation matrices Ry [S, H] and
// Rx [S, W] and runs two matrix products per channel, spending 2*S*H*W
// multiply-adds per channel almost all on zeros. Here each row of Ry/Rx has
// at most two non-zero taps, floor(c) and floor(c)+1, so an output pixel is a
// 2 x 2 gather over its C channels. One block per (output row, image); its
// threads walk the output columns. Sums run in f32 with rows contracted first
// (Ry @ img, then @ Rx^T) as the reference does; the file is built with
// --fmad=false, so the coordinates round after every operation in the JAX
// op order. The NHWC input is read in place: the TPU wrapper's NCHW
// transpose was a TPU layout choice.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// Taps of one output coordinate: the first source index and the weights of
// it and its successor. Coordinates far outside the image are pulled in to
// just outside it before the int cast, where both taps are dropped anyway.
struct Taps {
  int first;
  float w[2];
};

__device__ __forceinline__ Taps taps(float lo, float hi, int k, float denom, int n) {
  const float c = lo + (hi - lo) * ((float)k / denom);
  const float f = floorf(c);
  Taps t;
  t.w[0] = fmaxf(0.0f, 1.0f - fabsf(c - f));
  t.w[1] = fmaxf(0.0f, 1.0f - fabsf(c - (f + 1.0f)));
  t.first = (int)fminf(fmaxf(f, -2.0f), (float)n + 1.0f);
  return t;
}

__global__ void __launch_bounds__(kThreads) crop_kernel(
    const float* __restrict__ images, int H, int W, int C, int S,
    const float* __restrict__ boxes, float* __restrict__ out) {
  const int i = blockIdx.x;  // output row
  const int b = blockIdx.y;  // image
  const float* box = boxes + (int64_t)b * 4;
  const float denom = (float)(S - 1);
  const Taps ty = taps(box[0], box[1], i, denom, H);
  const float* img = images + (int64_t)b * H * W * C;
  float* orow = out + ((int64_t)b * S + i) * S * C;

  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    const Taps tx = taps(box[2], box[3], j, denom, W);
    float* o = orow + (int64_t)j * C;
    for (int ch = 0; ch < C; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int x = tx.first + dx;
        if (x < 0 || x >= W) continue;
        float col = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int y = ty.first + dy;
          if (y < 0 || y >= H) continue;
          col += ty.w[dy] * img[((int64_t)y * W + x) * C + ch];
        }
        acc += tx.w[dx] * col;
      }
      o[ch] = acc;
    }
  }
}

}  // namespace

extern "C" int ivosw_roi_crop(const void* images, int B, int H, int W, int C,
                              int S, const void* boxes, void* out, void* stream) {
  if (B == 0) return 0;
  const dim3 grid(S, B);
  crop_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(images), H, W, C, S,
      static_cast<const float*>(boxes), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* ivosw_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
