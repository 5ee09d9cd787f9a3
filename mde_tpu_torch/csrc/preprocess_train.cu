// The train step's image pipeline in one pass: uint8 NHWC -> half-pixel
// bilinear resize -> colour jitter in each sample's own order -> ImageNet
// normalisation -> float32 NCHW.
//
// Replaces mde_tpu/ops/pallas_kernels.py::normalize_u8_fused (the u8 ->
// normalised map) together with the colour jitter that sits between the
// resize and that map on the train path, mde_tpu/ops/image.py::color_jitter
// (called from mde_tpu/data/transforms.py::preprocess_train). The jitter's
// draws are made on the host from the step's generator and handed over as
// one (B, 8) float32 row a sample: brightness, contrast, saturation and hue
// factors, then the sample's order of the four adjustments (0 brightness,
// 1 contrast, 2 saturation, 3 hue).
//
// What bounds it on an H100: memory. At batch 4, 426x560 -> 448x576 it reads
// 2.86 MB of uint8 and writes 12.4 MB of float32 (4.6 us at 3.35 TB/s); the
// arithmetic, a few hundred FLOP a pixel with the hue round trip, stays
// below that at the CUDA cores' 67 TFLOP/s.
//
// Design. Contrast blends each pixel with the mean grey of the image as it
// stands before contrast in that sample's order, which depends on the
// adjustments before it, so the pass runs as three launches, all
// deterministic (no atomics; the same bits run to run):
//   1. on a (chunks, B) grid, each thread recomputes its pixels from u8
//      (the bilinear taps, with the JAX rounding of the source coordinate),
//      applies the adjustments that come before contrast in the sample's
//      order, takes the grey, and the block writes one partial sum per chunk
//      of 1,024 pixels (a fixed-order tree in shared memory);
//   2. one block per sample adds its partials in a fixed order and divides
//      by the pixel count (K2's scheme, csrc/si_loss.cu);
//   3. one thread per output pixel recomputes it, applies all four
//      adjustments in the sample's order with that mean for contrast,
//      normalises and writes the three channel planes (coalesced along a row).
// No float intermediate goes to device memory: passes 1 and 3 read the u8
// image twice (from L2 the second time at this size) instead.
//
// The arithmetic follows the plain PyTorch version operation by operation:
// a clamp to [0, 1] after every blend, hue on the clamped image with
// floor-mod remainders, and every product and sum rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), since nvcc would fuse a
// product and a sum into one multiply-add that the plain version does not
// do (ROADMAP, Queue 3: the F.interpolate finding).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDraws = 8;     // fb, fc, fs, fh, order[4]
constexpr int kChunk = 1024;  // pixels a pass-1 block sums
constexpr int kReduceThreads = 256;
constexpr int kRowThreads = 128;

struct Geometry {
  int in_h, in_w, out_h, out_w;
  float scale_h, scale_w;
  float mean[3], std[3];
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// torch.remainder(x, 1.0): fmod, then shifted into [0, 1) if negative.
__device__ __forceinline__ float remainder1(float x) {
  const float r = fmodf(x, 1.f);
  return r < 0.f ? radd(r, 1.f) : r;
}

// Half-pixel source coordinate (dst + 0.5) * scale - 0.5, clamped at 0,
// with the multiply and the subtract each rounded, as the JAX reference.
__device__ __forceinline__ float source_index(float scale, int dst) {
  const float src = rsub(rmul(dst + 0.5f, scale), 0.5f);
  return src < 0.f ? 0.f : src;
}

__device__ __forceinline__ float u8_value(const uint8_t* p) {
  return rdiv(static_cast<float>(*p), 255.f);
}

// The resized pixel (oy, ox) of one image, rows blended first, then columns,
// as resize_half_pixel does.
__device__ __forceinline__ void resized_pixel(const uint8_t* img, const Geometry& g,
                                              int oy, int ox, float c[3]) {
  const float sy = source_index(g.scale_h, oy);
  const int y0 = min(static_cast<int>(sy), g.in_h - 1);
  const int y1 = min(y0 + 1, g.in_h - 1);
  const float wy = rsub(sy, static_cast<float>(y0));
  const float sx = source_index(g.scale_w, ox);
  const int x0 = min(static_cast<int>(sx), g.in_w - 1);
  const int x1 = min(x0 + 1, g.in_w - 1);
  const float wx = rsub(sx, static_cast<float>(x0));
  const float wy0 = rsub(1.f, wy);
  const float wx0 = rsub(1.f, wx);
  const uint8_t* r0 = img + static_cast<size_t>(y0) * g.in_w * 3;
  const uint8_t* r1 = img + static_cast<size_t>(y1) * g.in_w * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float left =
        radd(rmul(u8_value(r0 + x0 * 3 + ch), wy0), rmul(u8_value(r1 + x0 * 3 + ch), wy));
    const float right =
        radd(rmul(u8_value(r0 + x1 * 3 + ch), wy0), rmul(u8_value(r1 + x1 * 3 + ch), wy));
    c[ch] = radd(rmul(left, wx0), rmul(right, wx));
  }
}

__device__ __forceinline__ float gray(const float c[3]) {
  return radd(radd(rmul(c[0], 0.2989f), rmul(c[1], 0.587f)), rmul(c[2], 0.114f));
}

// clamp(ratio * a + (1 - ratio) * b, 0, 1)
__device__ __forceinline__ float blend(float a, float b, float ratio) {
  return clamp01(radd(rmul(ratio, a), rmul(rsub(1.f, ratio), b)));
}

__device__ __forceinline__ void adjust_hue(float c[3], float factor) {
  const float r = clamp01(c[0]);
  const float g = clamp01(c[1]);
  const float b = clamp01(c[2]);
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = rsub(maxc, minc);
  const float s = maxc > 0.f ? rdiv(delta, fmaxf(maxc, 1e-12f)) : 0.f;
  const float safe = delta > 0.f ? delta : 1.f;
  const float rc = rdiv(rsub(maxc, r), safe);
  const float gc = rdiv(rsub(maxc, g), safe);
  const float bc = rdiv(rsub(maxc, b), safe);
  float h = maxc == r ? rsub(bc, gc)
                      : (maxc == g ? rsub(radd(2.f, rc), bc) : rsub(radd(4.f, gc), rc));
  h = delta > 0.f ? remainder1(rdiv(h, 6.f)) : 0.f;
  h = remainder1(radd(h, factor));
  // HSV -> RGB with v = maxc
  const float v = maxc;
  const float h6 = rmul(h, 6.f);
  const float fi = floorf(h6);
  const float f = rsub(h6, fi);
  const float p = rmul(v, rsub(1.f, s));
  const float q = rmul(v, rsub(1.f, rmul(f, s)));
  const float t = rmul(v, rsub(1.f, rmul(rsub(1.f, f), s)));
  int i = static_cast<int>(fi) % 6;
  if (i < 0) i += 6;
  switch (i) {
    case 0: c[0] = v; c[1] = t; c[2] = p; break;
    case 1: c[0] = q; c[1] = v; c[2] = p; break;
    case 2: c[0] = p; c[1] = v; c[2] = t; break;
    case 3: c[0] = p; c[1] = q; c[2] = v; break;
    case 4: c[0] = t; c[1] = p; c[2] = v; break;
    default: c[0] = v; c[1] = p; c[2] = q; break;
  }
}

// One adjustment; contrast blends with ``mean``, the image's mean grey.
__device__ __forceinline__ void adjust(float c[3], int op, const float* d, float mean) {
  switch (op) {
    case 0:
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], 0.f, d[0]);
      break;
    case 1:
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], mean, d[1]);
      break;
    case 2: {
      const float gr = gray(c);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], gr, d[2]);
      break;
    }
    default:
      adjust_hue(c, d[3]);
  }
}

// Pass 1: per chunk of kChunk pixels, the sum of the grey of each pixel as
// it stands before contrast in its sample's order.
__global__ void gray_partial_kernel(const uint8_t* __restrict__ in,
                                    const float* __restrict__ draws,
                                    float* __restrict__ partial, Geometry g,
                                    int chunks) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const float* d = draws + b * kDraws;
  const uint8_t* img = in + static_cast<size_t>(b) * g.in_h * g.in_w * 3;
  const int n = g.out_h * g.out_w;
  const int end = min(n, (chunk + 1) * kChunk);
  float sum = 0.f;
  for (int idx = chunk * kChunk + threadIdx.x; idx < end; idx += kReduceThreads) {
    const int oy = idx / g.out_w;
    float c[3];
    resized_pixel(img, g, oy, idx - oy * g.out_w, c);
    for (int k = 0; k < 4; ++k) {
      const int op = static_cast<int>(d[4 + k]);
      if (op == 1) break;
      adjust(c, op, d, 0.f);
    }
    sum += gray(c);
  }
  __shared__ float red[kReduceThreads];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[static_cast<size_t>(b) * chunks + chunk] = red[0];
}

// Pass 2: one block a sample adds its partials in a fixed order.
__global__ void gray_mean_kernel(const float* __restrict__ partial,
                                 float* __restrict__ mean, int chunks, int n) {
  const int b = blockIdx.x;
  double sum = 0.0;
  for (int i = threadIdx.x; i < chunks; i += kReduceThreads) {
    sum += partial[static_cast<size_t>(b) * chunks + i];
  }
  __shared__ double red[kReduceThreads];
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) mean[b] = static_cast<float>(red[0] / n);
}

// Pass 3: every output pixel, all four adjustments in the sample's order,
// normalised, into the three channel planes.
__global__ void preprocess_train_kernel(const uint8_t* __restrict__ in,
                                        const float* __restrict__ draws,
                                        const float* __restrict__ mean,
                                        float* __restrict__ out, Geometry g) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= g.out_w) return;
  const float* d = draws + b * kDraws;
  float c[3];
  resized_pixel(in + static_cast<size_t>(b) * g.in_h * g.in_w * 3, g, oy, ox, c);
  const float m = mean[b];
  for (int k = 0; k < 4; ++k) adjust(c, static_cast<int>(d[4 + k]), d, m);
  const size_t plane = static_cast<size_t>(g.out_h) * g.out_w;
  float* o = out + static_cast<size_t>(b) * 3 * plane + static_cast<size_t>(oy) * g.out_w + ox;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * plane] = rdiv(rsub(c[ch], g.mean[ch]), g.std[ch]);
}

}  // namespace

// partial: (batch, ceil(out_h * out_w / 1024)) float32 scratch; mean: (batch,)
// float32 scratch; draws: (batch, 8) float32 on the device.
extern "C" int mde_preprocess_u8_train_f32(const uint8_t* in, const float* draws,
                                           float* partial, float* mean, float* out,
                                           int batch, int in_h, int in_w, int out_h,
                                           int out_w, float mean0, float mean1,
                                           float mean2, float std0, float std1,
                                           float std2, void* stream) {
  if (batch <= 0 || batch > 65535 || in_h <= 0 || in_w <= 0 || out_h <= 0 ||
      out_h > 65535 || out_w <= 0 ||
      static_cast<long long>(out_h) * out_w > 0x7fffffffLL - kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{in_h, in_w, out_h, out_w,
                   static_cast<float>(in_h) / static_cast<float>(out_h),
                   static_cast<float>(in_w) / static_cast<float>(out_w),
                   {mean0, mean1, mean2}, {std0, std1, std2}};
  const int n = out_h * out_w;
  const int chunks = (n + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gray_partial_kernel<<<dim3(chunks, batch), kReduceThreads, 0, s>>>(in, draws, partial, g,
                                                                      chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gray_mean_kernel<<<batch, kReduceThreads, 0, s>>>(partial, mean, chunks, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((out_w + kRowThreads - 1) / kRowThreads, out_h, batch);
  preprocess_train_kernel<<<grid, kRowThreads, 0, s>>>(in, draws, mean, out, g);
  return static_cast<int>(cudaGetLastError());
}
