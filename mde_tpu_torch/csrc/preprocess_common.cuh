// What K3's two forms (preprocess.cu, the eval form; preprocess_train.cu, the
// train form with the colour jitter) share: the half-pixel bilinear taps with
// the JAX rounding of the source coordinate, and the staging of the u8 source
// rows a block needs into shared memory.
//
// Staging. A block copies the contiguous byte range of its source rows into
// shared memory once, with 16-byte loads where the rows allow them (a row of
// 560 RGB pixels is 1,680 bytes, 105 such loads), so no thread gathers single
// bytes at stride 3 from device memory; the taps then read bytes from shared
// memory. Other row widths take byte loads, still coalesced. A shape whose
// rows do not fit the budget below reads its taps from device memory instead
// (``kStaged`` false in the kernels): the same function, chosen at launch.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mde_k3 {

// Dynamic shared memory a block may stage, below the 48 KB a launch gets
// without an opt-in attribute (the kernels add a little static memory).
constexpr int kStageBudget = 44 * 1024;

// Half-pixel source coordinate scale * (dst + 0.5) - 0.5, clamped at 0, with
// the multiply and the subtract each rounded, as in the JAX reference
// (mde_tpu/ops/resize.py::_interp_taps). F.interpolate fuses them into one
// multiply-add: near x = 256 that moves the coordinate by an ulp and the
// normalised output by up to 6e-5. The host computes the same value (to size
// the staging), with the product forced to float by a volatile store.
__host__ __device__ __forceinline__ float source_index(float scale, int dst) {
#ifdef __CUDA_ARCH__
  const float src = __fsub_rn(__fmul_rn(scale, dst + 0.5f), 0.5f);
#else
  volatile float prod = scale * (static_cast<float>(dst) + 0.5f);
  const float src = prod - 0.5f;
#endif
  return src < 0.f ? 0.f : src;
}

// One axis's taps: i0, i1 = min(i0 + 1, size - 1) and the weight of i1.
struct Tap {
  int i0, i1;
  float w1;
};

__host__ __device__ __forceinline__ Tap tap(float scale, int dst, int size) {
  const float s = source_index(scale, dst);
  Tap t;
  const int i = static_cast<int>(s);
  t.i0 = i < size - 1 ? i : size - 1;
  t.i1 = t.i0 + 1 < size - 1 ? t.i0 + 1 : size - 1;
#ifdef __CUDA_ARCH__
  t.w1 = __fsub_rn(s, static_cast<float>(t.i0));
#else
  t.w1 = s - static_cast<float>(t.i0);
#endif
  return t;
}

// The source rows from the first row tap of output row ``oy_first`` to the
// second of ``oy_last``.
__host__ __device__ __forceinline__ int source_rows(float scale_h, int in_h, int oy_first,
                                                    int oy_last, int* first) {
  const int y0 = tap(scale_h, oy_first, in_h).i0;
  if (first) *first = y0;
  return tap(scale_h, oy_last, in_h).i1 - y0 + 1;
}

// The most source rows any ``out_rows`` consecutive output rows need, in
// closed form, so the eval form sizes its staging on every launch without a
// walk over the bands: the first row taps of the two ends differ by at most
// floor((out_rows - 1) * scale) + 2 (floor of a difference, plus under an ulp
// of rounding at each end), and the last row adds its second tap and the
// first row itself.
inline int max_source_rows(float scale_h, int in_h, int out_rows) {
  const long long rows =
      static_cast<long long>((out_rows - 1) * static_cast<double>(scale_h)) + 4;
  return rows < in_h ? static_cast<int>(rows) : in_h;
}

// Exact uint8 -> float: the byte as the low mantissa bits of 2^23, minus 2^23.
__device__ __forceinline__ float u8f(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4b000000u | v), 8388608.f);
}

// Block-wide copy of ``bytes`` bytes from ``src`` to shared ``dst``: 16 bytes
// a thread a step where ``vec`` (``src`` 16-byte aligned), else one.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src, int bytes,
                                      bool vec) {
  if (vec) {
    const int n16 = bytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) d[i] = __ldg(s + i);
    for (int i = (n16 << 4) + threadIdx.x; i < bytes; i += blockDim.x) dst[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

}  // namespace mde_k3
