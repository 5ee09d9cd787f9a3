// uint8 NHWC image batch -> half-pixel bilinear resize -> ImageNet
// normalisation -> float32 NCHW, in one pass.
//
// Replaces mde_tpu/ops/pallas_kernels.py::normalize_u8_fused (its body is
// _normalize_kernel: u8 * 1/(255*std) - mean/std per channel) and folds in the
// resize that precedes that map on the serving path
// (mde_tpu/data/transforms.py::preprocess_eval): half-pixel source
// coordinates computed as the JAX reference computes them
// (mde_tpu/ops/resize.py::_interp_taps), clamped at 0, four taps blended in
// float32.
//
// What bounds it on an H100: memory. Per 426x560 -> 448x576 image it reads
// 0.7 MB of uint8 and writes 3.1 MB of float32 (at batch 4, 4.6 us at 3.35
// TB/s), with a few dozen operations an output pixel.
//
// Design. One block covers a band of output rows of one image. It stages the
// few source rows the band needs in shared memory with 16-byte loads
// (preprocess_common.cuh), so no thread gathers bytes at stride 3 from device
// memory. Each thread owns 4 adjacent output pixels of a row: their column
// taps are computed once and kept for the band's rows, the taps' bytes come
// from shared memory, and each channel plane takes one 16-byte store. The
// blend runs on the u8 values (the weights sum to 1) and the normalisation is
// the TPU kernel's own form, one multiply-add a channel with 1/(255 std) and
// -mean/std: no division a pixel. The band height is chosen at launch so that
// even one image (serving bucket 1, 448 rows) spreads over several blocks an
// SM. Widths that are not a multiple of 4 store value by value, and rows
// that are not a multiple of 16 bytes stage byte by byte: the same function,
// chosen at launch from the shape.

#include "preprocess_common.cuh"

namespace {

using mde_k3::Tap;

constexpr int kMaxThreads = 256;
constexpr int kMaxBand = 8;

struct EvalArgs {
  int in_h, in_w, out_h, out_w, row_bytes;
  int quads;        // 4-pixel groups a row, the last one ragged where out_w % 4 != 0
  int band;         // output rows a block
  int stage_bytes;  // shared memory for the staged rows (0: taps from device memory)
  int vec_load, vec_store;
  float scale_h, scale_w;
  float mul[3], add[3];  // 1/(255 std), -mean/std
};

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads)
    preprocess_u8_kernel(const uint8_t* __restrict__ in, float* __restrict__ out,
                         const EvalArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.y;
  const int oy_first = blockIdx.x * a.band;
  const int oy_end = min(a.out_h, oy_first + a.band);
  const uint8_t* img = in + static_cast<size_t>(b) * a.in_h * a.row_bytes;
  const uint8_t* src = img;
  int y_base = 0;
  if constexpr (kStaged) {
    const int rows = mde_k3::source_rows(a.scale_h, a.in_h, oy_first, oy_end - 1, &y_base);
    if (rows * a.row_bytes > a.stage_bytes) __trap();  // the host sized it; never taken
    mde_k3::stage(smem, img + static_cast<size_t>(y_base) * a.row_bytes, rows * a.row_bytes,
                  a.vec_load);
    __syncthreads();
    src = smem;
  }
  const size_t plane = static_cast<size_t>(a.out_h) * a.out_w;
  float* out_img = out + static_cast<size_t>(b) * 3 * plane;
  for (int cq = threadIdx.x; cq < a.quads; cq += blockDim.x) {
    const int ox = cq * 4;
    int x0[4], x1[4];
    float wx0[4], wx1[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const Tap t = mde_k3::tap(a.scale_w, min(ox + p, a.out_w - 1), a.in_w);
      x0[p] = t.i0 * 3;
      x1[p] = t.i1 * 3;
      wx1[p] = t.w1;
      wx0[p] = 1.f - t.w1;
    }
    for (int oy = oy_first; oy < oy_end; ++oy) {
      const Tap ty = mde_k3::tap(a.scale_h, oy, a.in_h);
      const uint8_t* r0 = src + static_cast<size_t>(ty.i0 - y_base) * a.row_bytes;
      const uint8_t* r1 = src + static_cast<size_t>(ty.i1 - y_base) * a.row_bytes;
      const float wy0 = 1.f - ty.w1;
      float v[3][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float left =
              mde_k3::u8f(r0[x0[p] + ch]) * wy0 + mde_k3::u8f(r1[x0[p] + ch]) * ty.w1;
          const float right =
              mde_k3::u8f(r0[x1[p] + ch]) * wy0 + mde_k3::u8f(r1[x1[p] + ch]) * ty.w1;
          v[ch][p] = fmaf(left * wx0[p] + right * wx1[p], a.mul[ch], a.add[ch]);
        }
      }
      float* o = out_img + static_cast<size_t>(oy) * a.out_w + ox;
      if (a.vec_store) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          *reinterpret_cast<float4*>(o + ch * plane) =
              make_float4(v[ch][0], v[ch][1], v[ch][2], v[ch][3]);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (ox + p < a.out_w) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) o[ch * plane + p] = v[ch][p];
          }
        }
      }
    }
  }
}

// Shared memory for the source rows of a band of ``band`` output rows.
long long stage_bytes_for(const EvalArgs& a, int band) {
  return static_cast<long long>(mde_k3::max_source_rows(a.scale_h, a.in_h, band)) * a.row_bytes;
}

// The geometry of a shape: scales, source row bytes and 4-wide output quads.
EvalArgs shape_args(int in_h, int in_w, int out_h, int out_w) {
  EvalArgs a{};
  a.in_h = in_h;
  a.in_w = in_w;
  a.out_h = out_h;
  a.out_w = out_w;
  a.row_bytes = in_w * 3;
  a.quads = (out_w + 3) / 4;
  a.scale_h = static_cast<float>(in_h) / static_cast<float>(out_h);
  a.scale_w = static_cast<float>(in_w) / static_cast<float>(out_w);
  return a;
}

// Output rows a block (``a.band``): the most (up to 8) that still give four
// blocks an SM, fewer where the staged rows would not fit; the staged bytes
// (0: rows too wide for the budget, the taps come from device memory);
// returns the threads a block. A few integer steps a call, so nothing is
// cached.
int plan_launch(EvalArgs& a, int batch) {
  const long long want = 4LL * mde_k3::sm_count();
  a.band = 1;
  while (a.band < kMaxBand &&
         batch * static_cast<long long>((a.out_h + 2 * a.band - 1) / (2 * a.band)) >= want) {
    a.band *= 2;
  }
  while (a.band > 1 && stage_bytes_for(a, a.band) > mde_k3::kStageBudget) a.band /= 2;
  const long long stage = stage_bytes_for(a, a.band);
  a.stage_bytes = stage <= mde_k3::kStageBudget ? static_cast<int>(stage) : 0;
  return a.quads < kMaxThreads ? (a.quads + 31) / 32 * 32 : kMaxThreads;
}

bool valid_shape(int batch, int in_h, int in_w, int out_h, int out_w) {
  return batch > 0 && batch <= 65535 && in_h > 0 && in_w > 0 && out_h > 0 && out_w > 0 &&
         static_cast<long long>(in_w) * 3 <= 0x7fffffffLL &&
         static_cast<long long>(out_w) + 3 <= 0x7fffffffLL;
}

}  // namespace

extern "C" int mde_preprocess_u8_f32(const uint8_t* in, float* out, int batch, int in_h,
                                     int in_w, int out_h, int out_w, float mean0, float mean1,
                                     float mean2, float std0, float std1, float std2,
                                     void* stream) {
  if (!valid_shape(batch, in_h, in_w, out_h, out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EvalArgs a = shape_args(in_h, in_w, out_h, out_w);
  a.vec_load = (a.row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
  a.vec_store = (out_w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  const float mean[3] = {mean0, mean1, mean2};
  const float sd[3] = {std0, std1, std2};
  for (int ch = 0; ch < 3; ++ch) {
    a.mul[ch] = static_cast<float>(1.0 / (255.0 * sd[ch]));
    a.add[ch] = static_cast<float>(-static_cast<double>(mean[ch]) / sd[ch]);
  }
  const int threads = plan_launch(a, batch);
  const dim3 grid((out_h + a.band - 1) / a.band, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.stage_bytes > 0) {
    preprocess_u8_kernel<true><<<grid, threads, a.stage_bytes, s>>>(in, out, a);
  } else {
    preprocess_u8_kernel<false><<<grid, threads, 0, s>>>(in, out, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// What mde_preprocess_u8_f32 launches for a shape on the current card, as
// four ints: output rows a block, staged bytes a block, threads a block and
// blocks a sample.
extern "C" int mde_preprocess_u8_plan(int batch, int in_h, int in_w, int out_h, int out_w,
                                      int* plan) {
  if (!valid_shape(batch, in_h, in_w, out_h, out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EvalArgs a = shape_args(in_h, in_w, out_h, out_w);
  plan[2] = plan_launch(a, batch);
  plan[0] = a.band;
  plan[1] = a.stage_bytes;
  plan[3] = (out_h + a.band - 1) / a.band;
  return 0;
}
