// The train step's image pipeline: uint8 NHWC -> half-pixel bilinear resize
// -> colour jitter in each sample's own order -> ImageNet normalisation ->
// float32 NCHW.
//
// Replaces mde_tpu/ops/pallas_kernels.py::normalize_u8_fused (the u8 ->
// normalised map) together with the colour jitter that sits between the
// resize and that map on the train path, mde_tpu/ops/image.py::color_jitter
// (called from mde_tpu/data/transforms.py::preprocess_train). The jitter's
// draws are made on the host from the step's generator: brightness,
// contrast, saturation and hue factors, and the sample's order of the four
// adjustments (0 brightness, 1 contrast, 2 saturation, 3 hue). They reach the
// kernel by value, in its parameter block (at most 64 samples a launch, 1.3
// KB): no pinned buffer, no host-to-card copy, no draws tensor on the card.
//
// What bounds it on an H100: by the roofline, memory. At batch 4, 426x560 ->
// 448x576 it reads 2.86 MB of uint8 and writes 12.4 MB of float32 (4.6 us at
// 3.35 TB/s). In practice the instructions are the limit: a few hundred a
// pixel with the hue round trip, about 0.3 G at that shape, some 9 us at the
// SMs' full rate. So the design spends no instruction twice where it can
// help it, and reads and writes each byte once.
//
// Design. Contrast blends each pixel with the mean grey of its image as it
// stands before contrast in the sample's order, a reduction over the whole
// image between two elementwise halves. One cooperative launch does both:
//   1. each block stages the u8 source rows of its range of output pixels
//      in shared memory with 16-byte loads (preprocess_common.cuh), resizes
//      each pixel once, applies the adjustments before contrast, keeps the
//      three values in shared memory and writes one partial grey sum (a
//      fixed-order tree, no atomics);
//   2. after the grid barrier, every block of a sample adds that sample's
//      partials in one fixed order (double), so all get the same mean bits;
//   3. contrast with that mean, the adjustments after it, the normalisation
//      and the stores (a warp's 32 neighbouring pixels a plane).
// The grid is sized from the occupancy the runtime reports for the launch's
// shared memory, P pixels a thread; a batch that does not fit runs in groups
// of samples, one launch a group (each sample's mean is its own). Where no
// grid fits (a very large image) or the source rows do not fit shared memory,
// the same function runs as two plain launches: the partials, then a pass
// that recomputes each pixel's first half from u8 (in L2) and reads the
// partials. The shape alone picks the design (mde_preprocess_u8_train_plan,
// asked once a shape by the caller, which hands the plan to every launch).
// Both designs give the same bits run to run.
//
// The arithmetic follows the plain PyTorch version operation by operation: a
// clamp to [0, 1] after every blend, hue on the clamped image with floor-mod
// remainders, and every product, sum and quotient rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn), since nvcc would fuse a
// product and a sum into one multiply-add that the plain version does not do
// (ROADMAP, Queue 3: the F.interpolate finding). Exact replacements: fmodf(x,
// 1) is x - trunc(x) (exact for every finite float), hue divides only the two
// differences its sector uses, and the sector's switch is selects. Two
// divisions become products, each within an ulp or two of the quotient: u8 /
// 255 is one scaling after the blend of the u8 values, and the hue
// differences share 1 / delta. h / 6 and the normalisation's / std stay
// divisions. Against the plain version the error stays within
// chip_smoke.py's 1e-5 at every case and all 24 orders (the numbers are in
// PERF.md).

#include <cooperative_groups.h>

#include "preprocess_common.cuh"

namespace {

using mde_k3::Tap;

constexpr int kThreads = 256;
constexpr int kMaxGroup = 64;  // samples a launch: the draws' share of the 4 KB parameter block
constexpr int kMaxPixels = 16;  // pixels a thread in the cooperative design

struct SampleDraws {
  float factor[4];   // brightness, contrast, saturation, hue
  uint8_t order[4];  // a permutation of 0..3
};

struct TrainArgs {
  int in_h, in_w, out_h, out_w, row_bytes, n_pix;
  int pixels;       // a thread's pixels (P)
  int bps;          // blocks a sample
  int stage_bytes;  // shared memory for the staged rows (0: taps from device memory)
  int sample0;      // the group's first sample in the batch
  int vec_load;
  float scale_h, scale_w;
  float mean[3], std[3];  // the normalisation: (x - mean) / std
  SampleDraws draws[kMaxGroup];
};

__device__ __forceinline__ float rmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float radd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// torch.remainder(x, 1.0): x - trunc(x) equals fmodf(x, 1) for every finite
// float (the difference is exact), then shifted into [0, 1) if negative.
__device__ __forceinline__ float remainder1(float x) {
  const float r = rsub(x, truncf(x));
  return r < 0.f ? radd(r, 1.f) : r;
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
  // h = bc - gc, 2 + rc - bc or 4 + gc - rc with xc = (maxc - x) / safe, by
  // which channel is the max: two of the three quotients, chosen first
  const bool is_r = maxc == r;
  const bool is_g = !is_r && maxc == g;
  const float inv = __frcp_rn(safe);
  const float t1 = rmul(rsub(maxc, is_r ? b : (is_g ? r : g)), inv);
  const float t2 = rmul(rsub(maxc, is_r ? g : (is_g ? b : r)), inv);
  float h = is_r ? rsub(t1, t2) : rsub(radd(is_g ? 2.f : 4.f, t1), t2);
  h = delta > 0.f ? remainder1(rdiv(h, 6.f)) : 0.f;
  h = remainder1(radd(h, factor));
  // HSV -> RGB with v = maxc; h in [0, 1], so the sector is 0..6, and 6 is 0
  const float v = maxc;
  const float h6 = rmul(h, 6.f);
  const float fi = floorf(h6);
  const float f = rsub(h6, fi);
  const float p = rmul(v, rsub(1.f, s));
  const float q = rmul(v, rsub(1.f, rmul(f, s)));
  const float t = rmul(v, rsub(1.f, rmul(rsub(1.f, f), s)));
  int i = static_cast<int>(fi);
  i = i >= 6 ? i - 6 : i;
  // sectors 0..5 take (v,t,p) (q,v,p) (p,v,t) (p,q,v) (t,p,v) (v,p,q)
  c[0] = (i == 0 || i == 5) ? v : (i == 1 ? q : (i == 4 ? t : p));
  c[1] = (i == 1 || i == 2) ? v : (i == 0 ? t : (i == 3 ? q : p));
  c[2] = (i == 3 || i == 4) ? v : (i == 2 ? t : (i == 5 ? q : p));
}

// One adjustment; contrast blends with ``mean``, the image's mean grey. The
// op is the same for the whole block, so the branch never diverges.
__device__ __forceinline__ void adjust(float c[3], int op, const float f[4], float mean) {
  if (op == 0) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], 0.f, f[0]);
  } else if (op == 1) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], mean, f[1]);
  } else if (op == 2) {
    const float gr = gray(c);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], gr, f[2]);
  } else {
    adjust_hue(c, f[3]);
  }
}

// The block's view of its sample: factors, order (8 bits an op) and where
// contrast stands in it.
struct Jitter {
  float f[4];
  unsigned order;
  int contrast_at;
};

__device__ __forceinline__ Jitter jitter_of(const SampleDraws& d) {
  Jitter j;
  j.order = 0;
  j.contrast_at = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    j.f[k] = d.factor[k];
    j.order |= static_cast<unsigned>(d.order[k]) << (8 * k);
    if (d.order[k] == 1) j.contrast_at = k;
  }
  return j;
}

__device__ __forceinline__ int op_at(const Jitter& j, int k) {
  return static_cast<int>((j.order >> (8 * k)) & 0xffu);
}

// The resized pixel (oy, ox), rows blended first, then columns, as
// resize_half_pixel does, on the u8 values and scaled by 1/255 once (the
// weights sum to 1); ``src`` holds source rows from ``y_base`` on.
__device__ __forceinline__ void resized_pixel(const uint8_t* src, int y_base,
                                              const TrainArgs& a, int oy, int ox, float c[3]) {
  const Tap ty = mde_k3::tap(a.scale_h, oy, a.in_h);
  const Tap tx = mde_k3::tap(a.scale_w, ox, a.in_w);
  const float wy0 = rsub(1.f, ty.w1);
  const float wx0 = rsub(1.f, tx.w1);
  const uint8_t* r0 = src + static_cast<size_t>(ty.i0 - y_base) * a.row_bytes;
  const uint8_t* r1 = src + static_cast<size_t>(ty.i1 - y_base) * a.row_bytes;
  const int x0 = tx.i0 * 3;
  const int x1 = tx.i1 * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float left =
        radd(rmul(mde_k3::u8f(r0[x0 + ch]), wy0), rmul(mde_k3::u8f(r1[x0 + ch]), ty.w1));
    const float right =
        radd(rmul(mde_k3::u8f(r0[x1 + ch]), wy0), rmul(mde_k3::u8f(r1[x1 + ch]), ty.w1));
    c[ch] = rmul(radd(rmul(left, wx0), rmul(right, tx.w1)), 1.f / 255.f);
  }
}

// The first half of a pixel: resized, then the adjustments before contrast.
__device__ __forceinline__ void first_half(const uint8_t* src, int y_base, const TrainArgs& a,
                                           const Jitter& j, int oy, int ox, float c[3]) {
  resized_pixel(src, y_base, a, oy, ox, c);
#pragma unroll 1
  for (int k = 0; k < j.contrast_at; ++k) adjust(c, op_at(j, k), j.f, 0.f);
}

// The second half: contrast, the adjustments after it, normalised, stored.
__device__ __forceinline__ void second_half(const TrainArgs& a, const Jitter& j, float mean,
                                            float c[3], float* o, size_t plane) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) c[ch] = blend(c[ch], mean, j.f[1]);
#pragma unroll 1
  for (int k = j.contrast_at + 1; k < 4; ++k) adjust(c, op_at(j, k), j.f, mean);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) o[ch * plane] = rdiv(rsub(c[ch], a.mean[ch]), a.std[ch]);
}

// kMode 0: the cooperative kernel (both halves around a grid barrier);
// 1: the partials alone; 2: the second launch of the two-launch design.
template <int kMode, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    preprocess_train_kernel(const uint8_t* __restrict__ in, float* __restrict__ partial,
                            float* __restrict__ out, const __grid_constant__ TrainArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float warp_sum[kThreads / 32];
  __shared__ float mean_s;
  const int s_local = blockIdx.x / a.bps;
  const int blk = blockIdx.x - s_local * a.bps;
  const int sample = a.sample0 + s_local;
  const Jitter j = jitter_of(a.draws[s_local]);  // once a block

  const int p_first = blk * kThreads * a.pixels;
  const int p_end = static_cast<int>(
      min(static_cast<long long>(a.n_pix), static_cast<long long>(p_first) + kThreads * a.pixels));
  const uint8_t* img = in + static_cast<size_t>(sample) * a.in_h * a.row_bytes;
  const uint8_t* src = img;
  int y_base = 0;
  if constexpr (kStaged) {
    const int rows = mde_k3::source_rows(a.scale_h, a.in_h, p_first / a.out_w,
                                         (p_end - 1) / a.out_w, &y_base);
    if (rows * a.row_bytes > a.stage_bytes) __trap();  // the host sized it; never taken
    mde_k3::stage(smem, img + static_cast<size_t>(y_base) * a.row_bytes, rows * a.row_bytes,
                  a.vec_load);
    src = smem;
  }
  // the values between the halves, [P][3][threads], after the staged rows
  float* vals = reinterpret_cast<float*>(smem + ((a.stage_bytes + 15) & ~15));
  __syncthreads();

  // a thread's pixels are p_first + t + k * threads: (oy, ox) by steps
  const int p0 = p_first + static_cast<int>(threadIdx.x);
  const int oy0 = p0 / a.out_w;
  const int ox0 = p0 - oy0 * a.out_w;
  const size_t plane = static_cast<size_t>(a.out_h) * a.out_w;
  float* out_img = out + static_cast<size_t>(sample) * 3 * plane;

  if (kMode != 2) {
    float gsum = 0.f;
    int oy = oy0, ox = ox0;
#pragma unroll 1
    for (int k = 0, p = p0; k < a.pixels && p < p_end; ++k, p += kThreads) {
      float c[3];
      first_half(src, y_base, a, j, oy, ox, c);
      gsum += gray(c);
      if (kMode == 0) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) vals[(k * 3 + ch) * kThreads + threadIdx.x] = c[ch];
      }
      for (ox += kThreads; ox >= a.out_w; ox -= a.out_w) ++oy;
    }
    // the block's grey sum: a fixed tree of shuffles, then warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) gsum += __shfl_xor_sync(0xffffffffu, gsum, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = gsum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s += warp_sum[w];
      partial[static_cast<size_t>(sample) * a.bps + blk] = s;
    }
    if constexpr (kMode == 1) {
      return;
    } else {
      cooperative_groups::this_grid().sync();
    }
  }

  // the sample's mean grey: its partials in one fixed order, by every block
  if (threadIdx.x < 32) {
    double s = 0.0;
    const float* ps = partial + static_cast<size_t>(sample) * a.bps;
    for (int i = threadIdx.x; i < a.bps; i += 32) s += static_cast<double>(__ldcg(ps + i));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) mean_s = static_cast<float>(s / a.n_pix);
  }
  __syncthreads();
  const float mean = mean_s;

  int oy = oy0, ox = ox0;
#pragma unroll 1
  for (int k = 0, p = p0; k < a.pixels && p < p_end; ++k, p += kThreads) {
    float c[3];
    if (kMode == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) c[ch] = vals[(k * 3 + ch) * kThreads + threadIdx.x];
    } else {
      first_half(src, y_base, a, j, oy, ox, c);
    }
    second_half(a, j, mean, c, out_img + static_cast<size_t>(oy) * a.out_w + ox, plane);
    for (ox += kThreads; ox >= a.out_w; ox -= a.out_w) ++oy;
  }
}

// How a call runs: the design, its grid and its shared memory. The fields
// are kernels.py's TrainPlan, in this order.
struct Plan {
  int coop;        // 1: one cooperative launch a group; 0: two launches a group
  int pixels;      // a thread's pixels
  int bps;         // blocks a sample
  int per_sm;      // the cooperative kernel's blocks an SM (occupancy), else 0
  int group;       // samples a launch
  int stage_bytes; // staged rows a block (0: taps from device memory)
  int smem;        // dynamic shared memory a block
};

// The most bytes of source rows any of the ``bps`` blocks of ``pixels``
// pixels a thread needs, exactly (the eval form's closed-form bound,
// max_source_rows, would reserve a row more a block at 448x576). The plan is
// made once a shape, so this walk over the blocks is not on the launch path.
long long stage_bytes_for(const TrainArgs& a, int pixels, int bps) {
  long long most = 0;
  const long long per_block = static_cast<long long>(kThreads) * pixels;
  for (int b = 0; b < bps; ++b) {
    const long long first = b * per_block;
    const long long end = first + per_block < a.n_pix ? first + per_block : a.n_pix;
    const long long rows =
        mde_k3::source_rows(a.scale_h, a.in_h, static_cast<int>(first / a.out_w),
                            static_cast<int>((end - 1) / a.out_w), nullptr);
    most = rows * a.row_bytes > most ? rows * a.row_bytes : most;
  }
  return most;
}

long long values_offset(long long stage_bytes) { return (stage_bytes + 15) & ~15LL; }

// The cooperative design at the fewest pixels a thread that gives the fewest
// launches; two launches where no cooperative grid fits.
cudaError_t make_plan(const TrainArgs& a, int batch, Plan* plan) {
  const int sms = mde_k3::sm_count();
  Plan best{};
  for (int p = 1; p <= kMaxPixels; ++p) {
    const int bps = (a.n_pix + kThreads * p - 1) / (kThreads * p);
    const long long stage = stage_bytes_for(a, p, bps);
    const long long smem = values_offset(stage) + p * 3 * kThreads * 4;
    if (smem > mde_k3::kStageBudget) break;  // grows with p
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, preprocess_train_kernel<0, true>, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    int group = per_sm * sms / bps;
    group = group < kMaxGroup ? group : kMaxGroup;
    group = group < batch ? group : batch;
    // the fewest launches; among those, the fewest pixels a thread
    if (group > best.group) {
      best = Plan{1, p, bps, per_sm, group, static_cast<int>(stage), static_cast<int>(smem)};
    }
    if (group == batch) break;
  }
  if (best.group == 0) {
    const int p = 4;
    const int bps = (a.n_pix + kThreads * p - 1) / (kThreads * p);
    const long long stage = stage_bytes_for(a, p, bps);
    const int staged = stage <= mde_k3::kStageBudget ? static_cast<int>(stage) : 0;
    best = Plan{0, p, bps, 0, batch < kMaxGroup ? batch : kMaxGroup, staged, staged};
  }
  *plan = best;
  return cudaSuccess;
}

TrainArgs base_args(int in_h, int in_w, int out_h, int out_w) {
  TrainArgs a{};
  a.in_h = in_h;
  a.in_w = in_w;
  a.out_h = out_h;
  a.out_w = out_w;
  a.row_bytes = in_w * 3;
  a.n_pix = out_h * out_w;
  a.scale_h = static_cast<float>(in_h) / static_cast<float>(out_h);
  a.scale_w = static_cast<float>(in_w) / static_cast<float>(out_w);
  return a;
}

bool bad_shape(int batch, int in_h, int in_w, int out_h, int out_w) {
  return batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
         static_cast<long long>(in_w) * 3 > 0x7fffffffLL ||
         static_cast<long long>(out_h) * out_w > 0x7fffffffLL - 1024;
}

// A plan the launcher can run safely: it covers the image, its shared memory
// holds the values between the halves and stays in budget, and the group fits
// the parameter block.
bool bad_plan(const Plan& p, const TrainArgs& a) {
  return p.coop < 0 || p.coop > 1 || p.pixels < 1 || p.pixels > kMaxPixels || p.bps < 1 ||
         static_cast<long long>(p.bps) * kThreads * p.pixels < a.n_pix || p.group < 1 ||
         p.group > kMaxGroup || p.stage_bytes < 0 || p.smem > mde_k3::kStageBudget ||
         p.smem < (p.coop ? values_offset(p.stage_bytes) + p.pixels * 3 * kThreads * 4
                          : p.stage_bytes) ||
         (p.coop && p.stage_bytes == 0);
}

}  // namespace

// How a call of this shape runs on the current device; ``out`` receives a
// Plan. The caller asks once a shape and passes the plan to every launch.
extern "C" int mde_preprocess_u8_train_plan(int batch, int in_h, int in_w, int out_h, int out_w,
                                            void* out) {
  if (bad_shape(batch, in_h, in_w, out_h, out_w)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      make_plan(base_args(in_h, in_w, out_h, out_w), batch, static_cast<Plan*>(out)));
}

// One group of samples [sample0, sample0 + count) of a (batch, in_h, in_w,
// 3) u8 batch into ``out`` (batch, 3, out_h, out_w), run as ``plan`` (from
// mde_preprocess_u8_train_plan for this shape). ``draws``: the group's
// (count, 8) float32 rows in host memory (four factors, then the order),
// copied into the launch's parameters; an order that is not a permutation of
// 0..3 is refused before any launch. ``partial``: ``partial_len`` float32 of
// device scratch, at least batch x blocks a sample.
extern "C" int mde_preprocess_u8_train_f32(const uint8_t* in, const float* draws, float* partial,
                                           long long partial_len, float* out, const void* plan,
                                           int batch, int sample0, int count, int in_h, int in_w,
                                           int out_h, int out_w, float mean0, float mean1,
                                           float mean2, float std0, float std1, float std2,
                                           void* stream) {
  if (bad_shape(batch, in_h, in_w, out_h, out_w) || plan == nullptr || draws == nullptr ||
      count <= 0 || sample0 < 0 || sample0 + count > batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TrainArgs a = base_args(in_h, in_w, out_h, out_w);
  const Plan p = *static_cast<const Plan*>(plan);
  if (bad_plan(p, a) || count > p.group || static_cast<long long>(batch) * p.bps > partial_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < count; ++s) {
    const float* row = draws + 8 * s;
    unsigned seen = 0;
    for (int k = 0; k < 4; ++k) {
      a.draws[s].factor[k] = row[k];
      const float o = row[4 + k];
      if (!(o == 0.f || o == 1.f || o == 2.f || o == 3.f)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      a.draws[s].order[k] = static_cast<uint8_t>(o);
      seen |= 1u << a.draws[s].order[k];
    }
    if (seen != 15u) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.vec_load = (a.row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
  a.mean[0] = mean0;
  a.mean[1] = mean1;
  a.mean[2] = mean2;
  a.std[0] = std0;
  a.std[1] = std1;
  a.std[2] = std2;
  a.pixels = p.pixels;
  a.bps = p.bps;
  a.stage_bytes = p.stage_bytes;
  a.sample0 = sample0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(count * p.bps);
  if (p.coop) {
    void* args[] = {&in, &partial, &out, &a};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(preprocess_train_kernel<0, true>), grid, dim3(kThreads),
        args, p.smem, s));
  }
  cudaError_t err;
  if (p.stage_bytes > 0) {
    preprocess_train_kernel<1, true><<<grid, kThreads, p.smem, s>>>(in, partial, out, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    preprocess_train_kernel<2, true><<<grid, kThreads, p.smem, s>>>(in, partial, out, a);
  } else {
    preprocess_train_kernel<1, false><<<grid, kThreads, 0, s>>>(in, partial, out, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    preprocess_train_kernel<2, false><<<grid, kThreads, 0, s>>>(in, partial, out, a);
  }
  return static_cast<int>(cudaGetLastError());
}
