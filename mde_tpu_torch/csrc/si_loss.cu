// Per-sample sums of the scale-invariant log difference, forward and backward,
// float32.
//
// Replaces mde_tpu/ops/pallas_kernels.py::si_loss_sums (forward body
// _si_sums_kernel, custom VJP _si_sums_bwd). For each sample b of a (B, n)
// pair pred/target the forward computes
//   S1[b] = sum_i d_i,  S2[b] = sum_i d_i^2,  d_i = log(pred_i + eps) - log(target_i + eps),
// the two sums every scale-invariant loss and the SI-RMSE metric are built
// from; the backward maps the cotangents (g1, g2) of (S1, S2) to
//   dpred_i = (g1[b] + 2 d_i g2[b]) / (pred_i + eps)
// and, only when asked, dtarget_i = -(g1[b] + 2 d_i g2[b]) / (target_i + eps),
// recomputing d instead of saving it.
//
// What bounds it on an H100. At the flagship's B=4 x 448x576 the forward
// reads 8.3 MB (2.5 us at 3.35 TB/s), and each element costs about 57
// instructions, 52 of them the two logf (logf, not __logf: jnp.log is
// accurate to about an ulp, and the library is built without
// -use_fast_math): some 2 us of the whole card's issue rate. So the forward
// needs every SM, and more warps an SM than one block of loads in flight
// gives; and a sample's sums need more SMs than a thread-block cluster holds
// (16): at B = 4, a cluster a sample reads with 64 SMs, and measured 1.5x
// slower than the design below (PERF.md, section 6).
//
// Forward design: one launch, one block a tile, a (T, B) grid of 512-thread
// blocks, three an SM. Each sample is cut into T tiles
// (ops/kernels.py::si_loss_sums_plan, from B, n and the SM count alone: one
// wave), contiguous shares of units // T units and one more for the first
// units % T tiles, where a unit is a float4 on the vector path (n % 4 == 0
// and both rows on 16 bytes, which the caller checks: every row then starts
// on 16 bytes) and a float on the scalar path. A thread keeps 2 loads of
// each input in flight (8 on the scalar path; ld.global.nc with no L1
// allocation: the data is read once) and sums its elements in order; the
// block adds its threads in a fixed tree (warp shuffles, then shared memory)
// and writes the tile's two partials after the (2, B) sums in ``out``. Its
// thread 0 then takes a ticket of the sample's counter (one acquire-release
// atomic add, which orders the partials before it); the block that draws the
// last ticket loads the sample's T partials at once and adds them in one
// fixed order (lane j takes tiles j, j + 32, ..., then a shuffle tree),
// writes S1[b] and S2[b] and sets the counter back to 0 for the next launch.
// Which block finishes last changes from run to run; the order of the sum
// does not, so a sum is bit-identical from run to run. No atomic touches a
// sum. The counters are the caller's: (B,) uint32, zero before the launch,
// zero after it, used by one stream at a time.
//
// Backward: one thread an element, elementwise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // the backward's block
constexpr int kSumThreads = 512;  // the forward's block
constexpr int kBlocksPerSm = 3;  // at most 42 registers a thread (kernels.py: SI_BLOCKS_PER_SM)
constexpr int kDepth = 2;  // 16-byte loads of each input in flight a thread (4-byte: 4 kDepth)
constexpr int kReads = 8;  // partials a lane of the last block loads at once

__device__ __forceinline__ float4 load_once(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void accumulate(float p, float t, float eps, float& s1, float& s2) {
  const float d = logf(p + eps) - logf(t + eps);
  s1 += d;
  s2 += d * d;
}

__device__ __forceinline__ void accumulate(const float4& p, const float4& t, float eps, float& s1,
                                           float& s2) {
  accumulate(p.x, t.x, eps, s1, s2);
  accumulate(p.y, t.y, eps, s1, s2);
  accumulate(p.z, t.z, eps, s1, s2);
  accumulate(p.w, t.w, eps, s1, s2);
}

// This thread's sums over units [begin, end) of one sample: thread t of kT
// takes units begin + t + k kT in order of k, kLoads loads of each input
// issued before the first is used.
template <int kT, int kLoads, typename U>
__device__ __forceinline__ void thread_sums(const U* __restrict__ p, const U* __restrict__ t,
                                           long long begin, long long end, float eps, float& s1,
                                           float& s2) {
  for (long long base = begin + threadIdx.x; base < end;
       base += static_cast<long long>(kT) * kLoads) {
    U a[kLoads], b[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const long long i = base + static_cast<long long>(k) * kT;
      if (i < end) {
        a[k] = load_once(p + i);
        b[k] = load_once(t + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (base + static_cast<long long>(k) * kT < end) accumulate(a[k], b[k], eps, s1, s2);
    }
  }
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, off);
    v.y += __shfl_down_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// One block a tile; see the header. out: the (2, batch) sums, then the
// tiles' partials, (batch * tiles) float2.
template <typename U, int kT, int kLoads>
__global__ void __launch_bounds__(kT, kBlocksPerSm) si_sums_kernel(
    const float* __restrict__ pred, const float* __restrict__ target, float* __restrict__ out,
    unsigned* __restrict__ counters, long long n, long long chunk, int extra, float eps) {
  __shared__ float2 warp_sums[kT / 32];
  const int r = blockIdx.x;  // the tile
  const int b = blockIdx.y;  // the sample
  const int tiles = gridDim.x;
  const int batch = gridDim.y;
  const U* p = reinterpret_cast<const U*>(pred + static_cast<size_t>(b) * n);
  const U* t = reinterpret_cast<const U*>(target + static_cast<size_t>(b) * n);
  // tile r: chunk units, and one more for the first ``extra`` tiles
  const long long begin = r * chunk + min(r, extra);
  float2 v = make_float2(0.f, 0.f);
  thread_sums<kT, kLoads>(p, t, begin, begin + chunk + (r < extra), eps, v.x, v.y);
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp != 0) return;
  v = warp_sum(lane < kT / 32 ? warp_sums[lane] : make_float2(0.f, 0.f));
  float2* partial = reinterpret_cast<float2*>(out + 2 * static_cast<size_t>(batch)) +
                    static_cast<size_t>(b) * tiles;
  unsigned ticket = 0;
  if (lane == 0) {
    partial[r] = v;
    // release: the partials above before the ticket; acquire: the other
    // tiles' partials before this block reads them, if it is the last
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counters + b)
                 : "memory");
  }
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket != static_cast<unsigned>(tiles - 1)) return;
  __syncwarp();  // lane 0's acquire before the other lanes' reads
  // lane j adds tiles j, j + 32, ... in that order; the first kReads loads
  // are issued together, so a sample of up to 32 kReads tiles costs one
  // round trip to L2
  float2 q[kReads];
#pragma unroll
  for (int k = 0; k < kReads; ++k) {
    const int j = lane + 32 * k;
    q[k] = j < tiles ? __ldcg(partial + j) : make_float2(0.f, 0.f);
  }
  v = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kReads; ++k) {
    v.x += q[k].x;
    v.y += q[k].y;
  }
  for (int j = lane + 32 * kReads; j < tiles; j += 32) {
    const float2 r2 = __ldcg(partial + j);
    v.x += r2.x;
    v.y += r2.y;
  }
  v = warp_sum(v);
  if (lane == 0) {
    out[b] = v.x;
    out[batch + b] = v.y;
    counters[b] = 0u;
  }
}

__global__ void si_backward_kernel(const float* __restrict__ pred,
                                   const float* __restrict__ target,
                                   const float* __restrict__ g1,
                                   const float* __restrict__ g2,
                                   float* __restrict__ dpred,
                                   float* __restrict__ dtarget, long long n,
                                   long long total, float eps) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int b = static_cast<int>(i / n);
  const float pe = pred[i] + eps;
  const float te = target[i] + eps;
  const float d = logf(pe) - logf(te);
  const float common = g1[b] + 2.f * d * g2[b];
  dpred[i] = common / pe;
  if (dtarget != nullptr) dtarget[i] = -common / te;
}

}  // namespace

// out: 2 * batch * (1 + tiles) float32, the sums of d and of d^2 (out[b],
// out[batch + b]), then the tiles' partials; counters: (batch,) uint32, all
// 0, left all 0. ``batch`` 1..65535; ``tiles`` a sample, 1..units, at most
// 2^31 - 1; ``vector``: 16-byte loads, only where n % 4 == 0 and pred and
// target start on 16 bytes.
extern "C" int mde_si_loss_sums_f32(const float* pred, const float* target, float* out,
                                    void* counters, int batch, long long n, int tiles,
                                    int vector, float eps, void* stream) {
  const bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(pred) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(target) % 16 == 0;
  const long long units = vector != 0 ? n / 4 : n;
  if (batch <= 0 || batch > 65535 || n <= 0 || tiles <= 0 || tiles > units ||
      (vector != 0 && !aligned) || counters == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ctr = static_cast<unsigned*>(counters);
  // the tiles' shares, divided here once rather than in every thread
  const long long chunk = units / tiles;
  const int extra = static_cast<int>(units % tiles);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(batch));
  if (vector != 0) {
    si_sums_kernel<float4, kSumThreads, kDepth>
        <<<grid, kSumThreads, 0, s>>>(pred, target, out, ctr, n, chunk, extra, eps);
  } else {
    si_sums_kernel<float, kSumThreads, 4 * kDepth>
        <<<grid, kSumThreads, 0, s>>>(pred, target, out, ctr, n, chunk, extra, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// g1, g2: (batch,) cotangents of the two sums; dtarget may be null.
extern "C" int mde_si_loss_backward_f32(const float* pred, const float* target,
                                        const float* g1, const float* g2,
                                        float* dpred, float* dtarget, int batch,
                                        long long n, float eps, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(batch) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  si_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pred, target, g1, g2, dpred, dtarget, n, total, eps);
  return static_cast<int>(cudaGetLastError());
}
