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
// What bounds it on an H100: memory and launch. At the flagship's B=4 x
// 448x576 the forward reads 8.3 MB (pred and target once) and does a few
// FLOPs a byte; the backward reads 8.3 MB and writes 4.1 MB. At 3.35 TB/s
// that is 2.5 us and 3.7 us, so a call is dominated by its launches.
//
// Design. The TPU grid walks a sample's chunks in order and carries the two
// sums in SMEM between grid steps. Hopper's blocks run in no order, so
// nothing is carried: a (chunks, B) grid of 256-thread blocks each reduces a
// 2048-element chunk (the TPU kernel's (8, 256) tile) to float32 partial
// sums in a (2, B, chunks) scratch tensor, and a second kernel, one block a
// sample, adds a sample's partials in a fixed order. Both reductions are
// fixed trees (warp shuffles, then shared memory): no atomics, so a sum is
// bit-identical from run to run. The ragged tail is masked by index (the TPU
// kernel pads with 1.0 instead). logf, not __logf: jnp.log is accurate to
// about an ulp, and the library is built without -use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;

// Sum of v over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kWarps ? scratch[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  __syncthreads();  // scratch is reused by the caller's next block_sum
  return v;
}

__global__ void si_partial_kernel(const float* __restrict__ pred,
                                  const float* __restrict__ target,
                                  float* __restrict__ partial, long long n,
                                  int chunks, float eps) {
  __shared__ float scratch[kWarps];
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const float* p = pred + static_cast<size_t>(b) * n;
  const float* t = target + static_cast<size_t>(b) * n;
  const long long base = static_cast<long long>(chunk) * kChunk + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + static_cast<long long>(k) * kThreads;  // coalesced
    if (i < n) {
      const float d = logf(p[i] + eps) - logf(t[i] + eps);
      s1 += d;
      s2 += d * d;
    }
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    const size_t batch = gridDim.y;
    partial[static_cast<size_t>(b) * chunks + chunk] = s1;
    partial[(batch + b) * chunks + chunk] = s2;
  }
}

__global__ void si_finish_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out1, float* __restrict__ out2,
                                 int batch, int chunks) {
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x;
  const float* p1 = partial + static_cast<size_t>(b) * chunks;
  const float* p2 = partial + (static_cast<size_t>(batch) + b) * chunks;
  float s1 = 0.f, s2 = 0.f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    s1 += p1[c];
    s2 += p2[c];
  }
  s1 = block_sum(s1, scratch);
  s2 = block_sum(s2, scratch);
  if (threadIdx.x == 0) {
    out1[b] = s1;
    out2[b] = s2;
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

// partial: (2, batch, chunks) float32 scratch, chunks = ceil(n / 2048);
// out1, out2: (batch,) float32, the sums of d and of d^2.
extern "C" int mde_si_loss_sums_f32(const float* pred, const float* target,
                                    float* partial, float* out1, float* out2,
                                    int batch, long long n, float eps, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (n + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(chunks), batch);
  si_partial_kernel<<<grid, kThreads, 0, s>>>(pred, target, partial, n,
                                              static_cast<int>(chunks), eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  si_finish_kernel<<<batch, kThreads, 0, s>>>(partial, out1, out2, batch,
                                               static_cast<int>(chunks));
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
