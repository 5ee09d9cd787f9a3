// Full (non-causal) attention forward over ViT tokens, float32 or bf16:
// out = softmax(q k^T * D^-1/2) v for every (batch, head), D = 64.
//
// Replaces mde_tpu/ops/flash_attention.py::flash_attention (its body is
// _flash_kernel). The TPU kernel takes a 128-query block and the whole padded
// K/V of one (batch, head) into VMEM, masks the padded keys with the float32
// minimum and never writes the N x N logits to HBM. This kernel keeps that
// last property and streams K/V instead: one block per (batch * head,
// 64-query tile) walks the keys in 32-key tiles staged in shared memory as
// float32 (16 KB for K and V), with an online softmax (running max and sum,
// rescaled once a tile) in float32, so neither the logits nor the
// probabilities leave registers. Keys past N are bounded by the loop and get
// no weight (exp(-inf) = 0), which equals the TPU kernel's finfo.min mask.
//
// q/k/v are (B, N, H, D) with (H, D) contiguous and any batch and token
// strides, so the three views of a fused qkv projection, (B, N, 3, H, D), are
// read in place. out is a contiguous (B, N, H, D). The element type is a
// template parameter: loads convert to float32, the softmax and both sums stay
// float32 (the TPU kernel's preferred_element_type), and the output is rounded
// to the element type once, at the store. The scale D^-1/2 = 1/8 is a power of
// two, so folding it into q changes no rounding.
//
// What bounds it on an H100: at DA-V2-S's 1,345 tokens a (batch, head) is
// 4 N^2 D = 463 MFLOP against 4 N D (1.4 MB f32) of q/k/v/out, about 330
// FLOP a byte: compute-bound. This first form runs on the CUDA cores (67
// TFLOP/s float32 peak); tensor cores (wgmma) are later work. Two threads
// share a query, each owning 8 of the 16 float4 chunks of a head row
// (chunk 2 i + half), so a warp's shared-memory reads of one K or V row hit
// two addresses in disjoint banks, each a broadcast, and one LDS.128 feeds
// four FMAs.

#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;                // head dim
constexpr int kQTile = 64;            // queries a block
constexpr int kKTile = 32;            // keys a shared-memory tile
constexpr int kThreads = 2 * kQTile;  // two threads a query
constexpr int kChunks = kD / 8;       // float4 chunks a thread owns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n, int heads,
                       long long stride_b, long long stride_n, float scale) {
  __shared__ __align__(16) float sk[kKTile * kD];
  __shared__ __align__(16) float sv[kKTile * kD];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int qi = blockIdx.y * kQTile + (tid >> 1);
  const bool valid_q = qi < n;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;

  float4 qr[kChunks];
  float4 acc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid_q) x = load4(q + head + qi * stride_n + 4 * (2 * i + half));
    qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float m = -INFINITY;  // running max of the logits seen so far
  float l = 0.f;        // running sum of exp(logit - m)
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    const int kn = min(kKTile, n - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKTile * (kD / 4); idx += kThreads) {
      const int j = idx / (kD / 4);
      const int c = idx - j * (kD / 4);
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (j < kn) {  // rows past N stay zero: their weight is exactly 0
        const long long off = head + (k0 + j) * stride_n + 4 * c;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      store4(sk + j * kD + 4 * c, kx);
      store4(sv + j * kD + 4 * c, vx);
    }
    __syncthreads();

    float s[kKTile];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float* kj = sk + j * kD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(kj + 4 * (2 * i + half));
        part = fmaf(qr[i].x, kk.x, part);
        part = fmaf(qr[i].y, kk.y, part);
        part = fmaf(qr[i].z, kk.z, part);
        part = fmaf(qr[i].w, kk.w, part);
      }
      // a + b == b + a, so both threads of the query hold the same logit.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      s[j] = j < kn ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // 0 at the first tile (m = -inf)
    l *= corr;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float* vj = sv + j * kD;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vj + 4 * (2 * i + half));
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
    m = m_new;
  }

  if (valid_q) {
    const float inv = 1.f / l;
    T* o = out + ((static_cast<long long>(b) * n + qi) * heads + h) * kD;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      store4(o + 4 * (2 * i + half),
             make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv));
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int batch, int n, int heads, int d,
           long long stride_b, long long stride_n, float scale, void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0 || d != kD || stride_b < 0 || stride_n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bh = static_cast<long long>(batch) * heads;
  const long long q_tiles = (static_cast<long long>(n) + kQTile - 1) / kQTile;
  if (bh > INT_MAX || q_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>(q_tiles));
  flash_attention_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, n, heads, stride_b, stride_n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mde_flash_attention_f32(const float* q, const float* k, const float* v,
                                       float* out, int batch, int n, int heads, int d,
                                       long long stride_b, long long stride_n, float scale,
                                       void* stream) {
  return launch<float>(q, k, v, out, batch, n, heads, d, stride_b, stride_n, scale, stream);
}

extern "C" int mde_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        int batch, int n, int heads, int d, long long stride_b,
                                        long long stride_n, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(out), batch, n, heads, d,
                      stride_b, stride_n, scale, stream);
}
