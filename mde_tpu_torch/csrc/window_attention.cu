// Windowed attention forward over pre-partitioned windows, float32 or bf16.
//
// Replaces mde_tpu/ops/pallas_kernels.py::window_attention_fused (its body is
// _window_attn_kernel). For every (batch, window) and head it computes
// softmax(q_h k_h^T * hd^-1/2) over the window's T keys, where a key whose
// entry in the window's validity row is <= 0 gets the logit -FLT_MAX (the
// float32 minimum the TPU kernel uses), and multiplies by v_h. q/k/v/out are
// float32 or bfloat16 (the element type is a template parameter, the bf16
// form serving the mixed-precision train step); logits, softmax and the
// weighted sum are float32 in both, as the TPU kernel's
// preferred_element_type=float32, and the output is rounded to the element
// type once, at the store.
//
// What bounds it on an H100: at the flagship shape (per image N=20 windows of
// T=256 tokens, C=32, 8 heads of head_dim 4) a call is about 168 MFLOP and
// 2.6 MB of q/k/v/out per image: microseconds at either roof, so the call is
// bound by launch and latency, not by the ALUs or HBM.
//
// Design: one block per (batch*window, head) and one thread per query row
// (T <= 1024). The block stages its T x hd slices of K and V and the window's
// validity row in shared memory as float32 (8 KB + 1 KB at the flagship,
// either element type); each thread then runs an online softmax (running
// max and running sum) over the T keys, so the T x T logits are never stored
// anywhere. A mask row, not a count of
// valid keys, is needed: right-edge windows have their invalid columns
// interleaved in token order. head_dim is a template parameter for the
// widths the models use, with a runtime loop (head_dim <= 64) otherwise.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHeadDim = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int HD>
__global__ void window_attention_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ key_valid,
                                        T* __restrict__ out, int n_windows,
                                        int t, int c, int hd_rt, float scale) {
  constexpr int kSlots = HD > 0 ? HD : kMaxHeadDim;
  const int hd = HD > 0 ? HD : hd_rt;
  const int bn = blockIdx.x;  // batch * n_windows + window
  const int head = blockIdx.y;
  const int window = bn % n_windows;

  extern __shared__ float smem[];
  float* sk = smem;           // (t, hd)
  float* sv = sk + t * hd;    // (t, hd)
  float* smask = sv + t * hd; // (t)

  const size_t base = static_cast<size_t>(bn) * t * c + static_cast<size_t>(head) * hd;
  for (int idx = threadIdx.x; idx < t * hd; idx += blockDim.x) {
    const int row = idx / hd;
    const int d = idx - row * hd;
    const size_t src = base + static_cast<size_t>(row) * c + d;
    sk[idx] = to_float(k[src]);
    sv[idx] = to_float(v[src]);
  }
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    smask[j] = key_valid[static_cast<size_t>(window) * t + j];
  }
  __syncthreads();

  const int row = threadIdx.x;
  if (row >= t) return;
  const size_t qo = base + static_cast<size_t>(row) * c;
  float qr[kSlots];
  float acc[kSlots];
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    qr[d] = d < hd ? to_float(q[qo + d]) : 0.f;
    acc[d] = 0.f;
  }

  float m = -INFINITY;  // running max of the logits seen so far
  float l = 0.f;        // running sum of exp(logit - m)
  for (int j = 0; j < t; ++j) {
    const float* kj = sk + j * hd;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) s = fmaf(qr[d], kj[d], s);
    }
    s = smask[j] > 0.f ? s * scale : -FLT_MAX;
    if (s > m) {
      const float corr = expf(m - s);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kSlots; ++d) acc[d] *= corr;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
    const float* vj = sv + j * hd;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) acc[d] = fmaf(p, vj[d], acc[d]);
    }
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) out[qo + d] = from_float<T>(acc[d] * inv);
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* key_valid, T* out,
           int batch, int n_windows, int t, int c, int num_heads, float scale,
           void* stream) {
  if (batch <= 0 || n_windows <= 0 || t <= 0 || t > 1024 || num_heads <= 0 ||
      c % num_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = c / num_heads;
  if (hd > kMaxHeadDim) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * static_cast<size_t>(t) * hd + t) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * n_windows, num_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 4:
      window_attention_kernel<T, 4><<<grid, t, smem, s>>>(q, k, v, key_valid, out,
                                                          n_windows, t, c, hd, scale);
      break;
    case 8:
      window_attention_kernel<T, 8><<<grid, t, smem, s>>>(q, k, v, key_valid, out,
                                                          n_windows, t, c, hd, scale);
      break;
    default:
      window_attention_kernel<T, 0><<<grid, t, smem, s>>>(q, k, v, key_valid, out,
                                                          n_windows, t, c, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mde_window_attention_f32(const float* q, const float* k,
                                        const float* v, const float* key_valid,
                                        float* out, int batch, int n_windows,
                                        int t, int c, int num_heads, float scale,
                                        void* stream) {
  return launch<float>(q, k, v, key_valid, out, batch, n_windows, t, c, num_heads,
                       scale, stream);
}

extern "C" int mde_window_attention_bf16(const void* q, const void* k,
                                         const void* v, const float* key_valid,
                                         void* out, int batch, int n_windows,
                                         int t, int c, int num_heads, float scale,
                                         void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), key_valid, static_cast<bf16*>(out),
                      batch, n_windows, t, c, num_heads, scale, stream);
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
