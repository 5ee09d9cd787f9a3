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
//
// Backward (window_attention_backward_kernel). Replaces _pallas_wa_bwd
// (mde_tpu/ops/window_attention.py:103-110), which recomputes the forward
// through the XLA einsums and differentiates it; key_valid gets no gradient.
// For each (batch*window, head) it returns dq, dk and dv; a key whose
// validity entry is <= 0 has the forward's logit -FLT_MAX, so its
// probability and its dk and dv are 0 (the logit gradient is gated by the
// mask, as autograd gates it through the plain version's torch.where).
//
// What bounds it on an H100: at the flagship train shape (4, 20, 256, 32)
// with 8 heads, 41.9 M (query, key, head) pairs at 10 * head_dim = 40 FLOP
// (S, dP, dV, dK, dQ) are 1.68 GFLOP, 25 us at the 67 TFLOP/s of the CUDA
// cores, against 18.4 MB of q/k/v/dO/dq/dk/dv in float32 (5.5 us) or 9.2 MB
// in bf16: operations bound it. Each pair also needs two exponentials, and
// head_dim 4 is far below any mma tile, so the tensor cores do not help.
//
// Design: one block per (batch*window, head), one thread per row, T <= 1024,
// one launch with no atomics. The block stages q, k, v and dO of its head in
// shared memory as float32 (16 KB at T = 256, head_dim 4), with the mask row.
// Phase A: thread i reruns its row's online softmax exactly as the forward
// does, and keeps the row max m_i, the reciprocal sum 1/l_i (log-sum-exp in
// two parts: m + log l would lose log l where a row's logits are all
// -FLT_MAX) and delta_i = dO_i . O_i with the float32 O, not the stored
// (maybe bf16) output: the math autograd uses through the plain version.
// Phase B: thread i loops over the keys, p = exp(s - m_i) / l_i,
// ds = p (dO_i . v_j - delta_i), dq_i += ds k_j. Phase C, after a barrier:
// thread j loops over the queries, dv_j += p dO_i and dk_j += ds q_i. Each
// output element is owned by one thread and summed in a fixed order, so two
// calls give the same bits. Every S is formed with the same fmaf sequence as
// the forward's. The cost is one extra T x T x head_dim pass for the
// softmax statistics; nothing but the inputs is read from memory.

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

// S = q_i . k_j, then scaled or, for an invalid key, -FLT_MAX: one fmaf
// sequence for the forward and every phase of the backward, so all see the
// same logits.
template <int kSlots>
__device__ __forceinline__ float logit(const float* qi, const float* kj, int hd,
                                       bool valid, float scale) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) s = fmaf(qi[d], kj[d], s);
  }
  return valid ? s * scale : -FLT_MAX;
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
    const float s = logit<kSlots>(qr, sk + j * hd, hd, smask[j] > 0.f, scale);
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

template <typename T, int HD>
__global__ void window_attention_backward_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_valid, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int n_windows,
    int t, int c, int hd_rt, float scale) {
  constexpr int kSlots = HD > 0 ? HD : kMaxHeadDim;
  const int hd = HD > 0 ? HD : hd_rt;
  const int bn = blockIdx.x;  // batch * n_windows + window
  const int head = blockIdx.y;
  const int window = bn % n_windows;

  extern __shared__ float smem[];
  float* sq = smem;            // (t, hd)
  float* sk = sq + t * hd;     // (t, hd)
  float* sv = sk + t * hd;     // (t, hd)
  float* sdo = sv + t * hd;    // (t, hd)
  float* smask = sdo + t * hd; // (t)
  float* smax = smask + t;     // (t) row max of the logits
  float* sinv = smax + t;      // (t) 1 / row sum of exp(logit - max)
  float* sdelta = sinv + t;    // (t) dO_i . O_i

  const size_t base = static_cast<size_t>(bn) * t * c + static_cast<size_t>(head) * hd;
  for (int idx = threadIdx.x; idx < t * hd; idx += blockDim.x) {
    const int row = idx / hd;
    const int d = idx - row * hd;
    const size_t src = base + static_cast<size_t>(row) * c + d;
    sq[idx] = to_float(q[src]);
    sk[idx] = to_float(k[src]);
    sv[idx] = to_float(v[src]);
    sdo[idx] = to_float(dout[src]);
  }
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    smask[j] = key_valid[static_cast<size_t>(window) * t + j];
  }
  __syncthreads();

  const int row = threadIdx.x;  // blockDim.x == t
  float qi[kSlots], doi[kSlots], acc[kSlots];
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    qi[d] = d < hd ? sq[row * hd + d] : 0.f;
    doi[d] = d < hd ? sdo[row * hd + d] : 0.f;
    acc[d] = 0.f;
  }

  // Phase A: the forward's online softmax of row i, for m, 1/l and delta.
  float m = -INFINITY;
  float l = 0.f;
  for (int j = 0; j < t; ++j) {
    const float s = logit<kSlots>(qi, sk + j * hd, hd, smask[j] > 0.f, scale);
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
  float delta = 0.f;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) delta = fmaf(doi[d], acc[d] * inv, delta);
  }
  smax[row] = m;
  sinv[row] = inv;
  sdelta[row] = delta;

  // Phase B: dq_i = scale * sum_j ds_ij k_j over the valid keys.
#pragma unroll
  for (int d = 0; d < kSlots; ++d) acc[d] = 0.f;
  for (int j = 0; j < t; ++j) {
    if (!(smask[j] > 0.f)) continue;  // ds is 0 for an invalid key
    const float* kj = sk + j * hd;
    const float* vj = sv + j * hd;
    const float p = expf(logit<kSlots>(qi, kj, hd, true, scale) - m) * inv;
    float dp = 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) dp = fmaf(doi[d], vj[d], dp);
    }
    const float ds = p * (dp - delta);
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
  }
  const size_t o = base + static_cast<size_t>(row) * c;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) dq[o + d] = from_float<T>(acc[d] * scale);
  }
  __syncthreads();

  // Phase C: thread j = row owns key j: dv_j = sum_i p_ij dO_i and
  // dk_j = scale * sum_i ds_ij q_i.
  const bool valid = smask[row] > 0.f;
  float kj[kSlots], vj[kSlots], dvr[kSlots];
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    kj[d] = d < hd ? sk[row * hd + d] : 0.f;
    vj[d] = d < hd ? sv[row * hd + d] : 0.f;
    acc[d] = 0.f;
    dvr[d] = 0.f;
  }
  for (int i = 0; i < t; ++i) {
    const float* qr = sq + i * hd;
    const float* dor = sdo + i * hd;
    const float p = expf(logit<kSlots>(qr, kj, hd, valid, scale) - smax[i]) * sinv[i];
    float dp = 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) {
        dvr[d] = fmaf(p, dor[d], dvr[d]);
        dp = fmaf(dor[d], vj[d], dp);
      }
    }
    const float ds = valid ? p * (dp - sdelta[i]) : 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) acc[d] = fmaf(ds, qr[d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) {
      dk[o + d] = from_float<T>(acc[d] * scale);
      dv[o + d] = from_float<T>(dvr[d]);
    }
  }
}

bool valid_shape(int batch, int n_windows, int t, int c, int num_heads) {
  return batch > 0 && n_windows > 0 && t > 0 && t <= 1024 && num_heads > 0 &&
         c % num_heads == 0 && c / num_heads <= kMaxHeadDim;
}

template <typename T, int HD>
cudaError_t launch_backward_hd(const T* q, const T* k, const T* v, const float* key_valid,
                               const T* dout, T* dq, T* dk, T* dv, int batch,
                               int n_windows, int t, int c, int hd, float scale,
                               size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_backward_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(batch * n_windows, c / hd);
  window_attention_backward_kernel<T, HD><<<grid, t, smem, s>>>(
      q, k, v, key_valid, dout, dq, dk, dv, n_windows, t, c, hd, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_backward(const T* q, const T* k, const T* v, const float* key_valid,
                    const T* dout, T* dq, T* dk, T* dv, int batch, int n_windows,
                    int t, int c, int num_heads, float scale, void* stream) {
  if (!valid_shape(batch, n_windows, t, c, num_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = c / num_heads;
  // q, k, v, dO (t x hd each), then mask, max, 1/sum and delta (t each)
  const size_t smem = (4 * static_cast<size_t>(t) * hd + 4 * t) * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 4:
      return static_cast<int>(launch_backward_hd<T, 4>(q, k, v, key_valid, dout, dq, dk, dv,
                                                       batch, n_windows, t, c, hd, scale, smem, s));
    case 8:
      return static_cast<int>(launch_backward_hd<T, 8>(q, k, v, key_valid, dout, dq, dk, dv,
                                                       batch, n_windows, t, c, hd, scale, smem, s));
    default:
      return static_cast<int>(launch_backward_hd<T, 0>(q, k, v, key_valid, dout, dq, dk, dv,
                                                       batch, n_windows, t, c, hd, scale, smem, s));
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* key_valid, T* out,
           int batch, int n_windows, int t, int c, int num_heads, float scale,
           void* stream) {
  if (!valid_shape(batch, n_windows, t, c, num_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = c / num_heads;
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

extern "C" int mde_window_attention_backward_f32(
    const float* q, const float* k, const float* v, const float* key_valid,
    const float* dout, float* dq, float* dk, float* dv, int batch, int n_windows,
    int t, int c, int num_heads, float scale, void* stream) {
  return launch_backward<float>(q, k, v, key_valid, dout, dq, dk, dv, batch, n_windows,
                                t, c, num_heads, scale, stream);
}

extern "C" int mde_window_attention_backward_bf16(
    const void* q, const void* k, const void* v, const float* key_valid,
    const void* dout, void* dq, void* dk, void* dv, int batch, int n_windows, int t,
    int c, int num_heads, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch_backward<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_valid, static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, n_windows, t, c, num_heads,
      scale, stream);
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
