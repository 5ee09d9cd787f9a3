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
// When a backward will follow, the caller passes a stats pointer and each
// thread also writes its row's final (max, 1 / sum), float32, (B*N, heads,
// T, 2); with a null pointer nothing more is written. Either way the output
// is the same. The pair is kept as it is, not as m + log l: a row whose
// logits are all -FLT_MAX would lose log l in that sum.
//
// Backward (window_attention_backward_kernel). Replaces _pallas_wa_bwd
// (mde_tpu/ops/window_attention.py:103), which recomputes the forward
// through the XLA einsums and differentiates it; key_valid gets no gradient.
// For each (batch*window, head) it returns dq, dk and dv from the forward's
// row statistics and its stored output: p_ij = exp(s_ij - m_i) / l_i,
// delta_i = dO_i . O_i, ds_ij = p_ij (dO_i . v_j - delta_i) on the valid
// keys (an invalid key's logit is the constant -FLT_MAX, so it passes no
// gradient, as autograd gates it through the plain version's torch.where),
// dq_i = scale sum_j ds_ij k_j, dk_j = scale sum_i ds_ij q_i and
// dv_j = sum_i p_ij dO_i. In bf16, delta reads the bf16-rounded output.
//
// What bounds it on an H100: at the flagship train shape (4, 20, 256, 32)
// with 8 heads, 41.9 M (query, key, head) pairs at 10 * head_dim = 40 FLOP
// (S, dP, dV, dK, dQ) are 1.68 GFLOP, 25 us at the 67 TFLOP/s of the CUDA
// cores, against 18.4 MB of q/k/v/dO/dq/dk/dv in float32 (5.5 us) or 9.2 MB
// in bf16: operations bound it, with one exponential a pair on the SFUs
// (about 12 us). The tensor cores do not help: at head_dim 4 a bf16
// m16n8k16 tile is three-quarters padding, every product here has head_dim
// as its inner or outer width, and float32 accuracy would need 3xTF32. So
// it runs in float32 on the CUDA cores in both element types, and the
// design aims at the least work a pair: each p_ij formed once and used for
// dv, ds, dq and dk, and few shared-memory loads a pair.
//
// Design (head_dim 4 and 8): one block per (batch*window, head), 4 warps,
// four blocks an SM (128 registers a thread), one launch, no atomics. The
// prologue stages q, dO and each row's (m log2(e), 1/l, delta) in shared
// memory as float32, delta from the stored output. The keys go in chunks of
// 32 C (C = 4 at head_dim 4, 2 at 8: 128 and 64 keys), staged as
// k' = k * scale * log2(e), and 0 for an invalid key, whose logit is
// instead the -FLT_MAX that its dot product starts from: p = 2^(q . k' -
// m log2(e)) / l needs no select and no scaling a pair. Lane l of every
// warp holds keys l, l + 32, ... of the chunk in registers, with their dk
// and dv sums. Each warp walks its own query rows, R = 32 / head_dim at a
// time: one broadcast load of q_i, dO_i and the row's three scalars serves
// the lane's C keys, and each pair costs one exponential and 24 float
// operations. The R x head_dim = 32 partial dq values of a step are summed
// across the 32 lanes by a reduce-scatter of shuffles (31 a step, after
// which lane l holds element l) and added to the row's float32 dq in shared
// memory, which one warp owns. At the end of a chunk the warps' dk and dv
// sums meet in shared memory and are added in warp order. Every sum has a
// fixed order, so two calls give the same bits. ds is not gated by the
// mask: an invalid key's p is 0, except in a window with no valid key at
// all, where every p is 1/T as in the forward; there k' = 0 keeps ds out of
// dq, and dk is written as 0. Keys past T (a ragged last chunk) are invalid
// keys with v = 0 and are not written; rows past a multiple of R have
// 1/l = 0, so p = 0. More keys a lane (C = 8) halve the shuffles a pair but
// need 255 registers and one block an SM, and measured slower on the H100.
// Other head widths (<= 64) take window_attention_backward_wide_kernel: one
// thread a row, dq by rows, then dk and dv by keys, two exponentials a pair.

#include <cfloat>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHeadDim = 64;
constexpr int kBwdThreads = 128;  // 4 warps a block in the tiled backward
constexpr float kLog2e = 1.4426950408889634f;
// keys a lane holds in the tiled backward: 4 at head_dim 4, 2 at 8
template <int HD>
constexpr int kLaneKeys = 16 / HD;

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

// S = q_i . k_j, then scaled or, for an invalid key, -FLT_MAX.
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

// 2^x on the SFU; -inf gives 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The backward's logit in base 2: q_i . k'_j with k' = k * scale * log2(e),
// or -FLT_MAX for an invalid key (whose k' the kernels set to 0), summed
// from that bias so the mask costs no instruction a pair.
template <int kSlots>
__device__ __forceinline__ float logit2(const float* qi, const float* kj, int hd, float bias) {
  float s = bias;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) s = fmaf(qi[d], kj[d], s);
  }
  return s;
}

template <typename T, int HD>
__global__ void window_attention_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ key_valid,
                                        T* __restrict__ out, float* __restrict__ stats,
                                        int n_windows, int t, int c, int hd_rt, float scale) {
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
  if (stats != nullptr) {
    reinterpret_cast<float2*>(stats)[(static_cast<size_t>(bn) * gridDim.y + head) * t + row] =
        make_float2(m, inv);
  }
}

// Four floats from 16-byte aligned shared memory, in one load.
__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}

// One halving step of reduce_scatter32: lanes with bit HALF set keep the
// upper HALF values, the others the lower, each adding its partner's.
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// Sums v[0..31] of the 32 lanes element by element; lane l returns the sum
// of element l. Five halving steps, 31 shuffles, in a fixed order.
__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  halve<1>(v, lane & 1);
  return v[0];
}

// The prologue of both backward kernels: row i's q and dO as float32 and its
// (m', 1/l, delta = dO_i . O_i with the stored output, 0) for i < t, where
// m' = m log2(e) kept finite: a row whose logits are all -FLT_MAX has
// m' = -FLT_MAX, which its keys' -FLT_MAX meets as 2^0 = 1, as in the
// forward; zeros and 1/l = 0 (so p = 0) for the padding rows up to ``rows``.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* q, const T* out, const T* dout,
                                           const float* stats, size_t base, int t, int rows,
                                           int c, int hd, float* sq, float* sdo, float4* srow) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float4 row = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t o = base + static_cast<size_t>(i) * c;
    for (int d = 0; d < hd; ++d) {
      const float qv = i < t ? to_float(q[o + d]) : 0.f;
      const float dov = i < t ? to_float(dout[o + d]) : 0.f;
      if (i < t) row.z = fmaf(dov, to_float(out[o + d]), row.z);
      sq[i * hd + d] = qv;
      sdo[i * hd + d] = dov;
    }
    if (i < t) {
      row.x = fmaxf(stats[2 * i] * kLog2e, -FLT_MAX);
      row.y = stats[2 * i + 1];
    }
    srow[i] = row;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 4) window_attention_backward_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_valid, const T* __restrict__ out,
    const float* __restrict__ stats, const T* __restrict__ dout, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int n_windows, int t, int c, float scale) {
  constexpr int R = 32 / HD;        // query rows a step: R * HD = 32 dq values
  constexpr int C = kLaneKeys<HD>;
  constexpr int KC = 32 * C;        // keys a chunk
  constexpr int W = kBwdThreads / 32;
  constexpr int KS = 2 * HD;        // dk and dv values a key
  const int bn = blockIdx.x;  // batch * n_windows + window
  const int head = blockIdx.y;
  const int window = bn % n_windows;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rows = (t + R - 1) / R * R;
  const float kscale = scale * kLog2e;

  extern __shared__ float4 smem4[];
  float4* srow = smem4;                          // (rows): m', 1/l, delta, 0
  float* sq = reinterpret_cast<float*>(srow + rows);  // (rows, HD)
  float* sdo = sq + rows * HD;                   // (rows, HD)
  float* sdq = sdo + rows * HD;                  // (rows, HD) float32 dq sums
  float* sk = sdq + rows * HD;                   // (KC, HD) the chunk's k'
  float* sv = sk + KC * HD;                      // (KC, HD)
  float* smask = sv + KC * HD;                   // (KC) 1 for a valid key, else 0
  float* sred = smask + KC;                      // (W, KC, KS) each warp's dk, dv sums

  const size_t base = static_cast<size_t>(bn) * t * c + static_cast<size_t>(head) * HD;
  stage_rows<T>(q, out, dout, stats + (static_cast<size_t>(bn) * gridDim.y + head) * t * 2,
                base, t, rows, c, HD, sq, sdo, srow);
  for (int idx = threadIdx.x; idx < rows * HD; idx += blockDim.x) sdq[idx] = 0.f;

  for (int k0 = 0; k0 < t; k0 += KC) {
    __syncthreads();  // the staged rows are in; the last chunk's sk, sv, sred are read
    for (int jj = threadIdx.x; jj < KC; jj += blockDim.x) {
      const int j = k0 + jj;
      smask[jj] = j < t && key_valid[static_cast<size_t>(window) * t + j] > 0.f ? 1.f : 0.f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < KC * HD; idx += blockDim.x) {
      const int j = k0 + idx / HD;
      const size_t src = base + static_cast<size_t>(j) * c + idx % HD;
      sk[idx] = smask[idx / HD] > 0.f ? to_float(k[src]) * kscale : 0.f;
      sv[idx] = j < t ? to_float(v[src]) : 0.f;
    }
    __syncthreads();

    float kr[C][HD], vr[C][HD], dkr[C][HD], dvr[C][HD], bias[C];
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      const int jj = cc * 32 + lane;
      bias[cc] = smask[jj] > 0.f ? 0.f : -FLT_MAX;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        load4(sk + jj * HD + d, kr[cc] + d);
        load4(sv + jj * HD + d, vr[cc] + d);
      }
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dkr[cc][d] = 0.f;
        dvr[cc][d] = 0.f;
      }
    }

    for (int i0 = warp * R; i0 < t; i0 += W * R) {
      float dqp[R * HD];
#pragma unroll
      for (int x = 0; x < R * HD; ++x) dqp[x] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        const float4 st = srow[i];  // m', 1/l, delta
        float qi[HD], doi[HD];
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          load4(sq + i * HD + d, qi + d);
          load4(sdo + i * HD + d, doi + d);
        }
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const float p = ex2(logit2<HD>(qi, kr[cc], HD, bias[cc]) - st.x) * st.y;
          float dp = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dp = fmaf(doi[d], vr[cc][d], dp);
          // not gated: an invalid key has p = 0, or k' = 0 and its dk
          // written as 0 where its window has no valid key at all
          const float ds = p * (dp - st.z);
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            dvr[cc][d] = fmaf(p, doi[d], dvr[cc][d]);
            dkr[cc][d] = fmaf(ds, qi[d], dkr[cc][d]);
            dqp[r * HD + d] = fmaf(ds, kr[cc][d], dqp[r * HD + d]);
          }
        }
      }
      // lane l now holds element l of the step's R x HD dq sums
      sdq[i0 * HD + lane] += reduce_scatter32(dqp, lane);
    }

    // The warps' dk and dv sums of the chunk's keys, added in warp order.
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      float* dst = sred + (warp * KC + cc * 32 + lane) * KS;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dst[d] = dkr[cc][d];
        dst[HD + d] = dvr[cc][d];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < KC * KS; idx += blockDim.x) {
      const int jj = idx / KS;
      const int comp = idx % KS;
      const int j = k0 + jj;
      if (j >= t) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) sum += sred[w * KC * KS + idx];
      const size_t o = base + static_cast<size_t>(j) * c;
      if (comp < HD) {
        dk[o + comp] = from_float<T>(smask[jj] > 0.f ? sum * scale : 0.f);
      } else {
        dv[o + comp - HD] = from_float<T>(sum);
      }
    }
  }
  __syncthreads();
  // dq = scale * sum ds k = sum ds k' / log2(e)
  for (int idx = threadIdx.x; idx < t * HD; idx += blockDim.x) {
    dq[base + static_cast<size_t>(idx / HD) * c + idx % HD] =
        from_float<T>(sdq[idx] * (scale / kscale));
  }
}

// Any head_dim <= 64: one thread a row (blockDim.x == t). dq_i by rows, then
// thread j owns key j for dk_j and dv_j; p formed in each.
template <typename T>
__global__ void window_attention_backward_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ key_valid, const T* __restrict__ out,
    const float* __restrict__ stats, const T* __restrict__ dout, T* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int n_windows, int t, int c, int hd, float scale) {
  constexpr int kSlots = kMaxHeadDim;
  const int bn = blockIdx.x;
  const int head = blockIdx.y;
  const int window = bn % n_windows;
  const float kscale = scale * kLog2e;

  extern __shared__ float4 smem4[];
  float4* srow = smem4;                               // (t): m', 1/l, delta, 0
  float* sq = reinterpret_cast<float*>(srow + t);     // (t, hd)
  float* sdo = sq + t * hd;                           // (t, hd)
  float* sk = sdo + t * hd;                           // (t, hd) k'
  float* sv = sk + t * hd;                            // (t, hd)
  float* smask = sv + t * hd;                         // (t)

  const size_t base = static_cast<size_t>(bn) * t * c + static_cast<size_t>(head) * hd;
  stage_rows<T>(q, out, dout, stats + (static_cast<size_t>(bn) * gridDim.y + head) * t * 2,
                base, t, t, c, hd, sq, sdo, srow);
  for (int j = threadIdx.x; j < t; j += blockDim.x) {
    smask[j] = key_valid[static_cast<size_t>(window) * t + j] > 0.f ? 1.f : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < t * hd; idx += blockDim.x) {
    const size_t src = base + static_cast<size_t>(idx / hd) * c + idx % hd;
    sk[idx] = smask[idx / hd] > 0.f ? to_float(k[src]) * kscale : 0.f;
    sv[idx] = to_float(v[src]);
  }
  __syncthreads();

  const int row = threadIdx.x;
  const float4 st = srow[row];
  float qi[kSlots], doi[kSlots], acc[kSlots];
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    qi[d] = d < hd ? sq[row * hd + d] : 0.f;
    doi[d] = d < hd ? sdo[row * hd + d] : 0.f;
    acc[d] = 0.f;
  }
  for (int j = 0; j < t; ++j) {
    if (!(smask[j] > 0.f)) continue;  // ds is 0 for an invalid key
    const float* kj = sk + j * hd;
    const float* vj = sv + j * hd;
    const float p = ex2(logit2<kSlots>(qi, kj, hd, 0.f) - st.x) * st.y;
    float dp = 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) dp = fmaf(doi[d], vj[d], dp);
    }
    const float ds = p * (dp - st.z);
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) acc[d] = fmaf(ds, kj[d], acc[d]);
    }
  }
  const size_t o = base + static_cast<size_t>(row) * c;
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) dq[o + d] = from_float<T>(acc[d] * (scale / kscale));
  }

  const bool valid = smask[row] > 0.f;
  const float bias = valid ? 0.f : -FLT_MAX;
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
    const float4 si = srow[i];
    const float p = ex2(logit2<kSlots>(qr, kj, hd, bias) - si.x) * si.y;
    float dp = 0.f;
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) {
        dvr[d] = fmaf(p, dor[d], dvr[d]);
        dp = fmaf(dor[d], vj[d], dp);
      }
    }
    const float ds = p * (dp - si.z);
#pragma unroll
    for (int d = 0; d < kSlots; ++d) {
      if (d < hd) acc[d] = fmaf(ds, qr[d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < kSlots; ++d) {
    if (d < hd) {
      dk[o + d] = from_float<T>(valid ? acc[d] * scale : 0.f);
      dv[o + d] = from_float<T>(dvr[d]);
    }
  }
}

bool valid_shape(int batch, int n_windows, int t, int c, int num_heads) {
  return batch > 0 && n_windows > 0 && t > 0 && t <= 1024 && num_heads > 0 &&
         c % num_heads == 0 && c / num_heads <= kMaxHeadDim;
}

// Shared memory of the backward kernels, in bytes.
template <int HD>
size_t tiled_backward_smem(int t) {
  constexpr int R = 32 / HD, KC = 32 * kLaneKeys<HD>;
  const size_t rows = (t + R - 1) / R * R;
  return (rows * 4 + 3 * rows * HD + 2 * KC * HD + KC +
          (kBwdThreads / 32) * 2 * HD * KC) * sizeof(float);
}

size_t wide_backward_smem(int t, int hd) {
  return (static_cast<size_t>(t) * 4 + 4 * static_cast<size_t>(t) * hd + t) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int HD>
cudaError_t launch_backward_tiled(const T* q, const T* k, const T* v, const float* key_valid,
                                  const T* out, const float* stats, const T* dout, T* dq, T* dk,
                                  T* dv, int batch, int n_windows, int t, int c, float scale,
                                  cudaStream_t s) {
  const size_t smem = tiled_backward_smem<HD>(t);
  const cudaError_t err = allow_smem(window_attention_backward_kernel<T, HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * n_windows, c / HD);
  window_attention_backward_kernel<T, HD><<<grid, kBwdThreads, smem, s>>>(
      q, k, v, key_valid, out, stats, dout, dq, dk, dv, n_windows, t, c, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_backward(const T* q, const T* k, const T* v, const float* key_valid, const T* out,
                    const float* stats, const T* dout, T* dq, T* dk, T* dv, int batch,
                    int n_windows, int t, int c, int num_heads, float scale, void* stream) {
  if (!valid_shape(batch, n_windows, t, c, num_heads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hd = c / num_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 4:
      return static_cast<int>(launch_backward_tiled<T, 4>(
          q, k, v, key_valid, out, stats, dout, dq, dk, dv, batch, n_windows, t, c, scale, s));
    case 8:
      return static_cast<int>(launch_backward_tiled<T, 8>(
          q, k, v, key_valid, out, stats, dout, dq, dk, dv, batch, n_windows, t, c, scale, s));
    default: {
      const size_t smem = wide_backward_smem(t, hd);
      cudaError_t err = allow_smem(window_attention_backward_wide_kernel<T>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      window_attention_backward_wide_kernel<T><<<dim3(batch * n_windows, num_heads), t, smem, s>>>(
          q, k, v, key_valid, out, stats, dout, dq, dk, dv, n_windows, t, c, hd, scale);
      return static_cast<int>(cudaGetLastError());
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* key_valid, T* out, float* stats,
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
      window_attention_kernel<T, 4><<<grid, t, smem, s>>>(q, k, v, key_valid, out, stats,
                                                          n_windows, t, c, hd, scale);
      break;
    case 8:
      window_attention_kernel<T, 8><<<grid, t, smem, s>>>(q, k, v, key_valid, out, stats,
                                                          n_windows, t, c, hd, scale);
      break;
    default:
      window_attention_kernel<T, 0><<<grid, t, smem, s>>>(q, k, v, key_valid, out, stats,
                                                          n_windows, t, c, hd, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``stats`` may be null: then only ``out`` is written.
extern "C" int mde_window_attention_f32(const float* q, const float* k,
                                        const float* v, const float* key_valid,
                                        float* out, float* stats, int batch, int n_windows,
                                        int t, int c, int num_heads, float scale,
                                        void* stream) {
  return launch<float>(q, k, v, key_valid, out, stats, batch, n_windows, t, c, num_heads,
                       scale, stream);
}

extern "C" int mde_window_attention_bf16(const void* q, const void* k,
                                         const void* v, const float* key_valid,
                                         void* out, float* stats, int batch, int n_windows,
                                         int t, int c, int num_heads, float scale,
                                         void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), key_valid, static_cast<bf16*>(out), stats,
                      batch, n_windows, t, c, num_heads, scale, stream);
}

extern "C" int mde_window_attention_backward_f32(
    const float* q, const float* k, const float* v, const float* key_valid, const float* out,
    const float* stats, const float* dout, float* dq, float* dk, float* dv, int batch,
    int n_windows, int t, int c, int num_heads, float scale, void* stream) {
  return launch_backward<float>(q, k, v, key_valid, out, stats, dout, dq, dk, dv, batch,
                                n_windows, t, c, num_heads, scale, stream);
}

extern "C" int mde_window_attention_backward_bf16(
    const void* q, const void* k, const void* v, const float* key_valid, const void* out,
    const float* stats, const void* dout, void* dq, void* dk, void* dv, int batch, int n_windows,
    int t, int c, int num_heads, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch_backward<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      key_valid, static_cast<const bf16*>(out), stats, static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, n_windows,
      t, c, num_heads, scale, stream);
}

extern "C" const char* mde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
