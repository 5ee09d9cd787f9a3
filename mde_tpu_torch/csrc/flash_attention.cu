// Full (non-causal) attention over ViT tokens on the tensor cores, float32 or
// bf16, forward and backward: out = softmax(q k^T * D^-1/2) v for every
// (batch, head), D = 64, and the gradients of q, k and v.
//
// Replaces mde_tpu/ops/flash_attention.py::flash_attention (its body is
// _flash_kernel). The TPU kernel takes a 128-query block and the whole padded
// K/V of one (batch, head) into VMEM, masks the padded keys with the float32
// minimum and never writes the N x N logits to HBM. These kernels keep that
// last property and stream K/V instead, FlashAttention-2 style. The JAX kernel
// has no VJP (its ViT differentiates the einsum path); the backward here
// replaces the port's own recompute through the plain version.
//
// What bounds K4 on an H100: at DA-V2-S's training shape (B, N, H, D) =
// (4, 1345, 6, 64) the forward is 4 B H N^2 D = 11.1 GFLOP and the backward
// 10 B H N^2 D = 27.8 GFLOP (2.5x: S recomputed, then dV, dP, dK and dQ),
// against 16.5 MB of q/k/v/o in bf16: about 670 FLOP a byte, far above the
// card's 295 (bf16) ridge, so compute-bound. The design therefore puts every
// product on the tensor cores and keeps the logits, probabilities and their
// gradients in registers:
//
// - One block holds 64 rows (queries in the forward and dQ kernels, keys in
//   the dK/dV kernel), one warp per 16 rows. The other operand streams through
//   a two-stage ring of 64-row tiles in shared memory, filled with 16-byte
//   cp.async copies while the previous tile is computed. Rows past N are
//   zero-filled (cp.async with source size 0), never read.
// - bf16: mma.sync m16n8k16 with float32 accumulators. Tile rows are padded
//   to 144 bytes, so the eight row addresses of every ldmatrix fall in eight
//   distinct 16-byte bank groups; V (and every operand used as [k][n]) is read
//   with ldmatrix.trans. The accumulator layout of m16n8k16 is its A-operand
//   layout, so P (and dS) go from the softmax to the next product in
//   registers, rounded to bf16 there. That rounding is what the TPU kernel does
//   (p.astype(v.dtype), flash_attention.py:53) and what the JAX ViT does
//   (mde_tpu/nn/vit.py:66); the plain version keeps P in float32.
// - float32: the same tiling on mma.sync m16n8k8 TF32 in 3xTF32. Each operand
//   x splits into big = tf32(x) and small = tf32(x - big), and the product
//   accumulates small*big + big*small + big*big, which keeps float32 accuracy
//   (plain TF32 keeps about 3 digits). The tensor cores truncate each mma's
//   sum towards zero, so a chain of mmas into one accumulator drifts with its
//   length: the cross terms go into an accumulator of their own, and each
//   tile's share of a sum over tiles (O, dV, dK, dQ) is taken in fresh
//   accumulators and added in software. Rows are padded to 68 floats, so a
//   fragment read (row g, column t) lands in bank 4 g + t. The accumulator of
//   m16n8k8 holds columns 2t, 2t+1 where its A operand wants t, t+4; the P V
//   product permutes its k index the same way in both operands (logical t is
//   key 2t, logical t+4 is key 2t+1), which is free.
// - The online softmax (row max and sum) stays in float32 registers, in base
//   2 with log2(e) folded into the scale; a row is spread over the four
//   threads of a quad and reduced with __shfl_xor_sync. Key columns past N
//   get -inf before the row max, so their weight is exactly 0: the TPU
//   kernel's finfo.min mask. Query rows past N are neither stored nor given an
//   LSE.
// - The forward optionally writes lse = m + log(l) per query row (float32,
//   (B, H, N)); the train step asks for it, the predict step does not.
// - The backward is three launches, deterministic (no atomics, one thread
//   owns each output element and sums in a fixed order): delta = rowsum(dO o),
//   then one block per (64-key tile) accumulating dV = P^T dO and
//   dK = dS^T q * scale over the query tiles, then one block per (64-query
//   tile) accumulating dQ = dS k * scale over the key tiles, each recomputing
//   S and P = exp(S - lse), with dS = P (dP - delta), dP = dO v^T.
//
// Why mma.sync and not wgmma with TMA: 3xTF32 needs V as an MN-major B
// operand, and wgmma takes TF32 only K-major; one fragment vocabulary serves
// the forward and the backward in both element types; and a TMA descriptor a
// call would need cuTensorMapEncodeTiled from libcuda (-lcuda) in a
// ctypes-bound library. A warp-specialised wgmma/TMA form is the next redesign.
//
// q/k/v are (B, N, H, D) with (H, D) contiguous and any batch and token
// strides (shared by the three), so the views of a fused qkv projection,
// (B, N, 3, H, D), are read in place. out, dout, dq, dk and dv are contiguous
// (B, N, H, D); lse and delta are float32 (B, H, N).

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                // head dim
constexpr int kTile = 64;             // rows a block, rows a streamed tile
constexpr int kWarps = kTile / 16;    // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;            // ring depth of the streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Padded row stride of a shared-memory tile, in elements (see the note).
template <typename T>
constexpr int kRow = std::is_same<T, float>::value ? kD + 4 : kD + 8;
template <typename T>
constexpr int kTileElems = kTile * kRow<T>;
template <typename T>
constexpr int kTileBytes = kTileElems<T> * static_cast<int>(sizeof(T));

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to float32 accuracy, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower column, in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// Tiles and warp products
//
// A warp computes C (16 x 64) += A (16 x 64) * B (64 x 64) in accumulators
// c[j][e], j the 8-column tile: with g = lane / 4 and t = lane % 4, c[j][0..1]
// hold row g, columns 8 j + 2 t, +1, and c[j][2..3] row g + 8, the same
// columns.
// ---------------------------------------------------------------------------

// Rows [row0, row0 + kTile) of a (rows, D) slab with row stride `stride`
// elements into a padded shared tile; rows past n are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int n,
                                          long long stride) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  constexpr int kChunks = kD / kVec;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kVec;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * kRow<T> + c, src + (valid ? row : 0) * stride + c, valid);
  }
}

// A operand of a warp's 16 rows of a shared tile (row-major, k contiguous).
template <typename T>
struct AFrag;

template <>
struct AFrag<bf16> {
  uint32_t r[4][4];  // 4 k-steps of 16
  __device__ __forceinline__ void load(const bf16* rows, int lane) {
    const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldsm_x4(r[kk], rows + row * kRow<bf16> + kk * 16 + col);
  }
};

template <>
struct AFrag<float> {
  uint32_t big[8][4], small[8][4];  // 8 k-steps of 8
  __device__ __forceinline__ void load(const float* rows, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* p = rows + g * kRow<float> + kk * 8 + t;
      const float x[4] = {p[0], p[8 * kRow<float>], p[4], p[8 * kRow<float> + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(x[i], big[kk][i], small[kk][i]);
    }
  }
};

// c += A * M^T: M a shared tile of 64 rows, B[k][n] = M[n][k] (k contiguous).
__device__ __forceinline__ void mma_nt(float (&c)[8][4], const AFrag<bf16>& a, const bf16* m,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, m + (8 * j + (lane & 7)) * kRow<bf16> + 32 * p + (lane >> 3) * 8);
      mma_bf16(c[j], a.r[2 * p], b[0], b[1]);
      mma_bf16(c[j], a.r[2 * p + 1], b[2], b[3]);
    }
  }
}

// float32 (3xTF32): the tensor cores truncate each mma's sum to the
// accumulator's precision, so every mma into an accumulator moves it by up to
// an ulp of its value, always towards zero. The cross terms (small*big,
// big*small, about 2^-11 of the sum) therefore go into an accumulator of
// their own, where that ulp is 2^-11 smaller, and are added to the big*big
// sum in software: 8 mmas at full magnitude per product of depth 64, not 24.
// c starts at zero.
__device__ __forceinline__ void mma_nt(float (&c)[8][4], const AFrag<float>& a, const float* m,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* row = m + (8 * j + g) * kRow<float> + t;
    float cross[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(row[kk * 8], bb0, bs0);
      split_tf32(row[kk * 8 + 4], bb1, bs1);
      mma_tf32(cross, a.small[kk], bb0, bb1);
      mma_tf32(cross, a.big[kk], bs0, bs1);
      mma_tf32(c[j], a.big[kk], bb0, bb1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cross[e];
  }
}

// c += A * M^T with A the warp's 16 rows of a shared tile, read as needed
// (the backward, where registers are scarcer than shared-memory reads).
__device__ __forceinline__ void mma_nt_rows(float (&c)[8][4], const bf16* rows, const bf16* m,
                                            int lane) {
  AFrag<bf16> a;
  a.load(rows, lane);
  mma_nt(c, a, m, lane);
}

__device__ __forceinline__ void mma_nt_rows(float (&c)[8][4], const float* rows, const float* m,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ar = rows + g * kRow<float> + t;
  const float* br = m + g * kRow<float> + t;
  float cross[8][4];  // the cross terms apart (see mma_nt)
  zero(cross);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float x[4] = {ar[kk * 8], ar[8 * kRow<float> + kk * 8], ar[kk * 8 + 4],
                        ar[8 * kRow<float> + kk * 8 + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], ab[i], as[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* p = br + 8 * j * kRow<float> + kk * 8;
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(p[0], bb0, bs0);
      split_tf32(p[4], bb1, bs1);
      mma_tf32(cross[j], as, bb0, bb1);
      mma_tf32(cross[j], ab, bs0, bs1);
      mma_tf32(c[j], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cross[j][e];
  }
}

// c += A * M: A (16 x 64) in accumulator layout, M a shared tile, B[k][n] =
// M[k][n]. bf16: A is rounded to bf16 here.
__device__ __forceinline__ void mma_acc_nn(float (&c)[8][4], const float (&a)[8][4],
                                           const bf16* m, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t af[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                            pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                            pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                            pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const bf16* rows = m + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow<bf16>;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, rows + 16 * jp + (lane >> 4) * 8);
      mma_bf16(c[2 * jp], af, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], af, b[2], b[3]);
    }
  }
}

// float32: the product of one tile goes into fresh accumulators, the cross
// terms apart (see mma_nt), and is added to the running sum c in software, so
// a sum over many key or query tiles does not drift with their number.
__device__ __forceinline__ void mma_acc_nn(float (&c)[8][4], const float (&a)[8][4],
                                           const float* m, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float big[8][4], cross[8][4];
  zero(big);
  zero(cross);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    // k permuted in both operands: logical t is column 8 kk + 2 t, logical
    // t + 4 is 8 kk + 2 t + 1, which is where the accumulator holds them.
    uint32_t ab[4], as[4];
    split_tf32(a[kk][0], ab[0], as[0]);
    split_tf32(a[kk][2], ab[1], as[1]);
    split_tf32(a[kk][1], ab[2], as[2]);
    split_tf32(a[kk][3], ab[3], as[3]);
    const float* rows = m + (8 * kk + 2 * t) * kRow<float> + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(rows[8 * j], bb0, bs0);
      split_tf32(rows[kRow<float> + 8 * j], bb1, bs1);
      mma_tf32(cross[j], as, bb0, bb1);
      mma_tf32(cross[j], ab, bs0, bs1);
      mma_tf32(big[j], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += big[j][e] + cross[j][e];
  }
}

// Rows g and g + 8 of a warp's accumulators, scaled, to a contiguous
// (B, N, H, D) tensor, rows at or past n skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&c)[8][4], const float (&mul)[2],
                                           int row0, int n, int heads, int b, int h, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
    T* o = dst + ((static_cast<long long>(b) * n + row) * heads + h) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = c[j][2 * r] * mul[r], x1 = c[j][2 * r + 1] * mul[r];
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (batch * head, 64 queries), K/V streamed.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                       int n, int heads, long long stride_b, long long stride_n,
                       float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);        // kStages K tiles
  T* s_v = s_k + kStages * kTileElems<T>;     // kStages V tiles
  T* s_q = s_k + kTileElems<T>;               // the query tile, in K's stage 1 until read

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const int n_tiles = (n + kTile - 1) / kTile;

  load_tile(s_q, q + head, q0, n, stride_n);
  load_tile(s_k, k + head, 0, n, stride_n);
  load_tile(s_v, v + head, 0, n, stride_n);
  cp_async_commit();

  AFrag<T> qf;
  float o[8][4];
  zero(o);
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of the base-2 logits
  float l_r[2] = {0.f, 0.f};              // this thread's part of the running sum
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` is in; every warp is done with tile it - 1
    if (it == 0) {
      qf.load(s_q + warp * 16 * kRow<T>, lane);
      __syncthreads();  // the query tile's buffer is K's stage 1
    }
    if (it + 1 < n_tiles) {
      const int st = (it + 1) % kStages;
      load_tile(s_k + st * kTileElems<T>, k + head, (it + 1) * kTile, n, stride_n);
      load_tile(s_v + st * kTileElems<T>, v + head, (it + 1) * kTile, n, stride_n);
    }
    cp_async_commit();
    const T* ck = s_k + (it % kStages) * kTileElems<T>;
    const T* cv = s_v + (it % kStages) * kTileElems<T>;

    float s[8][4];
    zero(s);
    mma_nt(s, qf, ck, lane);
    const int k0 = it * kTile;
    if (k0 + kTile > n) {  // the ragged last tile: keys past n weigh exactly 0
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + 8 * j + 2 * t + (e & 1) >= n) s[j][e] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      // scale_log2 > 0, so the max commutes with it; a tile holds a valid key.
      mx = fmaxf(m_r[r], quad_max(mx) * scale_log2);
      const float corr = ex2(m_r[r] - mx);  // 0 at the first tile
      m_r[r] = mx;
      l_r[r] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][2 * r] *= corr;
        o[j][2 * r + 1] *= corr;
        s[j][2 * r] = ex2(fmaf(s[j][2 * r], scale_log2, -mx));
        s[j][2 * r + 1] = ex2(fmaf(s[j][2 * r + 1], scale_log2, -mx));
        l_r[r] += s[j][2 * r] + s[j][2 * r + 1];
      }
    }
    mma_acc_nn(o, s, cv, lane);
  }

  const int row0 = q0 + warp * 16;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    inv[r] = 1.f / l;
    const int row = row0 + (lane >> 2) + 8 * r;
    if (lse != nullptr && t == 0 && row < n) {
      lse[static_cast<long long>(bh) * n + row] = (m_r[r] + log2f(l)) * kLn2;
    }
  }
  store_rows(out, o, inv, row0, n, heads, b, h, lane);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

// delta[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]: one thread a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int n, int heads, long long rows) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* o = out + r * kD;
  const T* d = dout + r * kD;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    const float4 x = load4(o + c), y = load4(d + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  const int h = static_cast<int>(r % heads);
  const long long bi = r / heads;
  const long long b = bi / n;
  const int i = static_cast<int>(bi - b * n);
  delta[(b * heads + h) * n + i] = acc;
}

// dK and dV of 64 keys: loops over the query tiles. Rows of the warp's
// products are keys, columns queries.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                            long long stride_b, long long stride_n, float scale_log2,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + kTileElems<T>;
  T* s_q = s_v + kTileElems<T>;                  // kStages query tiles
  T* s_do = s_q + kStages * kTileElems<T>;       // kStages dout tiles
  float* s_lse = reinterpret_cast<float*>(s_do + kStages * kTileElems<T>);  // kStages x kTile
  float* s_delta = s_lse + kStages * kTile;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const long long ostride = static_cast<long long>(heads) * kD;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;
  const int n_tiles = (n + kTile - 1) / kTile;

  auto load_queries = [&](int tile, int st) {
    load_tile(s_q + st * kTileElems<T>, q + head, tile * kTile, n, stride_n);
    load_tile(s_do + st * kTileElems<T>, dout + ohead, tile * kTile, n, ostride);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = tile * kTile + i;
      // A query past n gets lse = +inf, so P = 0 and it adds nothing.
      s_lse[st * kTile + i] = row < n ? lse_bh[row] * kLog2e : INFINITY;
      s_delta[st * kTile + i] = row < n ? delta_bh[row] : 0.f;
    }
  };

  load_tile(s_k, k + head, k0, n, stride_n);
  load_tile(s_v, v + head, k0, n, stride_n);
  load_queries(0, 0);
  cp_async_commit();

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_queries(it + 1, (it + 1) % kStages);
    cp_async_commit();
    const int st = it % kStages;
    const T* cq = s_q + st * kTileElems<T>;
    const T* cdo = s_do + st * kTileElems<T>;
    const float* cl = s_lse + st * kTile;
    const float* cd = s_delta + st * kTile;

    float p[8][4];  // S^T, then P^T
    zero(p);
    mma_nt_rows(p, s_k + warp * 16 * kRow<T>, cq, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = ex2(fmaf(p[j][e], scale_log2, -cl[8 * j + 2 * t + (e & 1)]));
      }
    }
    mma_acc_nn(dv_acc, p, cdo, lane);  // dV += P^T dO

    float ds[8][4];  // dP^T = v dO^T, then dS^T
    zero(ds);
    mma_nt_rows(ds, s_v + warp * 16 * kRow<T>, cdo, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - cd[8 * j + 2 * t + (e & 1)]);
    }
    mma_acc_nn(dk_acc, ds, cq, lane);  // dK += dS^T q (scaled at the store)
  }

  const int row0 = k0 + warp * 16;
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_rows(dk, dk_acc, sc, row0, n, heads, b, h, lane);
  store_rows(dv, dv_acc, one, row0, n, heads, b, h, lane);
}

// dQ of 64 queries: loops over the key tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int n, int heads, long long stride_b,
                          long long stride_n, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_do = s_q + kTileElems<T>;
  T* s_k = s_do + kTileElems<T>;               // kStages key tiles
  T* s_v = s_k + kStages * kTileElems<T>;      // kStages value tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const int n_tiles = (n + kTile - 1) / kTile;

  load_tile(s_q, q + head, q0, n, stride_n);
  load_tile(s_do, dout + ohead, q0, n, static_cast<long long>(heads) * kD);
  load_tile(s_k, k + head, 0, n, stride_n);
  load_tile(s_v, v + head, 0, n, stride_n);
  cp_async_commit();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const long long idx = static_cast<long long>(bh) * n + row;
    lse_r[r] = row < n ? lse[idx] * kLog2e : INFINITY;
    delta_r[r] = row < n ? delta[idx] : 0.f;
  }

  float dq_acc[8][4];
  zero(dq_acc);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int st = (it + 1) % kStages;
      load_tile(s_k + st * kTileElems<T>, k + head, (it + 1) * kTile, n, stride_n);
      load_tile(s_v + st * kTileElems<T>, v + head, (it + 1) * kTile, n, stride_n);
    }
    cp_async_commit();
    const T* ck = s_k + (it % kStages) * kTileElems<T>;
    const T* cv = s_v + (it % kStages) * kTileElems<T>;
    const int k0 = it * kTile;

    float p[8][4];  // S, then P
    zero(p);
    mma_nt_rows(p, s_q + warp * 16 * kRow<T>, ck, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * j + 2 * t + (e & 1) < n;  // zero-filled keys weigh 0
        p[j][e] = valid ? ex2(fmaf(p[j][e], scale_log2, -lse_r[e >> 1])) : 0.f;
      }
    }
    float ds[8][4];  // dP = dO v^T, then dS
    zero(ds);
    mma_nt_rows(ds, s_do + warp * 16 * kRow<T>, cv, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]);
    }
    mma_acc_nn(dq_acc, ds, ck, lane);  // dQ += dS k (scaled at the store)
  }

  const float sc[2] = {scale, scale};
  store_rows(dq, dq_acc, sc, q0 + warp * 16, n, heads, b, h, lane);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

bool bad_shape(int batch, int n, int heads, int d, long long stride_b, long long stride_n,
               dim3* grid) {
  if (batch <= 0 || n <= 0 || heads <= 0 || d != kD || stride_b < 0 || stride_n < 0) return true;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  if (bh > INT_MAX || tiles > 65535) return true;
  *grid = dim3(static_cast<unsigned>(bh), static_cast<unsigned>(tiles));
  return false;
}

// Above 48 KB a kernel's dynamic shared memory has to be allowed first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_forward(const T* q, const T* k, const T* v, T* out, float* lse, int batch, int n,
                   int heads, int d, long long stride_b, long long stride_n, float scale,
                   void* stream) {
  dim3 grid;
  if (bad_shape(batch, n, heads, d, stride_b, stride_n, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = 2 * kStages * kTileBytes<T>;
  cudaError_t err = allow_smem(flash_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, lse, n, heads, stride_b, stride_n, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const T* q, const T* k, const T* v, const T* out, const T* dout,
                    const float* lse, float* delta, T* dq, T* dk, T* dv, int batch, int n,
                    int heads, int d, long long stride_b, long long stride_n, float scale,
                    void* stream) {
  dim3 grid;
  if (bad_shape(batch, n, heads, d, stride_b, stride_n, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(batch) * n * heads;
  const long long blocks = (rows + 255) / 256;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_delta_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      out, dout, delta, n, heads, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_dkdv = (2 + 2 * kStages) * kTileBytes<T> +
                            2 * kStages * kTile * static_cast<int>(sizeof(float));
  err = allow_smem(flash_attention_dkdv_kernel<T>, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_dkdv_kernel<T><<<grid, kThreads, smem_dkdv, s>>>(
      q, k, v, dout, lse, delta, dk, dv, n, heads, stride_b, stride_n, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_dq = (2 + 2 * kStages) * kTileBytes<T>;
  err = allow_smem(flash_attention_dq_kernel<T>, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_dq_kernel<T><<<grid, kThreads, smem_dq, s>>>(
      q, k, v, dout, lse, delta, dq, n, heads, stride_b, stride_n, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mde_flash_attention_f32(const float* q, const float* k, const float* v,
                                       float* out, float* lse, int batch, int n, int heads,
                                       int d, long long stride_b, long long stride_n,
                                       float scale, void* stream) {
  return launch_forward<float>(q, k, v, out, lse, batch, n, heads, d, stride_b, stride_n, scale,
                               stream);
}

extern "C" int mde_flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                        float* lse, int batch, int n, int heads, int d,
                                        long long stride_b, long long stride_n, float scale,
                                        void* stream) {
  return launch_forward<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, batch,
                              n, heads, d, stride_b, stride_n, scale, stream);
}

extern "C" int mde_flash_attention_backward_f32(
    const float* q, const float* k, const float* v, const float* out, const float* dout,
    const float* lse, float* delta, float* dq, float* dk, float* dv, int batch, int n, int heads,
    int d, long long stride_b, long long stride_n, float scale, void* stream) {
  return launch_backward<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, batch, n, heads, d,
                                stride_b, stride_n, scale, stream);
}

extern "C" int mde_flash_attention_backward_bf16(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int batch, int n, int heads,
    int d, long long stride_b, long long stride_n, float scale, void* stream) {
  return launch_backward<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, delta,
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, n, heads, d,
      stride_b, stride_n, scale, stream);
}
