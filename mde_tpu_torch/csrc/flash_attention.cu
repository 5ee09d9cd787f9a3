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
// - The backward is three launches, deterministic (no atomics; every sum in
//   one fixed order): delta = rowsum(dO o); then one block per 64 keys
//   accumulating dV = P^T dO and dK = dS^T q * scale over the query tiles;
//   then one block per 64 queries (128 in bf16) accumulating dQ = dS k *
//   scale over the key tiles. Each recomputes S and P = exp(S - lse), with
//   dP = dO v^T and dS = P (dP - delta). The grids come from the shape
//   alone: at DA-V2-S's (4, 1345, 6, 64), 24 x 22 = 528 blocks a pass, 4
//   waves on 132 SMs at float32's one block an SM and 2 at bf16's two; bf16's
//   dQ 24 x 11 = 264, one wave.
//
// What bounds the backward: 5 products of 2 N^2 D a (batch, head) (27.8
// GFLOP at DA-V2-S, bound 0.028 ms in bf16 and 0.168 ms in 3xTF32); the
// kernels do 7, because the dQ pass computes S and dP again. That stays:
// the alternatives are atomics on dQ (other bits each run), ordered
// semaphores between blocks, or a float32 dQ scratch a key block (22 x the
// size of dQ, more bytes than the products it saves). On mma.sync the
// products then run at about 125 TFLOP/s of TF32 (float32) and 280-330 of
// bf16, counted over the padded 64-row tiles (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py --k4-backward-only); with float32's split operands the
// shared-memory reads (8 bytes an operand element) take as long as the mmas
// and do not overlap them.
//
// The backward's design, against what held the first one back:
// 1. float32 split every operand inside every product. Now each streamed
//    tile is split once a block: a cooperative pass turns the raw tile into
//    (big, small) TF32 pairs in shared memory, each thread the chunks it
//    copied, and the products read pairs with 8-byte loads from rows whose
//    pair slots are permuted (split_xor) so that both fragment reads are
//    conflict-free. The block's own keys and values (queries and dO in dQ)
//    are split once before the loop, into planes of the same layout. Only
//    the accumulators that feed the next product (P, dS) are split where
//    they are, in registers. The 3xTF32 rules stay: cross terms apart, each
//    tile's share of a sum in fresh accumulators.
// 2. bf16 reloaded the block's fixed operands each tile. Now the warp's
//    K and V (q and dO in dQ) A fragments go into registers once.
// 3. The copy ring waited for the tile it had just asked for. Now bf16 has
//    three stages, cp.async.wait_group leaving the newest in flight, so two
//    tiles fly while one is computed; float32 has one raw stage and two split
//    buffers: tile it + 2 flies while tile it is computed and tile it + 1 is
//    split, one barrier a tile. lse and delta travel with their tile by
//    4-byte cp.async.
// 4. Each streamed tile served 64 rows. bf16's dQ now takes 128 rows a
//    block, 32 a warp as two 16-row tiles that share every B fragment (half
//    the shared reads and L2 traffic a row); its dK/dV spilled so, with two
//    sets of accumulators, and keeps 64 rows, a warp per 16 (8 warps of 16
//    measured no faster). float32's split planes fill the SM's shared memory
//    at 64 rows (231 KB, one block an SM), and there two warps share each 16
//    rows, each taking 32 of a tile's 64 columns, so that their products fit
//    in registers; the two halves' dK/dV (dQ) are added once at the end,
//    half 0's first (two row tiles a warp spilled there too).
// 5. Seven products where five suffice: stays (above).
//
// Why mma.sync and not wgmma with TMA: float32 needs dO and q (v in the
// forward) as MN-major TF32 B operands (dV += P^T dO, dK += dS^T q), and
// wgmma takes TF32 only K-major; one fragment vocabulary serves the forward
// and the backward in both element types; and a TMA descriptor a call would
// need cuTensorMapEncodeTiled from libcuda (-lcuda) in a ctypes-bound
// library. A warp-specialised wgmma/TMA form of K4 (both directions, bf16)
// is a later redesign.
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

// Rows a block of the dK/dV and dQ kernels, and their threads. float32: 64
// rows in both (its shared memory allows no more), two warps per 16, each
// taking half of the streamed tile's 64 columns (queries in dK/dV, keys in
// dQ), so that its products fit in registers; the halves' sums are added
// once at the end. bf16: dK/dV 64 rows, a warp per 16; dQ 128 rows, 32 a
// warp as two 16-row tiles, so that each B fragment read from shared memory
// feeds two mmas (dK/dV so, with its two sets of accumulators, spilled at
// 255 registers).
constexpr int kDkdvRows = kTile;  // so bad_shape's grid is dK/dV's
template <typename T>
constexpr int kDqRows = std::is_same<T, float>::value ? 64 : 128;
template <typename T>
constexpr int kBwdThreads = std::is_same<T, float>::value ? 256 : 128;
constexpr int kBwdStagesBf16 = 3;  // bf16's ring of streamed tiles
// Rows of the streamed tile that bf16's products take at a time, so that S,
// dP and dS of a warp's two row tiles fit in registers beside its
// accumulators.
constexpr int kChunkBf16 = 16;

// 4 bytes global -> shared; with valid false nothing is read and the 4 bytes
// are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [row0, row0 + kRows) of a (n, D) slab with row stride `stride`
// elements into shared rows of kDstRow elements, by kNThreads threads; rows
// past n are zero-filled.
template <typename T, int kRows, int kDstRow, int kNThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int n,
                                          long long stride) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = kD / kVec;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kNThreads; ++i) {
    const int idx = threadIdx.x + i * kNThreads;
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * kVec;
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async16(dst + r * kDstRow + c, src + (valid ? row : 0) * stride + c, valid);
  }
}

// lse and delta of the kTile queries from row0 into s_stat[0, kTile) and
// [kTile, 2 kTile); rows past n are zero-filled.
template <int kNThreads>
__device__ __forceinline__ void load_row_stats(float* s_stat, const float* lse,
                                               const float* delta, int row0, int n) {
  for (int i = threadIdx.x; i < 2 * kTile; i += kNThreads) {
    const int r = i & (kTile - 1);
    const int row = row0 + r;
    const bool valid = row < n;
    cp_async4(s_stat + i, (i < kTile ? lse : delta) + (valid ? row : 0), valid);
  }
}

// float32 operands split once into TF32 (big, small) pairs. A split row holds
// the kD pairs of a row, 2 words each, in slots permuted by x = split_xor(r):
// slot s holds column s ^ x. x takes 0, 4, 8 or 12 so that the two fragment
// reads, (row g, columns 8 kk + t, + 4) and (rows 8 kk + 2 t, + 1, column
// 8 j + g), put the 16 lanes of each half-warp's 8-byte loads on distinct banks.
constexpr int kSplitRow = 2 * kD;              // words a split row
constexpr int kSplitTile = kTile * kSplitRow;  // words a split 64-row tile

__device__ __forceinline__ int split_xor(int r) { return (((r & 3) + ((r >> 2) & 1)) & 3) << 2; }

// Words into a split row of column c0 (< 8) of an even and of an odd 8-column
// group, for a row permuted by x: (8 m + c0) ^ x = (c0 ^ (x & 4)) + 8 (m ^ (x >> 3)).
__device__ __forceinline__ int split_even(int c0, int x) {
  return 2 * ((c0 ^ (x & 4)) + 8 * (x >> 3));
}
__device__ __forceinline__ int split_odd(int c0, int x) {
  return 2 * ((c0 ^ (x & 4)) + 8 * ((x >> 3) ^ 1));
}

__device__ __forceinline__ uint2 ld2(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// kRows dense rows of kD floats in shared memory -> their split rows.
template <int kRows, int kNThreads>
__device__ __forceinline__ void split_rows(uint32_t* dst, const float* src) {
  constexpr int kChunks = kD / 4;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < kRows * kChunks; idx += kNThreads) {
    const int r = idx / kChunks;
    const int c = (idx - r * kChunks) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * kD + c);
    uint32_t b0, s0, b1, s1, b2, s2, b3, s3;
    split_tf32(x.x, b0, s0);
    split_tf32(x.y, b1, s1);
    split_tf32(x.z, b2, s2);
    split_tf32(x.w, b3, s3);
    // columns c..c+3 sit in slots (c ^ x)..(c ^ x) + 3: x leaves the low two bits
    uint32_t* o = dst + r * kSplitRow + 2 * (c ^ split_xor(r));
    *reinterpret_cast<uint4*>(o) = make_uint4(b0, s0, b1, s1);
    *reinterpret_cast<uint4*>(o + 4) = make_uint4(b2, s2, b3, s3);
  }
}

// c += A * M^T in 3xTF32 from split rows: A the warp's 16 rows, M 8 kJ rows
// of a tile (B[k][n] = M[n][k]), the k loop unrolled kUnrollK times; the
// same mmas in the same order as mma_nt, the cross terms apart. c starts at
// zero.
template <int kJ, int kUnrollK = 8>
__device__ __forceinline__ void mma_nt_split(float (&c)[kJ][4], const uint32_t* a,
                                             const uint32_t* m, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int x = split_xor(g);  // rows g, g + 8 and 8 j + g alike
  const int lo0 = split_even(t, x), lo1 = split_odd(t, x);
  const uint32_t* ar = a + g * kSplitRow;
  const uint32_t* br = m + g * kSplitRow;
  float cross[kJ][4] = {};
#pragma unroll kUnrollK
  for (int kk = 0; kk < 8; ++kk) {
    const int lo = ((kk & 1) ? lo1 : lo0) + 32 * (kk >> 1);  // column 8 kk + t
    const int hi = lo ^ 8;                                   // column 8 kk + t + 4
    const uint2 a0 = ld2(ar + lo), a1 = ld2(ar + 8 * kSplitRow + lo), a2 = ld2(ar + hi),
                a3 = ld2(ar + 8 * kSplitRow + hi);
    const uint32_t ab[4] = {a0.x, a1.x, a2.x, a3.x}, as[4] = {a0.y, a1.y, a2.y, a3.y};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const uint2 b0 = ld2(br + 8 * j * kSplitRow + lo), b1 = ld2(br + 8 * j * kSplitRow + hi);
      mma_tf32(cross[j], as, b0.x, b1.x);
      mma_tf32(cross[j], ab, b0.y, b1.y);
      mma_tf32(c[j], ab, b0.x, b1.x);
    }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cross[j][e];
  }
}

// c += A * M with A (16 x 8 kK) in accumulator layout and M 8 kK rows of a
// split tile (B[k][n] = M[k][n]): the float32 mma_acc_nn, its B operand read pre-split.
template <int kK>
__device__ __forceinline__ void mma_acc_nn_split(float (&c)[8][4], const float (&a)[kK][4],
                                                 const uint32_t* m, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int x0 = split_xor(2 * t), x1 = split_xor(2 * t + 1);  // rows 8 kk + 2 t, + 1
  const int e0 = split_even(g, x0), o0 = split_odd(g, x0);
  const int e1 = split_even(g, x1), o1 = split_odd(g, x1);
  // Four 8-column tiles at a time, A split again for each four: each
  // element's mmas and sums as in mma_acc_nn, in half the registers.
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 4) {
    float big[4][4] = {}, cross[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      // k permuted in both operands, as in mma_acc_nn
      uint32_t ab[4], as[4];
      split_tf32(a[kk][0], ab[0], as[0]);
      split_tf32(a[kk][2], ab[1], as[1]);
      split_tf32(a[kk][1], ab[2], as[2]);
      split_tf32(a[kk][3], ab[3], as[3]);
      const uint32_t* rows = m + (8 * kk + 2 * t) * kSplitRow;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj, col = 32 * (j >> 1);
        const uint2 b0 = ld2(rows + ((j & 1) ? o0 : e0) + col);
        const uint2 b1 = ld2(rows + kSplitRow + ((j & 1) ? o1 : e1) + col);
        mma_tf32(cross[jj], as, b0.x, b1.x);
        mma_tf32(cross[jj], ab, b0.y, b1.y);
        mma_tf32(big[jj], ab, b0.x, b1.x);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j0 + jj][e] += big[jj][e] + cross[jj][e];
    }
  }
}

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

// Shared bytes of the dK/dV and dQ kernels.
template <typename T>
constexpr int bwd_smem(bool dkdv) {
  const int kR = dkdv ? kDkdvRows : kDqRows<T>;
  if (std::is_same<T, float>::value) {  // fixed rows and 2 buffers split, one raw stage
    return (2 * kR * kSplitRow + 4 * kSplitTile + 2 * kTile * kD) * 4 +
           (dkdv ? 6 * kTile * 4 : 0);  // lse and delta: raw, and 2 buffers
  }
  return 2 * kR * kRow<bf16> * 2 + kBwdStagesBf16 * 2 * kTileBytes<bf16> +
         (dkdv ? kBwdStagesBf16 * 2 * kTile * 4 : 0);
}

// dK and dV of kDkdvRows keys, looping over the query tiles: rows of the warp's
// products are keys, columns queries. Queries past n come zero-filled with
// lse = delta = 0: their P is exp(0) = 1 against q and dO rows of zeros, so
// they add exactly 0.
//
// float32: the raw copy of tile it + 2 flies while tile it is computed from
// one split buffer and tile it + 1 is split into the other. Each thread
// copies, and then splits, the same 16-byte chunks of a raw tile, so the raw
// stage needs no barrier of its own: one barrier a tile.
__device__ __forceinline__ void dkdv_block(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* delta, float* dk, float* dv, int n,
                                           int heads, long long stride_b, long long stride_n,
                                           float scale_log2, float scale) {
  constexpr int kNT = kBwdThreads<float>, kR = kDkdvRows;
  static_assert(2 * kR * kD <= 2 * kSplitTile, "the raw fixed rows land in a split buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_kf = reinterpret_cast<uint32_t*>(smem);  // the block's keys, split
  uint32_t* s_vf = s_kf + kR * kSplitRow;
  uint32_t* s_split = s_vf + kR * kSplitRow;  // 2 buffers of split (q, dO) tiles
  float* s_raw = reinterpret_cast<float*>(s_split + 4 * kSplitTile);  // raw q, dO
  float* s_stat = s_raw + 2 * kTile * kD;  // raw lse, delta
  float* s_cst = s_stat + 2 * kTile;       // 2 buffers of (lse * log2(e), delta)

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int slice = warp & 3, half = warp >> 2;  // 16 keys, 32 queries of each tile
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const long long ostride = static_cast<long long>(heads) * kD;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;
  const int n_tiles = (n + kTile - 1) / kTile;

  auto load_queries = [&](int tile) {
    load_rows<float, kTile, kD, kNT>(s_raw, q + head, tile * kTile, n, stride_n);
    load_rows<float, kTile, kD, kNT>(s_raw + kTile * kD, dout + ohead, tile * kTile, n, ostride);
    load_row_stats<kNT>(s_stat, lse_bh, delta_bh, tile * kTile, n);
  };
  auto split_queries = [&](int buf) {  // the chunks this thread copied
    uint32_t* dst = s_split + buf * 2 * kSplitTile;
    split_rows<kTile, kNT>(dst, s_raw);
    split_rows<kTile, kNT>(dst + kSplitTile, s_raw + kTile * kD);
    float* cst = s_cst + buf * 2 * kTile;
    for (int i = threadIdx.x; i < 2 * kTile; i += kNT) {
      cst[i] = i < kTile ? s_stat[i] * kLog2e : s_stat[i];
    }
  };

  // The raw keys and values land in split buffer 1.
  float* fixed_raw = reinterpret_cast<float*>(s_split + 2 * kSplitTile);
  load_rows<float, kR, kD, kNT>(fixed_raw, k + head, k0, n, stride_n);
  load_rows<float, kR, kD, kNT>(fixed_raw + kR * kD, v + head, k0, n, stride_n);
  load_queries(0);
  cp_async_commit();
  cp_async_wait<0>();  // each thread splits the chunks it copied
  split_rows<kR, kNT>(s_kf, fixed_raw);
  split_rows<kR, kNT>(s_vf, fixed_raw + kR * kD);
  split_queries(0);
  if (1 < n_tiles) load_queries(1);
  cp_async_commit();

  // dK/dV's streamed products unroll their k loop kDkdvUnrollK times: fully
  // unrolled, ptxas spills the accumulators.
  constexpr int kDkdvUnrollK = 4;
  const uint32_t* kr = s_kf + slice * 16 * kSplitRow;
  const uint32_t* vr = s_vf + slice * 16 * kSplitRow;
  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    // This thread's chunks of tile it + 1 are in; buffer buf is split; every
    // warp is done with buffer buf ^ 1 (tile it - 1, or the raw keys).
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      split_queries(buf ^ 1);
      if (it + 2 < n_tiles) load_queries(it + 2);
    }
    cp_async_commit();
    const uint32_t* qh = s_split + buf * 2 * kSplitTile + half * 32 * kSplitRow;  // the warp's half
    const uint32_t* doh = qh + kSplitTile;
    const float* lh = s_cst + buf * 2 * kTile + half * 32;
    const float* dh = lh + kTile;

    float p[4][4] = {};  // S^T, then P^T
    mma_nt_split<4, kDkdvUnrollK>(p, kr, qh, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = ex2(fmaf(p[j][e], scale_log2, -lh[8 * j + 2 * t + (e & 1)]));
      }
    }
    mma_acc_nn_split(dv_acc, p, doh, lane);  // dV += P^T dO

    float ds[4][4] = {};  // dP^T = v dO^T, then dS^T
    mma_nt_split<4, kDkdvUnrollK>(ds, vr, doh, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dh[8 * j + 2 * t + (e & 1)]);
    }
    mma_acc_nn_split(dk_acc, ds, qh, lane);  // dK += dS^T q (scaled at the store)
  }

  // The two halves' sums, half 0's first; half 1 hands its own over through
  // a split buffer, free after the barrier.
  __syncthreads();
  float* s_x = reinterpret_cast<float*>(s_split) + slice * 2 * 8 * 4 * 32;
  static_assert(4 * 2 * 8 * 4 * 32 <= 2 * kSplitTile, "the halves' exchange fits a split buffer");
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_x[(j * 4 + e) * 32 + lane] = dk_acc[j][e];
        s_x[((8 + j) * 4 + e) * 32 + lane] = dv_acc[j][e];
      }
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] += s_x[(j * 4 + e) * 32 + lane];
      dv_acc[j][e] += s_x[((8 + j) * 4 + e) * 32 + lane];
    }
  }
  const int row0 = k0 + slice * 16;
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_rows(dk, dk_acc, sc, row0, n, heads, b, h, lane);
  store_rows(dv, dv_acc, one, row0, n, heads, b, h, lane);
}

__device__ __forceinline__ void dkdv_block(const bf16* q, const bf16* k, const bf16* v,
                                           const bf16* dout, const float* lse,
                                           const float* delta, bf16* dk, bf16* dv, int n,
                                           int heads, long long stride_b, long long stride_n,
                                           float scale_log2, float scale) {
  constexpr int kNT = kBwdThreads<bf16>, kR = kDkdvRows, kS = kBwdStagesBf16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);  // the block's keys, read once
  bf16* s_v = s_k + kR * kRow<bf16>;
  bf16* s_q = s_v + kR * kRow<bf16>;           // kS query tiles
  bf16* s_do = s_q + kS * kTileElems<bf16>;    // kS dout tiles
  float* s_stat = reinterpret_cast<float*>(s_do + kS * kTileElems<bf16>);  // kS x (lse, delta)

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const long long ostride = static_cast<long long>(heads) * kD;
  const float* lse_bh = lse + static_cast<long long>(bh) * n;
  const float* delta_bh = delta + static_cast<long long>(bh) * n;
  const int n_tiles = (n + kTile - 1) / kTile;

  auto load_queries = [&](int tile, int st) {
    load_rows<bf16, kTile, kRow<bf16>, kNT>(s_q + st * kTileElems<bf16>, q + head, tile * kTile,
                                            n, stride_n);
    load_rows<bf16, kTile, kRow<bf16>, kNT>(s_do + st * kTileElems<bf16>, dout + ohead,
                                            tile * kTile, n, ostride);
    load_row_stats<kNT>(s_stat + st * 2 * kTile, lse_bh, delta_bh, tile * kTile, n);
  };

  load_rows<bf16, kR, kRow<bf16>, kNT>(s_k, k + head, k0, n, stride_n);
  load_rows<bf16, kR, kRow<bf16>, kNT>(s_v, v + head, k0, n, stride_n);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < n_tiles) load_queries(i, i);
    cp_async_commit();
  }
  cp_async_wait<kS - 1>();
  __syncthreads();
  AFrag<bf16> kf, vf;  // the warp's keys and values as A operands, once
  kf.load(s_k + warp * 16 * kRow<bf16>, lane);
  vf.load(s_v + warp * 16 * kRow<bf16>, lane);

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kS;
    // Tile it is in (the kS - 2 copies after it may still fly); every warp is
    // done with tile it - 1, whose stage the next copy refills.
    cp_async_wait<kS - 2>();
    __syncthreads();
    if (it + kS - 1 < n_tiles) load_queries(it + kS - 1, (it + kS - 1) % kS);
    cp_async_commit();
    const bf16* cq = s_q + st * kTileElems<bf16>;
    const bf16* cdo = s_do + st * kTileElems<bf16>;
    const float* cl = s_stat + st * 2 * kTile;
    const float* cd = cl + kTile;

    float p[8][4];  // S^T, then P^T
    zero(p);
    mma_nt(p, kf, cq, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(cl + 8 * j + 2 * t);  // queries 2t, 2t+1
      const float nl[2] = {-(l.x * kLog2e), -(l.y * kLog2e)};
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ex2(fmaf(p[j][e], scale_log2, nl[e & 1]));
    }
    mma_acc_nn(dv_acc, p, cdo, lane);  // dV += P^T dO

    float ds[8][4];  // dP^T = v dO^T, then dS^T
    zero(ds);
    mma_nt(ds, vf, cdo, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(cd + 8 * j + 2 * t);
      const float dd[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dd[e & 1]);
    }
    mma_acc_nn(dk_acc, ds, cq, lane);  // dK += dS^T q (scaled at the store)
  }

  const int row0 = k0 + warp * 16;
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_rows(dk, dk_acc, sc, row0, n, heads, b, h, lane);
  store_rows(dv, dv_acc, one, row0, n, heads, b, h, lane);
}

// The minimum of one block an SM lets ptxas give the bf16 kernels up to 255
// registers (it took 185 and 178 without it, and dK/dV ran 0.105 ms against
// 0.086 at DA-V2-S's shape).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads<T>, 1)
flash_attention_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int n, int heads,
                            long long stride_b, long long stride_n, float scale_log2,
                            float scale) {
  dkdv_block(q, k, v, dout, lse, delta, dk, dv, n, heads, stride_b, stride_n, scale_log2, scale);
}

// dQ of kDqRows<T> queries, looping over the key tiles. Keys past n come
// zero-filled and get P = 0. float32: copies and splits as in dK/dV.
__device__ __forceinline__ void dq_block(const float* q, const float* k, const float* v,
                                         const float* dout, const float* lse, const float* delta,
                                         float* dq, int n, int heads, long long stride_b,
                                         long long stride_n, float scale_log2, float scale) {
  constexpr int kNT = kBwdThreads<float>, kR = kDqRows<float>;
  static_assert(2 * kR * kD <= 2 * kSplitTile, "the raw fixed rows land in a split buffer");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_qf = reinterpret_cast<uint32_t*>(smem);  // the block's queries, split
  uint32_t* s_dof = s_qf + kR * kSplitRow;
  uint32_t* s_split = s_dof + kR * kSplitRow;  // 2 buffers of split (k, v) tiles
  float* s_raw = reinterpret_cast<float*>(s_split + 4 * kSplitTile);  // raw k, v

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = warp & 3, half = warp >> 2;  // 16 queries, 32 keys of each tile
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const int n_tiles = (n + kTile - 1) / kTile;

  auto load_keys = [&](int tile) {
    load_rows<float, kTile, kD, kNT>(s_raw, k + head, tile * kTile, n, stride_n);
    load_rows<float, kTile, kD, kNT>(s_raw + kTile * kD, v + head, tile * kTile, n, stride_n);
  };
  auto split_keys = [&](int buf) {  // the chunks this thread copied
    uint32_t* dst = s_split + buf * 2 * kSplitTile;
    split_rows<kTile, kNT>(dst, s_raw);
    split_rows<kTile, kNT>(dst + kSplitTile, s_raw + kTile * kD);
  };

  float* fixed_raw = reinterpret_cast<float*>(s_split + 2 * kSplitTile);  // split buffer 1
  load_rows<float, kR, kD, kNT>(fixed_raw, q + head, q0, n, stride_n);
  load_rows<float, kR, kD, kNT>(fixed_raw + kR * kD, dout + ohead, q0, n,
                                static_cast<long long>(heads) * kD);
  load_keys(0);
  cp_async_commit();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + slice * 16 + g + 8 * r;
    const long long idx = static_cast<long long>(bh) * n + row;
    lse_r[r] = row < n ? lse[idx] * kLog2e : INFINITY;
    delta_r[r] = row < n ? delta[idx] : 0.f;
  }
  cp_async_wait<0>();  // each thread splits the chunks it copied
  split_rows<kR, kNT>(s_qf, fixed_raw);
  split_rows<kR, kNT>(s_dof, fixed_raw + kR * kD);
  split_keys(0);
  if (1 < n_tiles) load_keys(1);
  cp_async_commit();

  const uint32_t* qr = s_qf + slice * 16 * kSplitRow;
  const uint32_t* dor = s_dof + slice * 16 * kSplitRow;
  float dq_acc[8][4];
  zero(dq_acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    cp_async_wait<0>();
    __syncthreads();  // as in dK/dV: buffer buf split, buffer buf ^ 1 free
    if (it + 1 < n_tiles) {
      split_keys(buf ^ 1);
      if (it + 2 < n_tiles) load_keys(it + 2);
    }
    cp_async_commit();
    const uint32_t* kh = s_split + buf * 2 * kSplitTile + half * 32 * kSplitRow;  // the warp's half
    const uint32_t* vh = kh + kSplitTile;
    const int k0 = it * kTile + half * 32;

    float p[4][4] = {};  // S, then P
    mma_nt_split(p, qr, kh, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * j + 2 * t + (e & 1) < n;  // zero-filled keys weigh 0
        p[j][e] = valid ? ex2(fmaf(p[j][e], scale_log2, -lse_r[e >> 1])) : 0.f;
      }
    }
    float ds[4][4] = {};  // dP = dO v^T, then dS
    mma_nt_split(ds, dor, vh, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]);
    }
    mma_acc_nn_split(dq_acc, ds, kh, lane);  // dQ += dS k (scaled at the store)
  }

  // The two halves' sums, half 0's first (as in dK/dV).
  __syncthreads();
  float* s_x = reinterpret_cast<float*>(s_split) + slice * 8 * 4 * 32;
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_x[(j * 4 + e) * 32 + lane] = dq_acc[j][e];
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] += s_x[(j * 4 + e) * 32 + lane];
  }
  const float sc[2] = {scale, scale};
  store_rows(dq, dq_acc, sc, q0 + slice * 16, n, heads, b, h, lane);
}

// bf16, two 16-row A tiles against one M: c[i] += A_i * M^T over kJ 8-column
// tiles (B[k][n] = M[n][k]), each B fragment feeding both A tiles; each
// accumulator gets mma_nt's mmas in mma_nt's order.
template <int kJ>
__device__ __forceinline__ void mma_nt_x2(float (&c)[2][kJ][4], const AFrag<bf16> (&a)[2],
                                          const bf16* m, int lane) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, m + (8 * j + (lane & 7)) * kRow<bf16> + 32 * p + (lane >> 3) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(c[i][j], a[i].r[2 * p], b[0], b[1]);
        mma_bf16(c[i][j], a[i].r[2 * p + 1], b[2], b[3]);
      }
    }
  }
}

// bf16: c[i] += A_i * M with A_i (16 x 16 kK) in accumulator layout, rounded
// to bf16, and M 16 kK rows of a tile (B[k][n] = M[k][n]), each B fragment
// feeding both A tiles; each accumulator as in mma_acc_nn.
template <int kK>
__device__ __forceinline__ void mma_acc_nn_x2(float (&c)[2][8][4], const float (&a)[2][2 * kK][4],
                                              const bf16* m, int lane) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      af[i][0] = pack_bf16(a[i][2 * kk][0], a[i][2 * kk][1]);
      af[i][1] = pack_bf16(a[i][2 * kk][2], a[i][2 * kk][3]);
      af[i][2] = pack_bf16(a[i][2 * kk + 1][0], a[i][2 * kk + 1][1]);
      af[i][3] = pack_bf16(a[i][2 * kk + 1][2], a[i][2 * kk + 1][3]);
    }
    const bf16* rows = m + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kRow<bf16>;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, rows + 16 * jp + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(c[i][2 * jp], af[i], b[0], b[1]);
        mma_bf16(c[i][2 * jp + 1], af[i], b[2], b[3]);
      }
    }
  }
}

// bf16: 32 queries a warp as two 16-row tiles, so that each B fragment read
// from shared memory feeds two mmas, and each key tile in chunks of
// kChunkBf16 keys; the same mmas, in the same order for each accumulator, as
// 16 rows a warp.
__device__ __forceinline__ void dq_block(const bf16* q, const bf16* k, const bf16* v,
                                         const bf16* dout, const float* lse, const float* delta,
                                         bf16* dq, int n, int heads, long long stride_b,
                                         long long stride_n, float scale_log2, float scale) {
  constexpr int kNT = kBwdThreads<bf16>, kR = kDqRows<bf16>, kS = kBwdStagesBf16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);  // the block's queries, read once
  bf16* s_do = s_q + kR * kRow<bf16>;
  bf16* s_k = s_do + kR * kRow<bf16>;          // kS key tiles
  bf16* s_v = s_k + kS * kTileElems<bf16>;     // kS value tiles

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = static_cast<long long>(b) * stride_b + static_cast<long long>(h) * kD;
  const long long ohead = static_cast<long long>(b) * n * heads * kD + static_cast<long long>(h) * kD;
  const int n_tiles = (n + kTile - 1) / kTile;

  auto load_keys = [&](int tile, int st) {
    load_rows<bf16, kTile, kRow<bf16>, kNT>(s_k + st * kTileElems<bf16>, k + head, tile * kTile,
                                            n, stride_n);
    load_rows<bf16, kTile, kRow<bf16>, kNT>(s_v + st * kTileElems<bf16>, v + head, tile * kTile,
                                            n, stride_n);
  };

  load_rows<bf16, kR, kRow<bf16>, kNT>(s_q, q + head, q0, n, stride_n);
  load_rows<bf16, kR, kRow<bf16>, kNT>(s_do, dout + ohead, q0, n,
                                       static_cast<long long>(heads) * kD);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kS - 1; ++i) {
    if (i < n_tiles) load_keys(i, i);
    cp_async_commit();
  }

  const int row0 = q0 + warp * 32;
  float lse_r[2][2], delta_r[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * i + g + 8 * r;
      const long long idx = static_cast<long long>(bh) * n + row;
      lse_r[i][r] = row < n ? lse[idx] * kLog2e : INFINITY;
      delta_r[i][r] = row < n ? delta[idx] : 0.f;
    }
  }
  cp_async_wait<kS - 1>();
  __syncthreads();
  AFrag<bf16> qf[2], dof[2];  // the warp's queries and output gradients as A operands, once
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qf[i].load(s_q + (warp * 32 + 16 * i) * kRow<bf16>, lane);
    dof[i].load(s_do + (warp * 32 + 16 * i) * kRow<bf16>, lane);
  }

  float dq_acc[2][8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kS;
    cp_async_wait<kS - 2>();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + kS - 1 < n_tiles) load_keys(it + kS - 1, (it + kS - 1) % kS);
    cp_async_commit();
#pragma unroll 1  // unrolled, ptxas spills
    for (int c = 0; c < kTile / kChunkBf16; ++c) {
      const bf16* kc = s_k + st * kTileElems<bf16> + c * kChunkBf16 * kRow<bf16>;
      const bf16* vc = s_v + st * kTileElems<bf16> + c * kChunkBf16 * kRow<bf16>;
      const int k0 = it * kTile + c * kChunkBf16;
      // S and dP = dO v^T, then P and dS
      float p[2][kChunkBf16 / 8][4] = {}, ds[2][kChunkBf16 / 8][4] = {};
      mma_nt_x2(p, qf, kc, lane);
      mma_nt_x2(ds, dof, vc, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < kChunkBf16 / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool valid = k0 + 8 * j + 2 * t + (e & 1) < n;  // zero-filled keys weigh 0
            p[i][j][e] = valid ? ex2(fmaf(p[i][j][e], scale_log2, -lse_r[i][e >> 1])) : 0.f;
            ds[i][j][e] = p[i][j][e] * (ds[i][j][e] - delta_r[i][e >> 1]);
          }
        }
      }
      mma_acc_nn_x2<kChunkBf16 / 16>(dq_acc, ds, kc, lane);  // dQ += dS k (scaled at the store)
    }
  }

  const float sc[2] = {scale, scale};
#pragma unroll
  for (int i = 0; i < 2; ++i) store_rows(dq, dq_acc[i], sc, row0 + 16 * i, n, heads, b, h, lane);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads<T>, 1)
flash_attention_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int n, int heads, long long stride_b,
                          long long stride_n, float scale_log2, float scale) {
  dq_block(q, k, v, dout, lse, delta, dq, n, heads, stride_b, stride_n, scale_log2, scale);
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

  constexpr int smem_dkdv = bwd_smem<T>(true);
  err = allow_smem(flash_attention_dkdv_kernel<T>, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_dkdv_kernel<T><<<grid, kBwdThreads<T>, smem_dkdv, s>>>(
      q, k, v, dout, lse, delta, dk, dv, n, heads, stride_b, stride_n, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int smem_dq = bwd_smem<T>(false);
  err = allow_smem(flash_attention_dq_kernel<T>, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_dq(grid.x, static_cast<unsigned>((n + kDqRows<T> - 1) / kDqRows<T>));
  flash_attention_dq_kernel<T><<<grid_dq, kBwdThreads<T>, smem_dq, s>>>(
      q, k, v, dout, lse, delta, dq, n, heads, stride_b, stride_n, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// What the backward launches for n tokens: out[0] threads a block (both
// kernels), out[1] and out[2] the dK/dV and dQ kernels' rows a block, out[3]
// and out[4] their blocks a (batch, head), out[5] and out[6] their dynamic
// shared bytes, out[7] and out[8] their resident blocks an SM.
template <typename T>
int backward_plan(int n, int* out) {
  out[0] = kBwdThreads<T>;
  out[1] = kDkdvRows;
  out[2] = kDqRows<T>;
  out[3] = (n + kDkdvRows - 1) / kDkdvRows;
  out[4] = (n + kDqRows<T> - 1) / kDqRows<T>;
  out[5] = bwd_smem<T>(true);
  out[6] = bwd_smem<T>(false);
  cudaError_t err = allow_smem(flash_attention_dkdv_kernel<T>, out[5]);
  if (err == cudaSuccess) err = allow_smem(flash_attention_dq_kernel<T>, out[6]);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[7], flash_attention_dkdv_kernel<T>,
                                                        kBwdThreads<T>, out[5]);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], flash_attention_dq_kernel<T>,
                                                        kBwdThreads<T>, out[6]);
  }
  return static_cast<int>(err);
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

extern "C" int mde_flash_attention_backward_plan(int bf16_form, int n, int* out) {
  return bf16_form ? backward_plan<bf16>(n, out) : backward_plan<float>(n, out);
}
