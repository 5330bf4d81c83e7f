// Flash attention (forward, dK/dV, dQ), hand-written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of fedml_tpu/ops/flash_attention.py:
//   forward  _fwd_kernel       (pallas_call in _fwd_pallas)
//   dK/dV    _bwd_dkdv_kernel  (first pallas_call in _flash_bwd)
//   dQ       _bwd_dq_kernel    (second pallas_call in _flash_bwd)
// On the TPU each runs on a (B*H, block, block) grid whose innermost axis is
// sequential, so the running max, denominator and accumulators carry across
// grid steps in VMEM scratch. Hopper runs blocks in any order, so here each
// block owns one (b*h, 64-row tile) and loops over the other axis itself,
// holding its accumulators in registers.
//
// Layout: q, k, v, out, do, dq, dk, dv are [B, S, H, D] read and written
// through their (b, s, h) strides with a unit stride on D, so the
// transformer's q/k/v (views of one qkv projection, row stride 3*width) are
// read in place; lse and delta are contiguous f32 [B, H, S]. Element types
// f32 or bf16 (f32 accumulation, rounded to the element type on store); D
// in {16, 32, 64, 128}.
//
// Arithmetic, as the TPU kernels do it:
//   forward  s = (q * scale) k^T, causal mask -1e30, online softmax with
//            running max m and denominator l, out = acc / max(l, 1e-30),
//            lse = m + log(max(l, 1e-30))
//   backward p = exp(s - lse), dp = dO v^T, dS = p * (dp - delta) * scale,
//            dV = p^T dO, dK = dS^T q, dQ = dS k     (FA-2, delta = rowsum(dO*O))
// with scale = 1/sqrt(D); keys past S and masked pairs weigh exactly 0.
//
// What bounds them: at the LM path's shape (B=4, S=2048, H=4, D=64, causal,
// f32) one [S,S]x[S,D] product over all heads is 4.3 GFLOP causal; the
// forward does 2 (8.6 GFLOP), dK/dV 4 (17.2), dQ 3 (12.9), against 34-50
// MB of HBM traffic a call. They are bound by operations: 0.13, 0.26 and
// 0.19 ms at the f32 CUDA-core peak (67 TFLOP/s); 0.052, 0.104 and 0.078
// ms in f32-accurate 3xTF32 on the tensor cores (3 TF32 products for each
// f32 one at 495 TFLOP/s). All three run on the tensor cores, in 3xTF32;
// in practice their ceiling is mma.sync's own TF32 rate, which reaches
// about 63% of the published 495 (experiments/mma_peak.py; the full rate
// needs wgmma).
//
// The design:
// - mma.sync m16n8k8 TF32. Every f32 operand x is split into hi =
//   tf32_rna(x) and lo = x - hi, and a product accumulates lo*hi + hi*lo
//   + hi*hi in f32, small terms first (CUTLASS's OpMultiplyAddFastF32),
//   which keeps f32 accuracy: one TF32 pass keeps about 3 decimal digits
//   and would miss the 1e-4 tolerances. lo is passed unrounded: the tensor
//   core reads its top 19 bits, truncating (CUTLASS's split relies on the
//   same), which errs by at most 2^-21 |x| against 2^-22 for a rounded lo
//   and saves 2 of 5 ALU operations a value. bf16 values are exact in TF32 (lo = 0), so a product of
//   two loaded bf16 operands takes one pass and one of P or dS with a
//   loaded operand two. The split is done at the fragment load, so shared
//   memory holds one copy of each tile and D = 128 fits; it is most of the
//   kernels' ALU work, the first thing a faster version would move.
// - Fragment loads: an ldmatrix.x4 brings an f32 A fragment, or the B
//   fragments of two 8-column slices of a score product, in one
//   instruction (an 8 x 8 b16 matrix is 8 rows x 4 f32, in the fragment's
//   order); the second products' B fragments are scalar loads.
// - Scores in log2 units: exp(x * scale - m) is exp2(fmaf(x, scale *
//   log2(e), -m')) with m' = m * log2(e), one FFMA and the exp2 unit where
//   expf takes several instructions. lse stays in natural-log units in
//   memory (the forward writes m' * ln(2) + log(l); the backward reads
//   lse * log2(e)).
// - A block of 4 warps owns a 64-row tile, 16 rows a warp. The forward
//   and dQ own query rows and stream key tiles: S = Q K^T lands in m16n8
//   accumulators that are already the A operands of O += P V (forward)
//   and dQ += dS K. dK/dV owns key rows and computes the transposed
//   scores S^T = K Q^T and dP^T = V dO^T (keys x queries), so its
//   accumulators are the A operands of dV += P^T dO and dK += dS^T Q. The
//   accumulator holds columns 2t, 2t+1 where the A fragment wants t, t+4;
//   the order of k inside an 8-wide slice is free, so the B fragment loads
//   rows 2t and 2t+1 instead. P and dS never leave the registers.
// - The forward's online softmax runs on the accumulators: a thread holds
//   rows g and g + 8 of its warp's 16 and two columns of each 8-key slice,
//   so a row's max is reduced over the 4 lanes of a quad (two xor
//   shuffles); the running max starts at -1e30, finite, so the first
//   correction is exp2(-huge) = 0, never inf - inf. The correction scales
//   the O accumulators before P V is added; each thread keeps its own part
//   of the denominator, reduced over the quad once, in the epilogue.
// - The streamed tiles (k, v in the forward and dQ; q, dO, lse, delta in
//   dK/dV) are double-buffered: the next tile's 16-byte cp.async copies
//   are in flight while the current one computes, one __syncthreads a
//   tile. A tile row is D elements and 16 bytes of padding, so the
//   fragment loads (rows g, columns t, or rows 2t, columns g) hit 32
//   distinct banks and the copies stay 16-byte aligned. Inputs whose rows
//   are not 16-byte aligned take a scalar copy path into the same layout.
// - Tiles: 64 keys x 64 queries; dK/dV streams 32 queries at D = 128, where
//   the dK and dV accumulators take 128 registers a thread. No atomics: the
//   split into two backward kernels keeps the result deterministic.
// - Causal work is skewed (the last q tile of the forward and dQ, and key
//   tile 0 of dK/dV, sweep every tile of the other side), so the grid is
//   (b*h, tile) with the heaviest tiles at blockIdx.y = 0: they launch
//   first. Key tiles wholly in a q tile's future are skipped, and the
//   masks are applied only on the tiles that meet the diagonal or the end
//   of the sequence.
//
// Launch contract: the kernels run on the caller's stream, allocate nothing
// and do not synchronise; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwnRows = 16 * kWarps;  // a block's own tile: 16 rows a warp
constexpr float kNegInf = -1e30f;  // the causal mask value, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;     // dO (backward)
  const float* lse;    // [B, H, S]
  const float* delta;  // [B, H, S] (backward)
  void* out0;          // out (forward), dk (dK/dV), dq (dQ)
  void* out1;          // dv (dK/dV)
  float* lse_out;      // lse (forward)
  Strides sq, sk, sv, sdo, s0, s1;
  int B, H, S, causal;
  int vec;  // every input row 16-byte aligned (cp.async)
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---- the building blocks: 3xTF32 on the tensor cores, cp.async tiles ------

// a tile row in shared memory: D elements and 16 bytes of padding
template <typename T, int D>
__host__ __device__ constexpr int tile_pitch() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32 for finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi in TF32; lo keeps its low 13 bits, which the tensor
// core ignores (it truncates lo, as CUTLASS's fast-f32 split relies on:
// the same error as rounding lo, two operations fewer). Without kSplit x
// is exact in TF32 (a bf16 value).
template <bool kSplit>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if (kSplit) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small products first; a term whose operand is
// exact in TF32 (no lo part) is left out
template <bool kLoA, bool kLoB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  if (kLoA) mma_tf32(c, al, bh);
  if (kLoB) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The m16n8k8 fragments (g = lane / 4, t = lane % 4):
//   A 16 x 8: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8 x 8:  b0 (t, g), b1 (t + 4, g)
//   C 16 x 8: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

// four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives word l % 4 of row l / 4 of each.
// An f32 tile's 8 rows x 4 columns land as an m16n8k8 fragment register.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A = tile[r0 .. r0 + 16)[c0 .. c0 + 8) of a [row][P] tile (one ldmatrix
// for f32: matrices rows 0-7 / 8-15 x columns 0-3 / 4-7 are a0..a3)
template <bool kSplit, typename T>
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const T* tile, int P, int r0, int c0,
                                       int lane) {
  float x[4];
  if constexpr (sizeof(T) == 4) {
    uint32_t raw[4];
    ldmatrix_x4(raw, tile + (r0 + lane % 16) * P + c0 + (lane / 16) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(raw[i]);
  } else {
    const T* r = tile + (r0 + lane / 4) * P + c0 + lane % 4;
    x[0] = to_f32(r[0]);
    x[1] = to_f32(r[8 * P]);
    x[2] = to_f32(r[4]);
    x[3] = to_f32(r[8 * P + 4]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32<kSplit>(x[i], hi[i], lo[i]);
}

// B[k][n] = tile[n0 + n][k0 + k] (the transposed tile, for the score
// products contracted over D) for two 8-column slices, n0 and n0 + 8: one
// ldmatrix for f32 (matrices rows n0 / n0 + 8 x columns 0-3 / 4-7)
template <bool kSplit, typename T>
__device__ __forceinline__ void frag_b_t2(uint32_t (&hi)[2][2],
                                          uint32_t (&lo)[2][2], const T* tile,
                                          int P, int n0, int k0, int lane) {
  float x[4];
  if constexpr (sizeof(T) == 4) {
    uint32_t raw[4];
    ldmatrix_x4(raw, tile + (n0 + lane % 8 + (lane / 16) * 8) * P + k0 +
                         ((lane / 8) % 2) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(raw[i]);
  } else {
    const T* r = tile + (n0 + lane / 4) * P + k0 + lane % 4;
    x[0] = to_f32(r[0]);
    x[1] = to_f32(r[4]);
    x[2] = to_f32(r[8 * P]);
    x[3] = to_f32(r[8 * P + 4]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    split_tf32<kSplit>(x[i], hi[i / 2][i % 2], lo[i / 2][i % 2]);
}

// B[k][n] = tile[k0 + perm(k)][n0 + n] with k = t read from row 2t and
// k = t + 4 from row 2t + 1: the k order of an accumulator used as A
template <bool kSplit, typename T>
__device__ __forceinline__ void frag_b_perm(uint32_t (&hi)[2],
                                            uint32_t (&lo)[2], const T* tile,
                                            int P, int k0, int n0, int g,
                                            int t) {
  const T* r = tile + (k0 + 2 * t) * P + n0 + g;
  split_tf32<kSplit>(to_f32(r[0]), hi[0], lo[0]);
  split_tf32<kSplit>(to_f32(r[P]), hi[1], lo[1]);
}

// an m16n8 accumulator as the A operand of the next product (k permuted
// as frag_b_perm reads B), split into hi and lo
__device__ __forceinline__ void acc_as_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                         const float (&c)[4]) {
  split_tf32<true>(c[0], hi[0], lo[0]);
  split_tf32<true>(c[2], hi[1], lo[1]);
  split_tf32<true>(c[1], hi[2], lo[2]);
  split_tf32<true>(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of head (b, h) into a [R][P] tile, rows past S zero:
// 16-byte cp.async copies (a zero source size fills zeros) when the rows
// are 16-byte aligned (vec), else plain loads and stores
template <typename T, int D, int R>
__device__ __forceinline__ void copy_tile(T* dst, const void* src, Strides st,
                                          int b, int h, int r0, int S,
                                          int vec) {
  constexpr int P = tile_pitch<T, D>();
  const T* base = static_cast<const T*>(src) + b * st.b + h * st.h;
  if (vec) {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = D / kChunk;
    for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk, s = r0 + r;
      cp_async16(dst + r * P + c,
                 base + static_cast<int64_t>(min(s, S - 1)) * st.s + c,
                 s < S ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * D; i += kThreads) {
      const int r = i / D, c = i % D, s = r0 + r;
      dst[r * P + c] = s < S ? base[static_cast<int64_t>(s) * st.s + c]
                             : from_f32<T>(0.f);
    }
  }
}

// rows [r0, r0 + R) of a contiguous f32 [B*H, S] array, past S zero
template <int R>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int64_t bh, int r0, int S) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const int s = r0 + i;
    cp_async4(dst + i, src + bh * S + min(s, S - 1), s < S ? 4 : 0);
  }
}

template <typename T, int D>
struct DkdvShape {
  static constexpr int P = tile_pitch<T, D>();
  static constexpr int BQ = D == 128 ? 32 : 64;  // streamed q rows a tile
  static constexpr int kTileK = kOwnRows * P;
  static constexpr int kTileQ = BQ * P;
  // K, V; two stages of (Q, dO); two stages of (lse, delta)
  static constexpr size_t smem =
      sizeof(T) * (2 * kTileK + 4 * kTileQ) + sizeof(float) * 4 * BQ;
};

// a block that owns kOwn tiles of its 64 query rows (Q; Q and dO) and
// streams double-buffered (K, V) stages of BK keys: the forward and dQ
template <typename T, int D, int kOwn>
struct KeyStreamShape {
  static constexpr int P = tile_pitch<T, D>();
  static constexpr int BK = 64;  // streamed key rows a tile
  static constexpr int kTileQ = kOwnRows * P;
  static constexpr int kTileK = BK * P;
  static constexpr size_t smem = sizeof(T) * (kOwn * kTileQ + 4 * kTileK);
};

// stage `stage` of the streamed (K, V) tiles, key rows [k0, k0 + R), as
// one cp.async group
template <typename T, int D, int R>
__device__ __forceinline__ void copy_kv_stage(T* Ks, T* Vs, int stage,
                                              const Params& p, int b, int h,
                                              int k0) {
  constexpr int kTile = R * tile_pitch<T, D>();
  copy_tile<T, D, R>(Ks + stage * kTile, p.k, p.sk, b, h, k0, p.S, p.vec);
  copy_tile<T, D, R>(Vs + stage * kTile, p.v, p.sv, b, h, k0, p.S, p.vec);
  cp_async_commit();
}

// ---- forward: one block per (b*h, 64-query tile), loop over key tiles -----
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using Sh = KeyStreamShape<T, D, 1>;
  constexpr int P = Sh::P, BK = Sh::BK, NK = BK / 8, ND = D / 8;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* Qs = reinterpret_cast<T*>(tile_smem);
  T* Ks = Qs + Sh::kTileQ;        // [2][BK][P]
  T* Vs = Ks + 2 * Sh::kTileK;    // [2][BK][P]

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the last q tile, the most key tiles under causal, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwnRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first q row
  const int S = p.S;
  const float scale_log2 = p.scale * kLog2e;  // scores in log2 units

  copy_tile<T, D, kOwnRows>(Qs, p.q, p.sq, b, h, q0, S, p.vec);
  copy_kv_stage<T, D, BK>(Ks, Vs, 0, p, b, h, 0);

  // rows wr + g and wr + g + 8: the running max (log2 units) and this
  // thread's part of the denominator; O at cols 8n + 2t (+1)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4] = {};
  // causal: key tiles wholly in this q tile's future are skipped
  const int k_end = p.causal ? min(S, q0 + kOwnRows) : S;
  int stage = 0;
  for (int k0 = 0; k0 < k_end; k0 += BK, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the other
    if (k0 + BK < k_end) copy_kv_stage<T, D, BK>(Ks, Vs, stage ^ 1, p, b, h,
                                                 k0 + BK);
    const T* K = Ks + stage * Sh::kTileK;
    const T* V = Vs + stage * Sh::kTileK;

    // S = Q K^T over D: the warp's 16 queries x BK keys
    float s[NK][4] = {};
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      uint32_t qh[4], ql[4];
      frag_a<kSplit>(qh, ql, Qs, P, wr, 8 * kd, lane);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bh_[2][2], bl_[2][2];
        frag_b_t2<kSplit>(bh_, bl_, K, P, 8 * j, 8 * kd, lane);
        mma_3xtf32<kSplit, kSplit>(s[j], qh, ql, bh_[0], bl_[0]);
        mma_3xtf32<kSplit, kSplit>(s[j + 1], qh, ql, bh_[1], bl_[1]);
      }
    }

    // masks only where the tile meets the causal diagonal or the end of
    // the sequence: keys past S weigh exactly 0, future keys get -1e30
    if ((p.causal && k0 + BK > q0) || k0 + BK > S) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + wr + g + 8 * (e >> 1);
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (kj >= S)
            s[j][e] = -INFINITY;
          else if (p.causal && qi < kj)
            s[j][e] = kNegInf;
        }
    }

    // online softmax: each row's max over its quad, the correction of O
    // and l, then P in place (every lane shuffles, rows past S included)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c) {
          s[j][c] = exp2f(fmaf(s[j][c], scale_log2, -m_new));
          sum += s[j][c];
        }
      l[r] = fmaf(l[r], corr, sum);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }

    // O += P V over the tile's keys
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t ph[4], pl[4];
      acc_as_a(ph, pl, s[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh_[2], bl_[2];
        frag_b_perm<kSplit>(bh_, bl_, V, P, 8 * j, 8 * n, g, t);
        mma_3xtf32<true, kSplit>(o[n], ph, pl, bh_, bl_);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the denominator over the quad
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    if (qi >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        out[static_cast<int64_t>(qi) * p.s0.s + 8 * n + 2 * t + c] =
            from_f32<T>(o[n][2 * r + c] / lc);
    if (t == 0)
      p.lse_out[static_cast<int64_t>(bh) * S + qi] = m[r] * kLn2 + logf(lc);
  }
}

// ---- dK/dV: one block per (b*h, 64-key tile), loop over q tiles -----------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  using Sh = DkdvShape<T, D>;
  constexpr int P = Sh::P, BQ = Sh::BQ, NQ = BQ / 8, ND = D / 8;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* Ks = reinterpret_cast<T*>(tile_smem);
  T* Vs = Ks + Sh::kTileK;
  T* Qs = Vs + Sh::kTileK;        // [2][BQ][P]
  T* dOs = Qs + 2 * Sh::kTileQ;   // [2][BQ][P]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * Sh::kTileQ);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.y * kOwnRows;  // tile 0, the most q tiles, first
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first key row
  const int S = p.S;
  const float scale_log2 = p.scale * kLog2e;  // p = 2^(s log2(e) - lse log2(e))

  auto load_stage = [&](int stage, int q0) {
    copy_tile<T, D, BQ>(Qs + stage * Sh::kTileQ, p.q, p.sq, b, h, q0, S,
                        p.vec);
    copy_tile<T, D, BQ>(dOs + stage * Sh::kTileQ, p.d_o, p.sdo, b, h, q0, S,
                        p.vec);
    copy_rows<BQ>(lse_s + stage * BQ, p.lse, bh, q0, S);
    copy_rows<BQ>(delta_s + stage * BQ, p.delta, bh, q0, S);
    cp_async_commit();
  };
  copy_tile<T, D, kOwnRows>(Ks, p.k, p.sk, b, h, k0, S, p.vec);
  copy_tile<T, D, kOwnRows>(Vs, p.v, p.sv, b, h, k0, S, p.vec);
  // causal: q tiles whose every row precedes this key tile are skipped
  const int q_begin = p.causal ? k0 : 0;
  load_stage(0, q_begin);

  float dk[ND][4] = {}, dv[ND][4] = {};  // key rows wr + g (+8), cols 8n + 2t
  int stage = 0;
  for (int q0 = q_begin; q0 < S; q0 += BQ, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the other
    if (q0 + BQ < S) load_stage(stage ^ 1, q0 + BQ);
    const T* Q = Qs + stage * Sh::kTileQ;
    const T* dO = dOs + stage * Sh::kTileQ;
    const float* lse = lse_s + stage * BQ;
    const float* delta = delta_s + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T over D: the warp's 16 keys x BQ queries
    float st[NQ][4] = {}, dpt[NQ][4] = {};
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      frag_a<kSplit>(kh, kl, Ks, P, wr, 8 * kd, lane);
      frag_a<kSplit>(vh, vl, Vs, P, wr, 8 * kd, lane);
#pragma unroll
      for (int j = 0; j < NQ; j += 2) {
        uint32_t bh_[2][2], bl_[2][2];
        frag_b_t2<kSplit>(bh_, bl_, Q, P, 8 * j, 8 * kd, lane);
        mma_3xtf32<kSplit, kSplit>(st[j], kh, kl, bh_[0], bl_[0]);
        mma_3xtf32<kSplit, kSplit>(st[j + 1], kh, kl, bh_[1], bl_[1]);
        frag_b_t2<kSplit>(bh_, bl_, dO, P, 8 * j, 8 * kd, lane);
        mma_3xtf32<kSplit, kSplit>(dpt[j], vh, vl, bh_[0], bl_[0]);
        mma_3xtf32<kSplit, kSplit>(dpt[j + 1], vh, vl, bh_[1], bl_[1]);
      }
    }

    // P^T and dS^T in place; masks only where the tile meets the causal
    // diagonal or the end of the sequence
    const bool edge = (p.causal && q0 < k0 + kOwnRows) || q0 + BQ > S ||
                      k0 + kOwnRows > S;
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        float pv = exp2f(fmaf(st[j][e], scale_log2, -lse[qc] * kLog2e));
        if (edge) {
          const int qi = q0 + qc, kj = k0 + wr + g + 8 * (e >> 1);
          if (qi >= S || kj >= S || (p.causal && qi < kj)) pv = 0.f;
        }
        st[j][e] = pv;
        dpt[j][e] = pv * (dpt[j][e] - delta[qc]) * p.scale;
      }

    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      acc_as_a(ph, pl, st[j]);
      acc_as_a(sh, sl, dpt[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh_[2], bl_[2];
        frag_b_perm<kSplit>(bh_, bl_, dO, P, 8 * j, 8 * n, g, t);
        mma_3xtf32<true, kSplit>(dv[n], ph, pl, bh_, bl_);
        frag_b_perm<kSplit>(bh_, bl_, Q, P, 8 * j, 8 * n, g, t);
        mma_3xtf32<true, kSplit>(dk[n], sh, sl, bh_, bl_);
      }
    }
  }

  T* dk_out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
  T* dv_out = static_cast<T*>(p.out1) + b * p.s1.b + h * p.s1.h;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k0 + wr + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (kj >= S) continue;
      dk_out[static_cast<int64_t>(kj) * p.s0.s + c] = from_f32<T>(dk[n][e]);
      dv_out[static_cast<int64_t>(kj) * p.s1.s + c] = from_f32<T>(dv[n][e]);
    }
}

// ---- dQ: one block per (b*h, 64-query tile), loop over key tiles ----------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  using Sh = KeyStreamShape<T, D, 2>;  // Q, dO
  constexpr int P = Sh::P, BK = Sh::BK, NK = BK / 8, ND = D / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  T* Qs = reinterpret_cast<T*>(tile_smem);
  T* dOs = Qs + Sh::kTileQ;
  T* Ks = dOs + Sh::kTileQ;       // [2][BK][P]
  T* Vs = Ks + 2 * Sh::kTileK;    // [2][BK][P]

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  // the last q tile, the most key tiles under causal, first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwnRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first q row
  const int S = p.S;
  const float scale_log2 = p.scale * kLog2e;

  copy_tile<T, D, kOwnRows>(Qs, p.q, p.sq, b, h, q0, S, p.vec);
  copy_tile<T, D, kOwnRows>(dOs, p.d_o, p.sdo, b, h, q0, S, p.vec);
  copy_kv_stage<T, D, BK>(Ks, Vs, 0, p, b, h, 0);

  float lse[2], delta[2];  // of the rows wr + g and wr + g + 8; lse * log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + wr + g + 8 * i;
    const int64_t at = static_cast<int64_t>(bh) * S + min(qi, S - 1);
    lse[i] = p.lse[at] * kLog2e;
    delta[i] = p.delta[at];
  }

  float dq[ND][4] = {};  // q rows wr + g (+8), cols 8n + 2t
  // causal: key tiles wholly in this q tile's future are skipped
  const int k_end = p.causal ? min(S, q0 + kOwnRows) : S;
  int stage = 0;
  for (int k0 = 0; k0 < k_end; k0 += BK, stage ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every thread is done with the other
    if (k0 + BK < k_end) copy_kv_stage<T, D, BK>(Ks, Vs, stage ^ 1, p, b, h,
                                                 k0 + BK);
    const T* K = Ks + stage * Sh::kTileK;
    const T* V = Vs + stage * Sh::kTileK;

    // S = Q K^T and dP = dO V^T over D: the warp's 16 queries x BK keys
    float s[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
    for (int kd = 0; kd < ND; ++kd) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      frag_a<kSplit>(qh, ql, Qs, P, wr, 8 * kd, lane);
      frag_a<kSplit>(oh, ol, dOs, P, wr, 8 * kd, lane);
#pragma unroll
      for (int j = 0; j < NK; j += 2) {
        uint32_t bh_[2][2], bl_[2][2];
        frag_b_t2<kSplit>(bh_, bl_, K, P, 8 * j, 8 * kd, lane);
        mma_3xtf32<kSplit, kSplit>(s[j], qh, ql, bh_[0], bl_[0]);
        mma_3xtf32<kSplit, kSplit>(s[j + 1], qh, ql, bh_[1], bl_[1]);
        frag_b_t2<kSplit>(bh_, bl_, V, P, 8 * j, 8 * kd, lane);
        mma_3xtf32<kSplit, kSplit>(dp[j], oh, ol, bh_[0], bl_[0]);
        mma_3xtf32<kSplit, kSplit>(dp[j + 1], oh, ol, bh_[1], bl_[1]);
      }
    }

    // dS in place
    const bool edge = (p.causal && k0 + BK > q0) || k0 + BK > S ||
                      q0 + kOwnRows > S;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = exp2f(fmaf(s[j][e], scale_log2, -lse[r]));
        if (edge) {
          const int qi = q0 + wr + g + 8 * r, kj = k0 + 8 * j + 2 * t + (e & 1);
          if (qi >= S || kj >= S || (p.causal && qi < kj)) pv = 0.f;
        }
        dp[j][e] = pv * (dp[j][e] - delta[r]) * p.scale;
      }

    // dQ += dS K over the tile's keys
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      uint32_t sh[4], sl[4];
      acc_as_a(sh, sl, dp[j]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bh_[2], bl_[2];
        frag_b_perm<kSplit>(bh_, bl_, K, P, 8 * j, 8 * n, g, t);
        mma_3xtf32<true, kSplit>(dq[n], sh, sl, bh_, bl_);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + wr + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
      if (qi < S)
        dq_out[static_cast<int64_t>(qi) * p.s0.s + c] = from_f32<T>(dq[n][e]);
    }
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

// the kernels' 16-byte copies need every input row 16-byte aligned
template <typename T>
bool rows_aligned16(const void* ptr, Strides st) {
  constexpr int64_t e = sizeof(T);
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st.b * e % 16 == 0 &&
         st.s * e % 16 == 0 && st.h * e % 16 == 0;
}

// shared memory above 48 KB needs the opt-in; it is set on every launch (a
// cheap host call) because it holds only for the device current at the
// time, and the caller makes the tensors' device current
template <typename Kernel>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  const Params& p, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(int which, const Params& p, cudaStream_t stream) {
  Params q = p;
  q.vec = rows_aligned16<T>(p.q, p.sq) && rows_aligned16<T>(p.k, p.sk) &&
          rows_aligned16<T>(p.v, p.sv) &&
          (which == kFwd || rows_aligned16<T>(p.d_o, p.sdo));
  // the heaviest causal tiles at blockIdx.y = 0, which launch first
  const dim3 grid(p.B * p.H, (p.S + kOwnRows - 1) / kOwnRows);
  if (which == kFwd)
    return launch_kernel(flash_fwd_kernel<T, D>, grid, kThreads,
                         KeyStreamShape<T, D, 1>::smem, q, stream);
  if (which == kDkdv)
    return launch_kernel(flash_bwd_dkdv_kernel<T, D>, grid, kThreads,
                         DkdvShape<T, D>::smem, q, stream);
  return launch_kernel(flash_bwd_dq_kernel<T, D>, grid, kThreads,
                       KeyStreamShape<T, D, 2>::smem, q, stream);
}

template <typename T>
int launch_d(int which, int head_dim, const Params& p, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(which, p, stream);
    case 32: return launch<T, 32>(which, p, stream);
    case 64: return launch<T, 64>(which, p, stream);
    case 128: return launch<T, 128>(which, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides strides_at(const int64_t* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int run(int which, int dtype, int head_dim, Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.S <= 0 || p.B * p.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  p.scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(head_dim)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(which, head_dim, p, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(which, head_dim, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (q, k, v, out alike). strides: (b, s, h) in
// elements for q, k, v, out, 12 int64 on the host. lse: f32 [B, H, S].
int fedml_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                    const void* v, void* out, float* lse,
                    const int64_t* strides, int B, int H, int S, int causal,
                    void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.out0 = out; p.lse_out = lse;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.s0 = strides_at(strides, 3);
  p.B = B; p.H = H; p.S = S; p.causal = causal;
  return run(kFwd, dtype, head_dim, p, stream);
}

// strides for q, k, v, do, dk, dv (18 int64); lse, delta: f32 [B, H, S]
int fedml_flash_bwd_dkdv(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* d_o,
                         const float* lse, const float* delta, void* dk,
                         void* dv, const int64_t* strides, int B, int H, int S,
                         int causal, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.d_o = d_o; p.lse = lse; p.delta = delta;
  p.out0 = dk; p.out1 = dv;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.sdo = strides_at(strides, 3);
  p.s0 = strides_at(strides, 4); p.s1 = strides_at(strides, 5);
  p.B = B; p.H = H; p.S = S; p.causal = causal;
  return run(kDkdv, dtype, head_dim, p, stream);
}

// strides for q, k, v, do, dq (15 int64)
int fedml_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                       const void* v, const void* d_o, const float* lse,
                       const float* delta, void* dq, const int64_t* strides,
                       int B, int H, int S, int causal, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.d_o = d_o; p.lse = lse; p.delta = delta;
  p.out0 = dq;
  p.sq = strides_at(strides, 0); p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2); p.sdo = strides_at(strides, 3);
  p.s0 = strides_at(strides, 4);
  p.B = B; p.H = H; p.S = S; p.causal = causal;
  return run(kDq, dtype, head_dim, p, stream);
}

const char* fedml_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
