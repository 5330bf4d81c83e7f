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
// f32 one at 495 TFLOP/s).
//
// The forward is the simple, correct design: f32 FMAs on CUDA cores. A
// block of 256 threads (16 x 16) holds its 64-row q tile and the current
// 64-row k/v tile in shared memory (rows padded to D+1 floats); each thread
// computes a 4 x 4 patch of the score tile, the row max and sum are
// reduced with warp shuffles, and the probabilities go through shared
// memory into the second product. It is bound by shared-memory loads.
//
// The backward pair runs on the tensor cores, in 3xTF32:
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
// - p = exp2(s * scale * log2(e) - lse * log2(e)): one FFMA and the exp2
//   unit where expf takes several instructions.
// - A block of 4 warps owns a 64-row tile, 16 rows a warp. dK/dV computes
//   the transposed scores S^T = K Q^T and dP^T = V dO^T (keys x queries),
//   so their m16n8 accumulators are already the A operands of dV += P^T dO
//   and dK += dS^T Q; dQ likewise feeds S and dS into dQ += dS K. The
//   accumulator holds columns 2t, 2t+1 where the A fragment wants t, t+4;
//   the order of k inside an 8-wide slice is free, so the B fragment loads
//   rows 2t and 2t+1 instead. P and dS never leave the registers.
// - The streamed tiles (q, dO, lse, delta in dK/dV; k, v in dQ) are
//   double-buffered: the next tile's 16-byte cp.async copies are in flight
//   while the current one computes, one __syncthreads a tile. A tile row
//   is D elements and 16 bytes of padding, so the fragment loads (rows
//   g, columns t, or rows 2t, columns g) hit 32 distinct banks and the
//   copies stay 16-byte aligned. Inputs whose rows are not 16-byte aligned
//   take a scalar copy path into the same layout.
// - Tiles: 64 keys x 64 queries; dK/dV streams 32 queries at D = 128, where
//   the dK and dV accumulators take 128 registers a thread. No atomics: the
//   split into two kernels keeps the result deterministic.
// - Causal work is skewed (key tile 0 of dK/dV and the last q tile of dQ
//   sweep every tile of the other side), so the grid is (b*h, tile) with
//   the heaviest tiles at blockIdx.y = 0: they launch first.
//
// Launch contract: the kernels run on the caller's stream, allocate nothing
// and do not synchronise; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 64;       // rows of a q tile and of a k/v tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kPitchP = kTile + 1;
constexpr float kNegInf = -1e30f;  // the causal mask value, as the TPU kernel

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
  int vec;  // backward: every input row 16-byte aligned (cp.async)
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

// rows [r0, r0 + kTile) of head (b, h) into dst (pitch floats a row), times
// mul; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const void* src, Strides st, int b,
                                          int h, int r0, int S, float mul) {
  const T* base = static_cast<const T*>(src) + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int s = r0 + r;
    dst[r * pitch + c] =
        s < S ? to_f32(base[static_cast<int64_t>(s) * st.s + c]) * mul : 0.f;
  }
}

// the sum over the 16 threads that share a row (16 neighbouring lanes)
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// s[i][j] += a[row i] . b[col j] over D, for the thread's 4 x 4 patch:
// rows ty*4 + i of a, rows tx + 16 j of b (both [kTile][D+1] in shared)
template <int D>
__device__ __forceinline__ void patch_product(float (&s)[4][4], const float* a,
                                              const float* b, int ty, int tx,
                                              float mul_a) {
  constexpr int DP = D + 1;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DP + d] * mul_a;
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPitchP);
}

// ---- forward: one block per (b*h, q tile) ---------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* Ps = Vs + kTile * DP;  // [q][k]

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = p.S;

  // q * scale, as the TPU kernel scales q before the product
  load_tile<T, D>(Qs, DP, p.q, p.sq, b, h, q0, S, p.scale);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  // causal: key tiles wholly in this q tile's future are skipped
  const int k_end = p.causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, DP, p.k, p.sk, b, h, k0, S, 1.f);
    load_tile<T, D>(Vs, DP, p.v, p.sv, b, h, k0, S, 1.f);
    __syncthreads();

    float s[4][4] = {};
    patch_product<D>(s, Qs, Ks, ty, tx, 1.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        if (kj >= S)
          s[i][j] = -INFINITY;  // past the sequence: weight exactly 0
        else if (p.causal && qi < kj)
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);
        sum += pij;
        Ps[(ty * 4 + i) * kPitchP + tx + 16 * j] = pij;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      out[static_cast<int64_t>(qi) * p.s0.s + tx + 16 * c] =
          from_f32<T>(acc[i][c] / lc);
    if (tx == 0) p.lse_out[static_cast<int64_t>(bh) * S + qi] = m[i] + logf(lc);
  }
}

// ---- backward: 3xTF32 on the tensor cores ---------------------------------

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kOwnRows = 16 * kBwdWarps;  // a block's own tile: 16 rows a warp
constexpr float kLog2e = 1.4426950408889634f;

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
    for (int i = threadIdx.x; i < R * kPerRow; i += kBwdThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk, s = r0 + r;
      cp_async16(dst + r * P + c,
                 base + static_cast<int64_t>(min(s, S - 1)) * st.s + c,
                 s < S ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < R * D; i += kBwdThreads) {
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
  for (int i = threadIdx.x; i < R; i += kBwdThreads) {
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

template <typename T, int D>
struct DqShape {
  static constexpr int P = tile_pitch<T, D>();
  static constexpr int BK = 64;  // streamed key rows a tile
  static constexpr int kTileQ = kOwnRows * P;
  static constexpr int kTileK = BK * P;
  // Q, dO; two stages of (K, V)
  static constexpr size_t smem = sizeof(T) * (2 * kTileQ + 4 * kTileK);
};

// ---- dK/dV: one block per (b*h, 64-key tile), loop over q tiles -----------
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkdv_kernel(Params p) {
  using Sh = DkdvShape<T, D>;
  constexpr int P = Sh::P, BQ = Sh::BQ, NQ = BQ / 8, ND = D / 8;
  constexpr bool kSplit = sizeof(T) == 4;  // bf16 is exact in TF32
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* Ks = reinterpret_cast<T*>(bwd_smem);
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
__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_kernel(Params p) {
  using Sh = DqShape<T, D>;
  constexpr int P = Sh::P, BK = Sh::BK, NK = BK / 8, ND = D / 8;
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  T* Qs = reinterpret_cast<T*>(bwd_smem);
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

  auto load_stage = [&](int stage, int k0) {
    copy_tile<T, D, BK>(Ks + stage * Sh::kTileK, p.k, p.sk, b, h, k0, S,
                        p.vec);
    copy_tile<T, D, BK>(Vs + stage * Sh::kTileK, p.v, p.sv, b, h, k0, S,
                        p.vec);
    cp_async_commit();
  };
  copy_tile<T, D, kOwnRows>(Qs, p.q, p.sq, b, h, q0, S, p.vec);
  copy_tile<T, D, kOwnRows>(dOs, p.d_o, p.sdo, b, h, q0, S, p.vec);
  load_stage(0, 0);

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
    if (k0 + BK < k_end) load_stage(stage ^ 1, k0 + BK);
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

// the backward kernels' 16-byte copies need every input row 16-byte aligned
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
  const int tiles = (p.S + kTile - 1) / kTile;
  if (which == kFwd)
    return launch_kernel(flash_fwd_kernel<T, D>, dim3(tiles, p.B * p.H),
                         kThreads, fwd_smem<D>(), p, stream);
  Params q = p;
  q.vec = rows_aligned16<T>(p.q, p.sq) && rows_aligned16<T>(p.k, p.sk) &&
          rows_aligned16<T>(p.v, p.sv) && rows_aligned16<T>(p.d_o, p.sdo);
  // the heaviest causal tiles at blockIdx.y = 0, which launch first
  const dim3 grid(p.B * p.H, tiles);
  if (which == kDkdv)
    return launch_kernel(flash_bwd_dkdv_kernel<T, D>, grid, kBwdThreads,
                         DkdvShape<T, D>::smem, q, stream);
  return launch_kernel(flash_bwd_dq_kernel<T, D>, grid, kBwdThreads,
                       DqShape<T, D>::smem, q, stream);
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
