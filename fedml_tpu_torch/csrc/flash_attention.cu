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
// f32 or bf16 (converted to f32 on load, f32 accumulation, rounded to the
// element type on store); D in {16, 32, 64, 128}.
//
// Arithmetic, as the TPU kernels do it:
//   forward  s = (q * scale) k^T, causal mask -1e30, online softmax with
//            running max m and denominator l, out = acc / max(l, 1e-30),
//            lse = m + log(max(l, 1e-30))
//   backward p = exp(s - lse), dp = dO v^T, dS = p * (dp - delta) * scale,
//            dV = p^T dO, dK = dS^T q, dQ = dS k     (FA-2, delta = rowsum(dO*O))
// with scale = 1/sqrt(D).
//
// What bounds them: at the LM path's shape (B=4, S=2048, H=4, D=64, causal,
// f32) one [S,S]x[S,D] product over all heads is 4.3 GFLOP causal; the
// forward does 2 (8.6 GFLOP), dK/dV 4 (17.2), dQ 3 (12.9), against about
// 34 MB of HBM traffic a call. They are bound by operations: 0.13, 0.26 and
// 0.19 ms at the f32 CUDA-core peak (67 TFLOP/s), 0.017/0.035/0.026 ms on
// TF32 tensor cores (495 TFLOP/s).
//
// The design is the simple, correct one: f32 FMAs on CUDA cores. A block of
// 256 threads (16 x 16) holds its 64-row tile and the current 64-row tile
// of the other side in shared memory (rows padded to D+1 floats, so the
// column walks of a score product hit 32 distinct banks); each thread
// computes a 4 x 4 patch of the 64 x 64 score tile (rows ty*4.., columns
// tx + 16j), the row max and row sum are reduced over the 16 threads of a
// row with warp shuffles, and the tile of probabilities goes through shared
// memory into the second product, where each thread owns 4 rows x D/16
// columns of the accumulator. Causal runs skip tiles wholly in the future.
// Not done yet: tensor cores (wgmma), TMA loads and a pipeline of tiles in
// flight, so the kernels reach a fraction of even the f32 peak, bound by
// shared-memory loads (8 loads for 16 FMAs in the score product).
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

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t bh, int r0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int s = r0 + i;
    dst[i] = s < S ? src[bh * S + s] : 0.f;
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
template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPitchP + 2 * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPitchP + 2 * kTile);
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

// p and dS for the thread's 4 x 4 patch of the (q tile, k tile) scores,
// written to Ps / dSs ([q][k], pitch kPitchP; Ps may be null)
template <int D>
__device__ __forceinline__ void bwd_patch(const Params& p, const float* Qs,
                                          const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse_s,
                                          const float* delta_s, float* Ps,
                                          float* dSs, int q0, int k0, int ty,
                                          int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  patch_product<D>(s, Qs, Ks, ty, tx, p.scale);  // (q * scale) k^T
  patch_product<D>(dp, dOs, Vs, ty, tx, 1.f);    // dO v^T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j, kj = k0 + col;
      float pij = 0.f;
      if (qi < p.S && kj < p.S) {
        const float sv = (p.causal && qi < kj) ? kNegInf : s[i][j];
        pij = expf(sv - lse_s[r]);
      }
      if (Ps) Ps[r * kPitchP + col] = pij;
      dSs[r * kPitchP + col] = pij * (dp[i][j] - delta_s[r]) * p.scale;
    }
  }
}

// ---- dK/dV: one block per (b*h, k tile), loop over q tiles ----------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Params p) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DP;
  float* Qs = Vs + kTile * DP;
  float* dOs = Qs + kTile * DP;
  float* Ps = dOs + kTile * DP;
  float* dSs = Ps + kTile * kPitchP;
  float* lse_s = dSs + kTile * kPitchP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = p.S;

  load_tile<T, D>(Ks, DP, p.k, p.sk, b, h, k0, S, 1.f);
  load_tile<T, D>(Vs, DP, p.v, p.sv, b, h, k0, S, 1.f);

  float dk[4][CPT], dv[4][CPT];  // key rows ty*4 + i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // causal: q tiles whose every row precedes this k tile are skipped
  const int q_begin = p.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(Qs, DP, p.q, p.sq, b, h, q0, S, 1.f);
    load_tile<T, D>(dOs, DP, p.d_o, p.sdo, b, h, q0, S, 1.f);
    load_rows(lse_s, p.lse, bh, q0, S);
    load_rows(delta_s, p.delta, bh, q0, S);
    __syncthreads();
    bwd_patch<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, Ps, dSs, q0, k0, ty, tx);
    __syncthreads();
    // dV += p^T dO, dK += dS^T q, contracted over the q tile's rows
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4], dov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kPitchP + ty * 4 + i];
        dsv[i] = dSs[qq * kPitchP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dov[c] = dOs[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv[i][c] = fmaf(pv[i], dov[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

  T* dk_out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
  T* dv_out = static_cast<T*>(p.out1) + b * p.s1.b + h * p.s1.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk_out[static_cast<int64_t>(kj) * p.s0.s + tx + 16 * c] =
          from_f32<T>(dk[i][c]);
      dv_out[static_cast<int64_t>(kj) * p.s1.s + tx + 16 * c] =
          from_f32<T>(dv[i][c]);
    }
  }
}

// ---- dQ: one block per (b*h, q tile), loop over k tiles -------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1, CPT = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DP;
  float* Ks = dOs + kTile * DP;
  float* Vs = Ks + kTile * DP;
  float* dSs = Vs + kTile * DP;
  float* lse_s = dSs + kTile * kPitchP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int S = p.S;

  load_tile<T, D>(Qs, DP, p.q, p.sq, b, h, q0, S, 1.f);
  load_tile<T, D>(dOs, DP, p.d_o, p.sdo, b, h, q0, S, 1.f);
  load_rows(lse_s, p.lse, bh, q0, S);
  load_rows(delta_s, p.delta, bh, q0, S);

  float dq[4][CPT];  // q rows ty*4 + i, columns tx + 16 c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  const int k_end = p.causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(Ks, DP, p.k, p.sk, b, h, k0, S, 1.f);
    load_tile<T, D>(Vs, DP, p.v, p.sv, b, h, k0, S, 1.f);
    __syncthreads();
    bwd_patch<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, nullptr, dSs, q0, k0, ty,
                 tx);
    __syncthreads();
    // dQ += dS k, contracted over the k tile's rows
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

  T* dq_out = static_cast<T*>(p.out0) + b * p.s0.b + h * p.s0.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dq_out[static_cast<int64_t>(qi) * p.s0.s + tx + 16 * c] =
          from_f32<T>(dq[i][c]);
  }
}

enum Which { kFwd = 0, kDkdv = 1, kDq = 2 };

template <typename T, int D>
int launch(int which, const Params& p, cudaStream_t stream) {
  const dim3 grid((p.S + kTile - 1) / kTile, p.B * p.H);
  // shared memory above 48 KB needs the opt-in; it is set on every launch
  // (a cheap host call) because it holds only for the device current at
  // the time, and the caller makes the tensors' device current
  if (which == kFwd) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(fwd_smem<D>()));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_fwd_kernel<T, D><<<grid, kThreads, fwd_smem<D>(), stream>>>(p);
  } else if (which == kDkdv) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_smem<D>()));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, dkdv_smem<D>(), stream>>>(p);
  } else {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem<D>()));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, dq_smem<D>(), stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
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
