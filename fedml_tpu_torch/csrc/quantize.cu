// Block-scaled int8 quantize and dequantize, hand-written for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels fedml_tpu/ops/quantize.py::_quant_kernel
// and ::_dequant_kernel, which carry the compressed cross-silo wire: every
// silo's uplink delta, the server's downlink delta against the silos'
// mirror, and the error-feedback residual of top-k + int8.
//
// Quantize, per block of 512 values (the last block of D may be ragged):
//   scale = max(absmax, 1e-12) * f32(1/127)
//   q     = clip(floor(x / scale) + (u < frac), -127, 127),  u = (bits >> 8) * 2^-24
// with the random bits an input (one uint32 a value), as on the TPU. The
// scale multiplies by the f32 reciprocal of 127, as XLA computes the TPU
// kernel's "/ 127.0"; x / scale is a true IEEE division (nvcc's default
// -prec-div=true; the build never passes --use_fast_math); bits >> 8 is a
// logical shift of a uint32. floor, the compare and the clip are exact and
// the block max is order-free, so the kernel is bit-exact against the plain
// version in ops/quantize.py and against the TPU kernel. Given a residual
// output it also writes x - float(q) * scale through one fmaf, from the
// registers: the error-feedback residual of top-k + int8 in the same
// launch, rounded once, as XLA fuses the JAX package's "vals -
// dequantize(q)".
//
// Dequantize: out = float(q) * scale[i / 512], one rounding, bit-exact.
// Given a minuend v, it writes v - float(q) * scale instead, through the
// same fmaf.
//
// A NaN in a block makes the block's scale NaN (the absmax keeps NaN, as
// the TPU kernel's max does) and its q 0, so the whole block dequantizes
// to NaN: a diverged silo ships NaN, not a finite step. An infinity gives
// an infinite scale and q = 0 for the block (inf / inf is NaN), so it too
// dequantizes to NaN.
//
// Both kernels do a few operations a value, far below what the card
// computes per byte: they are bound by HBM bytes and, at the wire's sizes,
// by one launch. Quantize must read 8 bytes a value (x f32 + bits u32) and
// write 1 (plus a scale per 512): 10.87 MB at the CNN's D = 1,206,590,
// 3.24 us at 3.35 TB/s. Dequantize reads 1 byte a value and writes 4:
// 6.04 MB, 1.80 us. The designs:
//   - quantize: one block of 128 threads per 512-value scale block; each
//     thread takes 4 consecutive values with one 16-byte load of x and one
//     of bits, neighbouring threads on neighbouring addresses. The block's
//     absmax is a warp __shfl_xor_sync max and then the 4 warps' partials
//     in shared memory; each thread stores a char4 (and a float4 of
//     residual), thread 0 the scale. One warp per scale block, 64 threads
//     per block and a persistent grid that prefetches the next block were
//     each measured slower on the H100 (PERF.md); without any per-value
//     arithmetic the same loads and stores take ~87% of the time.
//   - dequantize: a grid of (SMs x 4) blocks, each owning a contiguous run
//     of whole 512-value scale blocks (an even split: the runs differ by
//     at most one scale block). Warp w of a block takes the run's scale
//     blocks w, w + 4, ..., two at a time: each lane loads four char4 (and
//     the minuend's float4) of both, every load before any store, and
//     stores float4s, so each warp-wide store covers 512 contiguous bytes.
//     The same split through TMA bulk copies into a shared-memory ring was
//     measured slower at both sizes (PERF.md).
//   - x is read in place: the TPU wrapper's zero-padded copy of x is not
//     made. The quantize's ragged last block masks loads past D to zero,
//     which quantizes to zero as the padding does on the TPU, and stores
//     nothing past D; the dequantize's is converted value by value by the
//     grid's last block. Misaligned pointers take a scalar path of the same
//     kernels, with the same arithmetic.
//
// Launch contract: the kernels run on the caller's stream, allocate nothing
// and do not synchronise; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 512;          // values per scale block
constexpr int kQuantThreads = 128;   // 4 values a thread
constexpr int kDequantThreads = 128;
constexpr int kDequantWarps = kDequantThreads / 32;
constexpr int kDequantCtasPerSm = 4;
// f32(1/127) = 0x3C010204, the reciprocal XLA multiplies by
constexpr float kInv127 = 0x1.020408p-7f;
// 2^-24: (bits >> 8) * 2^-24 is a uniform draw on [0, 1), exact in f32
constexpr float kTwoPowM24 = 0x1.0p-24f;

// max that keeps NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ int8_t quant_one(float x, float scale,
                                            uint32_t bits) {
  const float scaled = x / scale;
  const float u = static_cast<float>(bits >> 8) * kTwoPowM24;
  const float low = floorf(scaled);
  const float q = low + (u < scaled - low ? 1.0f : 0.0f);
  if (q != q) return 0;  // a NaN block: its NaN scale carries the NaN
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// q * s, or v - q * s rounded once when a minuend is given
template <bool kSub>
__device__ __forceinline__ float deq_one(int8_t q, float s, float v) {
  const float qf = static_cast<float>(q);
  return kSub ? fmaf(-qf, s, v) : __fmul_rn(qf, s);
}

template <bool kRes>
__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
             int8_t* __restrict__ q, float* __restrict__ scales,
             float* __restrict__ res, int64_t D, bool vec) {
  __shared__ float warp_max[kQuantThreads / 32];
  const int64_t blk = blockIdx.x;
  const int64_t base = blk * kBlock + 4 * threadIdx.x;
  const bool full = vec && (blk + 1) * kBlock <= D;
  float v[4];
  uint32_t r[4];
  if (full) {
    const float4 xv = __ldg(reinterpret_cast<const float4*>(x + base));
    const uint4 rv = __ldg(reinterpret_cast<const uint4*>(bits + base));
    v[0] = xv.x; v[1] = xv.y; v[2] = xv.z; v[3] = xv.w;
    r[0] = rv.x; r[1] = rv.y; r[2] = rv.z; r[3] = rv.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = base + j < D;
      v[j] = in ? __ldg(x + base + j) : 0.0f;
      r[j] = in ? __ldg(bits + base + j) : 0u;
    }
  }
  float m = nan_max(nan_max(fabsf(v[0]), fabsf(v[1])),
                    nan_max(fabsf(v[2]), fabsf(v[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = nan_max(nan_max(warp_max[0], warp_max[1]),
              nan_max(warp_max[2], warp_max[3]));
  const float scale = nan_max(m, 1e-12f) * kInv127;
  if (threadIdx.x == 0) scales[blk] = scale;
  int8_t qv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) qv[j] = quant_one(v[j], scale, r[j]);
  if (full) {
    *reinterpret_cast<char4*>(q + base) = make_char4(qv[0], qv[1], qv[2],
                                                     qv[3]);
    if constexpr (kRes)
      *reinterpret_cast<float4*>(res + base) = make_float4(
          deq_one<true>(qv[0], scale, v[0]), deq_one<true>(qv[1], scale, v[1]),
          deq_one<true>(qv[2], scale, v[2]),
          deq_one<true>(qv[3], scale, v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < D) {
        q[base + j] = qv[j];
        if constexpr (kRes) res[base + j] = deq_one<true>(qv[j], scale, v[j]);
      }
  }
}

// the shares of an even split of n items over `parts`: part c owns
// [first, first + count), and the counts differ by at most one
__device__ __forceinline__ void even_share(int64_t n, int64_t parts,
                                           int64_t c, int64_t* first,
                                           int64_t* count) {
  const int64_t base = n / parts, extra = n % parts;
  *count = base + (c < extra ? 1 : 0);
  *first = c * base + (c < extra ? c : extra);
}

// values [begin, end), one at a time
template <bool kSub>
__device__ __forceinline__ void dequant_scalar(
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    const float* __restrict__ minuend, float* __restrict__ out,
    int64_t begin, int64_t end) {
  for (int64_t i = begin + threadIdx.x; i < end; i += kDequantThreads)
    out[i] = deq_one<kSub>(__ldg(q + i), __ldg(scales + i / kBlock),
                           kSub ? __ldg(minuend + i) : 0.0f);
}

template <bool kSub>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               const float* __restrict__ minuend, float* __restrict__ out,
               int64_t D, bool vec) {
  const int64_t whole = D / kBlock;  // the ragged last block is not shared
  int64_t first, count;
  even_share(whole, gridDim.x, blockIdx.x, &first, &count);
  const bool last = blockIdx.x == gridDim.x - 1;
  if (!vec) {  // misaligned pointers: the same run, one value at a time
    dequant_scalar<kSub>(q, scales, minuend, out, first * kBlock,
                         last ? D : (first + count) * kBlock);
    return;
  }
  if (last) dequant_scalar<kSub>(q, scales, minuend, out, whole * kBlock, D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t i = warp; i < count; i += 2 * kDequantWarps) {
    char4 c[2][4];
    float4 mv[2][4];
    float s[2] = {0.0f, 0.0f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t blk = first + i + u * kDequantWarps;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[u][j] = make_char4(0, 0, 0, 0);
        mv[u][j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (i + u * kDequantWarps < count) {
        s[u] = __ldg(scales + blk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[u][j] = __ldg(reinterpret_cast<const char4*>(q + blk * kBlock)
                          + 32 * j + lane);
          if constexpr (kSub)
            mv[u][j] = __ldg(reinterpret_cast<const float4*>(
                                 minuend + blk * kBlock) + 32 * j + lane);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i + u * kDequantWarps < count) {
        float4* o = reinterpret_cast<float4*>(
            out + (first + i + u * kDequantWarps) * kBlock);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[32 * j + lane] = make_float4(
              deq_one<kSub>(c[u][j].x, s[u], mv[u][j].x),
              deq_one<kSub>(c[u][j].y, s[u], mv[u][j].y),
              deq_one<kSub>(c[u][j].z, s[u], mv[u][j].z),
              deq_one<kSub>(c[u][j].w, s[u], mv[u][j].w));
      }
    }
  }
}

__global__ void empty_kernel() {}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

bool quant_vec(const float* x, const uint32_t* bits, const int8_t* q,
               const float* res) {
  return aligned(x, 16) && aligned(bits, 16) && aligned(q, 4)
         && aligned(res, 16);
}

bool dequant_vec(const int8_t* q, const float* minuend, const float* out) {
  return aligned(q, 16) && aligned(minuend, 16) && aligned(out, 16);
}

// blocks of the dequantize grid: kDequantCtasPerSm an SM, at most one per
// whole scale block, at least one
int64_t dequant_grid(int64_t D) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1)
                      * kDequantCtasPerSm;
  const int64_t whole = D / kBlock;
  return whole < 1 ? 1 : (whole < cap ? whole : cap);
}

}  // namespace

extern "C" {

// x: device f32 [D]; bits: device uint32 [D]; q: device int8 [D];
// scales: device f32 [ceil(D / 512)]; res: device f32 [D] or null, which
// gets x - float(q) * scale. Returns a cudaError_t (0 when clean).
int fedml_quantize_int8(const float* x, const uint32_t* bits, int8_t* q,
                        float* scales, float* res, int64_t D, void* stream) {
  if (D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 0) return 0;
  const int64_t blocks = (D + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  const bool vec = quant_vec(x, bits, q, res);
  const auto s = static_cast<cudaStream_t>(stream);
  if (res != nullptr)
    quant_kernel<true><<<grid, kQuantThreads, 0, s>>>(x, bits, q, scales,
                                                      res, D, vec);
  else
    quant_kernel<false><<<grid, kQuantThreads, 0, s>>>(x, bits, q, scales,
                                                       res, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// q: device int8 [D]; scales: device f32 [ceil(D / 512)]; minuend: device
// f32 [D] or null; out: device f32 [D]. Writes q * scale, or minuend -
// q * scale when a minuend is given. Returns a cudaError_t (0 when clean).
int fedml_dequantize_int8(const int8_t* q, const float* scales,
                          const float* minuend, float* out, int64_t D,
                          void* stream) {
  if (D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 0) return 0;
  const auto grid = static_cast<unsigned>(dequant_grid(D));
  const bool vec = dequant_vec(q, minuend, out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (minuend != nullptr)
    dequant_kernel<true><<<grid, kDequantThreads, 0, s>>>(
        q, scales, minuend, out, D, vec);
  else
    dequant_kernel<false><<<grid, kDequantThreads, 0, s>>>(
        q, scales, minuend, out, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel: the floor of a launch (or of a CUDA graph
// node) that the int8 kernels' times are read against.
int fedml_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// 1 when the launchers take the 16-byte paths for these pointers.
int fedml_quantize_int8_is_vec(const float* x, const uint32_t* bits,
                               const int8_t* q, const float* res) {
  return quant_vec(x, bits, q, res) ? 1 : 0;
}

int fedml_dequantize_int8_is_vec(const int8_t* q, const float* minuend,
                                 const float* out) {
  return dequant_vec(q, minuend, out) ? 1 : 0;
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
