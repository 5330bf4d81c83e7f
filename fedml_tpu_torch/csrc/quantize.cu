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
// version in ops/quantize.py and against the TPU kernel.
//
// Dequantize: out = float(q) * scale[i / 512], one rounding, bit-exact.
// Given a minuend v (the error-feedback residual of top-k + int8), it
// writes v - float(q) * scale instead, through one fmaf: rounded once, as
// XLA fuses the JAX package's "vals - dequantize(q)".
//
// A NaN in a block makes the block's scale NaN (the absmax keeps NaN, as
// the TPU kernel's max does) and its q 0, so the whole block dequantizes
// to NaN: a diverged silo ships NaN, not a finite step. An infinity gives
// an infinite scale and q = 0 for the block (inf / inf is NaN), so it too
// dequantizes to NaN.
//
// Both kernels do a few operations a value, far below what the card
// computes per byte: they are bound by HBM bytes. Quantize must read
// 8 bytes a value (x f32 + bits u32) and write 1 (plus a scale per 512):
// 10.87 MB at the CNN's D = 1,206,590, 3.24 us at 3.35 TB/s. Dequantize
// reads 1 byte a value and writes 4: 6.04 MB, 1.80 us. The design:
//   - quantize: one block of 128 threads per 512-value scale block; each
//     thread takes 4 consecutive values with one 16-byte load of x and one
//     of bits, neighbouring threads on neighbouring addresses. The block's
//     absmax is a warp __shfl_xor_sync max and then the 4 warps' partials
//     in shared memory; each thread stores a char4, thread 0 the scale.
//   - dequantize: each thread turns 16 int8 (one 16-byte load) into four
//     float4 stores (with a minuend, after four float4 loads of it); 16
//     values never straddle a 512-value block, so each thread reads one
//     scale.
//   - x is read in place: the TPU wrapper's zero-padded copy of x is not
//     made. The ragged last block masks loads past D to zero, which
//     quantizes to zero as the padding does on the TPU, and stores nothing
//     past D. Misaligned pointers take a scalar path with the same
//     arithmetic.
//
// Launch contract: the kernels run on the caller's stream, allocate nothing
// and do not synchronise; each launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 512;          // values per scale block
constexpr int kQuantThreads = 128;   // 4 values a thread
constexpr int kDequantThreads = 256;
constexpr int kDequantVals = 16;     // int8 values a dequantize thread owns
// grid cap for the dequantize grid-stride loop (132 SMs x 8 blocks x 4)
constexpr int64_t kMaxBlocks = 132 * 8 * 4;
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

__global__ void __launch_bounds__(kQuantThreads)
quant_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
             int8_t* __restrict__ q, float* __restrict__ scales, int64_t D,
             bool vec) {
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
  if (full) {
    char4 out;
    out.x = quant_one(v[0], scale, r[0]);
    out.y = quant_one(v[1], scale, r[1]);
    out.z = quant_one(v[2], scale, r[2]);
    out.w = quant_one(v[3], scale, r[3]);
    *reinterpret_cast<char4*>(q + base) = out;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (base + j < D) q[base + j] = quant_one(v[j], scale, r[j]);
  }
}

// q * s, or v - q * s rounded once when a minuend is given
template <bool kSub>
__device__ __forceinline__ float deq_one(int8_t q, float s, float v) {
  const float qf = static_cast<float>(q);
  return kSub ? fmaf(-qf, s, v) : __fmul_rn(qf, s);
}

template <bool kSub>
__global__ void __launch_bounds__(kDequantThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               const float* __restrict__ minuend, float* __restrict__ out,
               int64_t D, bool vec) {
  const int64_t chunks = (D + kDequantVals - 1) / kDequantVals;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < chunks; t += stride) {
    const int64_t base = t * kDequantVals;
    const float s = __ldg(scales + base / kBlock);
    if (vec && base + kDequantVals <= D) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(q + base));
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      float4* o = reinterpret_cast<float4*>(out + base);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (kSub)
          v = __ldg(reinterpret_cast<const float4*>(minuend + base) + j);
        o[j] = make_float4(deq_one<kSub>(b[4 * j], s, v.x),
                           deq_one<kSub>(b[4 * j + 1], s, v.y),
                           deq_one<kSub>(b[4 * j + 2], s, v.z),
                           deq_one<kSub>(b[4 * j + 3], s, v.w));
      }
    } else {
      for (int j = 0; j < kDequantVals && base + j < D; ++j)
        out[base + j] = deq_one<kSub>(__ldg(q + base + j), s,
                                      kSub ? __ldg(minuend + base + j)
                                           : 0.0f);
    }
  }
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

bool quant_vec(const float* x, const uint32_t* bits, const int8_t* q) {
  return aligned(x, 16) && aligned(bits, 16) && aligned(q, 4);
}

bool dequant_vec(const int8_t* q, const float* minuend, const float* out) {
  return aligned(q, 16) && aligned(minuend, 16) && aligned(out, 16);
}

}  // namespace

extern "C" {

// x: device f32 [D]; bits: device uint32 [D]; q: device int8 [D];
// scales: device f32 [ceil(D / 512)]. Returns a cudaError_t (0 when clean).
int fedml_quantize_int8(const float* x, const uint32_t* bits, int8_t* q,
                        float* scales, int64_t D, void* stream) {
  if (D < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 0) return 0;
  const int64_t blocks = (D + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  quant_kernel<<<static_cast<unsigned>(blocks), kQuantThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      x, bits, q, scales, D, quant_vec(x, bits, q));
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
  const int64_t chunks = (D + kDequantVals - 1) / kDequantVals;
  int64_t blocks = (chunks + kDequantThreads - 1) / kDequantThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool vec = dequant_vec(q, minuend, out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (minuend != nullptr)
    dequant_kernel<true><<<static_cast<unsigned>(blocks), kDequantThreads, 0,
                           s>>>(q, scales, minuend, out, D, vec);
  else
    dequant_kernel<false><<<static_cast<unsigned>(blocks), kDequantThreads,
                            0, s>>>(q, scales, minuend, out, D, vec);
  return static_cast<int>(cudaGetLastError());
}

// 1 when the launchers take the 16-byte paths for these pointers.
int fedml_quantize_int8_is_vec(const float* x, const uint32_t* bits,
                               const int8_t* q) {
  return quant_vec(x, bits, q) ? 1 : 0;
}

int fedml_dequantize_int8_is_vec(const int8_t* q, const float* minuend,
                                 const float* out) {
  return dequant_vec(q, minuend, out) ? 1 : 0;
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
