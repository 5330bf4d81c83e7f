// Sample-weighted mean over the client axis, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fedml_tpu/ops/aggregate.py::_wmean_kernel,
// which computes the FedAvg server rule as a [1,C] @ [C,2048] MXU product per
// tile over a stack padded to 2048-wide tiles.
//
//   out[d] = sum_c wn[c] * x[c, d]      x: f32 [C, D], rows ld floats apart
//
// wn are the normalized weights (the Python wrapper divides by their sum).
// The work is 2 FLOP per 4 bytes read, far below what the card can compute
// per byte, so the kernel is bound by HBM bytes: at the FedAvg CNN's shape
// (C=10, D=1,206,590) it must read 48.3 MB and write 4.8 MB. The design
// therefore:
//   - reads each element of x exactly once, with 16-byte loads where the
//     rows allow it (ld % 4 == 0 and a 16-byte aligned base): thread i owns
//     the four consecutive elements [4i, 4i+4) of every row, so neighbouring
//     threads read neighbouring 16-byte words;
//   - keeps the C weights in shared memory and the four partial sums in f32
//     registers, accumulating over c in order with fused multiply-adds;
//   - writes each output element once;
//   - masks the ragged edge of D itself, so no padded copy of the stack is
//     made (the TPU version pads D up to a multiple of 2048 first).
// Rows that are not 16-byte aligned take a scalar path with the same
// arithmetic, one element per thread, neighbouring threads on neighbouring
// addresses.
//
// Launch contract: the kernel runs on the caller's stream, allocates nothing
// and does not synchronise; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// grid cap for the grid-stride loops: 132 SMs x 8 resident blocks of 256
// threads, times 4 so each SM always has blocks queued
constexpr int64_t kMaxBlocks = 132 * 8 * 4;

__global__ void __launch_bounds__(kThreads)
wmean_vec4_kernel(const float* __restrict__ x, int64_t ld,
                  const float* __restrict__ w, float* __restrict__ out,
                  int C, int64_t D) {
  extern __shared__ float ws[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) ws[c] = w[c];
  __syncthreads();

  const int64_t n4 = D / 4;  // whole 16-byte words per row
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = gid; i < n4; i += stride) {
    const float* p = x + 4 * i;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(p + static_cast<int64_t>(c) * ld));
      const float wc = ws[c];
      acc.x = fmaf(wc, v.x, acc.x);
      acc.y = fmaf(wc, v.y, acc.y);
      acc.z = fmaf(wc, v.z, acc.z);
      acc.w = fmaf(wc, v.w, acc.w);
    }
    reinterpret_cast<float4*>(out)[i] = acc;
  }
  // the ragged edge: the last D % 4 elements, one thread each
  if (gid < (D & 3)) {
    const int64_t d = 4 * n4 + gid;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(ws[c], __ldg(x + static_cast<int64_t>(c) * ld + d), acc);
    out[d] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
wmean_scalar_kernel(const float* __restrict__ x, int64_t ld,
                    const float* __restrict__ w, float* __restrict__ out,
                    int C, int64_t D) {
  extern __shared__ float ws[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) ws[c] = w[c];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       d < D; d += stride) {
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < C; ++c)
      acc = fmaf(ws[c], __ldg(x + static_cast<int64_t>(c) * ld + d), acc);
    out[d] = acc;
  }
}

bool use_vec4(const float* x, int64_t ld, const float* out) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace

extern "C" {

// x: device f32, C rows of D elements, row r at x + r * ld (ld >= D);
// w: device f32 [C] normalized weights; out: device f32 [D].
// Returns a cudaError_t (0 on a clean launch).
int fedml_wmean_f32(const float* x, int64_t ld, const float* w, float* out,
                    int C, int64_t D, void* stream) {
  if (C <= 0 || D < 0 || ld < D) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 0) return 0;
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  const bool vec = use_vec4(x, ld, out);
  const int64_t work = vec ? (D / 4 > 0 ? D / 4 : 1) : D;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    wmean_vec4_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        x, ld, w, out, C, D);
  } else {
    wmean_scalar_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        x, ld, w, out, C, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// 1 when fedml_wmean_f32 takes the 16-byte path for these arguments.
int fedml_wmean_f32_is_vec4(const float* x, int64_t ld, const float* out) {
  return use_vec4(x, ld, out) ? 1 : 0;
}

const char* fedml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
