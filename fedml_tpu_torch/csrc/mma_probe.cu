// A probe of the card's rate for mma.sync m16n8k8 TF32, the instruction
// that the flash kernels (flash_attention.cu) run on. It ports no
// TPU kernel: it measures the ceiling of a kernel built on this
// instruction, beside the card's published dense TF32 rate (which needs
// wgmma). Every warp runs kChains independent accumulator chains of the
// instruction on register operands, with no memory traffic, so the time is
// the tensor pipe's rate for it.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChains = 8;

__global__ void mma_tf32_probe_kernel(float* out, int iters) {
  const uint32_t one = 0x3f800000u;  // 1.0f, exact in TF32
  const uint32_t a[4] = {one, one, one, one}, b[2] = {one, one};
  float c[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" {

// out: f32 [blocks * threads]; each thread's sum of its accumulators (each
// mma adds 8 to each of 4 a thread: 32 * kChains * iters), to check the run
int fedml_mma_tf32_probe(float* out, int blocks, int threads, int iters,
                         void* stream) {
  mma_tf32_probe_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* fedml_mma_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
