// Raw instruction rate of the candidate inner products of the GF(2) GEMM:
//   which = 0: mma.sync m16n8k256 b1.b1 and.popc  (65,536 bit-ops an instruction)
//   which = 1: mma.sync m16n8k32  s8.s8           ( 8,192 ops an instruction)
// Registers only, no memory traffic: eight independent accumulators a warp,
// so the figure is the tensor cores' rate for mma.sync and nothing else.
// probe_wgmma: wgmma m64n256k256 b1 and.popc (8,388,608 bit-ops an
// instruction) from operands resident in shared memory, two warpgroups a
// block, one block an SM; probe_wgmma_check: one 1024-bit contraction of
// known operands through the same descriptors, written out for the host to
// compare, which pins down the operand layout and the accumulator layout.
// Not part of the library's path; run by benches/probe_mma.py.
#include "gf2_sm90.cuh"

template <int kWhich>
__global__ void probe_kernel(int iters, int* out) {
  int acc[8][4] = {};
  uint32_t a0 = threadIdx.x * 2654435761u, a1 = a0 ^ 0x9E3779B9u,
           a2 = a0 + 77u, a3 = a1 + 1234567u;
  uint32_t b0 = a0 * 31u + 7u, b1 = a1 * 17u + 3u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kWhich == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] ^ acc[j][1] ^ acc[j][2] ^ acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out: int32[blocks * threads] on the device.  Writes the elapsed
// milliseconds of one launch to *ms.  Returns a CUDA error code, 0 if none.
extern "C" int probe_mma(int which, int blocks, int threads, int iters,
                         void* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  if (which == 0)
    probe_kernel<0><<<blocks, threads>>>(iters, static_cast<int*>(out));
  else
    probe_kernel<1><<<blocks, threads>>>(iters, static_cast<int*>(out));
  cudaEventRecord(e1);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventSynchronize(e1);
  if (err == cudaSuccess) cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return static_cast<int>(err);
}

// ---- wgmma b1 ----

namespace {

using namespace gf2;

constexpr int WG_SMEM = 2 * 64 * 128 + 256 * 128;   // A of two groups, B

__device__ __forceinline__ uint32_t probe_hash(uint32_t i, uint32_t w) {
  uint32_t x = ((i * 2654435761u) ^ (w * 2246822519u) ^ 0x5bd1e995u) *
               3266489917u;
  return x ^ (x >> 15);
}

// Fills the operands as a 128-byte swizzled tensor copy lays them out: word
// w of row r at byte r*128 + ((w/4) ^ (r%8))*16 + (w%4)*4.  A: 128 rows
// (hash rows 0..127), B: 256 rows (hash rows 1000..1255), 32 words a row.
__device__ void fill_operands(uint32_t* a, uint32_t* b) {
  for (int i = threadIdx.x; i < (128 + 256) * 32; i += blockDim.x) {
    const int r = i >> 5, w = i & 31;
    const bool is_a = r < 128;
    const int row = is_a ? r : r - 128;
    uint32_t* base = is_a ? a : b;
    base[row * 32 + (((w >> 2) ^ (row & 7)) << 2) + (w & 3)] =
        probe_hash(is_a ? row : 1000 + row, w);
  }
  fence_proxy_async();
  __syncthreads();
}

// the first 1024-byte boundary at or after p (the swizzle repeats every 1024)
__device__ __forceinline__ uint32_t* align1024(uint32_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023) / 4;
}

__global__ void __launch_bounds__(256, 1) wgmma_rate_kernel(int iters, int* out) {
  extern __shared__ __align__(16) uint32_t smem_raw[];
  uint32_t* a = align1024(smem_raw);
  uint32_t* b = a + 128 * 32;
  fill_operands(a, b);
  const int wg = threadIdx.x >> 7;
  int d[128] = {};
  const uint64_t da = desc_sw128(a + wg * 64 * 32), db = desc_sw128(b);
  wgmma_fence();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_b1_m64n256(d, da + 2 * k, db + 2 * k, it | k);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(d);
  int s = 0;
#pragma unroll
  for (int i = 0; i < 128; ++i) s ^= d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out: int32[128 * 256], row-major D of A rows 0..127 against B rows 0..255
// over the 32 words: each warpgroup its 64 rows.
__global__ void __launch_bounds__(256, 1) wgmma_check_kernel(int* out) {
  extern __shared__ __align__(16) uint32_t smem_raw[];
  uint32_t* a = align1024(smem_raw);
  uint32_t* b = a + 128 * 32;
  fill_operands(a, b);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int d[128] = {};
  const uint64_t da = desc_sw128(a + wg * 64 * 32), db = desc_sw128(b);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_b1_m64n256(d, da + 2 * k, db + 2 * k, k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(wg * 64 + warp * 16 + g + 8 * h) * 256 + 8 * i + 2 * t + e] =
            d[4 * i + 2 * h + e];
}

}  // namespace

// One launch of `blocks` blocks of two warpgroups, each issuing 4 * iters
// wgmma m64n256k256 b1; elapsed milliseconds to *ms.  out: int32[blocks*256].
extern "C" int probe_wgmma(int blocks, int iters, void* out, float* ms) {
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM + 1024);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  wgmma_rate_kernel<<<blocks, 256, WG_SMEM + 1024>>>(iters,
                                                     static_cast<int*>(out));
  cudaEventRecord(e1);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventSynchronize(e1);
  if (err == cudaSuccess) cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return static_cast<int>(err);
}

// out: int32[128 * 256] on the device, see wgmma_check_kernel.
extern "C" int probe_wgmma_check(void* out) {
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WG_SMEM + 1024);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_check_kernel<<<1, 256, WG_SMEM + 1024>>>(static_cast<int*>(out));
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
