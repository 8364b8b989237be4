// gf2_trinv_hopper: S = (I + N)^{-1} over GF(2) for strictly triangular N,
// a batch of packed n x n matrices at a time.
//
// Replaces no TPU kernel.  The JAX package inverts these unit-triangular
// matrices with the nilpotent series prod_i (I + N^(2^i))
// (m4ri_tpu/models/ple.py, _unit_upper_inv): 2*ceil(log2 n) - 2 products of
// n^3 on unpacked bits, which suits a matrix unit; on this card the port ran
// them as float32 GEMMs with fmod passes between.  The same inverse on
// packed words is a blocked back-substitution of about n^3/6 bit operations.
// Callers: the panel sweeps' T = U_piv^{-1} (upper) and S = L11^{-1} (lower),
// and the TRSM / TRTRI base blocks (models/triangular.py).
//
// Bits outside the strict triangle of the stated orientation are ignored
// (the diagonal is taken as ones); n is a multiple of 32, at most 1024;
// input rows ldn words apart, elements bn words apart; the output is
// contiguous [B, n, n/32].
//
// Algorithm, for upper N (lower is the mirror image: row blocks from the top,
// columns left of the block): with rows in 32-row blocks K,
//     S_K = D_K (E_K + N_{K,>K} S_{>K}),   D_K = (I + N_KK)^{-1},
// taken right-looking: every row starts as its identity row e_i; at step K
// (K from the last block down) the block's rows become D_K times themselves,
// then every row above takes N_{i,K} S_K, its 32 words of bits selecting
// rows of S_K while they sit in shared memory.  The 32 x 32 D_K are
// independent of S: one warp inverts each up front by a chain of 32
// shuffles (lane i holds row i).  Row block K of S is zero left of word K
// (right of it for lower), so a step touches only the words that can be
// nonzero.
//
// What bounds it on an H100, per launch: the bytes (N's strict triangle
// read once, 4 * B * 16 * nw * (nw + 1) bytes, and S written once, B *
// n^2 / 8), the shared-memory loads of the update (one word for each (row,
// contributing row, word of the row that can be nonzero): B * ~n^3/192, at
// 32 words a clock an SM), and the chain of n/32 dependent block steps,
// each a D_K product of 32 shuffles and two barriers.  chain_floor_kernel
// below times that chain alone at the launch's own grid, block size and
// shared memory.  On an H100 SXM the shared-memory loads bind at B = 1024
// (0.085 ms at n = 512, 0.036 at 384) and the chain at B = 1 (0.008 ms at
// n = 1024); the bytes stay below both.  The design hides the chain behind
// other work:
// The wrapper (ops/hopper_trinv.py, trinv_plan) picks the strips and block
// size from (B, n) and the SM count alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace gf2 {
namespace trinv {

constexpr int MAX_THREADS = 1024;
constexpr int WARP_ELEMS = 8;   // elements a block at n = 32: a warp each

// All ones where bit j of x is set, else zero (j a constant once unrolled).
__device__ __forceinline__ uint32_t bitmask(uint32_t x, int j) {
  return static_cast<uint32_t>(static_cast<int32_t>(x << (31 - j)) >> 31);
}

// Lane i holds row i of a 32 x 32 block of N (bit j = N_ij); returns row i
// of (I + N)^{-1}, the strict triangle of N only.
template <bool UPPER>
__device__ __forceinline__ uint32_t diag_inverse(uint32_t row, int lane) {
  row &= UPPER ? (~0u << lane) << 1 : (1u << lane) - 1u;
  uint32_t d = 1u << lane;
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const int j = UPPER ? 31 - s : s;   // row j of D is final here
    const uint32_t dj = __shfl_sync(0xffffffffu, d, j);
    if ((row >> j) & 1u) d ^= dj;
  }
  return d;
}

struct Args {
  const uint32_t* nil; long ldn, bn;   // N: rows ldn, elements bn words apart
  uint32_t* out;                       // S: [batch, n, nw] contiguous
  int batch, nw;                       // n = 32 * nw
  int sw, strips;                      // words a strip, strips an element
};

template <bool UPPER>
__global__ void __launch_bounds__(MAX_THREADS) trinv_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nw = a.nw, n = 32 * nw;

  if (nw == 1) {   // a warp an element
    const long e = (long)blockIdx.x * WARP_ELEMS + warp;
    if (warp < WARP_ELEMS && e < a.batch) {
      const uint32_t row = __ldg(a.nil + e * a.bn + lane * a.ldn);
      a.out[e * 32 + lane] = diag_inverse<UPPER>(row, lane);
    }
    return;
  }

  extern __shared__ uint32_t sm[];
  const long e = blockIdx.x / a.strips;
  const int w0 = (blockIdx.x % a.strips) * a.sw;
  const int w1 = min(nw, w0 + a.sw);
  const int ws = w1 - w0;
  const int ld = ws | 1;              // odd: a column of S hits 32 banks
  // the row blocks that can hold a nonzero word of the strip
  const int kb0 = UPPER ? 0 : w0, kb1 = UPPER ? w1 : nw;
  const int r0 = 32 * kb0, rows = 32 * (kb1 - kb0);
  uint32_t* S = sm;                   // [rows][ld], row r0 first
  uint32_t* D = sm + rows * ld;       // [kb1 - kb0][32]
  const uint32_t* N = a.nil + e * a.bn;
  uint32_t* out = a.out + e * (long)n * nw;

  for (int i = threadIdx.x; i < rows * ws; i += blockDim.x) {
    const int r = i / ws, c = i % ws, row = r0 + r;
    S[r * ld + c] = (row >> 5) == w0 + c ? 1u << (row & 31) : 0u;
  }
  for (int k = kb0 + warp; k < kb1; k += warps)
    D[(k - kb0) * 32 + lane] =
        diag_inverse<UPPER>(__ldg(N + (32L * k + lane) * a.ldn + k), lane);
  __syncthreads();

  for (int s = 0; s < kb1 - kb0; ++s) {
    const int K = UPPER ? kb1 - 1 - s : kb0 + s;
    // the strip's words that row block K can hold
    const int wl = UPPER ? max(w0, K) : w0;
    const int wh = UPPER ? w1 : min(w1, K + 1);
    const int nwk = wh - wl;
    // the rows that take N_{i,K} S_K: above the block, or below it
    const int rlo = UPPER ? 0 : 32 * (K + 1);
    const int items = (UPPER ? 32 * K : n - 32 * (K + 1)) * nwk;
    // the first item's word of N, in flight across the D_K product below
    uint32_t first = 0;
    if (threadIdx.x < items)
      first = __ldg(N + (long)(rlo + threadIdx.x / nwk) * a.ldn + K);

    // S_K = D_K * (rows of block K), a warp a word, lane i row i
    uint32_t* SK = S + (32 * K - r0) * ld;
    const uint32_t d = D[(K - kb0) * 32 + lane];
    for (int c = wl - w0 + warp; c < wh - w0; c += warps) {
      const uint32_t x = SK[lane * ld + c];
      uint32_t y = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        y ^= bitmask(d, j) & __shfl_sync(0xffffffffu, x, j);
      SK[lane * ld + c] = y;
    }
    __syncthreads();

    // every dependent row i: S_i ^= N_{i,K} S_K on the words [wl, wh)
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int row = rlo + it / nwk, c = wl - w0 + it % nwk;
      const uint32_t bits = it == threadIdx.x
          ? first : __ldg(N + (long)row * a.ldn + K);
      if (!bits) continue;
      uint32_t* dst = S + (row - r0) * ld + c;
      const uint32_t* src = SK + c;
      uint32_t acc = *dst;
#pragma unroll
      for (int j = 0; j < 32; ++j) acc ^= bitmask(bits, j) & src[j * ld];
      *dst = acc;
    }
    __syncthreads();
  }

  // rows outside [r0, r0 + rows) are zero on the strip's words
  for (int i = threadIdx.x; i < n * ws; i += blockDim.x) {
    const int row = i / ws, c = i % ws;
    const int r = row - r0;
    out[(long)row * nw + w0 + c] = r >= 0 && r < rows ? S[r * ld + c] : 0u;
  }
}

template <bool UPPER>
cudaError_t launch(const Args& a, int threads, cudaStream_t st) {
  if (a.nw == 1) {
    const long blocks = (a.batch + WARP_ELEMS - 1) / WARP_ELEMS;
    trinv_kernel<UPPER><<<static_cast<unsigned>(blocks), 32 * WARP_ELEMS, 0,
                          st>>>(a);
    return cudaGetLastError();
  }
  const int n = 32 * a.nw;
  const size_t smem = 4ul * ((size_t)n * (a.sw | 1) + n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trinv_kernel<UPPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long blocks = (long)a.batch * a.strips;
  trinv_kernel<UPPER><<<static_cast<unsigned>(blocks), threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The floor of the chain: ``steps`` dependent steps of what no step of
// the kernel does without, a D_K product of one word read from and written
// back to shared memory (32 shuffles), a barrier, that word read by every
// thread, a barrier.  Launched at the kernel's grid, block size and shared
// memory, so as many blocks share an SM as in the real launch.
__global__ void __launch_bounds__(MAX_THREADS)
chain_floor_kernel(int steps, uint32_t* out) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & 31;
  const uint32_t d = 0x9e3779b9u * (lane + 1) ^ blockIdx.x;
  uint32_t acc = threadIdx.x;
  if (threadIdx.x < 32) sm[lane] = 1u << lane;
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (threadIdx.x < 32) {
      const uint32_t x = sm[lane];
      uint32_t y = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        y ^= bitmask(d, j) & __shfl_sync(0xffffffffu, x, j);
      sm[lane] = y;
    }
    __syncthreads();
    acc ^= sm[lane];
    __syncthreads();
  }
  if (acc == 0x9e3779b9u) *out = acc;   // keeps the chain alive
}

}  // namespace trinv
}  // namespace gf2

// S = (I + N)^{-1} for every element.  nil: [batch, n, nw] words, rows ldn
// and elements bn words apart; out: [batch, n, nw] contiguous; n = 32 * nw,
// nw in [1, 32]; the strips of strip_words words cover nw; threads a
// multiple of 32 in [32, 1024] (ignored at nw = 1).  Shared memory:
// 4 * n * ((strip_words | 1) + 1) bytes a block.  Returns cudaGetLastError().
extern "C" int gf2_unit_tri_inv_launch(const void* nil, long ldn, long bn,
                                       void* out, int batch, int nw,
                                       int strip_words, int threads, int upper,
                                       void* stream) {
  using namespace gf2::trinv;
  const int strips = strip_words > 0 ? (nw + strip_words - 1) / strip_words
                                     : 0;
  if (batch < 1 || nw < 1 || nw > 32 || strip_words < 1 ||
      strip_words > nw || ldn < nw || bn < 0 ||
      threads < 32 || threads > MAX_THREADS || threads % 32 ||
      (long)batch * strips > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(nil), ldn, bn,
         static_cast<uint32_t*>(out), batch, nw, strip_words, strips};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(upper ? launch<true>(a, threads, st)
                                : launch<false>(a, threads, st));
}

// The chain floor's probe (chain_floor_kernel) on ``blocks`` blocks of
// ``threads`` threads with ``smem`` bytes of dynamic shared memory each.
// For timing.  Returns cudaGetLastError().
extern "C" int gf2_trinv_chain_floor_launch(int blocks, int threads, int smem,
                                            int steps, void* out,
                                            void* stream) {
  using namespace gf2::trinv;
  if (blocks < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 ||
      smem < 128 || steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chain_floor_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
