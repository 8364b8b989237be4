// gf2_trinv_hopper: S = (I + N)^{-1} over GF(2) for strictly triangular N,
// a batch of packed n x n matrices at a time.
//
// Replaces no TPU kernel.  The JAX package inverts these unit-triangular
// matrices with the nilpotent series prod_i (I + N^(2^i))
// (m4ri_tpu/models/ple.py, _unit_upper_inv): 2*ceil(log2 n) - 2 products of
// n^3 on unpacked bits, which suits a matrix unit; on this card the port ran
// them as float32 GEMMs with fmod passes between.  The same inverse on
// packed words is a blocked back-substitution of about n^3/6 bit operations.
// Callers: the panel sweeps' S = L11^{-1} (lower), the TRSM / TRTRI base
// blocks (models/triangular.py) and, inside this file, the below-window
// elimination's operands (namespace operands: T = U_piv^{-1}, upper).
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

// ---------------------------------------------------------------------------
// The below-window elimination's operands (ops/hopper_operands.py): from a
// window's nb pivot-slot rows [panel | L], m_small = E^T T and wmat as 0/1
// bytes [nb, nb] and the column mask [nb], E the one-hot pivot-column rows,
// T = U_piv^{-1}.  Replaces no TPU kernel: the JAX package builds them in the
// graph of its sweep (m4ri_tpu/models/ple.py:255-293), and the port ran them
// as ~45 PyTorch operations a panel; these kernels work on packed words and
// write each output once.
//
// What bounds them on an H100: bytes, the slot rows read once (B nb^2 / 4)
// and the outputs written once (2 B nb^2 + B nb): 2.28 GB at B = 976,000,
// nb = 32 (0.68 ms at 3.35 TB/s), 0.60 GB at B = 1024, nb = 512 (0.18 ms);
// at B = 1 the latency of the launches and the inverse's chain.
//
// nb = 32: a warp an element, eight a block, one launch.  Lane s holds slot
// s's two words; the slot of each pivot column goes through shared memory,
// the gathers of U's and L's columns are 32 steps of shifts, and T is
// trinv::diag_inverse in the same warp.
// nb >= 64: a block of nb threads an (element, 32-slot block): the prep
// pass turns the block's rows into column words (warp transposes), clears L's
// multipliers and gathers U's pivot columns by word, turns them back into
// rows and writes U_piv packed and wmat; trinv_kernel<true> inverts U_piv;
// the emit pass writes T's rows at their pivot columns as m_small.
namespace operands {

constexpr int WARP_ELEMS = 8;   // elements a block at nb = 32: a warp each

struct Args {
  const uint32_t* pw; long ldp, bp;     // rows ldp, elements bp words apart
  const int32_t* rank; long brank;      // the rank after the pivot loop
  const int32_t* r0; long br0; int r0c; // before it (r0c where r0 is null)
  const int32_t* q; long bq; int qoff;  // slot s's pivot column: q[s] - qoff
  uint8_t* msmall; uint8_t* wmat;       // [batch, nb, nb] bytes each
  uint8_t* cmb;                         // [batch, nb]
  uint32_t* upiv; uint32_t* tinv;       // nb >= 64: [batch, nb, nbw] each
  int32_t* inv;                         // nb >= 64: [batch, nb]
  int batch, nbw, col0, n, preserve_l, miss_check;
};

// The slots that hold a pivot: those below rank - r0, cut to [0, nb].
__device__ __forceinline__ int live_slots(const Args& a, long e, int nb) {
  const int r0 = a.r0 ? a.r0[e * a.br0] : a.r0c;
  return min(max(a.rank[e * a.brank] - r0, 0), nb);
}

// The low 16 bits of h as 16 bytes of 0/1, bit i at byte i.
__device__ __forceinline__ uint4 bytes16(uint32_t h) {
  uint4 v;
  v.x = ((h & 0xFu) * 0x00204081u) & 0x01010101u;
  v.y = (((h >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
  v.z = (((h >> 8) & 0xFu) * 0x00204081u) & 0x01010101u;
  v.w = (((h >> 12) & 0xFu) * 0x00204081u) & 0x01010101u;
  return v;
}

// A 32 x 32 bit tile across a warp, lane i holding row i; returns column
// ``lane`` as a word (bit i from row i).  Its own inverse.  Five stages: at
// stage s each 2s x 2s block swaps its two off-diagonal s x s blocks, the
// upper lane taking its partner's left half into its right half and the
// lower lane its partner's right half into its left half.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  constexpr uint32_t LO[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                              0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = lane & s ? (x & ~LO[k]) | ((y & ~LO[k]) >> s)
                 : (x & LO[k]) | ((y & LO[k]) << s);
  }
  return x;
}

__global__ void __launch_bounds__(32 * WARP_ELEMS)
operands_warp_kernel(Args a) {
  __shared__ int slot_of[WARP_ELEMS][32], col_of[WARP_ELEMS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long e = (long)blockIdx.x * WARP_ELEMS + warp;
  if (e >= a.batch) return;             // the whole warp
  const uint32_t* row = a.pw + e * a.bp + (long)lane * a.ldp;
  const uint32_t p = __ldg(row), l = __ldg(row + 1);
  const int cnt = live_slots(a, e, 32);
  const bool live = lane < cnt;
  const int c = live ? (__ldg(a.q + e * a.bq + lane) - a.qoff) & 31 : 0;
  int* inv = slot_of[warp];
  int* col = col_of[warp];
  inv[lane] = 32;
  col[lane] = c;
  __syncwarp();
  if (live) inv[c] = lane;
  __syncwarp();
  const int iv = inv[lane];             // the slot of column lane's pivot

  // U: the panel word with L's multipliers cleared at the pivot columns
  // (column k takes L's column inv[k])
  uint32_t u = p;
  if (a.preserve_l) {
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int j = inv[k];
      if (j < 32) u ^= ((l >> j) & 1u) << k;
    }
  }
  if (!live) u = 0;
  // U_piv: column j is U's column col[j], for the pivot slots j
  uint32_t up = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j)
    if (j < cnt) up |= ((u >> col[j]) & 1u) << j;
  const uint32_t t = trinv::diag_inverse<true>(up, lane);
  uint32_t ms = __shfl_sync(0xffffffffu, t, iv & 31);   // T's row inv[lane]
  if (iv == 32) ms = 0;
  const uint32_t w = a.preserve_l && live ? u ^ (1u << c) : u;

  // each output's 1024 bytes in two coalesced 512-byte stores: lane writes
  // the half (lane & 1) of row 16 k + lane / 2
  uint8_t* M = a.msmall + e * 1024;
  uint8_t* W = a.wmat + e * 1024;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int src = 16 * k + (lane >> 1), sh = 16 * (lane & 1);
    const uint32_t mr = __shfl_sync(0xffffffffu, ms, src);
    const uint32_t wr = __shfl_sync(0xffffffffu, w, src);
    *reinterpret_cast<uint4*>(M + 512 * k + 16 * lane) = bytes16(mr >> sh);
    *reinterpret_cast<uint4*>(W + 512 * k + 16 * lane) = bytes16(wr >> sh);
  }
  a.cmb[e * 32 + lane] = a.miss_check && iv == 32 && a.col0 + lane < a.n;
}

// Block (e, kb), nb threads: slots and columns [32 kb, 32 kb + 32) of
// element e; thread i stands for slot i and column i of the element.
__global__ void __launch_bounds__(1024) operands_prep_kernel(Args a) {
  extern __shared__ uint32_t sm[];
  const int nbw = a.nbw, nb = 32 * nbw, ld = nbw | 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long e = blockIdx.x / nbw;
  const int kb = blockIdx.x % nbw;
  int* col = reinterpret_cast<int*>(sm);     // [nb] slot's pivot column
  int* inv = col + nb;                       // [nb] column's pivot slot
  uint32_t* colL = sm + 2 * nb;              // [nb] L's columns, block rows
  uint32_t* colU = sm + 3 * nb;              // [nb] U's columns, block rows
  uint32_t* rows = sm + 4 * nb;              // [2][32][ld] U_piv, wmat rows

  const int cnt = live_slots(a, e, nb);
  const bool live = tid < cnt;
  int c = 0;
  if (live) c = min(max(__ldg(a.q + e * a.bq + tid) - a.qoff, 0), nb - 1);
  col[tid] = c;
  inv[tid] = nb;
  // the block's 32 rows, word ``warp`` of each (lane i: row 32 kb + i), as
  // column words
  const uint32_t* row = a.pw + e * a.bp + (long)(32 * kb + lane) * a.ldp;
  const uint32_t colP = transpose32(__ldg(row + warp), lane);
  if (a.preserve_l) colL[tid] = transpose32(__ldg(row + nbw + warp), lane);
  __syncthreads();
  if (live) inv[c] = tid;
  __syncthreads();

  const int iv = inv[tid];                   // nb: column tid holds no pivot
  const int r = cnt - 32 * kb;               // the block's pivot rows
  const uint32_t rowlive = r >= 32 ? ~0u : r <= 0 ? 0u : (1u << r) - 1u;
  uint32_t uc = colP;
  if (a.preserve_l && iv < nb) uc ^= colL[iv];
  uc &= rowlive;
  colU[tid] = uc;
  uint32_t wc = uc;                          // wmat: U, plus E's 1 here
  if (a.preserve_l && (iv >> 5) == kb) wc ^= 1u << (iv & 31);
  if (warp == kb) {                          // the block's 32 columns
    a.cmb[e * nb + tid] = a.miss_check && iv == nb && a.col0 + tid < a.n;
    a.inv[e * nb + tid] = iv;
  }
  __syncthreads();
  // U_piv's column tid is U's column col[tid]; both back into rows
  const uint32_t upc = live ? colU[c] : 0u;
  rows[lane * ld + warp] = transpose32(upc, lane);
  rows[(32 + lane) * ld + warp] = transpose32(wc, lane);
  __syncthreads();

  // thread tid stores word tid % nbw of row tid / nbw: consecutive threads,
  // consecutive words and 32-byte runs
  const int ri = tid / nbw, wi = tid % nbw;
  const long g = e * nb + 32 * kb + ri;
  a.upiv[g * nbw + wi] = rows[ri * ld + wi];
  const uint32_t wr = rows[(32 + ri) * ld + wi];
  uint4* dst = reinterpret_cast<uint4*>(a.wmat + g * nb + 32 * wi);
  dst[0] = bytes16(wr);
  dst[1] = bytes16(wr >> 16);
}

// Block (e, kb), nb threads: rows [32 kb, 32 kb + 32) of m_small, row c
// T's row inv[c] (zero where column c holds no pivot).
__global__ void __launch_bounds__(1024) operands_emit_kernel(Args a) {
  const int nbw = a.nbw, nb = 32 * nbw, tid = threadIdx.x;
  const long e = blockIdx.x / nbw;
  const int ri = 32 * (blockIdx.x % nbw) + tid / nbw, wi = tid % nbw;
  const int iv = a.inv[e * nb + ri];
  const uint32_t t = iv < nb ? a.tinv[(e * nb + iv) * nbw + wi] : 0u;
  uint4* dst = reinterpret_cast<uint4*>(a.msmall + (e * nb + ri) * nb +
                                        32 * wi);
  dst[0] = bytes16(t);
  dst[1] = bytes16(t >> 16);
}

}  // namespace operands
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

// The below-window elimination's operands for every element (see namespace
// operands).  pw: slot rows [panel | L] of 2 nbw words, ldp and bp words
// apart; rank / r0: int32 ranks after and before the pivot loop, brank /
// br0 apart (r0 null: r0c for every element); q: int32 pivot columns plus
// qoff, bq apart; msmall, wmat: [batch, nb, nb] bytes, cmb [batch, nb],
// 16-byte aligned; scratch (nbw > 1): int32 [batch, nb, 2 nbw + 1].  nbw in
// [1, 32]; strip_words and threads: the inverse's plan (trinv_plan), read at
// nbw > 1.  Launches one kernel at nbw = 1, three otherwise.  Returns
// cudaGetLastError() of the first launch that failed.
extern "C" int gf2_post_operands_launch(
    const void* pw, long ldp, long bp, const void* rank, long brank,
    const void* r0, long br0, int r0c, const void* q, long bq, int qoff,
    void* msmall, void* wmat, void* cmb, void* scratch, int batch, int nbw,
    int col0, int n, int preserve_l, int miss_check, int strip_words,
    int threads, void* stream) {
  using namespace gf2;
  const int nb = 32 * nbw;
  if (batch < 1 || nbw < 1 || nbw > 32 || ldp < 2 * nbw || bp < 0 ||
      brank < 0 || br0 < 0 || bq < 0 || (nbw > 1 && !scratch) ||
      (long)batch * nbw > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const long per = (long)batch * nb * nbw;
  operands::Args a{static_cast<const uint32_t*>(pw), ldp, bp,
                   static_cast<const int32_t*>(rank), brank,
                   static_cast<const int32_t*>(r0), br0, r0c,
                   static_cast<const int32_t*>(q), bq, qoff,
                   static_cast<uint8_t*>(msmall), static_cast<uint8_t*>(wmat),
                   static_cast<uint8_t*>(cmb), s, s ? s + per : nullptr,
                   s ? reinterpret_cast<int32_t*>(s + 2 * per) : nullptr,
                   batch, nbw, col0, n, preserve_l, miss_check};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nbw == 1) {
    const long blocks = (batch + operands::WARP_ELEMS - 1) /
                        operands::WARP_ELEMS;
    operands::operands_warp_kernel<<<static_cast<unsigned>(blocks),
                                     32 * operands::WARP_ELEMS, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int strips = strip_words > 0 ? (nbw + strip_words - 1) / strip_words
                                     : 0;
  if (strip_words < 1 || strip_words > nbw || threads < 32 ||
      threads > trinv::MAX_THREADS || threads % 32 ||
      (long)batch * strips > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((long)batch * nbw);
  const size_t smem = 4ul * (4 * nb + 64 * (nbw | 1));
  operands::operands_prep_kernel<<<blocks, nb, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  trinv::Args t{a.upiv, nbw, (long)nb * nbw, a.tinv, batch, nbw, strip_words,
                strips};
  err = trinv::launch<true>(t, threads, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  operands::operands_emit_kernel<<<blocks, nb, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
