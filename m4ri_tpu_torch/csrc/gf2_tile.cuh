// Shared pieces of the kernels built on the GF(2) tile product
// (gf2_gemm_hopper.cu, gf2_schur_hopper.cu, gf2_post_hopper.cu): the 32x32
// bit transpose of the pre-passes, the staging of operand tiles in shared
// memory, the 1-bit tensor-core inner product and the parity/pack epilogue.
//
// Inner product: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
// It takes A rows packed along k, which is how the packed matrix lies in
// memory, and B columns packed along k, i.e. B^T packed, which a pre-pass
// writes once, O(k*n/32) words, so the O(m*k*n) part never unpacks a bit:
// acc += popcount(a & b) over 256 contraction bits per instruction, and the
// GF(2) product is bit 0 of the s32 count.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gf2 {

constexpr int BM = 128;       // rows of C per block
constexpr int BN = 128;       // columns of C per block, in bits (4 words)
constexpr int KC = 32;        // contraction words staged per step (1024 bits)
constexpr int LDS = 40;       // shared row stride in words: 8 rows of a
                              // half-warp's 64-bit fragment loads fall on
                              // distinct banks (40 % 32 == 8)
constexpr int THREADS = 256;  // 8 warps as 4 (rows) x 2 (columns)

// ---- 32x32 bit transpose ----

// x[j] bit r  <-  x[r] bit j  (LSB-first; the butterfly of mzd.c:249-309).
__device__ __forceinline__ void transpose32(uint32_t (&x)[32]) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t m = s == 0 ? 0x0000FFFFu : s == 1 ? 0x00FF00FFu
                     : s == 2 ? 0x0F0F0F0Fu : s == 3 ? 0x33333333u
                     : 0x55555555u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if ((k & j) == 0) {
        const uint32_t a = x[k], b = x[k + j];
        const uint32_t t = ((a >> j) ^ b) & m;
        x[k] = a ^ (t << j);
        x[k + j] = b ^ t;
      }
    }
  }
}

// ---- the tile ----

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- staging: global -> shared with cp.async, STAGES deep ----

constexpr int STAGES = 2;
constexpr int STAGE_WORDS = (BM + BN) * LDS;             // A tile then B tile
constexpr int SMEM_BYTES = STAGES * STAGE_WORDS * 4;     // dynamic shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// Copies src_bytes (0..16) and zero-fills the rest of the 16 bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Start the copy of rows [row0, row0+128) x words [w0, w0+KC) of src into
// dst[128][LDS].  Rows at or beyond nrows and words at or beyond wend are
// zero-filled by the copy itself (source size 0) and never read.  16-byte
// copies only where `vec` says base and stride allow it, else 4-byte ones.
__device__ __forceinline__ void load_tile_async(uint32_t* dst,
                                                const uint32_t* __restrict__ src,
                                                long ld, int row0, int nrows,
                                                int w0, int wend, bool vec) {
#pragma unroll
  for (int i = 0; i < (BM * KC / 4) / THREADS; ++i) {
    const int v = i * THREADS + threadIdx.x;
    const int r = v >> 3;          // KC/4 = 8 vectors per row
    const int c = (v & 7) << 2;
    const int row = row0 + r, w = w0 + c;
    const int valid = row < nrows ? min(max(wend - w, 0), 4) : 0;  // words
    const uint32_t* p = valid ? src + (long)row * ld + w : src;
    const uint32_t d = smem_addr(dst + r * LDS + c);
    if (vec) {
      cp_async16(d, p, valid * 4);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async4(d + 4 * j, j < valid ? p + j : src, j < valid ? 4 : 0);
    }
  }
}

// acc += AND-popcount of A[m0.., kbeg..kend) with BT[n0.., kbeg..kend).
// Warp (wm, wn) owns rows wm*32..+31 and columns wn*64..+63 of the tile:
// 2 m16 tiles x 8 n8 tiles.  Within a 256-bit step, thread `tig` of a group
// feeds words 2*tig and 2*tig+1 to both operands; the instruction only asks
// that A and B agree on which contraction bits meet, so one 64-bit shared
// load fills two fragment registers.  The copy of step i+STAGES-1 is in
// flight while step i is multiplied; one barrier a step.
__device__ __forceinline__ void tile_mainloop(
    int (&acc)[2][8][4], const uint32_t* __restrict__ a, long lda, int m,
    bool vec_a, const uint32_t* __restrict__ bt, long ldbt, int n, int m0,
    int n0, int kbeg, int kend, uint32_t* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int steps = (kend - kbeg + KC - 1) / KC;
  auto start_copy = [&](int step) {
    if (step < steps) {
      uint32_t* as = smem + (step % STAGES) * STAGE_WORDS;
      const int k0 = kbeg + step * KC;
      load_tile_async(as, a, lda, m0, m, k0, kend, vec_a);
      load_tile_async(as + BM * LDS, bt, ldbt, n0, n, k0, kend, true);
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) start_copy(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();   // this step's tiles have landed (own copies)
    __syncthreads();               // ... everyone's; and step-1 is fully read
    start_copy(step + STAGES - 1); // refill the buffer step-1 used
    const uint32_t* as = smem + (step % STAGES) * STAGE_WORDS;
    const uint32_t* bs = as + BM * LDS;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* p = as + (wm * 32 + mt * 16 + g) * LDS + ks * 8 + 2 * tig;
        const uint2 lo = *reinterpret_cast<const uint2*>(p);
        const uint2 hi = *reinterpret_cast<const uint2*>(p + 8 * LDS);
        fa[mt][0] = lo.x; fa[mt][1] = hi.x; fa[mt][2] = lo.y; fa[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint2 fb = *reinterpret_cast<const uint2*>(
            bs + (wn * 64 + nt * 8 + g) * LDS + ks * 8 + 2 * tig);
        mma_b1(acc[0][nt], fa[0], fb.x, fb.y);
        mma_b1(acc[1][nt], fa[1], fb.x, fb.y);
      }
    }
  }
}

// Parity of the counts, 32 columns to a word.  The four threads of a group
// hold 8 of a word's 32 bits each; two shuffles OR them together, then thread
// `tig` owns the word (half = tig>>1, wi = tig&1) of each m16 tile and hands
// it to f(row, word, bits).  Every word of the tile goes to exactly one
// thread, once; f masks the ragged edge.
template <typename F>
__device__ __forceinline__ void for_each_parity_word(const int (&acc)[2][8][4],
                                                     int m0, int n0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    uint32_t mine = 0u;
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int sh = t * 8 + tig * 2;
        const int(&q)[4] = acc[mt][wi * 4 + t];
        lo |= ((uint32_t)(q[0] & 1) << sh) | ((uint32_t)(q[1] & 1) << (sh + 1));
        hi |= ((uint32_t)(q[2] & 1) << sh) | ((uint32_t)(q[3] & 1) << (sh + 1));
      }
      lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
      lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
      hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
      hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
      if ((tig & 1) == wi) mine = (tig >> 1) ? hi : lo;
    }
    f(m0 + wm * 32 + mt * 16 + g + 8 * (tig >> 1),
      n0 / 32 + wn * 2 + (tig & 1), mine);
  }
}

inline bool aligned16(const void* p, long ld_words) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (ld_words % 4 == 0);
}

// More than 48 KB of shared memory a block must be asked for, once a kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace gf2
