// Shared pieces of the kernels built on the GF(2) tile product
// (gf2_gemm_hopper.cu, gf2_schur_hopper.cu, gf2_post_hopper.cu): the 32x32
// bit transpose of the pre-passes, the staging of operand tiles in shared
// memory, the 1-bit tensor-core inner product, the parity/pack epilogue and
// the prefix sum the batched launches walk their work by.
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

// ---- staging: global -> shared with cp.async ----

constexpr int CHUNK_WORDS = BM * LDS;   // 128 rows x KC words of A or BT
constexpr int RING_B = 4;               // chunks of BT a product keeps in flight
static_assert(BM == BN, "A and BT chunks share one shape");

// Dynamic shared memory of tile_products over ksteps k-steps: A's chunks,
// then the ring of BT's.
__host__ __device__ constexpr int tile_smem_bytes(int ksteps) {
  return (ksteps + RING_B) * CHUNK_WORDS * 4;
}

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

// The products of the 128-row tile of A at m0 with every 128-column tile of
// BT (its rows [0, n)), over the contraction words [0, kw): step v is
// column tile v / ksteps, k-step v % ksteps.  A's tile is copied once and
// stays in shared memory for the whole sweep; BT's chunks stream through a
// ring of RING_B, RING_B - 1 copies ahead (at nb = 512 every chunk of BT is
// in flight at once), so a sweep waits about one round trip, not one a
// step.  pre(ct) is called before a column tile's first step (to start
// loads its epilogue needs), epi(ct, acc) after its last with the
// AND-popcounts.  Warp (wm, wn) owns rows wm*32..+31 and columns
// wn*64..+63 of a column tile: 2 m16 tiles x 8 n8 tiles.  Within a 256-bit
// step, thread `tig` of a group feeds words 2*tig and 2*tig+1 to both
// operands; the instruction only asks that A and B agree on which
// contraction bits meet, so one 64-bit shared load fills two fragment
// registers.  Words past kw (zero-filled) are not multiplied.  One barrier a
// step; the caller syncs before smem is reused.
template <typename Pre, typename Epi>
__device__ __forceinline__ void tile_products(
    const uint32_t* __restrict__ a, long lda, int m, bool vec_a,
    const uint32_t* __restrict__ bt, long ldbt, int n, int m0, int kw,
    uint32_t* smem, Pre pre, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tig = lane & 3;
  const int ksteps = (kw + KC - 1) / KC;
  const int total = (n + BN - 1) / BN * ksteps;
  uint32_t* ring = smem + ksteps * CHUNK_WORDS;
  auto copy_b = [&](int v) {
    if (v < total)
      load_tile_async(ring + v % RING_B * CHUNK_WORDS, bt, ldbt,
                      v / ksteps * BN, n, v % ksteps * KC, kw, true);
    cp_async_commit();  // an empty group keeps the count uniform
  };
  for (int k = 0; k < ksteps; ++k)      // A joins the first group
    load_tile_async(smem + k * CHUNK_WORDS, a, lda, m0, m, k * KC, kw, vec_a);
#pragma unroll
  for (int v = 0; v < RING_B - 1; ++v) copy_b(v);
  int acc[2][8][4];
  for (int v = 0; v < total; ++v) {
    const int ct = v / ksteps, kstep = v % ksteps;
    if (kstep == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
      pre(ct);
    }
    cp_async_wait<RING_B - 2>();  // this step's chunks have landed (own copies)
    __syncthreads();              // ... everyone's; and step v-1 is fully read
    copy_b(v + RING_B - 1);       // into the slot step v-1 used
    const uint32_t* as = smem + kstep * CHUNK_WORDS;
    const uint32_t* bs = ring + v % RING_B * CHUNK_WORDS;
    const int words = min(KC, kw - kstep * KC);
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      if (ks * 8 >= words) break;
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
    if (kstep == ksteps - 1) epi(ct, acc);
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

// ---- prefix sums of per-element counts, on the card ----

// cum[e] = count(0) + ... + count(e) for e < n, in one block of 32 warps:
// warp w owns the run [w*L, (w+1)*L), L = ceil(n/32), and reads it 32
// consecutive elements at a time; one pass sums each run, one warp scans the
// 32 sums, a second pass writes the run's inclusive scan (warp shuffles and
// a carry).  The batched kernels walk their work items through such sums,
// made on the stream ahead of them, so that nothing is read back.
constexpr int SCAN_THREADS = 1024;

template <typename Count>
__global__ void __launch_bounds__(SCAN_THREADS)
prefix_sum_kernel(Count count, int n, long long* __restrict__ cum) {
  __shared__ long long part[SCAN_THREADS / 32];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int run = (n + SCAN_THREADS / 32 - 1) / (SCAN_THREADS / 32);
  const int lo = min(w * run, n), hi = min(lo + run, n);
  long long s = 0;
  for (int e = lo + l; e < hi; e += 32) s += count(e);
#pragma unroll
  for (int d = 16; d; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (l == 0) part[w] = s;
  __syncthreads();
  if (w == 0) {
    long long v = part[l];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, v, d);
      if (l >= d) v += u;
    }
    part[l] = v;
  }
  __syncthreads();
  long long carry = w ? part[w - 1] : 0;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int e = e0 + l;
    long long v = e < hi ? count(e) : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, v, d);
      if (l >= d) v += u;
    }
    if (e < hi) cum[e] = carry + v;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

inline bool aligned16(const void* p, long ld_words) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (ld_words % 4 == 0);
}

// More than 48 KB of shared memory a block must be asked for, once a kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace gf2
