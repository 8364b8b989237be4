// gf2_schur_hopper: the PLE sweep's trailing update C ^= Lp*Up, in place,
// skipping the tiles that the factorization has already finished.
//
// Replaces the TPU kernels gf2_schur_update (m4ri_tpu/ops/pallas_schur.py,
// _schur_padded) and gf2_schur_update_dyn (_schur_dyn_padded): one kernel,
// two entry points.  Contract of both: rows of Lp above r0 are zero and words
// of Up left of c0w are zero, so a tile of C that lies wholly above r0 or
// wholly left of c0w has a zero delta and keeps its words; so do the first
// col_tile_skip column tiles.
//
// What bounds it on an H100.  One panel of contraction (k = 512 or 1024)
// against a C of 17152 x 512 or 34048 x 1024 words: by the bound (bytes of
// C and its operands once, against the 1-bit peak) bytes at nb=512 and
// operations at nb=1024.  What a kernel also has to move is Up^T once for
// every row band, from L2, so the bands are tall, and the design keeps the
// tensor cores fed from registers and hides every load behind them:
//   * A tile is 256 rows x 8 words (256 columns): a row of it is one 32-byte
//     sector of C.  Only the tiles of the active rectangle
//     [r0 / 256, tiles_i) x [max(c0w / 8, skip), tiles_j) exist for the
//     kernel; a persistent grid of one block an SM takes them in row-major
//     order, each block one contiguous run (schur_schedule_plain in
//     ops/hopper_schur.py is the same partition in numpy).  Bounds come by
//     value or, when the caller has them on the card, by pointer; neither
//     is ever copied from the host.
//   * A block is two groups of 8 warps, one on each 128-row half of the
//     tile, each with its own barrier and C buffers, so that one group
//     multiplies while the other is in its epilogue.
//   * Lp: a run crosses one or two row bands, so each warp loads its
//     fragments of the band (32 rows x k bits) once into registers and
//     keeps them while the block walks the band's column tiles.  Shared
//     memory then carries only Up^T, and a warp's MMAs read half the bytes
//     per instruction that a tile loop staging both operands reads.
//   * Up^T: the pre-pass writes, for the columns right of the rectangle's
//     edge only, each column tile's 256 rows x k bits as one contiguous
//     block, already in the bank-conflict-free (swizzled) order the MMA
//     loads want; one bulk copy (TMA, mbarrier) brings a tile into a ring of
//     four stages that both groups read.  The contraction is k rounded up to
//     256 bits: no MMA multiplies words that are zero-filled because a stage
//     is wider.
//   * C: each group keeps a ring of NC half tiles (4 KB each) in shared
//     memory and has the next NC - 1 of its tiles' C in flight (cp.async,
//     16 bytes a thread): the whole C round trip hides behind the MMAs of
//     the tiles in between, where one half tile in flight had left it
//     exposed at every tile.  The parity words are XORed into the tile
//     there and it goes back with 16-byte stores, a row a pair of threads.
//     One block owns a tile, so no atomics.
// The inner product is mma.sync m16n8k256 .b1 .and.popc on the packed
// words (gf2_tile.cuh): 10,400 Tbit-op/s measured for the instruction, which
// is as far as one panel of contraction can use; wgmma b1, which the GEMM
// (gf2_gemm_hopper.cu) runs at 15,500, is not used here yet.
// One launch contracts at most KW_MAX words; the wrapper splits a deeper
// contraction (XOR is associative).
//
// Batched entry (BATCH = true): B independent updates C_b ^= Lp_b*Up_b, each
// operand with its own batch stride, r0 one int per element on the card, c0w
// one int for all.  The persistent grid walks the concatenation of the
// elements' active rectangles, element-major: cum[b] is the inclusive prefix
// sum of the active tiles of elements 0..b, which a first launch
// (prefix_sum_kernel) writes on the card, so a block finds its first tile by
// a binary search over cum and then walks on without a division.  A block
// reloads its band of Lp when the (element, row tile) pair changes; Up^T is
// staged one block of tiles an element.  What bounded the batched launch at
// the batch's shapes (elements of 512-768 rows, k = 512, 12-14 column
// tiles: a block takes some 70 tiles and changes band every 12) was C's
// round trip, a tile's worth of latency at every tile: with a part left out
// (benches/variants_batched.py), the update took 0.44 ms at the McEliece
// first panel and 0.14 ms with C's loads and stores left out.  The ring of C above is the answer; the prefix
// sum made on the card spares the host the tensor operations that made it
// (a third of the call's time on the host clock).
#include "gf2_sm90.cuh"
#include "gf2_tile.cuh"

namespace gf2 {
namespace schur {

constexpr int TM = 256;          // rows of a tile: two groups of 128
constexpr int GM = 128;          // rows of a group
constexpr int TW = 8;            // words of a tile row
constexpr int TN = TW * 32;      // columns of a tile
constexpr int KW_MAX = 32;       // contraction words of one launch (4 k-steps)
constexpr int RING = 4;          // stages of Up^T
constexpr int NC = 6;            // C half-tiles a group holds: NC - 1 in flight
constexpr int GT = 256;          // threads of a group: 8 warps, 4 (rows) x 2
constexpr int NT = 2 * GT;       // threads of a block
constexpr int TR_ROWS = 9;       // padded row of the pre-pass's staging

// Bounds: by value, or read on the card where a pointer is given (batched:
// r0p points to one int an element).
struct Bounds {
  const int* r0p; const int* c0wp; int r0, c0w;
};

__device__ __forceinline__ int read_r0(const Bounds& b, long elem = 0) {
  return max(b.r0p ? b.r0p[elem] : b.r0, 0);
}
__device__ __forceinline__ int read_c0w(const Bounds& b) {
  return max(b.c0wp ? *b.c0wp : b.c0w, 0);
}
// first column tile of the active rectangle
__device__ __forceinline__ int first_col_tile(const Bounds& b, int skip) {
  return max(read_c0w(b) / TW, skip);
}

// Row n of a staged Up^T tile keeps its k-steps (8 words each) in the order
// ks ^ swz(n): the 16 threads of a half-warp, rows g = 0..3 and word pairs
// tig = 0..3, then fall on 16 distinct bank pairs (with KS = 1 or 3 the row
// stride alone spreads them).
template <int KS>
__host__ __device__ __forceinline__ int swz(int n) {
  return KS == 4 ? (n & 3) : KS == 2 ? ((n >> 1) & 1) : 0;
}

// The order of a tile's 256 columns among the MMA's: bit b of word w of
// the tile is row n = h*128 + wn*64 + nt*8 + 2*tig + j of the staged Up^T,
// with wn = w>>2, tig = w&3, j = b>>4, h = (b>>3)&1, nt = b&7.  Then the
// thread tig of a quad in the warps of column half wn holds, over the two
// 128-column halves h and the eight n8 tiles nt, all 32 counts of word
// wn*4 + tig of its two fragment rows (j: the fragment's two columns), and
// makes each of its words without a shuffle (parity_bits).
__host__ __device__ __forceinline__ int mma_row(int col) {
  const int w = col >> 5, b = col & 31;
  return ((b >> 3) & 1) * 128 + (w >> 2) * 64 + (b & 7) * 8 + (w & 3) * 2 +
         (b >> 4);
}

// ---- pre-pass: UT[tile][n][KS*8 words] from Up[k, nw], right of the edge --

// grid (ceil(words from the host's lower edge / 32), KS), 256 threads.  As
// the GEMM's bt_kernel (gf2_gemm_hopper.cu): warp w takes contraction word
// blockIdx.y*8 + w, lane l a word column of Up, a 32 x 32 bit block is
// transposed in registers; rows of Up at or beyond k and columns at or
// beyond nw read as zero.  The block's words start at the edge read on the
// card, so nothing left of it is read; blocks past the last tile return.
//
// Batched: grid (B * xb, KS); block x takes element x / xb, and writes that
// element's tiles from the first active one (j0) on, n_j of them, at
// ut + element * n_j tiles (tile t at t - j0).
template <int KS, bool BATCH>
__global__ void __launch_bounds__(256)
schur_transpose_kernel(const uint32_t* __restrict__ up, long ldu, long bsu,
                       int k, int nw, int tiles_j, Bounds bd, int skip, int xb,
                       uint32_t* __restrict__ ut) {
  __shared__ uint32_t s[1024 * TR_ROWS];
  constexpr int RW = KS * 8;
  const int j0 = first_col_tile(bd, skip);
  int bx = blockIdx.x;
  if constexpr (BATCH) {
    const long elem = blockIdx.x / xb;
    bx = blockIdx.x - (int)(elem * xb);
    up += elem * bsu;
    ut += elem * (long)(tiles_j - j0) * TN * RW;
  }
  const int wb = j0 * TW + bx * 32;
  if (wb >= tiles_j * TW) return;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int kwi = blockIdx.y * 8 + w;
  const int nwi = wb + l;
  uint32_t x[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const long row = (long)kwi * 32 + r;
    x[r] = (row < k && nwi < nw) ? up[row * ldu + nwi] : 0u;
  }
  transpose32(x);
#pragma unroll
  for (int j = 0; j < 32; ++j) s[(j * 32 + l) * TR_ROWS + w] = x[j];
  __syncthreads();
  // 8 threads write one row's 8 words: one 32-byte sector
  for (int i = 0; i < 32; ++i) {
    const int idx = i * 256 + threadIdx.x;
    const int row = idx >> 3, c = idx & 7;       // row = l*32 + j
    const long col = (long)wb * 32 + row;
    if (col < (long)tiles_j * TN) {
      const int t = (int)(col / TN) - (BATCH ? j0 : 0);
      const int n = mma_row((int)(col % TN));
      const int word = ((int)(blockIdx.y ^ swz<KS>(n)) << 3) + c;
      ut[((long)t * TN + n) * RW + word] =
          s[((row & 31) * 32 + (row >> 5)) * TR_ROWS + c];
    }
  }
}

// ---- the kernel ----

struct Args {
  const uint32_t* lp; long ldl; int kwl;   // Lp and its words in this launch
  const uint32_t* ut;                      // pre-pass output
  uint32_t* c; long ldc; int m, nw;
  int tiles_i, tiles_j, skip;
  bool vec_c;                              // 16-byte copies of C allowed
  Bounds bd;
  // batched only: elements, batch strides of C and Lp in words, and the
  // inclusive prefix sum of the elements' active tiles
  int batch; long bsc, bsl; long long* cum;
};

// Active tiles of element e, the batched launch's prefix sum's terms.
struct ActiveTiles {
  Bounds bd; int tiles_i, n_j;
  __device__ long long operator()(int e) const {
    return (long long)max(tiles_i - read_r0(bd, e) / TM, 0) * n_j;
  }
};

// first row tile of element `elem`'s active rectangle
__device__ __forceinline__ int elem_i0(const Args& a, long elem) {
  return read_r0(a.bd, elem) / TM;
}

template <int KS>
constexpr int smem_bytes() {
  return RING * TN * KS * 8 * 4 + 2 * NC * GM * TW * 4 + 2 * RING * 8;
}

// the barrier of one group of 8 warps (id 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + grp), "r"(GT) : "memory");
}

// The parity bits of half H of this thread's four words (rows g and g+8 of
// m16 tiles 0 and 1, word wn*4 + tig; see mma_row): bit j*16 + H*8 + nt is
// the count of n8 tile nt, fragment column j.  The two counts of a fragment
// row are summed 16 bits apart (a count is below 2^16), so one mask and one
// shift place two bits.
template <int H>
__device__ __forceinline__ void parity_bits(const int (&acc)[2][8][4],
                                            uint32_t (&word)[2][2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int(&q)[4] = acc[mt][nt];
      const uint32_t lo = (uint32_t)q[0] + ((uint32_t)q[1] << 16);
      const uint32_t hi = (uint32_t)q[2] + ((uint32_t)q[3] << 16);
      word[mt][0] |= (lo & 0x10001u) << (H * 8 + nt);
      word[mt][1] |= (hi & 0x10001u) << (H * 8 + nt);
    }
  }
}

// Tile coordinates of a run, advanced one tile at a time (row-major over
// the rectangle; batched, element after element, skipping elements with no
// active tile) so that no division is made per tile.
template <bool BATCH>
struct Walk {
  int b, ti, tj;
  __device__ __forceinline__ Walk(int b_, long s, int i0, int j0, int n_j)
      : b(b_), ti(i0 + (int)(s / n_j)), tj(j0 + (int)(s % n_j)) {}
  __device__ __forceinline__ void next(const Args& a, int j0) {
    if (++tj == a.tiles_j) {
      tj = j0;
      ++ti;
      if constexpr (BATCH) {
        if (ti == a.tiles_i) {
          ++b;
          while (b < a.batch && a.cum[b] == a.cum[b - 1]) ++b;
          ti = b < a.batch ? elem_i0(a, b) : 0;
        }
      }
    }
  }
};

// A block takes a run of 256-row tiles and runs it as two groups of 8 warps,
// one on each 128-row half, each with its own barrier, C buffers and
// copies: the groups drift apart like two blocks would (one multiplies while
// the other is in its epilogue) but share every staged Up^T tile, which
// halves what the ring reads from L2 against one 128-row band a tile.  A
// stage is refilled once both groups have arrived on its `empty` barrier.
template <int KS, bool BATCH>
__global__ void __launch_bounds__(NT, 1) schur_kernel(Args a) {
  extern __shared__ __align__(128) uint32_t smem[];
  constexpr int RW = KS * 8;
  constexpr int STAGE = TN * RW;                 // words of one Up^T tile
  uint32_t* stage = smem;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + RING * STAGE + 2 * NC * GM * TW);
  uint64_t* empty = full + RING;

  // the active rectangle and this block's run of it
  const int j0 = first_col_tile(a.bd, a.skip);
  const int n_j = a.tiles_j - j0;
  int i0 = 0, b0 = 0;
  long total;
  if constexpr (BATCH) {
    total = n_j > 0 ? (long)a.cum[a.batch - 1] : 0;
  } else {
    i0 = read_r0(a.bd) / TM;
    const int n_i = a.tiles_i - i0;
    total = (n_i > 0 && n_j > 0) ? (long)n_i * n_j : 0;
  }
  long s0 = total * blockIdx.x / gridDim.x;
  const int count = (int)(total * (blockIdx.x + 1) / gridDim.x - s0);
  if (count <= 0) return;
  if constexpr (BATCH) {   // the element of tile s0: first b with cum[b] > s0
    int lo = 0, hi = a.batch - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long)a.cum[mid] > s0) hi = mid; else lo = mid + 1;
    }
    b0 = lo;
    s0 -= lo ? (long)a.cum[lo - 1] : 0;
    i0 = elem_i0(a, lo);
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 3, gt = tid & (GT - 1);
  const int wm = (warp & 7) >> 1, wn = warp & 1, g = lane >> 2, tig = lane & 3;
  uint32_t* cbuf = smem + RING * STAGE + grp * NC * GM * TW;  // this group's
  Walk<BATCH> cur(b0, s0, i0, j0, n_j), c_next = cur, b_next = cur;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_b = [&](int i) {                     // thread 0, i in order
    if (i < count) {
      uint64_t* bar = &full[i % RING];
      mbar_expect_tx(bar, STAGE * 4);
      const long tile = BATCH ? (long)b_next.b * n_j + (b_next.tj - j0)
                              : (long)b_next.tj;
      bulk_load(stage + (i % RING) * STAGE, a.ut + tile * STAGE, STAGE * 4,
                bar);
      b_next.next(a, j0);
    }
  };
  // the group's half of C tile i into its buffer i % NC: thread gt copies
  // words 4*(gt&1).. of row gt>>1; what lies past the edge of C is neither
  // read nor written
  const int cr = gt >> 1, cw = 4 * (gt & 1);
  auto load_c = [&](int i) {                     // i in order
    if (i < count) {
      const int row = c_next.ti * TM + grp * GM + cr, w = c_next.tj * TW + cw;
      const uint32_t* ce = a.c + (BATCH ? (long)c_next.b * a.bsc : 0L);
      c_next.next(a, j0);
      const int valid = row < a.m ? min(max(a.nw - w, 0), 4) : 0;
      const uint32_t* p = valid ? ce + (long)row * a.ldc + w : a.c;
      const uint32_t d = smem_addr(cbuf + (i % NC) * GM * TW + cr * TW + cw);
      if (a.vec_c) {
        cp_async16(d, p, valid * 4);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cp_async4(d + 4 * j, j < valid ? p + j : a.c, j < valid ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (tid == 0)
    for (int i = 0; i < RING; ++i) load_b(i);
  for (int i = 0; i < NC - 1; ++i) load_c(i);

  uint32_t af[2][KS][4];                         // this warp's rows of the band
  long band = -1;
  for (int i = 0; i < count; ++i, cur.next(a, j0)) {
    const int ti = cur.ti, tj = cur.tj;
    const int row0 = ti * TM + grp * GM;          // the group's first row
    const uint32_t* lpe = a.lp + (BATCH ? (long)cur.b * a.bsl : 0L);
    uint32_t* ce = a.c + (BATCH ? (long)cur.b * a.bsc : 0L);
    const long key = BATCH ? (long)cur.b * a.tiles_i + ti : (long)ti;
    if (key != band) {
      band = key;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = row0 + wm * 32 + mt * 16 + g;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int w = ks * 8 + 2 * tig;
#pragma unroll
          for (int q = 0; q < 4; ++q) {          // lo.x, hi.x, lo.y, hi.y
            const int r = row + 8 * (q & 1), ww = w + (q >> 1);
            af[mt][ks][q] = (r < a.m && ww < a.kwl)
                                ? __ldg(lpe + (long)r * a.ldl + ww) : 0u;
          }
        }
      }
    }
    mbar_wait(&full[i % RING], (i / RING) & 1);
    const uint32_t* bs = stage + (i % RING) * STAGE;
    uint32_t word[2][2] = {};                    // [mt][row g, row g+8]
#pragma unroll
    for (int h = 0; h < 2; ++h) {                // 128-column halves
      int acc[2][8][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = h * 128 + wn * 64 + nt * 8 + g;
          const uint2 fb = *reinterpret_cast<const uint2*>(
              bs + n * RW + ((ks ^ swz<KS>(n)) << 3) + 2 * tig);
          mma_b1(acc[0][nt], af[0][ks], fb.x, fb.y);
          mma_b1(acc[1][nt], af[1][ks], fb.x, fb.y);
        }
      }
      if (h == 0) parity_bits<0>(acc, word);
      else parity_bits<1>(acc, word);
    }
    cp_async_wait<NC - 2>();   // this tile's C (later tiles' may pend) ...
    group_sync(grp);       // ... has landed for the group, which is done
    if (gt == 0) {         // with stage i % RING
      mbar_arrive(&empty[i % RING]);
      if (tid == 0 && i + RING < count) {
        mbar_wait(&empty[i % RING], (i / RING) & 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_b(i + RING);
      }
    }
    load_c(i + NC - 1);    // into the buffer the previous tile stored from
    uint32_t* cs = cbuf + (i % NC) * GM * TW;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        cs[(wm * 32 + mt * 16 + g + 8 * r) * TW + wn * 4 + tig] ^= word[mt][r];
    group_sync(grp);
    const int row = row0 + cr, w = tj * TW + cw;
    if (row < a.m) {
      const uint32_t* src = cs + cr * TW + cw;
      uint32_t* dst = ce + (long)row * a.ldc + w;
      const int valid = min(max(a.nw - w, 0), 4);
      if (a.vec_c && valid == 4) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < valid; ++j) dst[j] = src[j];
      }
    }
  }
}

// Blocks the card holds at once (an SM's worth times the SMs), once for
// each KS, with the kernel's shared memory allowed on the way: -1 if it
// cannot be had.  Internal linkage, so that two builds of this file loaded
// in one process (two trees compared) keep their own.
static int g_capacity[2][5];

template <int KS, bool BATCH>
int capacity() {
  int& blocks = g_capacity[BATCH][KS];
  if (!blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    const bool ok =
        cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaFuncSetAttribute(schur_kernel<KS, BATCH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<KS>()) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, schur_kernel<KS, BATCH>, NT, smem_bytes<KS>()) ==
            cudaSuccess;
    blocks = ok && per_sm * sms > 0 ? per_sm * sms : -1;
  }
  return blocks;
}

template <int KS, bool BATCH>
cudaError_t launch(const Args& a, const uint32_t* up, long ldu, long bsu,
                   int k, uint32_t* ut, int j0_host, int blocks,
                   cudaStream_t st) {
  if (capacity<KS, BATCH>() < 1) return cudaErrorInvalidConfiguration;
  const int xb = ((a.tiles_j - j0_host) * TW + 31) / 32;
  const long gx = BATCH ? (long)xb * a.batch : xb;
  if (gx > 0x7fffffffL) return cudaErrorInvalidConfiguration;
  if (BATCH)
    prefix_sum_kernel<<<1, SCAN_THREADS, 0, st>>>(
        ActiveTiles{a.bd, a.tiles_i, a.tiles_j - j0_host}, a.batch, a.cum);
  schur_transpose_kernel<KS, BATCH><<<dim3((unsigned)gx, KS), 256, 0, st>>>(
      up, ldu, bsu, k, a.nw, a.tiles_j, a.bd, a.skip, xb, ut);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  schur_kernel<KS, BATCH><<<blocks, NT, smem_bytes<KS>(), st>>>(a);
  return cudaGetLastError();
}

}  // namespace schur
}  // namespace gf2

// Blocks the persistent grid may hold resident on the current card for a
// contraction of ks k-steps (1..4); -1 if it cannot be asked.
extern "C" int gf2_schur_hopper_capacity(int ks) {
  using namespace gf2::schur;
  switch (ks) {
    case 1: return capacity<1, false>();
    case 2: return capacity<2, false>();
    case 3: return capacity<3, false>();
    case 4: return capacity<4, false>();
  }
  return -1;
}

// The same for the batched kernel.
extern "C" int gf2_schur_hopper_batched_capacity(int ks) {
  using namespace gf2::schur;
  switch (ks) {
    case 1: return capacity<1, true>();
    case 2: return capacity<2, true>();
    case 3: return capacity<3, true>();
    case 4: return capacity<4, true>();
  }
  return -1;
}

// c: [m, nw] words, updated in place; lp: [m, >= kwl] (kwl words used);
// up: [k, nw], k <= 32*kwl, ceil(k/32) <= 8*ks, ks in 1..4; ut: scratch of
// ceil(nw/8) * 256 * 8*ks words, 16-byte aligned.  Bounds: r0p / c0wp point
// to an int on the card, or are null and r0 / c0w are taken.  skip: leading
// 8-word column tiles never touched, 0 <= skip < ceil(nw/8).  j0_host: a
// lower bound of the first active column tile known on the host (>= skip);
// blocks: the grid, >= 1.  Strides in words.  Returns cudaGetLastError().
extern "C" int gf2_schur_hopper_launch(
    void* c, long ldc, const void* lp, long ldl, int kwl, const void* up,
    long ldu, int k, void* ut, const void* r0p, const void* c0wp, int r0,
    int c0w, int m, int nw, int ks, int skip, int j0_host, int blocks,
    void* stream) {
  using namespace gf2;
  using namespace gf2::schur;
  const int tiles_j = (nw + TW - 1) / TW;
  if (skip < 0 || skip >= tiles_j || j0_host < skip || j0_host >= tiles_j ||
      blocks < 1 || kwl > KW_MAX || (k + 31) / 32 > 8 * ks)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(lp), ldl, kwl,
         static_cast<const uint32_t*>(ut), static_cast<uint32_t*>(c), ldc, m,
         nw, (m + TM - 1) / TM, tiles_j, skip, aligned16(c, ldc),
         Bounds{static_cast<const int*>(r0p), static_cast<const int*>(c0wp),
                r0, c0w}, 1, 0, 0, nullptr};
  const auto* u = static_cast<const uint32_t*>(up);
  auto* t = static_cast<uint32_t*>(ut);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (ks) {
    case 1: err = launch<1, false>(a, u, ldu, 0, k, t, j0_host, blocks, st); break;
    case 2: err = launch<2, false>(a, u, ldu, 0, k, t, j0_host, blocks, st); break;
    case 3: err = launch<3, false>(a, u, ldu, 0, k, t, j0_host, blocks, st); break;
    case 4: err = launch<4, false>(a, u, ldu, 0, k, t, j0_host, blocks, st); break;
  }
  return static_cast<int>(err);
}

// The batched update: batch elements, element e at c + e*bsc, lp + e*bsl,
// up + e*bsu (strides in words, each a shape as above).  r0p: one int an
// element on the card, or null and r0 for all; c0w for all.  cum: scratch of
// batch long longs on the card, where a first launch writes the inclusive
// prefix sum over elements of max(ceil(m/256) - max(r0_e, 0)/256, 0) *
// (ceil(nw/8) - j0); j0 = max(c0w/8, 0), < ceil(nw/8).  ut: batch *
// (ceil(nw/8) - j0) * 256 * 8*ks words, 16-byte aligned.  blocks: the grid,
// >= 1.  Three launches: the prefix sum, the pre-pass, the update.
extern "C" int gf2_schur_hopper_batched_launch(
    void* c, long ldc, long bsc, const void* lp, long ldl, long bsl, int kwl,
    const void* up, long ldu, long bsu, int k, void* ut, const void* r0p,
    void* cum, int r0, int c0w, int m, int nw, int batch, int ks,
    int blocks, void* stream) {
  using namespace gf2;
  using namespace gf2::schur;
  const int tiles_j = (nw + TW - 1) / TW;
  const int j0 = c0w > 0 ? c0w / TW : 0;
  if (batch < 1 || j0 >= tiles_j || blocks < 1 || kwl > KW_MAX ||
      (k + 31) / 32 > 8 * ks)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint32_t*>(lp), ldl, kwl,
         static_cast<const uint32_t*>(ut), static_cast<uint32_t*>(c), ldc, m,
         nw, (m + TM - 1) / TM, tiles_j, j0,
         aligned16(c, ldc) && bsc % 4 == 0,
         Bounds{static_cast<const int*>(r0p), nullptr, r0, c0w}, batch, bsc,
         bsl, static_cast<long long*>(cum)};
  const auto* u = static_cast<const uint32_t*>(up);
  auto* t = static_cast<uint32_t*>(ut);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (ks) {
    case 1: err = launch<1, true>(a, u, ldu, bsu, k, t, j0, blocks, st); break;
    case 2: err = launch<2, true>(a, u, ldu, bsu, k, t, j0, blocks, st); break;
    case 3: err = launch<3, true>(a, u, ldu, bsu, k, t, j0, blocks, st); break;
    case 4: err = launch<4, true>(a, u, ldu, bsu, k, t, j0, blocks, st); break;
  }
  return static_cast<int>(err);
}
