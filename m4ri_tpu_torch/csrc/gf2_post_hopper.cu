// gf2_post_hopper: the PLE panel's elimination of the rows below the window,
// fused into one pass over the panel.
//
// Replaces the TPU kernel panel_post (m4ri_tpu/ops/pallas_post.py,
// _post_padded).  For the rows in [below0, mvalid):
//     lam  = X * M          multipliers           (M = E^T T, nb x nb bits)
//     v    = X ^ lam * W    eliminated panel words
//     miss = any(v & colmask)
// other rows pass through (v = X, lam = 0).
//
// What bounds it on an H100: bytes.  X, v and lam are m x nb/32 words each,
// and M, W arrive as one byte a bit (nb x nb bytes each), against 2 *
// 2*rows*nb*nb bit operations that the 1-bit MMA does in microseconds.  A
// call is two launches on one stream:
//   * post_pack_kernel, a grid sized to the card that strides over its work:
//     (1) zeroes the miss bytes; (2) packs M^T and W^T along the contraction
//     and the column mask, for the elements that have a row in range only: a
//     warp takes a unit of 32 columns x 4 words (128 rows) of one operand,
//     each lane loads 32 bytes of a row (one sector; four rows in flight),
//     packs them into a word and a butterfly of shuffles transposes the
//     warp's 32 x 32 bits, and each lane stores its column's 4 words with
//     one 16-byte store (a padding word of the row is a zero word of its
//     unit); (3) copies X to v and zeroes lam on every
//     row out of range, 16 bytes an item where the layout allows, four
//     items in flight a thread.
//   * post_kernel, a persistent grid of the MMA blocks over the 128-row
//     tiles that hold a row in range and nothing else: a block forms its
//     rows of lam (the contraction runs along the packed axis of X, M^T
//     packed by the pack kernel), stores them, since lam is an output
//     anyway, and reads those rows back as the left operand of the second
//     product while they are still in cache (rows of the tile out of range
//     read the zeros the copy left); only rows in range are written.  A
//     product keeps its tile of X (of lam) in shared memory and has the
//     chunks of M^T (W^T) in flight four at a time (tile_products), and the
//     words of X the second product's epilogue XORs are loaded before its
//     MMAs: a tile waits for a few round trips, not one a step.  Blocks run
//     in no order, so the miss byte, zeroed by the pack kernel, is set by
//     any block that finds a hit.
// Batched (B panels, below0 one int an element on the card): an element
// with no row in range (below0 >= mvalid, as on every McEliece panel after
// the first and every panel of a 32 x 32 rank test) has lam = 0 and v = X,
// so its M, W and column mask are never read: the pack skips it, the copy
// moves its rows, no MMA block exists for it.  The MMA grid walks the
// in-range tiles of all elements through their prefix sum (cum, made on the
// card by a first launch, prefix_sum_kernel), a binary search an item;
// nothing is read back.  The single call is the batch of one, its tile range
// known on the host.
// The batched sweep's commit of a panel (commit_warp_kernel,
// commit_block_kernel) sits at the end of this file: it reads v and lam.
#include <algorithm>

#include "gf2_tile.cuh"

namespace gf2 {
namespace post {

constexpr int PACK_THREADS = 256;

struct Args {
  const uint32_t* x; long ldx, bx;       // X: rows ldx, elements bx words apart
  bool vec_x;                            // 16-byte loads of X allowed
  const int8_t* m_small; const int8_t* wmat;   // [B, nb, nb] bytes
  const int8_t* colmask_bits;                  // [B, nb] bytes
  uint32_t* mt; uint32_t* wt; long ld;   // packed M^T, W^T: rows ld words
  uint32_t* colmask;                     // packed column mask
  long tstride;                          // element stride of mt, wt, colmask
  uint32_t* v; uint32_t* lam; long bo;   // rows nbw words, elements bo apart
  bool vec_out;                          // 16-byte access to v, lam allowed
  unsigned char* miss;                   // one byte an element
  int m, nbw, mvalid, batch;
  int below0; const int* below0p;        // by value, or one int an element
  long long* cum;                        // prefix sum of in-range tiles
  bool pack_all;                         // the packing launch alone
};

// Rows [lo_row, hi_row) of element e are in range.
__device__ __forceinline__ int lo_row(const Args& a, long e) {
  return max(a.below0p ? __ldg(a.below0p + e) : a.below0, 0);
}
__device__ __forceinline__ int hi_row(const Args& a) {
  return min(a.mvalid, a.m);
}

// In-range tiles of element e, the batched launch's prefix sum's terms.
struct InRangeTiles {
  const int* below0p; int hi;
  __device__ long long operator()(int e) const {
    const int lo = max(below0p[e], 0);
    return lo < hi ? (hi + BM - 1) / BM - lo / BM : 0;
  }
};

// The word of column t of the 32 bytes each lane holds (bit l: lane l's
// byte t), handed to lane t.  Each lane packs its 32 bytes (0 or 1) into a
// word, four at a time by one multiply (byte i of w lands on bit 24 + i of
// w * 0x01020408), then the warp transposes the 32 x 32 bit block across
// its lanes, transpose32's butterfly with a shuffle a stage.
__device__ __forceinline__ uint32_t column_word(const uint4 (&q)[2], int lane) {
  const uint32_t b[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                         q[1].x, q[1].y, q[1].z, q[1].w};
  uint32_t x = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x |= (((b[i] & 0x01010101u) * 0x01020408u) >> 24 & 0xFu) << (4 * i);
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const uint32_t m = s == 0 ? 0x0000FFFFu : s == 1 ? 0x00FF00FFu
                     : s == 2 ? 0x0F0F0F0Fu : s == 3 ? 0x33333333u
                     : 0x55555555u;
    const uint32_t other = __shfl_xor_sync(0xffffffffu, x, j);
    const bool upper = lane & j;
    const uint32_t lo = upper ? other : x, hi = upper ? x : other;
    const uint32_t t = ((lo >> j) ^ hi) & m;
    x = upper ? hi ^ t : lo ^ (t << j);
  }
  return x;
}

// Unit u of the pack: element e, plane z (M, then W), strip s of 32
// columns, group g of 4 packed words; per element 2 * nbw * (ld/4) units.
// dst[j, w] bit b = src[32*w + b, j] for j in the strip, w in the group.
__device__ void pack_unit(const Args& a, long u, int lane) {
  const int nb = a.nbw * 32, G = (int)(a.ld >> 2);
  const long per = 2L * a.nbw * G;
  const long e = u / per;
  int rem = (int)(u - e * per);
  const int z = rem / (a.nbw * G);
  rem -= z * a.nbw * G;
  const int s = rem / G, g = rem - s * G;
  const int8_t* src = (z ? a.wmat : a.m_small) + e * nb * (long)nb + 32 * s;
  uint4 q[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = 4 * g + i;
    if (w < a.nbw) {
      const uint4* p =
          reinterpret_cast<const uint4*>(src + (long)(32 * w + lane) * nb);
      q[i][0] = __ldg(p);
      q[i][1] = __ldg(p + 1);
    } else {
      q[i][0] = q[i][1] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  uint4 out;
  out.x = column_word(q[0], lane);
  out.y = column_word(q[1], lane);
  out.z = column_word(q[2], lane);
  out.w = column_word(q[3], lane);
  uint32_t* dst = (z ? a.wt : a.mt) + e * a.tstride;
  *reinterpret_cast<uint4*>(dst + (long)(32 * s + lane) * a.ld + 4 * g) = out;
  if (z == 0 && g == 0) {
    const unsigned cm = __ballot_sync(
        0xffffffffu, a.colmask_bits[e * nb + 32 * s + lane] & 1);
    if (lane == 0) a.colmask[e * a.tstride + s] = cm;
  }
}

// Rows out of range: v = X, lam = 0.  Item i is chunk i % per of row i /
// per (of all the batch's rows), a chunk 16 bytes where the layout allows
// (V = uint4) or one word; items are strided over the grid, four at a time,
// so that four loads are in flight a thread.  I: the index type (32 bits
// where the items allow, to keep the divisions cheap).
template <typename V, typename I>
__device__ void copy_out_of_range(const Args& a, I first, I step) {
  constexpr int W = sizeof(V) / 4;   // words a chunk
  const int hi = hi_row(a), per = a.nbw / W;
  const I items = (I)a.batch * (I)a.m * (I)per;
  for (I i0 = first; i0 < items; i0 += 4 * step) {
    long src[4], dst[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const I i = i0 + k * step;
      src[k] = -1;
      if (i < items) {
        const I rg = i / (I)per;
        const int c = (int)(i - rg * (I)per) * W;
        const I e = rg / (I)a.m;
        const int row = (int)(rg - e * (I)a.m);
        if (row < lo_row(a, (long)e) || row >= hi) {
          src[k] = (long)e * a.bx + (long)row * a.ldx + c;
          dst[k] = (long)e * a.bo + (long)row * a.nbw + c;
        }
      }
    }
    V val[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (src[k] >= 0) val[k] = __ldg(reinterpret_cast<const V*>(a.x + src[k]));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (src[k] >= 0) {
        *reinterpret_cast<V*>(a.v + dst[k]) = val[k];
        *reinterpret_cast<V*>(a.lam + dst[k]) = V{};
      }
    }
  }
}

__global__ void __launch_bounds__(PACK_THREADS)
post_pack_kernel(Args a) {
  const long tid = (long)blockIdx.x * PACK_THREADS + threadIdx.x;
  const long threads = (long)gridDim.x * PACK_THREADS;
  const int lane = threadIdx.x & 31;
  for (long e = tid; e < a.batch; e += threads) a.miss[e] = 0;
  // the pack: a warp tests 32 units at once (lane l: unit r + l*warps) and
  // packs those of elements with a row in range, one after the other
  const int hi = hi_row(a);
  const long per = 2L * a.nbw * (a.ld >> 2), units = per * a.batch;
  const long warp = tid >> 5, warps = threads >> 5;
  for (long r = warp; r < units; r += 32 * warps) {
    const long u = r + lane * warps;
    const bool act = u < units && (a.pack_all || lo_row(a, u / per) < hi);
    unsigned todo = __ballot_sync(0xffffffffu, act);
    while (todo) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      pack_unit(a, r + l * warps, lane);
    }
  }
  if (a.pack_all) return;
  const bool vec = a.vec_x && a.vec_out && a.nbw % 4 == 0;
  const bool narrow =   // every item index, and the last stride past it
      (long)a.batch * a.m * a.nbw + 4 * threads <= 0xffffffffL;
  if (vec && narrow)
    copy_out_of_range<uint4, unsigned>(a, (unsigned)tid, (unsigned)threads);
  else if (vec)
    copy_out_of_range<uint4, long>(a, tid, threads);
  else if (narrow)
    copy_out_of_range<uint32_t, unsigned>(a, (unsigned)tid, (unsigned)threads);
  else
    copy_out_of_range<uint32_t, long>(a, tid, threads);
}

// A persistent grid over the in-range 128-row tiles: item s is tile
// lo_row(e)/BM + (s - cum[e-1]) of the element e with cum[e-1] <= s <
// cum[e] (batched), or tile lo_row/BM + s of the one element.
__global__ void __launch_bounds__(THREADS, 2) post_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int hi = hi_row(a);
  long total;
  if (a.cum) {
    total = a.cum[a.batch - 1];
  } else {
    const int lo = lo_row(a, 0);
    total = lo < hi ? (hi + BM - 1) / BM - lo / BM : 0;
  }
  const int nbw = a.nbw, nb = nbw * 32;
  for (long s = blockIdx.x; s < total; s += gridDim.x) {
    long e = 0, first = 0;
    if (a.cum) {   // the first element with cum[e] > s
      int l = 0, h = a.batch - 1;
      while (l < h) {
        const int mid = (l + h) >> 1;
        if (a.cum[mid] > s) h = mid; else l = mid + 1;
      }
      e = l;
      first = l ? a.cum[l - 1] : 0;
    }
    const int lo = lo_row(a, e);
    const int m0 = (lo / BM + (int)(s - first)) * BM;
    const uint32_t* x = a.x + e * a.bx;
    uint32_t* v = a.v + e * a.bo;
    uint32_t* lam = a.lam + e * a.bo;
    const uint32_t* mt = a.mt + e * a.tstride;
    const uint32_t* wt = a.wt + e * a.tstride;
    const uint32_t* colmask = a.colmask + e * a.tstride;
    // lam = X * M on the rows in range
    tile_products(x, a.ldx, a.m, a.vec_x, mt, a.ld, nb, m0, nbw, smem,
               [](int) {}, [&](int ct, const int (&acc)[2][8][4]) {
      for_each_parity_word(acc, m0, ct * BN, [&](int row, int word, uint32_t bits) {
        if (row >= lo && row < hi && word < nbw) lam[(long)row * nbw + word] = bits;
      });
    });
    __syncthreads();  // stage reuse; and lam is complete
    // v = X ^ lam * W; the words of X a thread's epilogue takes (see
    // for_each_parity_word) and the mask are loaded before the column
    // tile's products, to land while they run
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = m0 + (warp >> 1) * 32 + (lane >> 2) + 8 * ((lane & 3) >> 1);
    uint32_t xv[2], cm = 0u;
    bool hit = false;
    tile_products(lam, nbw, a.m, a.vec_out, wt, a.ld, nb, m0, nbw, smem,
               [&](int ct) {
      const int word = ct * 4 + (warp & 1) * 2 + (lane & 1);
      cm = word < nbw ? colmask[word] : 0u;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int row = r0 + 16 * t;
        xv[t] = row >= lo && row < hi && word < nbw
                    ? x[(long)row * a.ldx + word] : 0u;
      }
    }, [&](int ct, const int (&acc)[2][8][4]) {
      for_each_parity_word(acc, m0, ct * BN, [&](int row, int word, uint32_t bits) {
        if (row >= lo && row < hi && word < nbw) {
          const uint32_t val = xv[(row - m0) >> 4 & 1] ^ bits;
          v[(long)row * nbw + word] = val;
          if (val & cm) hit = true;
        }
      });
    });
    __syncthreads();  // stage reuse by the next item
    if (hit) a.miss[e] = 1;   // every writer writes the same byte
  }
}

// The SMs, and the MMA blocks one SM holds for a contraction of k k-steps
// (the kernel's shared memory allowed on the way), once each; false if they
// cannot be had.  Internal linkage, so that two builds of this file loaded
// in one process keep their own.
constexpr int MAX_KSTEPS = 7;    // tile_smem_bytes(7) is the most a block gets
static int g_sms, g_mma_per_sm[MAX_KSTEPS + 1];

inline bool card_limits(int ksteps = 0) {
  if (!g_sms) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        allow_smem(post_kernel, tile_smem_bytes(MAX_KSTEPS)) != cudaSuccess)
      return false;
    g_sms = sms;
  }
  if (ksteps < 1) return true;
  if (ksteps > MAX_KSTEPS) return false;
  int& per = g_mma_per_sm[ksteps];
  if (!per &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, post_kernel, THREADS, tile_smem_bytes(ksteps)) != cudaSuccess ||
       per < 1)) {
    per = 0;
    return false;
  }
  return true;
}

// The pack (and copy, unless pack_all) launch: a grid of at most 8 blocks
// an SM, fewer where the work is small.
inline cudaError_t launch_pack(const Args& a, cudaStream_t st) {
  if (!card_limits()) return cudaErrorInvalidConfiguration;
  const long units = 2L * a.nbw * (a.ld >> 2) * a.batch;
  const long work = std::max(std::max(units * 32, (long)a.batch * a.m),
                             (long)a.batch);
  const long blocks = std::min((work + PACK_THREADS - 1) / PACK_THREADS,
                               8L * g_sms);
  post_pack_kernel<<<(unsigned)blocks, PACK_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// The MMA launch over at most `items` in-range tiles.
inline cudaError_t launch_mma(const Args& a, long items, cudaStream_t st) {
  if (items <= 0) return cudaSuccess;
  const int ksteps = (a.nbw + KC - 1) / KC;
  if (!card_limits(ksteps)) return cudaErrorInvalidValue;
  const long blocks = std::min(items, (long)g_mma_per_sm[ksteps] * g_sms);
  post_kernel<<<(unsigned)blocks, THREADS, tile_smem_bytes(ksteps), st>>>(a);
  return cudaGetLastError();
}

inline bool is16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace post
}  // namespace gf2

// Words a packed row of M^T or W^T takes: a multiple of 4 (16 bytes).
static long post_row_words(int nb) { return (nb / 32 + 3) / 4 * 4; }

// Words of scratch for M^T, W^T and the packed column mask.
extern "C" long gf2_panel_post_scratch_words(int nb) {
  return 2L * nb * post_row_words(nb) + (nb / 32 + 3) / 4 * 4;
}

// The batched call, two launches on the stream: packing and copy, then the
// elimination.  B elements; x: element e at x + e*bx words, its rows ldx
// apart; m_small, wmat: [B, nb, nb] bytes of 0/1, colmask_bits [B, nb],
// contiguous and 16-byte aligned; below0: B ints on the card, or null and
// below0_value for the one element (batch 1); cum: scratch of B long longs
// on the card, where a first launch writes the inclusive prefix sum over
// elements of their 128-row tiles that hold a row of [max(below0_e, 0),
// min(mvalid, m)), or null (batch 1, below0 by value); scratch: B times
// gf2_panel_post_scratch_words(nb) words, 16-byte aligned; v, lam: [B, m,
// nbw] contiguous; miss: B bytes.  Returns cudaGetLastError().
extern "C" int gf2_panel_post_hopper_batched_launch(
    const void* x, long ldx, long bx, const void* m_small, const void* wmat,
    const void* colmask_bits, void* scratch, void* v, void* lam, void* miss,
    const void* below0, void* cum, int below0_value, int batch, int m,
    int nbw, int mvalid, void* stream) {
  using namespace gf2;
  using namespace gf2::post;
  const int nb = nbw * 32;
  const long ld = post_row_words(nb);
  const int hi = std::min(mvalid, m);
  const long tiles = hi > 0 ? (hi + BM - 1) / BM : 0;
  if (batch < 1 || m < 1 || nbw < 1 || (batch > 1 && !(below0 && cum)) ||
      !is16(m_small) || !is16(wmat) || !is16(scratch) ||
      tiles * batch > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* mt = static_cast<uint32_t*>(scratch);
  const long bo = (long)m * nbw;
  Args a{static_cast<const uint32_t*>(x), ldx, bx,
         is16(x) && ldx % 4 == 0 && bx % 4 == 0,
         static_cast<const int8_t*>(m_small), static_cast<const int8_t*>(wmat),
         static_cast<const int8_t*>(colmask_bits), mt, mt + (long)nb * ld, ld,
         mt + 2L * nb * ld, gf2_panel_post_scratch_words(nb),
         static_cast<uint32_t*>(v), static_cast<uint32_t*>(lam), bo,
         is16(v) && is16(lam) && nbw % 4 == 0 && bo % 4 == 0,
         static_cast<unsigned char*>(miss), m, nbw, mvalid, batch,
         below0_value, static_cast<const int*>(below0),
         static_cast<long long*>(cum), false};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cum && hi > 0)
    prefix_sum_kernel<<<1, SCAN_THREADS, 0, st>>>(
        InRangeTiles{a.below0p, hi}, batch, a.cum);
  cudaError_t err = launch_pack(a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the MMA items: exact for one element with below0 on the host, else at
  // most every tile below min(mvalid, m) of every element
  long items = tiles * batch;
  if (!cum) {
    const int lo = std::max(below0 ? 0 : below0_value, 0);
    items = lo < hi ? tiles - lo / BM : 0;
  }
  return static_cast<int>(launch_mma(a, items, st));
}

// The single call: the batch of one with below0 by value.  x: [m, nbw]
// words, row stride ldx; m_small, wmat: [nb, nb] bytes, colmask_bits: [nb]
// bytes, contiguous, 16-byte aligned; scratch: gf2_panel_post_scratch_words
// (nb) words, 16-byte aligned; v, lam: [m, nbw] contiguous outputs; miss:
// one byte on the device (0 or 1 afterwards).  Returns cudaGetLastError().
extern "C" int gf2_panel_post_hopper_launch(
    const void* x, long ldx, const void* m_small, const void* wmat,
    const void* colmask_bits, void* scratch, void* v, void* lam, void* miss,
    int m, int nbw, int below0, int mvalid, void* stream) {
  return gf2_panel_post_hopper_batched_launch(
      x, ldx, 0, m_small, wmat, colmask_bits, scratch, v, lam, miss, nullptr,
      nullptr, below0, 1, m, nbw, mvalid, stream);
}

// The packing launch alone.  mt, wt: [nb, ld] words out, ld >= nb/32 and a
// multiple of 4, 16-byte aligned; colmask: [nb/32] words out; miss: one
// byte, zeroed; m_small, wmat 16-byte aligned.
extern "C" int gf2_panel_post_pack_launch(
    const void* m_small, const void* wmat, const void* colmask_bits, void* mt,
    void* wt, long ld, void* colmask, void* miss, int nb, void* stream) {
  using namespace gf2::post;
  if (nb < 32 || nb % 32 || ld < nb / 32 || ld % 4 || !is16(m_small) ||
      !is16(wmat) || !is16(mt) || !is16(wt))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{nullptr, 0, 0, false,
         static_cast<const int8_t*>(m_small), static_cast<const int8_t*>(wmat),
         static_cast<const int8_t*>(colmask_bits), static_cast<uint32_t*>(mt),
         static_cast<uint32_t*>(wt), ld, static_cast<uint32_t*>(colmask), 0,
         nullptr, nullptr, 0, false, static_cast<unsigned char*>(miss), 0,
         nb / 32, 0, 1, 0, nullptr, nullptr, true};
  return static_cast<int>(launch_pack(a, static_cast<cudaStream_t>(stream)));
}

// ---- the batched sweep's commit of a panel ---------------------------------
//
// Replaces no TPU kernel: the JAX package commits a panel with
// dynamic_update_slices in the graph of its sweep (m4ri_tpu/models/ple.py,
// _block_factor_impl); the port's batched sweep ran it as about 18 PyTorch
// operations a panel (gathers and scatters through int64 [B, W] indices, a
// copy of the panel words of every padded row), which
// ops/hopper_commit.py keeps as panel_commit_batched_plain.  It lives here
// because it reads the elimination's outputs v and lam.  For each element e
// that did not miss its window (miss[e] == 0), with r0 = r_in[e]:
//   * window row i (row r0 + i of A) takes, on every word outside the panel,
//     the words of row r0 + rpw[e, i] (the window's row permutation); a row
//     with rpw[e, i] == i is neither read nor written there;
//   * A's panel words of the rows in [r0, m): ALw's panel words at the
//     window's rows, v below it.  Above r0 the elimination passed X through
//     (v = X), and rows past m are zero padding that no step changes: no
//     write there;
//   * lam's window rows below m take ALw's L words;
//   * P[e, r0 + s] = r0 + p_f[e, s] and Q[e, r0 + s] = qoff + q_f[e, s] for
//     s < r_f[e] - r0, and no other slot.
// An element that missed is left alone: the sweep redoes it at full height.
//
// What bounds it on an H100: bytes, each word read once and written once.
// 976,000 x 32^2 (nist_sp800_22.rank): ALw's 32 rows in (256 B an element),
// A's and lam's 32 rows out (256 B), p_f / q_f in and P / Q out at 32 slots
// (512 B), about 1.0 GB or 0.30 ms at 3.35 TB/s.  1024 x 768 x 3488, nb =
// 512 (mceliece348864's first panel): the moved rows' 96 words outside the
// panel in and out (at most 226 MB each way), ALw's panel and L words in and
// A's and lam's out (about 150 MB), v's 192 rows below the window (25 MB
// each way), about 0.19 ms; a panel where every rank has reached m (panels
// 3-7) writes nothing.  Two plans, chosen on the host from the shape
// (ops/hopper_commit.py::commit_plan):
//   * warp: no word outside the panel (one panel, w_pad == nbw) and a small
//     element (m nbw <= 1024 words): a warp an element, eight a block, the
//     lanes over the element's (row, word) pairs, so every access of the
//     warp is one contiguous run;
//   * block: a block an (element, chunk of cw word columns) over the window,
//     the chunk's moved rows staged in shared memory (W x cw words: 18 KB at
//     W = 576, cw = 8) so the permutation needs no second buffer in device
//     memory, then a block an (element, tile of rows) for v's rows below the
//     window; 16-byte accesses where rows, panel and chunks line up.
// The batch is folded into grid x (976,000 elements a launch).
namespace gf2 {
namespace commit {

constexpr int WARPS = 8;        // elements a block, warp plan
constexpr int THREADS = 256;    // block plan

struct Args {
  uint32_t* a; long a_el; int w_pad;             // A [B, m_pad, w_pad]
  int* p; long p_el; int* q; long q_el;          // P [B, m_pad], Q [B, n_pad]
  const uint32_t* v; uint32_t* lam; long v_el;   // v, lam [B, m_pad, nbw]
  const uint32_t* al;                            // ALw [B, W, 2 nbw]
  const int* rpw; const int* pf; const int* qf;  // [B, W], [B, nb], [B, nb]
  const int* rf; const int* rin;                 // [B]
  const unsigned char* miss;                     // [B] bytes
  long batch; int W, nb, nbw, c0w, qoff, m;
  int cw, chunks, below_rows, below_tiles;       // the block plan's items
};

// P and Q at the element's pivot slots s < k, threads t, t + step, ...
__device__ __forceinline__ void slots(const Args& a, long e, int r0, int k,
                                      int t, int step) {
  int* p = a.p + e * a.p_el + r0;
  int* q = a.q + e * a.q_el + r0;
  const int* pf = a.pf + e * a.nb;
  const int* qf = a.qf + e * a.nb;
  for (int s = t; s < k; s += step) {
    p[s] = r0 + __ldg(pf + s);
    q[s] = a.qoff + __ldg(qf + s);
  }
}

__global__ void __launch_bounds__(32 * WARPS) commit_warp_kernel(Args a) {
  const long e = (long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= a.batch || a.miss[e]) return;
  const int r0 = __ldg(a.rin + e), nbw = a.nbw;
  slots(a, e, r0, __ldg(a.rf + e) - r0, lane, 32);
  // rows [r0, m), row i of the window first
  uint32_t* A = a.a + e * a.a_el + (long)r0 * a.w_pad + a.c0w;
  uint32_t* lam = a.lam + e * a.v_el + (long)r0 * nbw;
  const uint32_t* v = a.v + e * a.v_el + (long)r0 * nbw;
  const uint32_t* al = a.al + e * (long)a.W * 2 * nbw;
  const long items = (long)max(a.m - r0, 0) * nbw;
  for (long it = lane; it < items; it += 32) {
    const long i = it / nbw;
    const int w = (int)(it - i * nbw);
    if (i < a.W) {
      A[i * a.w_pad + w] = __ldg(al + i * 2 * nbw + w);
      lam[i * nbw + w] = __ldg(al + i * 2 * nbw + nbw + w);
    } else {
      A[i * a.w_pad + w] = __ldg(v + i * nbw + w);
    }
  }
}

template <int V> struct Vec { using T = uint32_t; };
template <> struct Vec<4> { using T = uint4; };

template <int V>
__global__ void __launch_bounds__(THREADS) commit_block_kernel(Args a) {
  using T = typename Vec<V>::T;
  extern __shared__ __align__(16) uint32_t stage[];
  const long per = a.chunks + a.below_tiles;
  const long e = blockIdx.x / per;
  const int item = (int)(blockIdx.x - e * per);
  if (a.miss[e]) return;
  const int r0 = __ldg(a.rin + e), nbw = a.nbw, W = a.W;
  if (item >= a.chunks) {
    // the panel words of a tile of the rows in [r0 + W, m), from v
    const long lo = (long)r0 + W + (long)(item - a.chunks) * a.below_rows;
    const long hi = min((long)a.m, lo + a.below_rows);
    const int nv = nbw / V;
    const long n = (hi - lo) * nv;
    uint32_t* A = a.a + e * a.a_el + a.c0w;
    const uint32_t* v = a.v + e * a.v_el;
    for (long it = threadIdx.x; it < n; it += THREADS) {
      const long row = lo + it / nv;
      const int w = (int)(it % nv) * V;
      *reinterpret_cast<T*>(A + row * a.w_pad + w) =
          __ldg(reinterpret_cast<const T*>(v + row * nbw + w));
    }
    return;
  }
  if (item == 0) slots(a, e, r0, __ldg(a.rf + e) - r0, threadIdx.x, THREADS);
  // words [w0, w1) of the window's rows; the panel is [p0, p1)
  const int w0 = item * a.cw, w1 = min(w0 + a.cw, a.w_pad);
  const int p0 = a.c0w, p1 = a.c0w + nbw;
  const int nv = (w1 - w0) / V, n = W * nv;
  uint32_t* A = a.a + e * a.a_el + (long)r0 * a.w_pad;
  const int* rp = a.rpw + e * W;
  if (w0 < p0 || w1 > p1) {
    // the moved rows' words outside the panel, staged: every source is read
    // before any row of the chunk is written
    for (int it = threadIdx.x; it < n; it += THREADS) {
      const int i = it / nv, w = w0 + (it - i * nv) * V;
      const int src = __ldg(rp + i);
      if (src != i && (w < p0 || w >= p1))
        reinterpret_cast<T*>(stage)[it] =
            *reinterpret_cast<const T*>(A + (long)src * a.w_pad + w);
    }
    __syncthreads();
  }
  const uint32_t* al = a.al + e * (long)W * 2 * nbw;
  uint32_t* lam = a.lam + e * a.v_el + (long)r0 * nbw;
  const int below_m = a.m - r0;              // window rows below m
  for (int it = threadIdx.x; it < n; it += THREADS) {
    const int i = it / nv, w = w0 + (it - i * nv) * V;
    if (w >= p0 && w < p1) {
      if (i < below_m) {
        const long s = (long)i * 2 * nbw + (w - p0);
        *reinterpret_cast<T*>(A + (long)i * a.w_pad + w) =
            __ldg(reinterpret_cast<const T*>(al + s));
        *reinterpret_cast<T*>(lam + (long)i * nbw + (w - p0)) =
            __ldg(reinterpret_cast<const T*>(al + s + nbw));
      }
    } else if (__ldg(rp + i) != i) {
      *reinterpret_cast<T*>(A + (long)i * a.w_pad + w) =
          reinterpret_cast<const T*>(stage)[it];
    }
  }
}

constexpr int SMEM_MAX = 227 * 1024;

template <int V>
inline cudaError_t launch_block(const Args& a, long blocks, cudaStream_t st) {
  const int smem = 4 * a.W * a.cw;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(commit_block_kernel<V>, smem);
    if (err != cudaSuccess) return err;
  }
  commit_block_kernel<V><<<(unsigned)blocks, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace commit
}  // namespace gf2

// The batched commit of panel t, in place on A, P, Q and lam (see above).
// a: [B, m_pad, w_pad] words; p: [B, m_pad], q: [B, n_pad] ints; v, lam:
// [B, m_pad, nbw] words; al: [B, W, 2 nbw] words; rpw: [B, W], pf, qf: [B,
// nb], rf, rin: [B] ints; miss: [B] bytes; every array contiguous.  plan 0:
// the warp plan (w_pad == nbw); 1: the block plan with chunks of cw words
// and tiles of below_rows rows.  Returns cudaGetLastError().
extern "C" int gf2_panel_commit_batched_launch(
    void* a, void* p, void* q, const void* v, void* lam, const void* al,
    const void* rpw, const void* pf, const void* qf, const void* rf,
    const void* rin, const void* miss, long batch, int m_pad, int w_pad,
    int n_pad, int W, int nbw, int t, int m, int plan, int cw,
    int below_rows, void* stream) {
  using namespace gf2;
  using namespace gf2::commit;
  using gf2::post::is16;
  const int nb = nbw * 32;
  if (batch < 1 || nbw < 1 || W < nb || m < 0 || m > m_pad ||
      (long)(t + 1) * nbw > w_pad || (long)(t + 1) * nb > n_pad ||
      (plan == 0 && w_pad != nbw) ||
      (plan == 1 && (cw < 1 || below_rows < 1)) || plan < 0 || plan > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{static_cast<uint32_t*>(a), (long)m_pad * w_pad, w_pad,
            static_cast<int*>(p), m_pad, static_cast<int*>(q), n_pad,
            static_cast<const uint32_t*>(v), static_cast<uint32_t*>(lam),
            (long)m_pad * nbw, static_cast<const uint32_t*>(al),
            static_cast<const int*>(rpw), static_cast<const int*>(pf),
            static_cast<const int*>(qf), static_cast<const int*>(rf),
            static_cast<const int*>(rin),
            static_cast<const unsigned char*>(miss), batch, W, nb, nbw,
            t * nbw, t * nb, m, cw, 0, below_rows, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plan == 0) {
    const long blocks = (batch + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
    commit_warp_kernel<<<(unsigned)blocks, 32 * WARPS, 0, st>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  args.chunks = (w_pad + cw - 1) / cw;
  args.below_tiles = (std::max(m - W, 0) + below_rows - 1) / below_rows;
  const long blocks = batch * (args.chunks + args.below_tiles);
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte accesses: rows, the panel, the chunks and every base in step
  const bool vec = nbw % 4 == 0 && w_pad % 4 == 0 && cw % 4 == 0 &&
                   is16(a) && is16(v) && is16(lam) && is16(al);
  return static_cast<int>(vec ? launch_block<4>(args, blocks, st)
                              : launch_block<1>(args, blocks, st));
}
