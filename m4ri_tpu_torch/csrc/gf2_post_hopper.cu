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
