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
// What bounds it on an H100: bytes.  X, v and lam are m x nb/32 words each
// (1.1 MB at m = 17,152, nb = 512) against 2 * 2*m*nb*nb bit operations that
// the 1-bit MMA does in about a microsecond.  So the design reads X once from
// device memory, writes v and lam once, and does both products with the tile
// product of gf2_mul_hopper on the packed words: a block owns 128 rows and
// all nb columns; it forms its rows of lam (the contraction runs along the
// packed axis of X, and M^T, W^T arrive packed from the wrapper), stores
// them, since lam is an output anyway, and reads those same rows back as the
// left operand of the second product while they are still in cache.  Blocks
// run in no order, so the miss flag is zeroed on the stream before the launch
// and any block that finds a hit sets it.
//
// M, W and the column mask arrive as one byte a bit.  post_pack_kernel, one
// launch ahead on the same stream, writes M^T and W^T packed along the
// contraction and the packed column mask, and zeroes the flag: a block loads
// a 32 x 32 tile of bytes with rows coalesced, and each warp then reads one
// column of the tile and makes its word with one ballot.
#include "gf2_tile.cuh"

namespace gf2 {

// grid (B * nb/32, ld, 2), block (32, 32).  Element e = x / (nb/32), block
// x' = x % (nb/32) of it.  Plane z packs src = z ? W : M:
// dst[j, w] bit b = src[32*w + b, j], rows of dst ld >= nb/32 words apart,
// the words from nb/32 on zero.  Blocks (x', 0, 0) also pack word x' of the
// column mask, and block (0, 0, 0) zeroes the element's flag.  Element e's
// operands lie e*nb*nb bytes (M, W), e*nb bytes (mask bits), e*tstride words
// (M^T, W^T), e*cstride words (packed mask) and e bytes (flag) on.
__global__ void __launch_bounds__(1024)
post_pack_kernel(const int8_t* __restrict__ m_small,
                 const int8_t* __restrict__ wmat,
                 const int8_t* __restrict__ colmask_bits,
                 uint32_t* __restrict__ mt, uint32_t* __restrict__ wt, long ld,
                 uint32_t* __restrict__ colmask, unsigned char* miss, int nb,
                 long tstride, long cstride) {
  __shared__ int8_t tile[32][33];
  const int per = nb / 32;
  const long e = blockIdx.x / per;
  const int bx = (int)(blockIdx.x - e * per);
  m_small += e * nb * (long)nb;
  wmat += e * nb * (long)nb;
  colmask_bits += e * nb;
  mt += e * tstride;
  wt += e * tstride;
  colmask += e * cstride;
  miss += e;
  const int lane = threadIdx.x, wr = threadIdx.y;
  const int j0 = bx * 32, w = blockIdx.y;
  const bool real = w < nb / 32;       // else a padding word of the row
  const int8_t* src = blockIdx.z ? wmat : m_small;
  uint32_t* dst = blockIdx.z ? wt : mt;
  if (real) tile[wr][lane] = src[(long)(32 * w + wr) * nb + j0 + lane];
  __syncthreads();
  const unsigned word = __ballot_sync(0xffffffffu, real && (tile[lane][wr] & 1));
  if (lane == 0) dst[(long)(j0 + wr) * ld + w] = word;
  if (blockIdx.z == 0 && blockIdx.y == 0 && wr == 0) {
    const unsigned cm = __ballot_sync(0xffffffffu, colmask_bits[j0 + lane] & 1);
    if (lane == 0) {
      colmask[bx] = cm;
      if (bx == 0) *miss = 0;
    }
  }
}

// grid (B * ceil(m/BM)): element e = x / ceil(m/BM) takes the row tile
// x % ceil(m/BM) of its panel; below0p, if given, holds one row range start
// an element.  Strides of element e: bx words (x), bo words (v and lam),
// tstride (M^T, W^T), cstride (packed mask), 1 byte (flag).
__global__ void __launch_bounds__(THREADS, 2)
post_kernel(const uint32_t* __restrict__ x, long ldx, bool vec_x, int m,
            int nbw, const uint32_t* __restrict__ mt,
            const uint32_t* __restrict__ wt, long ldt,
            const uint32_t* __restrict__ colmask, uint32_t* __restrict__ v,
            long ldv, uint32_t* lam, long ldlam, bool vec_lam, unsigned char* miss,
            int below0, int mvalid, const int* __restrict__ below0p, long bx,
            long bo, long tstride, long cstride) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int per = (m + BM - 1) / BM;
  const long e = blockIdx.x / per;
  const int m0 = (int)(blockIdx.x - e * per) * BM;
  x += e * bx;
  v += e * bo;
  lam += e * bo;
  mt += e * tstride;
  wt += e * tstride;
  colmask += e * cstride;
  miss += e;
  if (below0p) below0 = below0p[e];
  if (m0 + BM <= below0 || m0 >= mvalid) {   // no row of the tile is in range
    for (int idx = threadIdx.x; idx < BM * nbw; idx += THREADS) {
      const int row = m0 + idx / nbw, w = idx % nbw;
      if (row < m) {
        v[(long)row * ldv + w] = x[(long)row * ldx + w];
        lam[(long)row * ldlam + w] = 0u;
      }
    }
    return;
  }
  const int nb = nbw * 32;
  const int tiles = (nb + BN - 1) / BN;
  for (int ct = 0; ct < tiles; ++ct) {
    int acc[2][8][4] = {};
    tile_mainloop(acc, x, ldx, m, vec_x, mt, ldt, nb, m0, ct * BN, 0, nbw, smem);
    for_each_parity_word(acc, m0, ct * BN, [&](int row, int word, uint32_t bits) {
      if (row < m && word < nbw)
        lam[(long)row * ldlam + word] =
            (row >= below0 && row < mvalid) ? bits : 0u;
    });
    __syncthreads();  // stage reuse; and after the last tile: lam is complete
  }
  bool hit = false;
  for (int ct = 0; ct < tiles; ++ct) {
    int acc[2][8][4] = {};
    tile_mainloop(acc, lam, ldlam, m, vec_lam, wt, ldt, nb, m0, ct * BN, 0, nbw,
                  smem);
    for_each_parity_word(acc, m0, ct * BN, [&](int row, int word, uint32_t bits) {
      if (row < m && word < nbw) {
        const uint32_t val = x[(long)row * ldx + word] ^ bits;
        v[(long)row * ldv + word] = val;
        if (row >= below0 && row < mvalid && (val & colmask[word])) hit = true;
      }
    });
    __syncthreads();
  }
  if (hit) *miss = 1;   // every writer writes the same byte
}

inline cudaError_t launch_pack(const void* m_small, const void* wmat,
                               const void* colmask_bits, uint32_t* mt,
                               uint32_t* wt, long ld, uint32_t* colmask,
                               void* miss, int nb, cudaStream_t stream,
                               int batch = 1, long tstride = 0,
                               long cstride = 0) {
  if (nb < 32 || nb % 32 || ld < nb / 32 || ld > 65535 || batch < 1 ||
      (long)batch * (nb / 32) > 0x7fffffffL)
    return cudaErrorInvalidValue;
  post_pack_kernel<<<dim3((unsigned)(batch * (nb / 32)), (unsigned)ld, 2),
                     dim3(32, 32), 0, stream>>>(
      static_cast<const int8_t*>(m_small), static_cast<const int8_t*>(wmat),
      static_cast<const int8_t*>(colmask_bits), mt, wt, ld, colmask,
      static_cast<unsigned char*>(miss), nb, tstride, cstride);
  return cudaGetLastError();
}

}  // namespace gf2

// Words a packed row of M^T or W^T takes: a multiple of 4 (16 bytes).
static long post_row_words(int nb) { return (nb / 32 + 3) / 4 * 4; }

// Words of scratch for M^T, W^T and the packed column mask.
extern "C" long gf2_panel_post_scratch_words(int nb) {
  return 2L * nb * post_row_words(nb) + (nb / 32 + 3) / 4 * 4;
}

// The whole call, two launches on the stream: packing, then elimination.
// x: [m, nbw] words, row stride ldx; m_small, wmat: [nb, nb] bytes of 0/1,
// contiguous, nb = 32 * nbw; colmask_bits: [nb] bytes; scratch:
// gf2_panel_post_scratch_words(nb) words, 16-byte aligned; v, lam: [m, nbw]
// contiguous outputs; miss: one byte on the device (0 or 1 afterwards).
// Returns cudaGetLastError().
extern "C" int gf2_panel_post_hopper_launch(
    const void* x, long ldx, const void* m_small, const void* wmat,
    const void* colmask_bits, void* scratch, void* v, void* lam, void* miss,
    int m, int nbw, int below0, int mvalid, void* stream) {
  using namespace gf2;
  const int nb = nbw * 32;
  const long ld = post_row_words(nb);
  uint32_t* mt = static_cast<uint32_t*>(scratch);
  uint32_t* wt = mt + (long)nb * ld;
  uint32_t* colmask = wt + (long)nb * ld;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_pack(m_small, wmat, colmask_bits, mt, wt, ld,
                                colmask, miss, nb, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(post_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  post_kernel<<<(m + BM - 1) / BM, THREADS, SMEM_BYTES, st>>>(
      static_cast<const uint32_t*>(x), ldx, aligned16(x, ldx), m, nbw, mt, wt,
      ld, colmask, static_cast<uint32_t*>(v), (long)nbw,
      static_cast<uint32_t*>(lam), (long)nbw, aligned16(lam, (long)nbw),
      static_cast<unsigned char*>(miss), below0, mvalid, nullptr, 0, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// The batched call, two launches: B elements; x: element e at x + e*bx
// words, its rows ldx apart; m_small, wmat: [B, nb, nb] bytes, colmask_bits
// [B, nb], contiguous; below0: B ints on the card; scratch: B times
// gf2_panel_post_scratch_words(nb) words, 16-byte aligned; v, lam: [B, m,
// nbw] contiguous; miss: B bytes.  Returns cudaGetLastError().
extern "C" int gf2_panel_post_hopper_batched_launch(
    const void* x, long ldx, long bx, const void* m_small, const void* wmat,
    const void* colmask_bits, void* scratch, void* v, void* lam, void* miss,
    const void* below0, int batch, int m, int nbw, int mvalid, void* stream) {
  using namespace gf2;
  const int nb = nbw * 32;
  const long ld = post_row_words(nb);
  const long tstride = 2L * nb * ld + (nbw + 3) / 4 * 4;   // one element's
  const long tiles = (m + BM - 1) / BM;
  if (batch < 1 || m < 1 || tiles * batch > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* mt = static_cast<uint32_t*>(scratch);
  uint32_t* wt = mt + (long)nb * ld;
  uint32_t* colmask = wt + (long)nb * ld;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_pack(m_small, wmat, colmask_bits, mt, wt, ld,
                                colmask, miss, nb, st, batch, tstride,
                                tstride);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(post_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long bo = (long)m * nbw;
  post_kernel<<<(unsigned)(tiles * batch), THREADS, SMEM_BYTES, st>>>(
      static_cast<const uint32_t*>(x), ldx, aligned16(x, ldx) && bx % 4 == 0,
      m, nbw, mt, wt, ld, colmask, static_cast<uint32_t*>(v), (long)nbw,
      static_cast<uint32_t*>(lam), (long)nbw,
      aligned16(lam, (long)nbw) && bo % 4 == 0,
      static_cast<unsigned char*>(miss), 0, mvalid,
      static_cast<const int*>(below0), bx, bo, tstride, tstride);
  return static_cast<int>(cudaGetLastError());
}

// The packing launch alone.  mt, wt: [nb, ld] words out, ld >= nb/32;
// colmask: [nb/32] words out; miss: one byte, zeroed.
extern "C" int gf2_panel_post_pack_launch(
    const void* m_small, const void* wmat, const void* colmask_bits, void* mt,
    void* wt, long ld, void* colmask, void* miss, int nb, void* stream) {
  return static_cast<int>(gf2::launch_pack(
      m_small, wmat, colmask_bits, static_cast<uint32_t*>(mt),
      static_cast<uint32_t*>(wt), ld, static_cast<uint32_t*>(colmask), miss,
      nb, static_cast<cudaStream_t>(stream)));
}
