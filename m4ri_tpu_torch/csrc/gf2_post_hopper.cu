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
// run in no order, so the miss flag is zeroed by the wrapper on the stream
// and blocks OR into it with an atomic.
#include "gf2_tile.cuh"

namespace gf2 {

__global__ void __launch_bounds__(THREADS, 2)
post_kernel(const uint32_t* __restrict__ x, long ldx, bool vec_x, int m,
            int nbw, const uint32_t* __restrict__ mt,
            const uint32_t* __restrict__ wt, long ldt,
            const uint32_t* __restrict__ colmask, uint32_t* __restrict__ v,
            long ldv, uint32_t* lam, long ldlam, bool vec_lam, int* miss,
            int below0, int mvalid) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int m0 = blockIdx.x * BM;
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
  if (hit) atomicOr(miss, 1);
}

}  // namespace gf2

// x: [m, nbw] words, row stride ldx; mt, wt: M^T and W^T packed along the
// contraction, [32*nbw, ldt] words each, ldt >= nbw and a multiple of 4,
// 16-byte aligned; colmask: [nbw] words; v, lam: [m, nbw] outputs; miss: one
// int on the device, zero before the launch.  Returns cudaGetLastError().
extern "C" int gf2_panel_post_hopper_launch(
    const void* x, long ldx, const void* mt, const void* wt, long ldt,
    const void* colmask, void* v, long ldv, void* lam, long ldlam, void* miss,
    int m, int nbw, int below0, int mvalid, void* stream) {
  using namespace gf2;
  cudaError_t err = allow_smem(post_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  post_kernel<<<(m + BM - 1) / BM, THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), ldx, aligned16(x, ldx), m, nbw,
      static_cast<const uint32_t*>(mt), static_cast<const uint32_t*>(wt), ldt,
      static_cast<const uint32_t*>(colmask), static_cast<uint32_t*>(v), ldv,
      static_cast<uint32_t*>(lam), ldlam, aligned16(lam, ldlam),
      static_cast<int*>(miss), below0, mvalid);
  return static_cast<int>(cudaGetLastError());
}
