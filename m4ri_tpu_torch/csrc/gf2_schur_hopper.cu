// gf2_schur_hopper: the PLE sweep's trailing update C ^= Lp*Up, in place,
// skipping the tiles that the factorization has already finished.
//
// Replaces the TPU kernels gf2_schur_update (m4ri_tpu/ops/pallas_schur.py,
// _schur_padded) and gf2_schur_update_dyn (_schur_dyn_padded).  Contract of
// both: rows of Lp above r0 are zero and words of Up left of c0w are zero, so
// a tile of C that lies wholly above r0 or wholly left of c0w has a zero
// delta and is left untouched.  (r0, c0w) are read from device memory.
//
// What bounds it on an H100: bytes.  The contraction is one panel deep
// (k = 512 or 1024), so a 128 x 128-bit tile of C costs one or two staged
// steps of the 1-bit MMA and then a read and a write of C; over a whole
// sweep the untouched tiles are three quarters of C.  So the design is the
// tile product of gf2_mul_hopper with an XOR-into-C epilogue, and neither
// kernel ever loads a tile it can skip:
//   * schur_kernel: a grid over the tiles right of `tile0` (column tiles the
//     caller knows are finished are not even launched); a block whose tile is
//     inactive returns before its first load.
//   * schur_dyn_kernel: a persistent grid of a few blocks an SM; each block
//     derives the active rectangle from (r0, c0w) and walks its tiles
//     s = blockIdx.x, += gridDim.x.  Nothing active: zero trips.
// One block owns a tile and each word of it belongs to one thread, so the
// XOR is a plain read-modify-write, no atomics.
#include "gf2_tile.cuh"

namespace gf2 {

constexpr int BNW = BN / 32;  // words of C per tile row

struct SchurArgs {
  const uint32_t* lp; long ldl; int m; int kw; bool vec_l;
  const uint32_t* upt; long ldbt; int nw;
  uint32_t* c; long ldc;
};

__device__ __forceinline__ void schur_tile(const SchurArgs& s, int m0, int n0,
                                           uint32_t* smem) {
  int acc[2][8][4] = {};
  tile_mainloop(acc, s.lp, s.ldl, s.m, s.vec_l, s.upt, s.ldbt, s.nw * 32, m0,
                n0, 0, s.kw, smem);
  for_each_parity_word(acc, m0, n0, [&](int row, int word, uint32_t bits) {
    if (row < s.m && word < s.nw && bits) s.c[(long)row * s.ldc + word] ^= bits;
  });
}

__global__ void __launch_bounds__(THREADS, 2)
schur_kernel(const int* __restrict__ bounds, SchurArgs s, int tile0) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int m0 = blockIdx.y * BM;
  const int n0 = (blockIdx.x + tile0) * BN;
  const int r0 = bounds[0], c0w = bounds[1];
  if (m0 + BM <= r0 || n0 / 32 + BNW <= c0w) return;
  schur_tile(s, m0, n0, smem);
}

__global__ void __launch_bounds__(THREADS, 2)
schur_dyn_kernel(const int* __restrict__ bounds, SchurArgs s, int tiles_i,
                 int tiles_j) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int i0 = max(bounds[0], 0) / BM;    // tiles wholly above r0
  const int j0 = max(bounds[1], 0) / BNW;   // tiles wholly left of c0w
  const int n_i = tiles_i - i0, n_j = tiles_j - j0;
  const long total = (n_i > 0 && n_j > 0) ? (long)n_i * n_j : 0;
  for (long t = blockIdx.x; t < total; t += gridDim.x) {
    const int jr = (int)(t / n_i), ir = (int)(t - (long)jr * n_i);
    schur_tile(s, (i0 + ir) * BM, (j0 + jr) * BN, smem);
    __syncthreads();  // the next tile's first copy reuses this tile's stage
  }
}

inline SchurArgs schur_args(void* c, long ldc, const void* lp, long ldl,
                            void* upt, long ldbt, int m, int kw, int nw) {
  return SchurArgs{static_cast<const uint32_t*>(lp), ldl, m, kw,
                   aligned16(lp, ldl), static_cast<const uint32_t*>(upt), ldbt,
                   nw, static_cast<uint32_t*>(c), ldc};
}

}  // namespace gf2

// c: [m, nw] words, updated in place; lp: [m, kw]; up: [k, nw], k <= 32*kw;
// upt: scratch [32*nw, ldbt] for Up^T, ldbt >= kw and a multiple of 4, 16-byte
// aligned; bounds: two ints on the device, (r0, c0w); strides in words.
// col_tile_skip: leading 128-bit column tiles that are not launched,
// 0 <= col_tile_skip < ceil(nw/4).  Returns cudaGetLastError().
extern "C" int gf2_schur_update_hopper_launch(
    void* c, long ldc, const void* lp, long ldl, const void* up, long ldu,
    void* upt, long ldbt, const void* bounds, int m, int kw, int k, int nw,
    int col_tile_skip, void* stream) {
  using namespace gf2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_j = (nw + BNW - 1) / BNW;
  if (col_tile_skip < 0 || col_tile_skip >= tiles_j)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_transpose_b(static_cast<const uint32_t*>(up), ldu, k,
                                       nw, static_cast<uint32_t*>(upt), ldbt,
                                       kw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(schur_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles_j - col_tile_skip, (m + BM - 1) / BM);
  schur_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int*>(bounds),
      schur_args(c, ldc, lp, ldl, upt, ldbt, m, kw, nw), col_tile_skip);
  return static_cast<int>(cudaGetLastError());
}

// As above, for m % 128 == 0 and nw % 4 == 0 (whole tiles), without
// col_tile_skip: the kernel finds the active tiles itself.
extern "C" int gf2_schur_update_dyn_hopper_launch(
    void* c, long ldc, const void* lp, long ldl, const void* up, long ldu,
    void* upt, long ldbt, const void* bounds, int m, int kw, int k, int nw,
    void* stream) {
  using namespace gf2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m % BM || nw % BNW) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_transpose_b(static_cast<const uint32_t*>(up), ldu, k,
                                       nw, static_cast<uint32_t*>(upt), ldbt,
                                       kw, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(schur_dyn_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_i = m / BM, tiles_j = nw / BNW;
  const long tiles = (long)tiles_i * tiles_j;
  const int blocks = (int)(tiles < 2L * sms ? tiles : 2L * sms);  // 2 fit an SM
  schur_dyn_kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int*>(bounds),
      schur_args(c, ldc, lp, ldl, upt, ldbt, m, kw, nw), tiles_i, tiles_j);
  return static_cast<int>(cudaGetLastError());
}
