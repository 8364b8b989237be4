// gf2_gemm_hopper: packed GF(2) product C = A*B, or C ^= A*B, on the H100.
// The one GEMM kernel behind both gf2_mul_hopper and gf2_mul_hopper_v2.
//
// Replaces the TPU kernels gf2_mul_pallas (m4ri_tpu/ops/pallas_mul.py,
// _mul_padded) and gf2_mul_pallas_v2 (m4ri_tpu/ops/pallas_mul2.py,
// _mul2_padded).  Contract: A [m, kw] words, B [k, nw] words with
// k <= 32*kw and padding bits zero, C [m, nw] words, all with a row stride
// and the words of a row adjacent.
//
// What bounds it on an H100: operations at every shape the paths give it
// (2*m*k*n bit operations against (m*kw + k*nw + m*nw) * 4 bytes), except
// the PLE's U rows (k = 512), where it is bytes.  The design keeps the
// tensor cores fed and the host out of the way:
//   * The inner product is wgmma m64n256k256 .b1 .and.popc, both operands
//     read by the tensor cores from shared memory: 15,300-15,500 Tbit-op/s
//     measured for the instruction alone against 10,300 for mma.sync b1 from
//     registers (benches/probe_mma.py), and no fragment is loaded by the
//     threads.
//   * A tile of C is 128 rows x 256 columns (8 words), one warpgroup on each
//     64-row half; the s32 counts stay in 128 registers a thread (setmaxnreg
//     moves registers from the producer to the consumers).
//   * Operands through a ring: a producer thread keeps RING stages of
//     1024 contraction bits in flight with tensor copies (TMA), A's 128 rows
//     and B^T's 256 rows of a stage in the 128-byte swizzled layout wgmma
//     reads, on full/empty mbarriers; consumers never touch device memory
//     for operands, and the ring fills for the next tile during an epilogue.
//   * B is packed along its columns and the instruction wants the
//     contraction: the kernel's first phase (bt_unit, spread over the grid,
//     then a grid barrier: one launch, not two, which measured faster for
//     the small calls and within 3 % for the large) writes B^T once, O(k*n)
//     bits, in the column order below (bt_row), so that a thread's
//     accumulators cover whole 32-bit words of C: parity without a shuffle,
//     then one shuffle between neighbours so that each thread stores 16
//     bytes of a row.
//   * A comes from the caller's matrix as it lies, through its own tensor
//     map; a tensor copy needs a 16-byte aligned base and row stride, so an
//     A that is not (a view at an odd word offset) is first copied into
//     aligned scratch by copy_a_kernel, in the same call.
//   * A persistent grid, at most one block an SM, walks the (tile, split)
//     items in a grouped order (GROUP_M row tiles at a time, so that blocks
//     running together share operands in L2); gemm_schedule_plain in
//     ops/hopper_mul.py is the same walk in numpy.
//   * The contraction stays inside the block, so C is written once (or, with
//     accumulate, read and written once by the tile's one owner): no zeroing,
//     no atomics.  Only where the tiles do not fill the card and the
//     contraction is deep does the caller split it across blocks
//     (gemm_plan); then C is zeroed on the stream (unless accumulating) and
//     the splits XOR into it with atomics.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "gf2_sm90.cuh"
#include "gf2_tile.cuh"

namespace gf2 {
namespace gemm {

namespace cg = cooperative_groups;

constexpr int TM = 128;                 // rows of a tile: 64 a consumer warpgroup
constexpr int TW = 8;                   // words of a tile row
constexpr int TN = TW * 32;             // columns of a tile: the wgmma's N
constexpr int KC = 32;                  // contraction words of a stage (128 bytes)
constexpr int RING = 4;                 // stages in flight
constexpr int A_BYTES = TM * KC * 4;    // 16 KB
constexpr int B_BYTES = TN * KC * 4;    // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = 1024 + RING * STAGE_BYTES + 2 * RING * 8;
constexpr int THREADS = 384;            // producer warpgroup + two consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int GROUP_M = 8;              // row tiles a group of the walk

// Column order of a staged B^T tile (bt_row in ops/hopper_mul.py): column
// 32*w + b of the tile (word w, bit b) is row 8*b + w.  wgmma gives thread t
// of a quad the columns 8*i + 2*t + e (i = 0..31, e = 0, 1), which are then
// bits i of words 2*t + e: whole words.

struct Args {
  uint32_t* c;
  long ldc;
  int m, nw, kw;
  int tiles_m, tiles_n;
  int splits, chunk, stages;   // the contraction: stages of KC words, split
                               // into `splits` runs of `chunk` stages
  bool vec_c, accumulate;
  const uint32_t* b;           // the pre-pass: B [k, nw] into bt
  long ldb;
  int k;
  uint32_t* bt;
  long ldbt;
  int units_x, units;          // its units: ceil(nw/32) x ceil(kw/8)
};

// Item L of the walk: tile (tm, tn) and its stages [s0, s1).
struct Item {
  int tm, tn, s0, s1;
};

__device__ __forceinline__ Item item_at(const Args& a, int L) {
  const int s = L % a.splits, t = L / a.splits;
  const int span = GROUP_M * a.tiles_n;
  const int first = t / span * GROUP_M;
  const int gsz = min(a.tiles_m - first, GROUP_M);
  const int r = t % span;
  Item it;
  it.tm = first + r % gsz;
  it.tn = r / gsz;
  it.s0 = s * a.chunk;
  it.s1 = min(it.s0 + a.chunk, a.stages);
  return it;
}

// ---- pre-pass: B^T, each tile's 256 rows in bt_row order ----

// the barrier of the pre-pass's 256 threads (id 0 is __syncthreads')
__device__ __forceinline__ void pre_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Unit (ux, uy) of the pre-pass, run by threads 0..255 of a block with s
// (36,992 bytes of shared memory): contraction words 8*uy..+7 of B's word
// columns 32*ux..+31.  Warp w takes contraction word kwi = 8*uy + w, lane l
// the word column nwi = 32*ux + l: the warp reads 32 rows of B, 128 bytes a
// row, and each lane transposes its 32 x 32 bits in registers (gf2_tile.cuh's
// transpose32), so that x[j] holds column 32*nwi + j.  Rows of B at or
// beyond k and columns at or beyond nw read as zero.  Through shared memory
// two threads then write the 8 contraction words of a B^T row, one 32-byte
// sector, with a 16-byte store each; the unit's 32 word columns are 4 tiles
// of B^T.  (Measured slower on the H100: ballots instead of the register
// transpose, one row a lane, which make one word where the transpose makes
// 32 for 12 instructions each; and 4 contraction words a unit, half a
// sector a row.)
__device__ __forceinline__ void bt_unit(const Args& a, int ux, int uy,
                                        uint32_t* s) {
  // s: [bit j][word column l][contraction word w] at 289*j + 9*l + w, so
  // that the stores of a warp and the reads below fall on (nearly) distinct
  // banks
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int kwi = uy * 8 + w, nwi = ux * 32 + l;
  uint32_t x[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const long row = (long)kwi * 32 + r;
    x[r] = (kwi < a.kw && row < a.k && nwi < a.nw)
               ? __ldg(a.b + row * a.ldb + nwi) : 0u;
  }
  transpose32(x);
#pragma unroll
  for (int j = 0; j < 32; ++j) s[289 * j + 9 * l + w] = x[j];
  pre_sync();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // half h of row r of the unit's 4 tiles: tile r / 256, row 8*j + c of
    // it, which is bit j of the tile's word c (bt_row)
    const int v = i * 256 + threadIdx.x, r = v >> 1, h = v & 1;
    if (ux * 4 + (r >> 8) >= a.tiles_n) break;
    const int kk = uy * 8 + 4 * h;
    const int j = (r & 255) >> 3, lw = (r >> 8) * 8 + (r & 7);
    const uint32_t* src = s + 289 * j + 9 * lw + 4 * h;
    uint32_t* dst = a.bt + ((long)ux * 1024 + r) * a.ldbt + kk;
    if (kk + 4 <= a.kw) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(src[0], src[1], src[2], src[3]);
    } else {
      for (int q = 0; q < a.kw - kk; ++q) dst[q] = src[q];
    }
  }
  pre_sync();            // s is free for the next unit
}

// A into aligned scratch [m, ldd], for an A whose base or stride a tensor
// copy cannot take.
__global__ void __launch_bounds__(256)
copy_a_kernel(const uint32_t* __restrict__ a, long lda, int m, int kw,
              uint32_t* __restrict__ dst, long ldd) {
  const long n = (long)m * kw;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const long r = i / kw;
    const int w = (int)(i - r * kw);
    dst[r * ldd + w] = a[r * lda + w];
  }
}

// ---- the GEMM ----

__global__ void __launch_bounds__(THREADS, 1)
gf2_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: stages start on one
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RING * STAGE_BYTES);
  uint64_t* empty = full + RING;
  const int items = a.tiles_m * a.tiles_n * a.splits;
  const int wg = threadIdx.x >> 7;

  // phase 1: B^T, the pre-pass's units spread over the grid; the tensor
  // copies of phase 2 read it after the grid barrier (a cooperative launch
  // keeps every block resident), its stores ordered before them by the
  // proxy fence
  if (threadIdx.x < 256) {
    for (int u = blockIdx.x; u < a.units; u += gridDim.x)
      bt_unit(a, u % a.units_x, u / a.units_x,
              reinterpret_cast<uint32_t*>(smem));
    fence_proxy_async();          // the staging, before tensor copies land there
    fence_proxy_async_global();
  }
  cg::this_grid().sync();

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread starts every copy
    regs_dec<40>();
    if (threadIdx.x == 0) {
      fence_proxy_async_global();
      int q = 0;
      for (int L = blockIdx.x; L < items; L += gridDim.x) {
        const Item it = item_at(a, L);
        for (int st = it.s0; st < it.s1; ++st, ++q) {
          const int slot = q % RING;
          if (q >= RING) mbar_wait(&empty[slot], ((q / RING) - 1) & 1);
          uint8_t* sa = smem + slot * STAGE_BYTES;
          mbar_expect_tx(&full[slot], STAGE_BYTES);
          tma_load_2d(sa, &tma_a, st * KC, it.tm * TM, &full[slot]);
          tma_load_2d(sa + A_BYTES, &tma_b, st * KC, it.tn * TN, &full[slot]);
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int cw = wg - 1;                         // rows 64*cw.. of a tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  auto release = [&](int qq) {                   // this warp is done with a stage
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[qq % RING]);
  };
  int d[128];
  int q = 0;
  for (int L = blockIdx.x; L < items; L += gridDim.x) {
    const Item it = item_at(a, L);
    // after the exchange below, this thread holds words col..col+3 of `row`
    const int row = it.tm * TM + cw * 64 + warp * 16 + g + (odd ? 8 : 0);
    const int col = it.tn * TW + 4 * (t >> 1);
    const int valid = row < a.m ? min(max(a.nw - col, 0), 4) : 0;
    uint32_t* cp = a.c + (long)row * a.ldc + col;
    const bool whole = a.vec_c && valid == 4;
    uint4 old = make_uint4(0u, 0u, 0u, 0u);
    if (a.accumulate && a.splits == 1 && valid) {   // in flight during the MMAs
      if (whole) {
        old = *reinterpret_cast<const uint4*>(cp);
      } else {
        uint32_t o[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < valid; ++j) o[j] = cp[j];
        old = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }

    for (int st = it.s0; st < it.s1; ++st, ++q) {
      const int slot = q % RING;
      mbar_wait(&full[slot], (q / RING) & 1);
      const uint8_t* sa = smem + slot * STAGE_BYTES;
      const uint64_t da = desc_sw128(sa + cw * 64 * KC * 4);
      const uint64_t db = desc_sw128(sa + A_BYTES);
      const int steps = min(4, (a.kw - st * KC + 7) / 8);   // 256-bit steps with data
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < steps)
          wgmma_b1_m64n256(d, da + 2 * ks, db + 2 * ks, st > it.s0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();                  // the previous stage's MMAs are done
      if (st > it.s0) release(q - 1);
    }
    wgmma_wait<0>();
    fence_regs(d);
    release(q - 1);

    // parity: bit i of word 2t + e of rows g, g + 8 is d[4i + 2h + e] & 1
    uint32_t w[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w[h][e] |= ((uint32_t)d[4 * i + 2 * h + e] & 1u) << i;
    // neighbours t, t ^ 1 trade halves: the even one takes row g, words
    // 4*(t/2)..+3, the odd one row g + 8, the same words
    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? w[0][0] : w[1][0], 1);
    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? w[0][1] : w[1][1], 1);
    uint4 v = odd ? make_uint4(r0, r1, w[1][0], w[1][1])
                  : make_uint4(w[0][0], w[0][1], r0, r1);
    if (valid) {
      if (a.splits > 1) {
        const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
        for (int j = 0; j < valid; ++j) atomicXor(cp + j, vv[j]);
      } else {
        v.x ^= old.x; v.y ^= old.y; v.z ^= old.z; v.w ^= old.w;
        if (whole) {
          *reinterpret_cast<uint4*>(cp) = v;
        } else {
          const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
          for (int j = 0; j < valid; ++j) cp[j] = vv[j];
        }
      }
    }
  }
}

// ---- host side ----

// cuTensorMapEncodeTiled, looked up once through the runtime (no link to
// libcuda).
static PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &got) == cudaSuccess &&
        got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A [rows, words] of uint32 with row stride ld words, read in boxes of KC
// words x box_rows rows, 128-byte swizzled; outside it reads as zeros.
static bool make_map(CUtensorMap* map, const void* base, int words, int rows,
                     long ld, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return false;
  cuuint64_t dim[2] = {(cuuint64_t)words, (cuuint64_t)rows};
  cuuint64_t stride[1] = {(cuuint64_t)ld * 4};
  cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(base), dim, stride, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The last map made for each operand, by this host thread: a caller that
// multiplies the same buffers again (the sweep's U rows, a scratch that stays
// put) gets it without encoding.
struct MapCache {
  const void* base = nullptr;
  int words = 0, rows = 0, box = 0;
  long ld = 0;
  CUtensorMap map;
};
static thread_local MapCache g_map_a, g_map_b;

static const CUtensorMap* cached_map(MapCache& mc, const void* base, int words,
                                     int rows, long ld, int box) {
  if (mc.base != base || mc.words != words || mc.rows != rows ||
      mc.ld != ld || mc.box != box) {
    mc.base = nullptr;
    if (!make_map(&mc.map, base, words, rows, ld, box)) return nullptr;
    mc.base = base;
    mc.words = words;
    mc.rows = rows;
    mc.ld = ld;
    mc.box = box;
  }
  return &mc.map;
}

// The kernel's shared memory, asked for once a device; a failure (more than
// the card has) is returned, never clamped.  Internal linkage, so that two
// builds of this file loaded in one process keep their own.
static bool g_ready[64];

static cudaError_t prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!g_ready[dev]) {
    err = cudaFuncSetAttribute(gf2_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    g_ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace gemm
}  // namespace gf2

// C = A*B (accumulate 0) or C ^= A*B, on the current device and `stream`.
// a: [m, kw] words, row stride lda; b: [k, nw], row stride ldb, k <= 32*kw;
// c: [m, nw], row stride ldc, not overlapping a or b.  Strides in words.
// scratch: 16-byte aligned, ceil(nw/8) * 256 * ldbt words for B^T, then, if
// copy_a, m * ldbt words for A (ldbt = kw rounded up to 4); copy_a must be
// set when a or lda is not 16-byte aligned.  The walk: `splits` runs of
// `chunk` stages of 32 words covering ceil(kw/32) stages, each run non-empty,
// over a grid of `grid` blocks, at most one an SM (gemm_plan in
// ops/hopper_mul.py).  One call launches the A copy (if asked), the zeroing
// of C (split and not accumulating only) and the GEMM with its pre-pass, a
// cooperative launch.  Returns the first CUDA error, 0 if none.
extern "C" int gf2_gemm_hopper_launch(const void* a, long lda, const void* b,
                                      long ldb, void* scratch, int copy_a,
                                      void* c, long ldc, int m, int kw, int k,
                                      int nw, int accumulate, int splits,
                                      int chunk, int grid, void* stream) {
  using namespace gf2::gemm;
  const int stages = (kw + KC - 1) / KC;
  if (m < 1 || nw < 1 || kw < 1 || k < 1 || k > 32L * kw ||
      splits < 1 ||
      chunk < 1 || (long)(splits - 1) * chunk >= stages ||
      (long)splits * chunk < stages || grid < 1 ||
      (long)((nw + 31) / 32) * ((kw + 7) / 8) > 0x7fffffffL ||
      (!copy_a && !gf2::aligned16(a, lda)) || !gf2::aligned16(scratch, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long ldbt = (kw + 3) / 4 * 4;
  const int tiles_n = (nw + TW - 1) / TW;
  auto* bt = static_cast<uint32_t*>(scratch);
  const uint32_t* a_in = static_cast<const uint32_t*>(a);
  long lda_in = lda;
  if (copy_a) {
    uint32_t* ac = bt + (long)tiles_n * TN * ldbt;
    const long n = (long)m * kw;
    const int blocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
    copy_a_kernel<<<blocks, 256, 0, st>>>(a_in, lda, m, kw, ac, ldbt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    a_in = ac;
    lda_in = ldbt;
  }
  if (splits > 1 && !accumulate) {
    err = cudaMemset2DAsync(c, ldc * 4, 0, (size_t)nw * 4, m, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const CUtensorMap* map_a = cached_map(g_map_a, a_in, kw, m, lda_in, TM);
  const CUtensorMap* map_b =
      cached_map(g_map_b, bt, kw, tiles_n * TN, ldbt, TN);
  if (!map_a || !map_b) return static_cast<int>(cudaErrorInvalidValue);
  const int units_x = (nw + 31) / 32;
  Args args{static_cast<uint32_t*>(c), ldc, m, nw, kw,
            (m + TM - 1) / TM, tiles_n, splits, chunk, stages,
            gf2::aligned16(c, ldc), accumulate != 0,
            static_cast<const uint32_t*>(b), ldb, k, bt, ldbt,
            units_x, units_x * ((kw + 7) / 8)};
  void* params[] = {const_cast<CUtensorMap*>(map_a),
                    const_cast<CUtensorMap*>(map_b), &args};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gf2_gemm_kernel), dim3(grid),
      dim3(THREADS), params, SMEM_BYTES, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
