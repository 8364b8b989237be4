// gf2_panel_hopper: the PLE panel's sequential pivot loop, all nb column
// steps in one launch.
//
// Replaces the TPU kernel panel_loop (m4ri_tpu/ops/pallas_panel.py,
// _make_kernel).  On a fused window AL = [panel | L] of h rows whose row 0
// sits at global position `base`, for each column j = 0..nb-1: find the first
// row at or below the current rank r with a 1 in column j (among rows at
// global positions < m, and within `search_window` rows of r if that is set),
// swap it to the rank's row, record the swap, XOR the pivot row (masked to the
// columns right of j when L is preserved in place) into every lower row with
// a 1 in column j, and set that row's multiplier bit in the L half.
//
// What bounds it on an H100: neither bytes nor operations but the chain of nb
// dependent steps, each a search, a swap and an update with a block-wide
// barrier between them.  So the design keeps one step short: one thread
// block owns the window; a thread reads word j/32 of its row directly and
// computes the masks from j; the search is a ballot per warp and an
// atomicMin in shared memory, taken in chunks of blockDim rows from the rank
// downwards so that it ends at the first chunk with a candidate; the update
// is a thread per row.  Where the window lives decides the cost of a step:
//   SHARED  the whole window in shared memory (h = 576, nb = 512: 76 KB);
//   SPLIT   the panel half in shared memory, the L half, which only sees
//           the row swap and one bit a step, in device memory
//           (h = 1088, nb = 1024: 144 KB where the whole would be 283 KB);
//   GLOBAL  the whole window in device memory, for the full-height window of
//           the miss fallback (h = 17,152 and more).
// Rows in shared memory are one word apart from a multiple of 32 so that a
// warp's threads, one row each, fall on distinct banks.
#include <cuda_runtime.h>
#include <initializer_list>
#include <limits.h>
#include <stdint.h>

namespace gf2 {

enum PanelMode { kAuto = 0, kShared = 1, kSplit = 2, kGlobal = 3 };
constexpr int MAX_NBW = 64;       // panel width up to 2048 columns
constexpr int MAX_THREADS = 1024;

template <bool kRowWork>
__global__ void __launch_bounds__(MAX_THREADS, 1)
panel_kernel(const uint32_t* __restrict__ al0, uint32_t* al, int* rowperm,
             int* r_out, int* touched, int* p_out, int* q_out,
             const int* __restrict__ r0_ptr, int base, int m, int h, int nbw,
             int preserve_l, int search_window, int mode) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_first;
  __shared__ uint32_t s_piv[MAX_NBW];
  const int tid = threadIdx.x, T = blockDim.x;
  const int nb = nbw * 32, w2 = 2 * nbw;

  // the two halves of the window: base pointer and row stride, in words
  uint32_t *pan, *lh;
  long ldp, ldl;
  if (mode == kShared) {
    ldp = ldl = w2 + 1; pan = smem; lh = smem + nbw;
  } else if (mode == kSplit) {
    ldp = nbw + 1; pan = smem; ldl = w2; lh = al + nbw;
  } else {
    ldp = ldl = w2; pan = al; lh = al + nbw;
  }
  for (long idx = tid; idx < (long)h * w2; idx += T) {
    const long row = idx / w2;
    const int w = (int)(idx - row * w2);
    if (w < nbw) pan[row * ldp + w] = al0[idx];
    else lh[row * ldl + (w - nbw)] = al0[idx];
  }
  for (int i = tid; i < h; i += T) rowperm[i] = i;
  for (int i = tid; i < 2 * nb; i += T) touched[i] = 0;
  for (int i = tid; i < nb; i += T) { p_out[i] = 0; q_out[i] = 0; }
  if (tid == 0) s_first = INT_MAX;
  const int r_in = *r0_ptr;
  int r = r_in;
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int wloc = j >> 5, sh = j & 31;
    const int rl = r - base;            // window row of the rank's slot
    const int rs = max(0, min(rl, h - 1));
    int hi = min(h, m - base);          // rows at positions >= m never pivot
    if (search_window) hi = min(hi, rl + search_window);

    // -- search: first row in [rl, hi) with a 1 in column j
    int first = INT_MAX;
    for (int lo = max(rl, 0); lo < hi; lo += T) {
      const int i = lo + tid;
      const bool cand = i < hi && ((pan[(long)i * ldp + wloc] >> sh) & 1u);
      const unsigned b = __ballot_sync(0xffffffffu, cand);
      if (b && (tid & 31) == 0) atomicMin(&s_first, lo + tid + __ffs(b) - 1);
      if (__syncthreads_or(cand)) { first = s_first; break; }
    }
    const bool found = first != INT_MAX;
    const int ps = found ? first : rs;
    const int slot = r - r_in;          // 0 <= slot <= j

    // -- swap rows rs and ps, record, stage the masked pivot row
    if (tid < 32) {
      for (int w = tid; w < nbw; w += 32) {
        const uint32_t a = pan[(long)rs * ldp + w], b = pan[(long)ps * ldp + w];
        pan[(long)rs * ldp + w] = b;
        pan[(long)ps * ldp + w] = a;
        uint32_t keep = 0xffffffffu;
        if (preserve_l)   // columns <= j stay: they hold L in place
          keep = w > wloc ? 0xffffffffu
               : w < wloc ? 0u
               : sh == 31 ? 0u : 0xffffffffu << (sh + 1);
        s_piv[w] = b & keep;
        const uint32_t la = lh[(long)rs * ldl + w], lb = lh[(long)ps * ldl + w];
        lh[(long)rs * ldl + w] = lb;
        lh[(long)ps * ldl + w] = la;
      }
      if (tid == 0) {
        const int t = rowperm[rs];
        rowperm[rs] = rowperm[ps];
        rowperm[ps] = t;
        touched[2 * j] = rs;
        touched[2 * j + 1] = ps;
        p_out[slot] = ps;
        q_out[slot] = j;
      }
    }
    __syncthreads();
    if (tid == 0) s_first = INT_MAX;    // every thread has read it by now

    // -- update: rows below the slot with a 1 in column j
    if (found) {
      if (kRowWork) {
        const int wbeg = preserve_l ? wloc : 0;
        const int lw = slot >> 5;
        const uint32_t lbit = 1u << (slot & 31);
        for (int i = rl + 1 + tid; i < h; i += T) {
          uint32_t* row = pan + (long)i * ldp;
          if ((row[wloc] >> sh) & 1u) {
#pragma unroll 4   // several loads in flight when the window is in device memory
            for (int w = wbeg; w < nbw; ++w) row[w] ^= s_piv[w];
            lh[(long)i * ldl + lw] ^= lbit;
          }
        }
      }
      ++r;
    }
    __syncthreads();
  }

  if (mode != kGlobal) {
    const int wend = mode == kShared ? w2 : nbw;   // SPLIT: L is in al already
    for (long idx = tid; idx < (long)h * wend; idx += T) {
      const long row = idx / wend;
      const int w = (int)(idx - row * wend);
      al[row * w2 + w] = w < nbw ? pan[row * ldp + w]
                                 : lh[row * ldl + (w - nbw)];
    }
  }
  if (tid == 0) *r_out = r;
}

// Dynamic shared memory of a mode, in bytes.
inline size_t panel_smem(int mode, int h, int nbw) {
  if (mode == kShared) return (size_t)h * (2 * nbw + 1) * 4;
  if (mode == kSplit) return (size_t)h * (nbw + 1) * 4;
  return 0;
}

// The mode a window runs in: the one asked for, or under kAuto the first of
// SHARED, SPLIT, GLOBAL that fits.  -1 when the one asked for does not fit
// the card's shared memory: nothing is clamped.
inline int panel_mode(int requested, int h, int nbw) {
  int dev = 0, cap = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) return -1;
  const size_t room = cap > 1024 ? (size_t)cap - 1024 : 0;  // static part
  if (requested != kAuto)
    return panel_smem(requested, h, nbw) <= room ? requested : -1;
  for (int mode : {kShared, kSplit})
    if (panel_smem(mode, h, nbw) <= room) return mode;
  return kGlobal;
}

}  // namespace gf2

// 1 SHARED, 2 SPLIT, 3 GLOBAL; -1 if `requested` (0 = choose) does not fit.
extern "C" int gf2_panel_loop_hopper_mode(int requested, int h, int nbw) {
  return gf2::panel_mode(requested, h, nbw);
}

// al0: [h, 2*nbw] words, contiguous; al: output of the same shape; rowperm:
// [h] ints; r_out: one int; touched: [2*nb]; p_out, q_out: [nb]; r0: one int
// on the device.  row_work = 0 leaves the update of the lower rows out: the
// serial skeleton of the loop, for timing only.  Returns cudaGetLastError().
extern "C" int gf2_panel_loop_hopper_launch(
    const void* al0, void* al, void* rowperm, void* r_out, void* touched,
    void* p_out, void* q_out, const void* r0, int base, int m, int h, int nbw,
    int preserve_l, int search_window, int requested_mode, int row_work,
    void* stream) {
  using namespace gf2;
  if (nbw < 1 || nbw > MAX_NBW || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = panel_mode(requested_mode, h, nbw);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t bytes = panel_smem(mode, h, nbw);
  auto kernel = row_work ? panel_kernel<true> : panel_kernel<false>;
  if (bytes > 48 * 1024) {  // beyond that a kernel has to ask
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = (h + 31) / 32 * 32;
  threads = threads < 128 ? 128 : threads > MAX_THREADS ? MAX_THREADS : threads;
  kernel<<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(al0), static_cast<uint32_t*>(al),
      static_cast<int*>(rowperm), static_cast<int*>(r_out),
      static_cast<int*>(touched), static_cast<int*>(p_out),
      static_cast<int*>(q_out), static_cast<const int*>(r0), base, m, h, nbw,
      preserve_l, search_window, mode);
  return static_cast<int>(cudaGetLastError());
}
