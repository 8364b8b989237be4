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
// dependent steps.  So the design makes a step touch as little as it can and
// moves everything else off the chain: columns are taken in groups of 32 =
// one packed word column, and inside a group a step sees ONE word a row.
//   Fast path: one warp holds that word of the 64 rows from the group's
//   first slot down in registers, two a lane (a group advances the rank by
//   at most 32, so 32 of them always stay in play).  A step is two ballots, a
//   find-first and four shuffles: no barrier, no memory.  Each row's word
//   carries along which raw pivot rows it has absorbed, so every pivot is
//   known as a combination of the group's RAW pivot rows when it is chosen.
//   The warp gives up at the first column where none of its rows has a 1
//   and rows beyond them could (deficient windows).
//   Slow path, for the rest of such a group: the whole block, the word column
//   of all h rows in c[] (shared memory; device scratch in TALL mode).  A thread owns the positions
//   congruent to it; the rows beyond the 64 catch up by replaying the group
//   so far; then the update of step s and the search of step s+1 are one
//   pass over a thread's own words, each warp reduces its first candidate,
//   one barrier publishes the warps' results and every warp reduces them
//   again: one barrier a step, no atomics.  Rows are not swapped: the swap
//   is logged, and c[] only takes the displaced word at the pivot's old
//   position.
//   At the group's end the logged swaps become one gather of at most 64
//   rows; every row at or below the group's first slot replays the group on
//   its own word of the (still stale) panel, which gives its multiplier word
//   mu and its combination of raw pivot rows; then every row takes, in one
//   pass parallel over rows x words with no dependency inside, the XOR of
//   the raw pivot rows its combination selects, four pivots a table look-up
//   (8 tables of 16 entries built from the raw rows, two words a load), and
//   mu lands in the L half at the group's first slot (across two words if
//   need be).  The L half is never read by the chain and lives in device
//   memory in every mode.
// Where the panel half lives decides the mode:
//   SHARED  one block; the panel half in shared memory
//           (h = 576, nb = 512: 37 KB; h = 1088, nb = 1024: 144 KB);
//   GRID    a cooperative grid; the panel in device memory; block 0 runs the
//           chain, then all blocks share the group-end pass over the rows,
//           between two grid barriers a group (the full-height window of the
//           miss fallback, h = 17,152 and more);
//   TALL    GRID with c[] in device scratch, which only the chain's block
//           touches and only on the slow path: windows whose word column
//           does not fit beside the tables (above about 48,000 rows).
// Panel rows in shared memory are one word apart from a multiple of 32 so
// that threads taking one row each fall on distinct banks.
// Batched: window b of a contiguous [B, h, 2*nbw] stack, its rank r0[b] and
// its base base[b] on the card, output b of each stack; the batch on grid x.
// Which kernel takes the batch follows the window's shape:
//   WARP    a warp a window, eight windows a block (h <= 64, nbw <= 2: NIST's
//           32 x 32 matrices, the sweep's narrow windows).  The window lives
//           in the warp's registers; rows never move: each carries its
//           position, a step is one min-reduction over the rows in range, nbw
//           shuffles of the pivot's panel words, the exchange of two
//           positions and a masked XOR; every row is stored at its position
//           at the end.  No barrier, no shared memory, no group end.
//   BLOCK   mode SHARED, a block a window.  Where two or more windows fit an
//           SM and the batch outnumbers the SMs, an instance of the kernel
//           whose launch bounds keep two (576 threads) or three (256) windows
//           resident, their chains and passes overlapping, whichever runs
//           the batch in fewer waves (the McEliece first panel's 256 windows
//           of 576 rows: one wave, 576 threads; 1024 ISD windows: three
//           waves, 256); else the single call's configuration, one window
//           an SM (a batch of one).
// In the batched launch's mode SHARED a window with no row in range (r_in >=
// m, or the rank past the window: min(h, m - base) <= r_in - base) takes no
// step: its block writes what the loop leaves there (AL = al0, the
// identity, every step's swap (rs, rs), p[0] = rs, q[0] = nb - 1) from
// device memory to device memory, decided on the card from r0 and base.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <initializer_list>
#include <limits.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace gf2 {

enum PanelMode { kAuto = 0, kShared = 1, kGrid = 2, kTall = 3 };
constexpr int MAX_NBW = 64;       // panel width up to 2048 columns
constexpr int MAX_THREADS = 1024;
constexpr int GROUP = 32;         // columns a group = bits a word
constexpr unsigned FULL = 0xffffffffu;

// What a group's chain hands to the pass at its end: K pivots, the window
// row and the L slot of the first, the word column, and for pivot k its bit
// in the word, its word at the time of its step (masked to what the
// elimination may touch) and the raw pivot rows it is the XOR of.
struct alignas(16) GroupMeta {
  int K, rl0, slot0, wloc;
  uint4 piv[GROUP];   // x: bit in the word, y: masked pivot word, z: combination
};

struct PanelArgs {
  const uint32_t* al0;
  uint32_t* al;
  int *rowperm, *r_out, *touched, *p_out, *q_out;
  const int* r0;
  const int* base_p;    // batched: one base a window (else null: `base`)
  uint32_t* cnext;      // GRID: the next word column, [h]
  uint32_t* cdev;       // TALL: the chain's word column c[], [h]
  GroupMeta* meta_g;    // GRID: the group's meta for the other blocks
  uint32_t* tab_g;      // GRID: the raw pivot rows, [32, nbw]
  int base, m, h, nbw, preserve_l, search_window, row_work, r0_val;
};

template <bool kGlobal>
__device__ __forceinline__ uint32_t ldw(const uint32_t* p) {
  return kGlobal ? __ldcg(p) : *p;   // past L1: other blocks write there
}

template <bool kGlobal>
__device__ __forceinline__ void stw(uint32_t* p, uint32_t v) {
  if (kGlobal) __stcg(p, v); else *p = v;
}

// The parallel part of the pass: row chunk + rr takes, on every word from
// wbeg on but wloc, the XOR of the table entries its selection sel_s[rr]
// names.  Items of W adjacent words (W = 2 needs nbw even) are dealt out
// densely over the block.  cnext, if given, receives word wloc + 1.
template <bool kGlobal, int W>
__device__ __forceinline__ void xor_selected(
    uint32_t* pan, long ldp, const uint32_t* t4, const uint32_t* sel_s,
    int chunk, int nrows, int nbw, int wloc, int wbeg, uint32_t* cnext) {
  const int ibeg = wbeg / W, ni = nbw / W - ibeg;   // items a row
  const int ntab = 8;
  for (int e = threadIdx.x; e < nrows * ni; e += blockDim.x) {
    const int rr = e / ni, w0 = (ibeg + e - rr * ni) * W;
    const uint32_t sel = sel_s[rr];
    if (!sel && !(cnext && w0 <= wloc + 1 && wloc + 1 < w0 + W)) continue;
    uint32_t acc[W] = {};
    if (sel)
      for (int t = 0; t < ntab; ++t) {
        const uint32_t* ent =
            t4 + ((t << 4) | ((sel >> (4 * t)) & 15u)) * nbw + w0;
        if (W == 2) {
          const uint2 two = *reinterpret_cast<const uint2*>(ent);
          acc[0] ^= two.x;
          acc[W - 1] ^= two.y;
        } else {
          acc[0] ^= ent[0];
        }
      }
    uint32_t* row = pan + (long)(chunk + rr) * ldp;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int w = w0 + i;
      if (w < wbeg || w == wloc) continue;
      const uint32_t v = ldw<kGlobal>(row + w) ^ acc[i];
      if (acc[i]) row[w] = v;
      if (cnext && w == wloc + 1) cnext[chunk + rr] = v;
    }
  }
}

// The group-end pass over the window rows [row_lo, row_hi) (row_lo >= rl0):
// replay, XOR of the selected raw pivot rows, multiplier word into L.
// tab[k * tabld + w]: word w of raw pivot row k.  The selection goes four
// pivots at a time through t4[(4-bit group, 16 combinations), nbw], built
// here from tab (Four Russians).  sel_s: cap words, cap rows a round.
template <bool kGlobal>
__device__ void delayed_pass(uint32_t* pan, long ldp, uint32_t* lhp, long ldl,
                             const GroupMeta& mt, const uint32_t* tab,
                             int tabld, uint32_t* t4, uint32_t* sel_s, int cap,
                             int row_lo, int row_hi, int nbw, int preserve_l,
                             uint32_t* cnext) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int K = mt.K, wloc = mt.wloc, rl0 = mt.rl0;
  const int wbeg = preserve_l ? wloc + 1 : 0;
  const int lw = mt.slot0 >> 5, ls = mt.slot0 & 31;
  for (int e = tid; e < 128 * nbw; e += T) {
    const int te = e / nbw, w = e - te * nbw;
    const int k0 = (te >> 4) << 2;
    uint32_t acc = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (((te >> b) & 1) && k0 + b < K) acc ^= tab[(k0 + b) * tabld + w];
    t4[e] = acc;
  }
  for (int chunk = row_lo; chunk < row_hi; chunk += cap) {
    const int nrows = min(cap, row_hi - chunk);
    for (int rr = tid; rr < nrows; rr += T) {
      const int pos = chunk + rr;
      uint32_t x = ldw<kGlobal>(pan + pos * ldp + wloc), mu = 0, sel = 0;
      const int lim = min(K, pos - rl0);   // a pivot row stops at its step
#pragma unroll 4
      for (int k = 0; k < lim; ++k) {
        const uint4 pk = mt.piv[k];          // one 16-byte broadcast load
        const uint32_t bit = (x >> pk.x) & 1u, take = 0u - bit;
        x ^= pk.y & take;
        mu |= bit << k;
        sel ^= pk.z & take;
      }
      if (mu) {
        pan[pos * ldp + wloc] = x;
        atomicXor(lhp + pos * ldl + lw, mu << ls);   // result unused: a RED
        if (ls && (mu >> (32 - ls)))
          atomicXor(lhp + pos * ldl + lw + 1, mu >> (32 - ls));
      }
      sel_s[rr] = sel;
    }
    __syncthreads();   // sel_s, and before the first chunk t4
    if (nbw & 1)
      xor_selected<kGlobal, 1>(pan, ldp, t4, sel_s, chunk, nrows, nbw, wloc,
                               wbeg, cnext);
    else   // two words an item: half the table loads
      xor_selected<kGlobal, 2>(pan, ldp, t4, sel_s, chunk, nrows, nbw, wloc,
                               wbeg, cnext);
    __syncthreads();
  }
}

// The outputs of a window in which no step finds a row in range: the copy
// of al0 (8 bytes an item: 2 * nbw words a row), the identity, every step's
// swap (rs, rs) and slot 0 written by every step, the last being nb - 1.
__device__ void idle_window(const PanelArgs& a, int r_in) {
  const int tid = threadIdx.x, T = blockDim.x, h = a.h, nb = a.nbw * 32;
  const long items = (long)h * a.nbw;
  const uint2* src = reinterpret_cast<const uint2*>(a.al0);
  uint2* dst = reinterpret_cast<uint2*>(a.al);
  for (long i = tid; i < items; i += T) dst[i] = __ldcs(src + i);
  for (int i = tid; i < h; i += T) a.rowperm[i] = i;
  const int rs = max(0, min(r_in - a.base, h - 1));
  for (int i = tid; i < 2 * nb; i += T) a.touched[i] = rs;
  for (int i = tid; i < nb; i += T) {
    a.p_out[i] = i == 0 ? rs : 0;
    a.q_out[i] = i == 0 ? nb - 1 : 0;
  }
  if (tid == 0) *a.r_out = r_in;
}

template <bool kGrid, bool kTall, int kMaxT = MAX_THREADS, int kMinBlocks = 1>
__global__ void __launch_bounds__(kMaxT, kMinBlocks)
panel_kernel(PanelArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ GroupMeta mt;
  __shared__ int s_pos[2][32];
  __shared__ uint32_t s_word[2][32];
  __shared__ int sw_ps[GROUP], s_dst[2 * GROUP], s_src[2 * GROUP], s_state[3];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int h = a.h, nbw = a.nbw, w2 = 2 * nbw, nb = nbw * 32;
  const bool chain_block = !kGrid || blockIdx.x == 0;
  if (!kGrid) {   // window blockIdx.x of a batch (0 for a single window)
    const long e = blockIdx.x;
    a.al0 += e * h * w2;
    a.al += e * h * w2;
    a.rowperm += e * h;
    a.r_out += e;
    a.touched += e * 2 * nb;
    a.p_out += e * nb;
    a.q_out += e * nb;
    if (a.r0) a.r0 += e;
    if (a.base_p) {   // batched: a window with no row in range takes no step
      a.base = a.base_p[e];
      const int r_in = max(*a.r0, a.base);
      if (min(h, a.m - a.base) <= r_in - a.base) {
        idle_window(a, r_in);
        return;
      }
    }
  }

  // shared memory: t4[8 * 16, nbw] (first: read 8 bytes at a time) |
  // tab[64, w2] | c[h] (not in TALL mode) | sel_s[T], or in SHARED mode
  // sel_s[h] | rowperm[h] | pan
  uint32_t* t4 = smem;
  uint32_t* tab = t4 + 128 * nbw;
  uint32_t* c = kTall ? a.cdev : tab + 2 * GROUP * w2;
  uint32_t* sel_s = kTall ? tab + 2 * GROUP * w2 : c + h;
  int* rowperm = kGrid ? a.rowperm : reinterpret_cast<int*>(sel_s + h);
  uint32_t* pan = kGrid ? a.al : sel_s + 2 * h;
  const long ldp = kGrid ? w2 : nbw + 1;
  uint32_t* lhp = a.al + nbw;          // the L half, in place in the output
  const long ldl = w2;

  {  // the window into place, the index outputs to their start values
    const long gt = kGrid ? (long)blockIdx.x * T + tid : tid;
    const long gn = kGrid ? (long)gridDim.x * T : T;
    for (long idx = gt; idx < (long)h * w2; idx += gn) {
      const long row = idx / w2;
      const int w = (int)(idx - row * w2);
      if (kGrid || w >= nbw) a.al[idx] = a.al0[idx];
      else pan[row * ldp + w] = a.al0[idx];
    }
    for (long i = gt; i < h; i += gn) rowperm[i] = (int)i;
    for (long i = gt; i < nb; i += gn) { a.p_out[i] = 0; a.q_out[i] = 0; }
  }
  // r0 >= base is the contract; a rank above the window is taken as its
  // first row, so that no row index below leaves the window
  const int r_in = max(a.r0 ? *a.r0 : a.r0_val, a.base);
  int r = r_in;
  if (kGrid) cg::this_grid().sync(); else __syncthreads();

  const int hi_all = min(h, a.m - a.base);   // rows at positions >= m never pivot
  int par = 0;
  for (int g = 0; g < nbw; ++g) {
    int K = 0;
    if (chain_block) {
      const int rl0 = r - a.base, slot0 = r - r_in;
      const bool from_cnext = kGrid && g > 0 && a.row_work;
      // -- fast path: one warp, the 64 rows from the first slot down in
      // registers (two a lane), no barrier.  A group advances the rank by at
      // most 32, so at least 32 of them stay in play.  It stops at the first
      // column where none of them has a 1 and rows beyond them could.
      if (warp == 0) {
        const int hp0 = rl0 + lane, hp1 = hp0 + 32;
        uint32_t v0 = 0, v1 = 0;
        if (hp0 < h) v0 = from_cnext ? __ldcg(a.cnext + hp0)
                                     : ldw<kGrid>(pan + hp0 * ldp + g);
        if (hp1 < h) v1 = from_cnext ? __ldcg(a.cnext + hp1)
                                     : ldw<kGrid>(pan + hp1 * ldp + g);
        // sel: the raw pivot rows a row has taken so far, as a combination
        // (it travels with the row).  The log stays in registers until the
        // loop ends: lane sh keeps step sh, lane k keeps pivot k.
        uint32_t sel0 = 0, sel1 = 0, fmask = 0;
        int rec_rs = 0, rec_ps = 0, rec_slot = 0, my_ps = 0;
        uint32_t my_sh = 0, my_pv = 0, my_comb = 0;
        int sh = 0;
        for (; sh < GROUP; ++sh) {
          const int rl = r - a.base;
          int hi = hi_all;
          if (a.search_window) hi = min(hi, rl + a.search_window);
          const unsigned b0 = __ballot_sync(
              FULL, hp0 >= rl && hp0 < hi && ((v0 >> sh) & 1u));
          const unsigned b1 = __ballot_sync(FULL, hp1 < hi && ((v1 >> sh) & 1u));
          const bool found = (b0 | b1) != 0u;
          if (!found && rl0 + 2 * GROUP < hi) break;   // these rows cannot tell
          const int rs = max(0, min(rl, h - 1));
          int ps = rs;
          if (found) {
            const bool low = b0 != 0u;
            const int src = __ffs(low ? b0 : b1) - 1;
            ps = rl0 + src + (low ? 0 : GROUP);
            const uint32_t pw = __shfl_sync(FULL, low ? v0 : v1, src);
            const uint32_t psel = __shfl_sync(FULL, low ? sel0 : sel1, src);
            const uint32_t crs = __shfl_sync(FULL, v0, K);     // K == rl - rl0
            const uint32_t csel = __shfl_sync(FULL, sel0, K);
            if (ps != rs && lane == src) {
              if (low) { v0 = crs; sel0 = csel; } else { v1 = crs; sel1 = csel; }
            }
            uint32_t keep = FULL;
            if (a.preserve_l)   // columns <= j stay: they hold L in place
              keep = sh == 31 ? 0u : FULL << (sh + 1);
            const uint32_t pivc = pw & keep, comb = psel | (1u << K);
            if (hp0 > rl && ((v0 >> sh) & 1u)) { v0 ^= pivc; sel0 ^= comb; }
            if ((v1 >> sh) & 1u) { v1 ^= pivc; sel1 ^= comb; }
            if (lane == K) { my_sh = sh; my_pv = pivc; my_comb = comb; my_ps = ps; }
            fmask |= 1u << sh;
          }
          if (lane == sh) { rec_rs = rs; rec_ps = ps; rec_slot = r - r_in; }
          if (found) { ++r; ++K; }
        }
        if (lane < sh) {   // the log of the sh steps taken, a lane a step
          const int j = g * GROUP + lane;
          a.touched[2 * j] = rec_rs;
          a.touched[2 * j + 1] = rec_ps;
          // a step that found nothing shares its slot with the next step
          if (((fmask >> lane) & 1u) || lane == sh - 1) {
            a.p_out[rec_slot] = rec_ps;
            a.q_out[rec_slot] = j;
          }
        }
        if (lane < K) {
          mt.piv[lane] = make_uint4(my_sh, my_pv, my_comb, 0u);
          sw_ps[lane] = my_ps;
        }
        if (sh < GROUP) {   // hand the rows over as they stand
          if (hp0 < h) stw<kTall>(c + hp0, v0);
          if (hp1 < h) stw<kTall>(c + hp1, v1);
        }
        if (lane == 0) { s_state[0] = r; s_state[1] = K; s_state[2] = sh; }
      }
      __syncthreads();
      r = s_state[0];
      K = s_state[1];
      const int sh_slow = s_state[2];
      if (sh_slow < GROUP) {
        // -- slow path for the rest of the group: the whole block, one word a
        // row in c[].  A thread owns the positions congruent to it; the rows
        // beyond the 64 first catch up by replaying the group so far.
        int cand = INT_MAX;
        uint32_t candw = 0;
        int mypos;          // the thread's first position in play
        {
          const int rl = r - a.base;
          int hi = hi_all;
          if (a.search_window) hi = min(hi, rl + a.search_window);
          const int lo = max(rl, 0);
          mypos = lo + ((tid - lo) % T + T) % T;
          for (int pos = mypos; pos < h; pos += T) {
            uint32_t v;
            if (pos < rl0 + 2 * GROUP) {
              v = ldw<kTall>(c + pos);
            } else {
              v = from_cnext ? __ldcg(a.cnext + pos)
                             : ldw<kGrid>(pan + pos * ldp + g);
              for (int k = 0; k < K; ++k)
                if ((v >> mt.piv[k].x) & 1u) v ^= mt.piv[k].y;
              stw<kTall>(c + pos, v);
            }
            if (cand == INT_MAX && pos < hi && ((v >> sh_slow) & 1u)) {
              cand = pos; candw = v;
            }
          }
        }
        for (int sh = sh_slow; sh < GROUP; ++sh) {
          const int j = g * GROUP + sh;
          const int rl = r - a.base;          // window row of the rank's slot
          const int rs = max(0, min(rl, h - 1));
          // -- first candidate of the block: warp, barrier, warp.  The key
          // carries who holds the word in its low five bits.
          const int key = cand == INT_MAX ? INT_MAX : (cand << 5) | lane;
          const int wmin = __reduce_min_sync(FULL, key);
          const uint32_t ww = __shfl_sync(FULL, candw, wmin & 31);
          if (lane == 0) {
            s_pos[par][warp] = wmin == INT_MAX ? INT_MAX : (wmin & ~31) | warp;
            s_word[par][warp] = ww;
          }
          __syncthreads();
          const int pp = lane < nwarps ? s_pos[par][lane] : INT_MAX;
          const int first = __reduce_min_sync(FULL, pp);
          const bool found = first != INT_MAX;
          const int ps = found ? first >> 5 : rs;
          const uint32_t pw = found ? s_word[par][first & 31] : 0u;
          par ^= 1;
          uint32_t keep = FULL;
          if (a.preserve_l)
            keep = sh == 31 ? 0u : FULL << (sh + 1);
          const uint32_t pivc = pw & keep;
          if (tid == 0) {
            const int slot = r - r_in;
            a.touched[2 * j] = rs;
            a.touched[2 * j + 1] = ps;
            a.p_out[slot] = ps;
            a.q_out[slot] = j;
            if (found) { mt.piv[K].x = sh; mt.piv[K].y = pivc; sw_ps[K] = ps; }
          }
          if (found) { ++r; ++K; }
          cand = INT_MAX;
          if (!found && sh == GROUP - 1) continue;
          // -- update of this step and search of the next, own words only.
          // c[rs] is not written here (only positions below the slot are)
          // and is dead to the chain afterwards.
          const uint32_t crs = (found && ps != rs) ? ldw<kTall>(c + rs) : 0u;
          const int rl2 = r - a.base;
          int hi2 = hi_all;
          if (a.search_window) hi2 = min(hi2, rl2 + a.search_window);
          if (mypos < rl2) mypos += T;
          for (int pos = mypos; pos < h; pos += T) {
            uint32_t v = ldw<kTall>(c + pos);
            if (found) {
              const uint32_t v0 = v;
              if (pos == ps) v = crs;
              if ((v >> sh) & 1u) v ^= pivc;
              if (v != v0) stw<kTall>(c + pos, v);
            }
            if (sh < GROUP - 1 && cand == INT_MAX && pos < hi2 &&
                ((v >> (sh + 1)) & 1u)) { cand = pos; candw = v; }
          }
        }
      }
      __syncthreads();   // the log of the last step is written

      // -- the group's end on the chain's block: rows into place
      if (K > 0 && a.row_work) {
        if (warp == 0) {   // the K swaps in order, as one gather
          const int A = lane < K ? rl0 + lane : -1;
          const int B = lane < K ? sw_ps[lane] : -1;
          int cA = A, cB = B;
          for (int k = 0; k < K; ++k) {
            const int rs = rl0 + k, ps = __shfl_sync(FULL, B, k);
            const int vrs = __shfl_sync(FULL, cA, k);
            const int vps = __shfl_sync(FULL, cB, k);
            if (A == rs) cA = vps; else if (A == ps) cA = vrs;
            if (B == rs) cB = vps; else if (B == ps) cB = vrs;
          }
          int pa = 0, pb = 0;
          if (lane < K) {
            pa = kGrid ? __ldcg(rowperm + cA) : rowperm[cA];
            pb = kGrid ? __ldcg(rowperm + cB) : rowperm[cB];
          }
          __syncwarp();
          if (lane < K) {
            rowperm[A] = pa; rowperm[B] = pb;
            s_dst[lane] = A; s_src[lane] = cA;
            s_dst[GROUP + lane] = B; s_src[GROUP + lane] = cB;
          }
          if (lane == 0) { mt.K = K; mt.rl0 = rl0; mt.slot0 = slot0; mt.wloc = g; }
        }
        __syncthreads();
        for (int e = tid; e < 2 * K * w2; e += T) {
          const int ent = e / w2, w = e - ent * w2;
          const int idx = ent < K ? ent : GROUP + ent - K;
          const long src = s_src[idx];
          tab[idx * w2 + w] = w < nbw ? ldw<kGrid>(pan + src * ldp + w)
                                      : __ldcg(lhp + src * ldl + (w - nbw));
        }
        __syncthreads();
        for (int e = tid; e < 2 * K * w2; e += T) {
          const int ent = e / w2, w = e - ent * w2;
          const int idx = ent < K ? ent : GROUP + ent - K;
          const long dst = s_dst[idx];
          if (dst == s_src[idx]) continue;
          if (w < nbw) pan[dst * ldp + w] = tab[idx * w2 + w];
          else lhp[dst * ldl + (w - nbw)] = tab[idx * w2 + w];
        }
        if (warp == 0 && sh_slow < GROUP) {   // pivot k as a combination of
          // raw pivot rows (the fast path has logged its own)
          uint32_t x = lane < K ? tab[lane * w2 + g] : 0u, mu = 0;
          for (int k2 = 0; k2 < K; ++k2)      // its own multipliers first,
            if (k2 < lane && ((x >> mt.piv[k2].x) & 1u)) {   // lanes in parallel
              x ^= mt.piv[k2].y;
              mu |= 1u << k2;
            }
          uint32_t t = 1u << lane;            // then their closure, in order
          for (int k2 = 0; k2 < K; ++k2) {
            const uint32_t t2 = __shfl_sync(FULL, t, k2);
            if ((mu >> k2) & 1u) t ^= t2;
          }
          if (lane < K) mt.piv[lane].z = t;
        }
        __syncthreads();
      }
    }

    if (!kGrid) {
      if (K > 0 && a.row_work)
        delayed_pass<false>(pan, ldp, lhp, ldl, mt, tab, w2, t4, sel_s, h,
                            max(mt.rl0, 0), h, nbw, a.preserve_l, nullptr);
    } else if (a.row_work) {
      // hand the group to the grid: meta and raw pivot rows through device
      // memory, the rows at or below the first slot split evenly
      if (chain_block) {
        if (K == 0 && tid == 0) {
          mt.K = 0; mt.rl0 = r - a.base; mt.slot0 = r - r_in; mt.wloc = g;
        }
        __syncthreads();
        const int words = sizeof(GroupMeta) / 4;
        for (int i = tid; i < words; i += T)
          reinterpret_cast<uint32_t*>(a.meta_g)[i] =
              reinterpret_cast<const uint32_t*>(&mt)[i];
        for (int e = tid; e < K * nbw; e += T)
          a.tab_g[e] = tab[(e / nbw) * w2 + e % nbw];
        __threadfence();
      }
      cg::this_grid().sync();
      if (!chain_block) {
        const int words = sizeof(GroupMeta) / 4;
        for (int i = tid; i < words; i += T)
          reinterpret_cast<uint32_t*>(&mt)[i] =
              __ldcg(reinterpret_cast<const uint32_t*>(a.meta_g) + i);
        __syncthreads();
        for (int e = tid; e < mt.K * nbw; e += T)
          tab[(e / nbw) * w2 + e % nbw] = __ldcg(a.tab_g + e);
        __syncthreads();
      }
      const int lo = max(mt.rl0, 0);
      const int per = (max(h - lo, 0) + gridDim.x - 1) / gridDim.x;
      const int row_lo = min(h, lo + (int)blockIdx.x * per);
      delayed_pass<true>(pan, ldp, lhp, ldl, mt, tab, w2, t4, sel_s, T, row_lo,
                         min(h, row_lo + per), nbw, a.preserve_l,
                         g + 1 < nbw ? a.cnext : nullptr);
      __threadfence();
      cg::this_grid().sync();
    }
  }

  if (!kGrid) {
    for (long idx = tid; idx < (long)h * nbw; idx += T) {
      const long row = idx / nbw;
      const int w = (int)(idx - row * nbw);
      a.al[row * w2 + w] = pan[row * ldp + w];
    }
    for (int i = tid; i < h; i += T) a.rowperm[i] = rowperm[i];
  }
  if (chain_block && tid == 0) *a.r_out = r;
}

// ---- small windows: a warp a window ----------------------------------------
constexpr int WARP_WINDOWS = 8;    // windows (warps) a block
constexpr int WARP_MAX_H = 64;     // two rows a lane
constexpr int WARP_MAX_NBW = 2;    // 2 rows x 2 * nbw words: 8 registers

template <int NBW>
__device__ __forceinline__ void load_row(const uint32_t* p,
                                         uint32_t (&v)[2 * NBW]) {
  if constexpr (NBW == 1) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
}

template <int NBW>
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&v)[2 * NBW]) {
  if constexpr (NBW == 1)
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(v[0], v[1]));
  else
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
}

// Window e = blockIdx.x * WARP_WINDOWS + warp of a batch; lane l holds rows l
// and l + 32 (R = 2; R = 1 when h <= 32) with all 2 * NBW words of each, and
// the position each has reached.  h <= 64 means every row is in the warp: no
// slow path, no deferred update.  The steps are unrolled and branch-free but
// for "no pivot": the column's bit, its masks and the step's lane are
// immediates (kPres: L preserved in place; kSW: a search window is given),
// the multiplier bit of the rank's slot is shifted along a step at a time.
// A step keeps only its pivot position (lane sh) and whether it found one (a
// bit of fmask): its rank, its swap and the slot it writes follow at the
// group's end from a prefix count, as in the block kernel's fast path.
// Needs al0 and al 8 * NBW-byte aligned.
template <int NBW, int R, bool kSW, bool kPres>
__global__ void __launch_bounds__(WARP_WINDOWS * 32)
panel_warp_kernel(PanelArgs a, int batch) {
  constexpr int W2 = 2 * NBW, NB = GROUP * NBW;
  using Bits = typename std::conditional<NBW == 1, uint32_t, uint64_t>::type;
  const int lane = threadIdx.x & 31;
  const long e = (long)blockIdx.x * WARP_WINDOWS + (threadIdx.x >> 5);
  if (e >= batch) return;            // the tail of the last block
  const int h = a.h;
  const long off = e * h * W2;
  uint32_t v[R][W2];
  int pos[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = lane + 32 * i;
    pos[i] = row < h ? row : WARP_MAX_H;   // past h: never in range or moved
#pragma unroll
    for (int w = 0; w < W2; ++w) v[i][w] = 0u;
    if (row < h) load_row<NBW>(a.al0 + off + (long)row * W2, v[i]);
  }
  const int base = a.base_p[e];
  const int r_in = max(a.r0[e], base);
  const int hi_all = min(h, a.m - base);
  int* p_out = a.p_out + e * NB;
  int* q_out = a.q_out + e * NB;
  int r = r_in;
  Bits lb = 1u;                      // the multiplier bit of slot r - r_in
  uint32_t fmask = 0u;               // the group's steps that found a pivot
#pragma unroll
  for (int g = 0; g < NBW; ++g) {
    const int r_g = r;               // the rank at the group's first step
    fmask = 0u;
    int t_ps = 0;                    // lane sh: step sh's pivot position
#pragma unroll
    for (int sh = 0; sh < GROUP; ++sh) {
      const int rl = r - base;       // >= 0: r_in >= base
      int hi = hi_all;
      if (kSW) hi = min(hi, rl + a.search_window);
      // the first row in range with a 1: the least position, and who holds it
      const unsigned span = max(hi - rl, 0);
      unsigned key = UINT_MAX;
      bool bit[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        bit[i] = (v[i][g] >> sh) & 1u;
        if (bit[i] && (unsigned)(pos[i] - rl) < span)
          key = min(key, (unsigned)((pos[i] << 6) | (i << 5) | lane));
      }
      key = __reduce_min_sync(FULL, key);
      const int rs = min(rl, h - 1);
      const int ps = key != UINT_MAX ? (int)(key >> 6) : rs;
      if (lane == sh) t_ps = ps;
      if (key == UINT_MAX) continue;
      fmask |= 1u << sh;
      const int src = key & 31;
      const bool high = R > 1 && ((key >> 5) & 1u);
      uint32_t pw[NBW];
#pragma unroll
      for (int w = 0; w < NBW; ++w)
        pw[w] = __shfl_sync(FULL, high ? v[R - 1][w] : v[0][w], src);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pos[i] = pos[i] == rs ? ps : pos[i] == ps ? rs : pos[i];
        // the rows below the pivot (now at rl) with a 1
        const uint32_t el = (bit[i] && pos[i] > rl) ? FULL : 0u;
#pragma unroll
        for (int w = g; w < NBW; ++w) {   // columns <= j keep L in place
          const uint32_t keep = !kPres || w > g ? FULL
                              : sh == 31 ? 0u : FULL << (sh + 1);
          v[i][w] ^= pw[w] & keep & el;
        }
        if (!kPres) {
#pragma unroll
          for (int w = 0; w < g; ++w) v[i][w] ^= pw[w] & el;
        }
        v[i][NBW] ^= (uint32_t)lb & el;
        if (NBW > 1) v[i][W2 - 1] ^= (uint32_t)((uint64_t)lb >> 32) & el;
      }
      lb <<= 1;
      ++r;
    }
    // lane sh's step: its rank from the pivots before it, its swap; it
    // writes slot (rank - r_in), which a step that finds nothing shares with
    // the next step, so the writer that stays is the one that found a pivot
    // there or the group's last step (a later group's steps follow)
    const int rb = r_g + __popc(fmask & ((1u << lane) - 1u));
    int* tw = a.touched + e * 2 * NB + 2 * (g * GROUP + lane);
    tw[0] = max(0, min(rb - base, h - 1));
    tw[1] = t_ps;
    if (g) __syncwarp();             // the previous group's slots first
    if (((fmask >> lane) & 1u) || lane == GROUP - 1) {
      p_out[rb - r_in] = t_ps;
      q_out[rb - r_in] = g * GROUP + lane;
    }
  }
  const int last = r - r_in - (int)(fmask >> 31);   // the last slot written
#pragma unroll
  for (int k = 0; k < NBW; ++k)
    if (GROUP * k + lane > last) {
      p_out[GROUP * k + lane] = 0;
      q_out[GROUP * k + lane] = 0;
    }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = lane + 32 * i;
    if (row < h) {
      store_row<NBW>(a.al + off + (long)pos[i] * W2, v[i]);
      a.rowperm[e * h + pos[i]] = row;
    }
  }
  if (lane == 0) a.r_out[e] = r;
}

// The floor of a chain of dependent block-wide steps at a block size: each
// step is what no pivot loop can do without: a shared-memory round trip
// through another thread's word, a warp ballot, one barrier.
__global__ void __launch_bounds__(MAX_THREADS, 1)
chain_floor_kernel(int steps, int* out) {
  __shared__ uint32_t s[2][MAX_THREADS];
  const int tid = threadIdx.x, T = blockDim.x;
  uint32_t v = tid;
  s[0][tid] = v;
  __syncthreads();
  for (int k = 0; k < steps; ++k) {
    const uint32_t other = s[k & 1][(tid + 33) % T];
    const unsigned b = __ballot_sync(FULL, (other >> (k & 31)) & 1u);
    v = v * 1664525u + b + other;
    s[(k + 1) & 1][tid] = v;   // the other buffer: its readers are a barrier back
    __syncthreads();
  }
  if (v == 0x9e3779b9u) *out = 1;   // keeps the chain alive
}

// Per device: the shared memory a block may ask for, the SM count, and
// whether the kernels have been allowed that much yet.
struct Card { int cap = -1, sms = 0; bool allowed = false; };
constexpr int MAX_CARDS = 64;
static Card g_cards[MAX_CARDS];

inline Card* card() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_CARDS)
    return nullptr;
  Card& cd = g_cards[dev];
  if (cd.cap < 0) {
    int cap = 0, sms = 0;
    if (cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return nullptr;
    cd.sms = sms;
    cd.cap = cap;
  }
  return &cd;
}

inline int panel_threads(int h) {
  const int t = (h + 31) / 32 * 32;
  return t < 128 ? 128 : t > MAX_THREADS ? MAX_THREADS : t;
}

// Dynamic shared memory of a mode, in bytes.
inline size_t panel_smem(int mode, int h, int nbw, int threads) {
  size_t words = 2 * GROUP * 2 * nbw + 128 * nbw;
  if (mode != kTall) words += h;   // c[]
  words += mode == kShared ? 2 * (size_t)h + (size_t)h * (nbw + 1) : threads;
  return words * 4;
}

// The mode a window runs in: the one asked for, or under kAuto the first of
// SHARED, GRID, TALL that fits.  -1 when it does not fit the card's shared
// memory (nothing is clamped) or its rows outgrow the search key.
inline int panel_mode(int requested, int h, int nbw, int threads) {
  Card* cd = card();
  if (!cd || h >= (1 << 26)) return -1;
  const size_t room = cd->cap > 2048 ? (size_t)cd->cap - 2048 : 0;  // static part
  for (int mode : {kShared, kGrid, kTall})
    if ((requested == kAuto || requested == mode) &&
        panel_smem(mode, h, nbw, threads) <= room)
      return mode;
  return -1;
}

// Once a card: the most shared memory a block of each mode may ask for.
// The batched launch's instances that keep several windows an SM: block
// size and the least blocks an SM it is compiled for.
using PanelFn = void (*)(PanelArgs);
using PanelWarpFn = void (*)(PanelArgs, int);

// The warp kernel's instance for a search window given or not, L preserved
// or not.
template <int N, int R>
PanelWarpFn warp_fn(bool sw, bool pres) {
  return sw ? (pres ? panel_warp_kernel<N, R, true, true>
                    : panel_warp_kernel<N, R, true, false>)
            : (pres ? panel_warp_kernel<N, R, false, true>
                    : panel_warp_kernel<N, R, false, false>);
}
struct Resident { int threads; PanelFn fn; };
static const Resident RESIDENT[] = {
    {256, panel_kernel<false, false, 256, 3>},
    {576, panel_kernel<false, false, 576, 2>}};

inline cudaError_t allow_kernels(Card* cd) {
  if (!cd) return cudaErrorInvalidDevice;
  if (!cd->allowed) {
    for (auto kernel : {panel_kernel<false, false>, panel_kernel<true, false>,
                        panel_kernel<true, true>, RESIDENT[0].fn,
                        RESIDENT[1].fn}) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cd->cap - 2048);
      if (err != cudaSuccess) return err;
    }
    for (const Resident& rs : RESIDENT) {   // shared memory before L1
      cudaError_t err = cudaFuncSetAttribute(
          rs.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
    }
    cd->allowed = true;
  }
  return cudaSuccess;
}

// The batched launch: which kernel, its block size and dynamic shared
// memory.  kind 1: a warp a window; 2: a block a window, several an SM; 3: a
// block a window, one an SM (the single call's configuration); -1: nothing
// fits.  Kind 2 takes, of the instances that keep two or more windows an SM,
// the one that runs the batch in the fewest waves, the larger block on a
// tie; it is taken only where the batch outnumbers the SMs.
struct BatchedPlan { int kind, threads, grid; size_t smem; PanelFn fn; };

inline BatchedPlan batched_plan(int h, int nbw, int batch) {
  BatchedPlan pl{-1, 0, 0, 0, nullptr};
  if (h <= WARP_MAX_H && nbw <= WARP_MAX_NBW) {
    pl.kind = 1;
    pl.threads = WARP_WINDOWS * 32;
    pl.grid = (batch + WARP_WINDOWS - 1) / WARP_WINDOWS;
    return pl;
  }
  const int one = panel_threads(h);
  if (panel_mode(kShared, h, nbw, one) != kShared) return pl;
  Card* cd = card();
  if (!cd || allow_kernels(cd) != cudaSuccess) return pl;
  pl.smem = panel_smem(kShared, h, nbw, one);
  pl.grid = batch;
  pl.kind = 3;
  pl.threads = one;
  pl.fn = panel_kernel<false, false>;
  if (batch <= cd->sms) return pl;
  long best_waves = LONG_MAX;
  for (const Resident& rs : RESIDENT) {   // from the smallest block up
    const int t = one < rs.threads ? one : rs.threads;
    int fit = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, rs.fn, t,
                                                      pl.smem) != cudaSuccess)
      return BatchedPlan{-1, 0, 0, 0, nullptr};
    if (fit < 2) continue;
    const long per_wave = (long)fit * cd->sms;
    const long waves = (batch + per_wave - 1) / per_wave;
    if (waves <= best_waves) {
      best_waves = waves;
      pl.kind = 2;
      pl.threads = t;
      pl.fn = rs.fn;
    }
  }
  return pl;
}

}  // namespace gf2

// 1 SHARED, 2 GRID, 3 TALL; -1 if `requested` (0 = choose) does not fit.
extern "C" int gf2_panel_loop_hopper_mode(int requested, int h, int nbw) {
  return gf2::panel_mode(requested, h, nbw, gf2::panel_threads(h));
}

// The block size a window of h rows takes.
extern "C" int gf2_panel_loop_hopper_threads(int h) {
  return gf2::panel_threads(h);
}

// Words of device scratch a launch needs (the hand-over of GRID and TALL
// modes and TALL's word column; any mode may be given it).
extern "C" long gf2_panel_loop_hopper_scratch_words(int h, int nbw) {
  return 2 * (long)h + sizeof(gf2::GroupMeta) / 4 + (long)gf2::GROUP * nbw;
}

// al0: [h, 2*nbw] words, contiguous; al: output of the same shape; rowperm:
// [h] ints; r_out: one int; touched: [2*nb]; p_out, q_out: [nb]; r0: one int
// on the device, or null and the rank in r0_val (>= base either way: a rank
// above the window is taken as base); scratch:
// gf2_panel_loop_hopper_scratch_words words.
// row_work = 0 leaves every group's end out (no row is moved or updated): the
// chain alone, for timing only.  Returns cudaGetLastError().
extern "C" int gf2_panel_loop_hopper_launch(
    const void* al0, void* al, void* rowperm, void* r_out, void* touched,
    void* p_out, void* q_out, const void* r0, void* scratch, int base, int m,
    int h, int nbw, int preserve_l, int search_window, int requested_mode,
    int row_work, int r0_val, void* stream) {
  using namespace gf2;
  if (nbw < 1 || nbw > MAX_NBW || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = panel_threads(h);
  const int mode = panel_mode(requested_mode, h, nbw, threads);
  if (mode < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Card* cd = card();
  if (cudaError_t err = allow_kernels(cd)) return static_cast<int>(err);
  const size_t bytes = panel_smem(mode, h, nbw, threads);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  PanelArgs a;
  a.al0 = static_cast<const uint32_t*>(al0);
  a.al = static_cast<uint32_t*>(al);
  a.rowperm = static_cast<int*>(rowperm);
  a.r_out = static_cast<int*>(r_out);
  a.touched = static_cast<int*>(touched);
  a.p_out = static_cast<int*>(p_out);
  a.q_out = static_cast<int*>(q_out);
  a.r0 = static_cast<const int*>(r0);
  a.base_p = nullptr;
  a.cnext = sc;
  a.cdev = sc + h;
  a.meta_g = reinterpret_cast<GroupMeta*>(sc + 2 * (size_t)h);
  a.tab_g = sc + 2 * (size_t)h + sizeof(GroupMeta) / 4;
  a.base = base; a.m = m; a.h = h; a.nbw = nbw; a.preserve_l = preserve_l;
  a.search_window = search_window; a.row_work = row_work; a.r0_val = r0_val;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kShared) {
    panel_kernel<false, false><<<1, threads, bytes, st>>>(a);
  } else {
    // one block an SM at most (the chain's block fills one); enough blocks
    // that a block's share of the rows is a few warps' worth
    int blocks = (h + 127) / 128;
    if (blocks > cd->sms) blocks = cd->sms;
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(
        mode == kTall ? reinterpret_cast<void*>(panel_kernel<true, true>)
                      : reinterpret_cast<void*>(panel_kernel<true, false>),
        dim3(blocks), dim3(threads), args, bytes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched call: batch windows, each [h, 2*nbw] words, stacked
// contiguously in al0 (16-byte aligned); outputs stacked likewise (al,
// rowperm [B, h], r_out [B], touched [B, 2*nb], p_out, q_out [B, nb]); r0,
// base: B ints on the card each (r0 >= base, else taken as base).  A window
// that fits neither a warp nor mode SHARED is refused
// (cudaErrorInvalidConfiguration).  *kind receives the kind of kernel
// launched (batched_plan).
extern "C" int gf2_panel_loop_hopper_batched_launch(
    const void* al0, void* al, void* rowperm, void* r_out, void* touched,
    void* p_out, void* q_out, const void* r0, const void* base, int batch,
    int m, int h, int nbw, int preserve_l, int search_window, int* kind,
    void* stream) {
  using namespace gf2;
  if (nbw < 1 || nbw > MAX_NBW || h < 1 || batch < 1 || !r0 || !base)
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchedPlan pl = batched_plan(h, nbw, batch);
  if (kind) *kind = pl.kind;
  if (pl.kind < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  PanelArgs a{};
  a.al0 = static_cast<const uint32_t*>(al0);
  a.al = static_cast<uint32_t*>(al);
  a.rowperm = static_cast<int*>(rowperm);
  a.r_out = static_cast<int*>(r_out);
  a.touched = static_cast<int*>(touched);
  a.p_out = static_cast<int*>(p_out);
  a.q_out = static_cast<int*>(q_out);
  a.r0 = static_cast<const int*>(r0);
  a.base_p = static_cast<const int*>(base);
  a.m = m; a.h = h; a.nbw = nbw; a.preserve_l = preserve_l;
  a.search_window = search_window; a.row_work = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.kind == 1) {
    const bool sw = search_window > 0, pres = preserve_l != 0;
    const PanelWarpFn fn =
        nbw == 1 ? (h <= 32 ? warp_fn<1, 1>(sw, pres)
                            : warp_fn<1, 2>(sw, pres))
                 : (h <= 32 ? warp_fn<2, 1>(sw, pres)
                            : warp_fn<2, 2>(sw, pres));
    fn<<<pl.grid, pl.threads, 0, st>>>(a, batch);
  } else {
    void* args[] = {&a};
    cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(pl.fn),
                                       dim3(pl.grid), dim3(pl.threads), args,
                                       pl.smem, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// `steps` dependent steps of a barrier, a ballot and a shared-memory round
// trip in one block of `threads` threads.  out: one int on the device.
extern "C" int gf2_panel_chain_floor_launch(int steps, int threads, void* out,
                                            void* stream) {
  if (threads < 32 || threads > gf2::MAX_THREADS || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  gf2::chain_floor_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
