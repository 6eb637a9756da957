// The streaming frontier fold, hand-written for Hopper (sm_90a).
//
// Replaces the reference's XLA program for the fold, not a Pallas kernel:
// jepsen_tpu/checker/streamlin.py:_build_fold (:124-297), a lax.scan over
// the events, a lax.cond per event and a bounded lax.while_loop of closure
// passes per return, compiled into one jitted program. Its counterpart in
// plain PyTorch is fold_kernel.plain (a host loop over events); this kernel
// computes the same function, bit for bit, in one launch: every event of
// every lane and every closure pass of every return, with no host read in
// between.
//
// The function, per lane (one stream's frontier: F rows of a B-word bitset
// `lin` and an S-word state `st`, a `live` mask, the open-slot set `open_w`):
// an invoke event sets its slot in open_w; a return event of slot s runs the
// BFS closure: every config still without s (the work set) expands by every
// open op (the first C open slots, ascending) whose model step succeeds;
// the pool (the seen rows, pool index = row, then the candidates, pool index
// F + f*C + j) is ordered by (h1, h2, h3, h4, pool index) over the valid
// entries, h1..h4 the four multiply-shift fingerprints of fold_kernel.plain;
// an entry whose four fingerprints equal its predecessor's is a duplicate;
// the survivors take rows 0.. in that order, a rank past F is dropped and
// sets overflow. Passes stop when no work is left, at overflow, or at C + 1
// passes. A return with more than C open slots overflows at once. After a
// return the frontier is the rows that hold s; none is a violation. A lane
// whose status is not 0 treats every later event as a no-op. clear_w is
// applied once, at the end.
//
// What bounds it. A pass depends on the pass before it, and a return on the
// return before it, so a lane is a chain of passes; the lanes are
// independent. Its bytes stay in L2 (a few MB a lane), so the kernel is
// bound by the latency of a pass's dependent phases (block barriers, L2 and
// shared-memory round trips) times the passes, not by bytes or operations.
// The design keeps a pass's work proportional to what changed in it:
//
// 1. One block per lane (JF_T threads: 512, whose 128 registers a thread
//    leave the pass's arrays unspilled; 1024 threads spilled at 64), so
//    the lanes run on K SMs with no grid-wide barrier (folds run
//    concurrently from several threads, and a cooperative grid could
//    deadlock against another fold's blocks).
// 2. Fingerprints are carried per row. The input rows are fingerprinted
//    once, at the fold's start; a new row's fingerprints are written with
//    it. A fingerprint is a sum mod 2^32 of per-word terms, so a
//    candidate's is its parent's plus, for the one bitset word that gains
//    the slot and for each state word the step changes, the new word's
//    term minus the old one's: O(1 + S) mixes, not O(B + S) loads and
//    4(B + S) mixes.
// 3. Rows stay where they were written. They live in a heap of F slots
//    (bitsets, states, fingerprints), and an order array says which slot
//    holds row f. A pass whose candidates fit in the heap's free slots
//    appends its new rows and rewrites only the order: a row that was one
//    costs a 4-byte write, not a copy. A pass without the room copies its
//    kept rows, in order, into the other heap and the heaps swap. The
//    outputs are gathered in row order once, at the fold's end.
// 4. Only the candidates are sorted. After a pass the rows 0..rows-1 are
//    strictly increasing in (h1..h4) with pool index = row, so the next
//    pass merges them, as they are, with the sorted candidates (merge path:
//    each thread binary-searches its diagonal, the seen rows first on a
//    full tie, since their pool index is below F). At a return's first
//    pass the seen rows are the live ones, ascending: a block-wide OR over
//    adjacent pairs says whether they are in order (they are not at a
//    fold's start, after the caller's rows or after clear_w); if not, that
//    pass sorts them with the candidates. Either way the order is exact.
// 5. The sort is a block-wide LSD radix sort of (h1, entry) by h1's top 16
//    bits, two 8-bit digits, stable, with up to 4 items per thread in
//    registers (as few as the pool needs): ranks within a warp from
//    __match_any_sync, per-(digit, warp) counters in shared memory, one
//    block scan per digit pass. A pool of more than one tile sorts tile by
//    tile between two global buffers after a histogram. A run equal in
//    those bits is left in pool-index order; only where a block-wide OR
//    finds one out of (h1, h2, h3, h4, pool index) order (a few pairs a
//    pass, mostly none), one thread a run insertion-sorts it. Sorting the
//    other 16 bits too took two more digit passes than these fix-ups cost.
// 6. The pool lives in dynamic shared memory (24 bytes an entry: h1, the
//    entry index, h2..h4 with the pool index) when it fits, up to
//    smem_items entries (at most a sort tile, JF_TILE); otherwise the same
//    code runs over the global scratch. Shared memory stays small (62 KB
//    with the static part), because what the SM's 256 KB leave is L1,
//    which holds the rows, orders and fingerprints the pass gathers:
//    staging the seen rows' keys in shared memory for the merge was
//    slower on the card. The merge, the dedup and the compaction are one sweep per
//    JF_TILE outputs: a block scan of (kept, kept-and-fresh, back to work)
//    gives each survivor its row, its slot and the next pass's work list.
// 7. Block scans take two barriers (their buffer alternates); rows at a
//    return are scanned only below the last pass's rows.
//
// What does not apply: wgmma and the tensor cores (no matrix product, only
// integer hashing, sorting and scans); TMA (a lane's rows, 256 KB at
// F = 8192, do not fit in shared memory beside the pool, and are read by
// scattered parent indices, not as tiles). A cluster of blocks per lane is
// not done (PERF.md says why).
//
// fold_kernel.plan owns the scratch layout (per lane: the two row heaps,
// the two orders, the seen and work lists, the open ops, the global pool)
// and the shared pool's capacity, and passes them in a JfLayout; nothing
// here recomputes them.
//
// With `clk` set, thread 0 adds its clock64() cycles per phase, and some
// counts, into clk[lane * JF_STATS ...] (fold_kernel.STAT_NAMES); the
// outputs do not change.
//
// The model step is a switch on a model id: 0 register, 1 cas-register,
// 2 mutex (S = 1), 3 multi-register (S = A, any width), mirroring
// _register_step, _cas_step, _mutex_step and _multi_step of
// jepsen_tpu_torch/models, NIL = -2^31 included.

#include <cuda_runtime.h>
#include <stdint.h>

#define JF_NIL (-2147483647 - 1)
#ifndef JF_T
#define JF_T 512
#endif
#define JF_W (JF_T / 32)
#define JF_FULL 0xffffffffu
#define JF_IPT 4                 // sort items / merge outputs per thread
#define JF_TILE (JF_T * JF_IPT)  // a sort tile, a merge sweep
#define JF_RADIX 256
#define JF_CPT (JF_RADIX * JF_W / JF_T)  // digit counters per thread: 8
#define JF_ENTRY 24              // shared-pool bytes per entry
#define JF_B_REF 0x80000000u     // a merge output taken from the sorted pool
#define JF_OPS_SMEM 1024         // the open ops' words kept in shared memory
#define JF_SORT_FROM 2           // the sort's first 8-bit digit of h1
// the bits of h1 the sort orders by: a run of entries equal in them is left
// in pool-index order, for the fix-up; an even number of digit passes ends
// a multi-tile sort in its first buffer
#define JF_SORT_MASK (~((1u << (8 * JF_SORT_FROM)) - 1u))
static_assert(JF_T % 32 == 0 && JF_T >= JF_RADIX && JF_T <= 1024,
              "a block is whole warps, one thread per digit at least");

// per-lane statistics: thread 0's cycles per phase, then counts
#define JF_STATS 16
enum {
  JF_S_SEEN, JF_S_CAND, JF_S_SORT, JF_S_MERGE, JF_S_COMPACT, JF_S_RETURN,
  JF_S_PASSES, JF_S_ENTRIES, JF_S_CANDS, JF_S_FULL, JF_S_GLOBAL, JF_S_FIXUP,
  JF_S_RETURNS, JF_S_IN_PLACE, JF_S_MAX, JF_S_TILES
};
#define JF_MARK(i)                                 \
  do {                                             \
    if (clk != nullptr && tid == 0) {              \
      const long long t_ = clock64();              \
      acc[i] += t_ - t_prev;                       \
      t_prev = t_;                                 \
    }                                              \
  } while (0)
#define JF_COUNT(i, v)                             \
  do {                                             \
    if (clk != nullptr && tid == 0) acc[i] += (v); \
  } while (0)

// Per-lane scratch: byte offsets into a lane's slice of lane_bytes, and the
// shared pool's capacity in entries, from fold_kernel.plan.
struct JfLayout {
  long long lane_bytes;
  long long lin0, st0, fp0;  // row heap 0: F slots of B uint32, S int32, uint4
  long long lin1, st1, fp1;  // row heap 1
  long long ord0, ord1;      // F int32 each: row -> heap slot, two buffers
  long long alist;     // F int32: the seen rows at a return's first pass
  long long worklist;  // F int32: the rows to expand, ascending
  long long workslot;  // F int32: their heap slots
  long long ops;       // C * (2 + 2A) int32: open slots, f, args, rets
  long long key0, val0, key1, val1;  // P uint32 each: h1, entry index
  long long ent;       // P uint4: h2, h3, h4, pool index
  long long smem_items;  // entries of the shared pool (at most JF_TILE)
};

// Whether op (f, a, r) may run from state st (S words).
__device__ __forceinline__ bool jf_ok(int model, const int* st, int S, int f,
                                      const int* a, const int* r) {
  switch (model) {
    case 0: {  // register: F_READ 0, F_WRITE 1 (any f but 1 reads)
      const int v = st[0];
      return f == 1 || r[0] == JF_NIL || r[0] == v;
    }
    case 1: {  // cas-register: F_READ 0, F_WRITE 1, F_CAS 2
      const int v = st[0];
      return f == 1 || (f == 2 && v == a[0]) ||
             (f == 0 && (r[0] == JF_NIL || r[0] == v));
    }
    case 2:  // mutex: F_ACQUIRE 0, F_RELEASE 1
      return f == 0 ? st[0] == 0 : st[0] == 1;
    default: {  // multi-register: F_READ 0, F_WRITE 1
      if (f == 1) return true;
      for (int i = 0; i < S; ++i)
        if (r[i] != JF_NIL && r[i] != st[i]) return false;
      return true;
    }
  }
}

// Word i of the state after op (f, a) from st.
__device__ __forceinline__ int jf_post(int model, const int* st, int i, int f,
                                       const int* a) {
  switch (model) {
    case 0:
      return f == 1 ? a[0] : st[0];
    case 1: {
      const int v = st[0];
      return f == 1 ? a[0] : ((f == 2 && v == a[0]) ? a[1] : v);
    }
    case 2:
      return f == 0 ? 1 : 0;
    default:
      return (f == 1 && a[i] != JF_NIL) ? a[i] : st[i];
  }
}

__device__ __forceinline__ uint32_t jf_mix(uint32_t w, uint32_t c) {
  uint32_t t = w * c;
  t ^= t >> 15;
  t *= 0x2C1B3C6Du;
  t ^= t >> 12;
  return t;
}

// The four fingerprints of a row: its B bitset words, then its S state
// words. cols holds the four per-word multiplier rows, B + S each.
__device__ __forceinline__ uint4 jf_fp(const uint32_t* lin, int B,
                                       const int* st, int S,
                                       const uint32_t* __restrict__ cols) {
  const int n = B + S;
  uint32_t h[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < n; ++i) {
    const uint32_t w = i < B ? lin[i] : (uint32_t)st[i - B];
#pragma unroll
    for (int c = 0; c < 4; ++c) h[c] += jf_mix(w, __ldg(cols + c * n + i));
  }
  return make_uint4(h[0], h[1], h[2], h[3]);
}

// h with word i's term for w_old replaced by w_new's, in all four sums.
__device__ __forceinline__ void jf_refp(uint32_t h[4], int i, int n,
                                        uint32_t w_old, uint32_t w_new,
                                        const uint32_t* __restrict__ cols) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t m = __ldg(cols + c * n + i);
    h[c] += jf_mix(w_new, m) - jf_mix(w_old, m);
  }
}

// Row (src_lin, src_st) into (dl, ds), bitset word bw OR'd with bb: every
// load of up to 16 bitset words (in 16-byte pieces where B allows) and 4
// state words is issued before the first store, so a row costs one round
// trip to L2, not one a word.
__device__ __forceinline__ void jf_copy_row(
    const uint32_t* __restrict__ src_lin, const int32_t* __restrict__ src_st,
    uint32_t* __restrict__ dl, int32_t* __restrict__ ds, int B, int S,
    int bw, uint32_t bb) {
  const int nb = (B & 3) == 0 ? B : 0;  // words moved 16 bytes at a time
  for (int y0 = 0; y0 < B || y0 < 4 * S; y0 += 16) {
    uint4 v[4];
    uint32_t w[16];
    int32_t t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (y0 + 4 * u < nb) v[u] = ((const uint4*)src_lin)[(y0 >> 2) + u];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (y0 + u >= nb && y0 + u < B) w[u] = src_lin[y0 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (y0 / 4 + u < S) t[u] = src_st[y0 / 4 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (y0 + 4 * u < nb) {
        const int b0 = y0 + 4 * u;
        v[u].x |= b0 == bw ? bb : 0u;
        v[u].y |= b0 + 1 == bw ? bb : 0u;
        v[u].z |= b0 + 2 == bw ? bb : 0u;
        v[u].w |= b0 + 3 == bw ? bb : 0u;
        ((uint4*)dl)[(y0 >> 2) + u] = v[u];
      }
#pragma unroll
    for (int u = 0; u < 16; ++u)
      if (y0 + u >= nb && y0 + u < B)
        dl[y0 + u] = w[u] | (y0 + u == bw ? bb : 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (y0 / 4 + u < S) ds[y0 / 4 + u] = t[u];
  }
}

// Ask for p's line in L1 ahead of its use (a no-op off the card).
__device__ __forceinline__ void jf_prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// (h1, h2, h3, h4) order.
__device__ __forceinline__ bool jf_le(uint4 a, uint4 b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.z != b.z) return a.z < b.z;
  return a.w <= b.w;
}

__device__ __forceinline__ bool jf_eq(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// Whether entry a orders before entry b among equal h1: (h2, h3, h4, pool
// index).
__device__ __forceinline__ bool jf_less(uint4 a, uint4 b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.z != b.z) return a.z < b.z;
  return a.w < b.w;
}

// Whether sorted-pool entry (ka, ea) orders before (kb, eb): (h1, h2, h3,
// h4, pool index), with h1 in the key and the rest in the entry.
__device__ __forceinline__ bool jf_before(uint32_t ka, uint4 ea, uint32_t kb,
                                          uint4 eb) {
  return ka != kb ? ka < kb : jf_less(ea, eb);
}

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread calls every scan, in the same order. sh alternates between two
// buffers (par), so a scan's reads end before the next but one writes: two
// barriers a scan. Two counts travel packed, one in each 32-bit half of a
// long long; a single count scans as an int, with half the shuffles.
template <typename T>
__device__ __forceinline__ T jf_scan(T v, T* total, long long (*sh)[JF_W + 1],
                                     int& par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long* s = sh[par];
  par ^= 1;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(JF_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const T t = lane < JF_W ? (T)s[lane] : (T)0;
    T u = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(JF_FULL, u, o);
      if (lane >= o) u += y;
    }
    if (lane < JF_W) s[lane] = u - t;
    if (lane == JF_W - 1) s[JF_W] = u;
  }
  __syncthreads();
  *total = (T)s[JF_W];
  return (T)s[warp] + x - v;
}

#define JF_LO(x) ((int)((x) & 0xffffffffLL))
#define JF_C21(x, i) ((int)(((x) >> (21 * (i))) & 0x1fffffLL))
#define JF_HI(x) ((int)((x) >> 32))

// Stable LSD radix sort of the pairs (k0[i], v0[i]), i < n, by key, four
// 8-bit digits; the result is in (k0, v0). A pool of one tile sorts in
// place: each pass loads every item into registers, and barriers separate
// the loads from the scatter. A larger pool alternates with (k1, v1), tile
// by tile after a histogram of the digit, four passes, so it ends in (k0,
// v0). A tile's items sit warp-striped, ipt to a thread, as few as hold
// the tile (warp w holds items w*32*ipt .., item i of lane l at i*32 + l),
// so (digit, warp, item, lane) order is the input order.
__device__ void jf_sort(uint32_t* k0, uint32_t* v0, uint32_t* k1,
                        uint32_t* v1, int n, uint16_t* cnt, int* base,
                        long long (*sh)[JF_W + 1], int& par) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool one = n <= JF_TILE;
  for (int pass = JF_SORT_FROM; pass < 4; ++pass) {
    const int shift = 8 * pass;
    const bool odd = !one && ((pass - JF_SORT_FROM) & 1);
    const uint32_t* ki = odd ? k1 : k0;
    const uint32_t* vi = odd ? v1 : v0;
    uint32_t* ko = one ? k0 : (odd ? k0 : k1);
    uint32_t* vo = one ? v0 : (odd ? v0 : v1);
    if (!one) {  // where each digit starts in the whole pool
      if (tid < JF_RADIX) base[tid] = 0;
      __syncthreads();
      for (int i = tid; i < n; i += JF_T)
        atomicAdd(&base[(ki[i] >> shift) & 255u], 1);
      __syncthreads();
      const int c = tid < JF_RADIX ? base[tid] : 0;
      int tot;
      const int pre = jf_scan(c, &tot, sh, par);
      if (tid < JF_RADIX) base[tid] = pre;
    }
    for (int t0 = 0; t0 < n; t0 += JF_TILE) {
      const int m = min(n - t0, JF_TILE);
      const int ipt = (m + JF_T - 1) / JF_T;  // items a thread holds
      uint32_t k[JF_IPT], v[JF_IPT];
      int r[JF_IPT];
      for (int x = tid; x < JF_RADIX * JF_W / 2; x += JF_T)
        ((uint32_t*)cnt)[x] = 0u;
#pragma unroll
      for (int i = 0; i < JF_IPT; ++i) {
        const int idx = warp * 32 * ipt + i * 32 + lane;
        k[i] = i < ipt && idx < m ? ki[t0 + idx] : 0xffffffffu;  // pads last
        v[i] = i < ipt && idx < m ? vi[t0 + idx] : 0u;
      }
      __syncthreads();
      // ranks within (digit, warp), in (item, lane) order
#pragma unroll
      for (int i = 0; i < JF_IPT; ++i) {
        if (i >= ipt) break;
        const int d = (int)((k[i] >> shift) & 255u);
        const uint32_t peers = __match_any_sync(JF_FULL, d);
        const int old = cnt[d * JF_W + warp];
        __syncwarp();
        if (lane == __ffs(peers) - 1)
          cnt[d * JF_W + warp] = (uint16_t)(old + __popc(peers));
        __syncwarp();
        r[i] = old + __popc(peers & ((1u << lane) - 1u));
      }
      __syncthreads();
      // the counters' exclusive prefix in (digit, warp) order: one scan
      int c[JF_CPT], sum = 0;
#pragma unroll
      for (int x = 0; x < JF_CPT; ++x) {
        c[x] = cnt[tid * JF_CPT + x];
        sum += c[x];
      }
      int tot;
      int run = jf_scan(sum, &tot, sh, par);
#pragma unroll
      for (int x = 0; x < JF_CPT; ++x) {
        cnt[tid * JF_CPT + x] = (uint16_t)run;
        run += c[x];
      }
      __syncthreads();
      int nb = 0;  // the digit's start for the next tile
      if (!one && tid < JF_RADIX) {
        const int first = cnt[tid * JF_W];
        const int end = tid < JF_RADIX - 1 ? cnt[(tid + 1) * JF_W] : m;
        nb = base[tid] + end - first;
      }
#pragma unroll
      for (int i = 0; i < JF_IPT; ++i) {
        const int idx = warp * 32 * ipt + i * 32 + lane;
        if (i < ipt && idx < m) {
          const int d = (int)((k[i] >> shift) & 255u);
          const int dst = (one ? 0 : base[d] - cnt[d * JF_W]) +
                          cnt[d * JF_W + warp] + r[i];
          ko[dst] = k[i];
          vo[dst] = v[i];
        }
      }
      __syncthreads();
      if (!one && tid < JF_RADIX) base[tid] = nb;
    }
  }
}

// One lane per block: lin (K,F,B), st (K,F,S), live (K,F) uint8, open_w
// (K,B), w_f (K,NW), w_args/w_ret (K,NW,A), clear_w (K,B), ev (K,2,E): kinds
// then slots; cols (4,B+S) uint32. Outputs lin_out, st_out, live_out,
// open_out shaped as the inputs, res (K,5): status, viol, passes, steps,
// n_live. Dynamic shared memory: the shared pool, JF_ENTRY bytes an entry.
__global__ void __launch_bounds__(JF_T)
jf_fold_kernel(const uint32_t* __restrict__ lin_in,
               const int32_t* __restrict__ st_in,
               const uint8_t* __restrict__ live_in,
               const uint32_t* __restrict__ open_in,
               const int32_t* __restrict__ w_f,
               const int32_t* __restrict__ w_args,
               const int32_t* __restrict__ w_ret,
               const uint32_t* __restrict__ clear_w,
               const uint32_t* __restrict__ cols,
               const int32_t* __restrict__ ev, uint32_t* lin_out,
               int32_t* st_out, uint8_t* live_out, uint32_t* open_out,
               int32_t* res, unsigned char* scratch, const JfLayout L, int F,
               int B, int S, int A, int C, int E, int model,
               long long* clk) {
  extern __shared__ __align__(16) unsigned char jf_smem[];
  __shared__ long long sh[2][JF_W + 1];
  __shared__ __align__(16) uint16_t cnt[JF_RADIX * JF_W];
  __shared__ int base[JF_RADIX];
  __shared__ long long acc[JF_STATS];
  __shared__ int32_t ops_smem[JF_OPS_SMEM];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NW = B * 32, n_words = B + S;
  const size_t FB = (size_t)F * B, FS = (size_t)F * S;
  const int M = (int)L.smem_items;
  int par = 0;
  long long t_prev = 0;
  if (clk != nullptr && tid < JF_STATS) acc[tid] = 0;
  if (clk != nullptr && tid == 0) t_prev = clock64();

  unsigned char* lane_base = scratch + (size_t)k * L.lane_bytes;
  int32_t* alist = (int32_t*)(lane_base + L.alist);
  int32_t* wl = (int32_t*)(lane_base + L.worklist);
  // the open ops: slots, f, args, rets; in shared memory where they fit
  int32_t* o_slot = (size_t)C * (2 + 2 * A) <= JF_OPS_SMEM
                        ? ops_smem : (int32_t*)(lane_base + L.ops);
  int32_t* o_f = o_slot + C;
  int32_t* o_a = o_f + C;
  int32_t* o_r = o_a + (size_t)C * A;
  uint32_t* gkey1 = (uint32_t*)(lane_base + L.key1);
  uint32_t* gval1 = (uint32_t*)(lane_base + L.val1);

  uint32_t* linO = lin_out + (size_t)k * FB;
  int32_t* stO = st_out + (size_t)k * FS;
  uint8_t* liveO = live_out + (size_t)k * F;
  uint32_t* openO = open_out + (size_t)k * B;
  const int32_t* wf = w_f + (size_t)k * NW;
  const int32_t* wa = w_args + (size_t)k * NW * A;
  const int32_t* wr = w_ret + (size_t)k * NW * A;
  const int32_t* kinds = ev + (size_t)k * 2 * E;
  const int32_t* slots = kinds + E;

  // the frontier's rows live in a heap of F slots with their
  // fingerprints, and row f (the f-th in the fold's order) is in slot
  // cur_ord[f]. A pass that has room appends its new rows to the heap in
  // use and rewrites only the order; one that has not copies its rows, in
  // order, into the other heap (slot = row) and the heaps swap
  uint32_t* cur_lin = (uint32_t*)(lane_base + L.lin0);
  int32_t* cur_st = (int32_t*)(lane_base + L.st0);
  uint4* cur_fp = (uint4*)(lane_base + L.fp0);
  uint32_t* alt_lin = (uint32_t*)(lane_base + L.lin1);
  int32_t* alt_st = (int32_t*)(lane_base + L.st1);
  uint4* alt_fp = (uint4*)(lane_base + L.fp1);
  int32_t* cur_ord = (int32_t*)(lane_base + L.ord0);
  int32_t* alt_ord = (int32_t*)(lane_base + L.ord1);
  int32_t* wslot = (int32_t*)(lane_base + L.workslot);
  int heap_top = F;  // the heap's slots in use (the input fills it)
  int cur_rows = F;  // the rows that hold configs
  int live_hi = F;   // no row from here on is live

  for (size_t i = tid; i < FB; i += JF_T) cur_lin[i] = lin_in[k * FB + i];
  for (size_t i = tid; i < FS; i += JF_T) cur_st[i] = st_in[k * FS + i];
  for (int i = tid; i < F; i += JF_T) liveO[i] = live_in[(size_t)k * F + i];
  for (int i = tid; i < B; i += JF_T) openO[i] = open_in[(size_t)k * B + i];
  // the input rows' fingerprints, once; row f in slot f
  for (int f = tid; f < F; f += JF_T) {
    cur_fp[f] = jf_fp(lin_in + k * FB + (size_t)f * B, B,
                      st_in + k * FS + (size_t)f * S, S, cols);
    cur_ord[f] = f;
  }
  __syncthreads();
  JF_MARK(JF_S_SEEN);

  int status = 0, viol = -1, passes = 0, steps = 0;
  for (int t = 0; t < E && status == 0; ++t) {
    const int kind = kinds[t];
    if (kind != 1 && kind != 2) continue;
    const int s = min(max(slots[t], 0), NW - 1);
    const int word = s >> 5;
    const uint32_t bit = 1u << (s & 31);
    if (kind == 1) {  // invoke: the slot opens
      if (tid == 0) openO[word] |= bit;
      __syncthreads();
      continue;
    }
    JF_COUNT(JF_S_RETURNS, 1);

    // -- a return of slot s: the open ops, the first C ascending ----------
    int n_open = 0;
    for (int w0 = 0; w0 < B; w0 += JF_T) {
      const int w = w0 + tid;
      uint32_t ow = w < B ? openO[w] : 0u;
      int tot;
      int r = n_open + jf_scan(__popc(ow), &tot, sh, par);
      for (; ow; ow &= ow - 1, ++r) {
        if (r >= C) break;
        const int sl = (w << 5) + __ffs(ow) - 1;
        o_slot[r] = sl;
        o_f[r] = wf[sl];
        for (int i = 0; i < A; ++i) {
          o_a[(size_t)r * A + i] = wa[(size_t)sl * A + i];
          o_r[(size_t)r * A + i] = wr[(size_t)sl * A + i];
        }
      }
      n_open += tot;
    }
    const int nj = min(n_open, C);
    bool ovf = n_open > C;

    // the seen rows (live, ascending) and the work list (live, without s):
    // thread tid takes R rows, so one scan orders both lists
    int n_a, n_wl;
    {
      const int R = (live_hi + JF_T - 1) / JF_T;
      const int f0 = min(tid * R, live_hi), f1 = min(f0 + R, live_hi);
      int na = 0, nw = 0;
      for (int f = f0; f < f1; ++f)
        if (liveO[f]) {
          ++na;
          nw += !(cur_lin[(size_t)cur_ord[f] * B + word] & bit);
        }
      long long tot;
      const long long pre = jf_scan(na + ((long long)nw << 32), &tot, sh, par);
      int ia = JF_LO(pre), iw = JF_HI(pre);
      for (int f = f0; f < f1; ++f)
        if (liveO[f]) {
          const int h = cur_ord[f];
          alist[ia++] = f;
          if (!(cur_lin[(size_t)h * B + word] & bit)) {
            wslot[iw] = h;
            wl[iw++] = f;
          }
        }
      n_a = JF_LO(tot);
      n_wl = JF_HI(tot);
    }
    __syncthreads();
    bool go = n_wl > 0 && !ovf;
    // whether the seen rows are in (h1..h4) order: else this return's first
    // pass sorts them with its candidates
    bool full = false;
    if (go) {
      int bad = 0;
      for (int i = tid + 1; i < n_a; i += JF_T)
        bad |= !jf_le(cur_fp[cur_ord[alist[i - 1]]],
                      cur_fp[cur_ord[alist[i]]]);
      full = __syncthreads_or(bad) != 0;
    }
    int p = 0, stp = steps, rows = n_a;
    JF_MARK(JF_S_SEEN);

    while (go) {
      // -- B. the candidates (pool index F + f*C + j) whose step succeeds --
      // thread tid takes the (work row, op) pairs q0..q1-1, so one scan of
      // its counts writes them in pool-index order
      const int nq = n_wl * nj;
      const int Q = (nq + JF_T - 1) / JF_T;
      const int q0 = min(tid * Q, nq), q1 = min(q0 + Q, nq);
      const int w0 = q0 < q1 ? q0 / nj : 0, j0 = q0 - w0 * nj;
      const int n_am = full ? 0 : rows;  // the sorted seen rows to merge
      int nv = 0, npok = 0;
      unsigned long long vmask = 0ull;  // the first 64 pairs' verdicts
#define JF_NEXT_PAIR ++q, j = j + 1 == nj ? 0 : j + 1, w += j == 0
      for (int q = q0, w = w0, j = j0; q < q1; JF_NEXT_PAIR) {
        const int h = wslot[w], sl = o_slot[j];
        if (j == j0 || j == 0) jf_prefetch_l1(cur_fp + h);  // for sweep 2
        const bool pok =
            !((cur_lin[(size_t)h * B + (sl >> 5)] >> (sl & 31)) & 1u);
        const bool v = pok && jf_ok(model, cur_st + (size_t)h * S, S, o_f[j],
                                    o_a + (size_t)j * A, o_r + (size_t)j * A);
        npok += pok;
        nv += v;
        if (v && q - q0 < 64) vmask |= 1ull << (q - q0);
      }
      long long tot;
      const long long pre = jf_scan(nv + ((long long)npok << 32), &tot, sh,
                                    par);
      const int n_c = JF_LO(tot), d_steps = JF_HI(tot);
      const int n_b = (full ? rows : 0) + n_c;
      // the pool: h2..h4 and pool index, h1, entry index (n_b each)
      const bool in_smem = n_b <= M;
      unsigned char* pool = jf_smem;
      uint4* ent = in_smem ? (uint4*)pool : (uint4*)(lane_base + L.ent);
      uint32_t* key = in_smem ? (uint32_t*)(pool + 16 * n_b)
                              : (uint32_t*)(lane_base + L.key0);
      uint32_t* val = in_smem ? key + n_b : (uint32_t*)(lane_base + L.val0);
      if (full)  // the seen rows enter the pool first
        for (int i = tid; i < rows; i += JF_T) {
          const int f = alist[i];
          const uint4 h = cur_fp[cur_ord[f]];
          key[i] = h.x;
          val[i] = i;
          ent[i] = make_uint4(h.y, h.z, h.w, (uint32_t)f);
        }
      int e = n_b - n_c + JF_LO(pre);
      for (int q = q0, w = w0, j = j0; q < q1; JF_NEXT_PAIR) {
        if (q - q0 < 64 && !((vmask >> (q - q0)) & 1ull)) continue;
        const int f = wl[w], hs = wslot[w], sl = o_slot[j];
        const uint32_t wo = cur_lin[(size_t)hs * B + (sl >> 5)];
        const int* ps = cur_st + (size_t)hs * S;
        const int* oa = o_a + (size_t)j * A;
        if (q - q0 >= 64 &&
            (((wo >> (sl & 31)) & 1u) ||
             !jf_ok(model, ps, S, o_f[j], oa, o_r + (size_t)j * A)))
          continue;
        const uint4 hp = cur_fp[hs];
        uint32_t h[4] = {hp.x, hp.y, hp.z, hp.w};
        jf_refp(h, sl >> 5, n_words, wo, wo | (1u << (sl & 31)), cols);
        for (int y = 0; y < S; ++y) {
          const uint32_t so = (uint32_t)ps[y];
          const uint32_t sn = (uint32_t)jf_post(model, ps, y, o_f[j], oa);
          if (sn != so) jf_refp(h, B + y, n_words, so, sn, cols);
        }
        key[e] = h[0];
        val[e] = e;
        ent[e] = make_uint4(h[1], h[2], h[3], (uint32_t)(F + f * C + j));
        ++e;
      }
#undef JF_NEXT_PAIR
      __syncthreads();
      JF_MARK(JF_S_CAND);
      JF_COUNT(JF_S_ENTRIES, n_am + n_b);
      JF_COUNT(JF_S_CANDS, n_c);
      JF_COUNT(JF_S_FULL, full);
      JF_COUNT(JF_S_GLOBAL, !in_smem);
      JF_COUNT(JF_S_TILES, n_b > JF_TILE);

      if (clk != nullptr && tid == 0 && n_am + n_b > acc[JF_S_MAX])
        acc[JF_S_MAX] = n_am + n_b;

      // -- C. the pool sorted by h1, stably --------------------------------
      jf_sort(key, val, gkey1, gval1, n_b, cnt, base, sh, par);
      JF_MARK(JF_S_SORT);

      // -- D. runs equal in the sorted bits, out of order, into order -------
      // a run the sort left in pool-index order is out of order only where
      // its entries differ in h1's other bits or in h2..h4: one thread a run
      // insertion-sorts it by (h1, h2, h3, h4, pool index)
      {
        int bad = 0;
        for (int i = tid + 1; i < n_b; i += JF_T)
          if (((key[i - 1] ^ key[i]) & JF_SORT_MASK) == 0)
            bad |= jf_before(key[i], ent[val[i]], key[i - 1], ent[val[i - 1]]);
        if (__syncthreads_or(bad)) {
          JF_COUNT(JF_S_FIXUP, 1);
          for (int i = tid; i < n_b; i += JF_T) {
            if (i > 0 && ((key[i - 1] ^ key[i]) & JF_SORT_MASK) == 0) continue;
            int end = i + 1;
            while (end < n_b && ((key[end] ^ key[i]) & JF_SORT_MASK) == 0)
              ++end;
            for (int a = i + 1; a < end; ++a) {
              const uint32_t xk = key[a], xv = val[a];
              const uint4 fx = ent[xv];
              int b = a - 1;
              while (b >= i && jf_before(xk, fx, key[b], ent[val[b]])) {
                key[b + 1] = key[b];
                val[b + 1] = val[b];
                --b;
              }
              key[b + 1] = xk;
              val[b + 1] = xv;
            }
          }
          __syncthreads();
        }
      }

      // -- D/E. merge, dedup and compaction into the other row buffer -------
      // the sorted seen rows (A: alist[i] at a return's first pass, else row
      // i) and the sorted pool (B), A first on a full tie; in each sweep a
      // thread takes `per` outputs from its diagonal on, as few as cover N
      const int N = n_am + n_b;
      const int per = min(JF_IPT, max(1, (N + JF_T - 1) / JF_T));
      const bool by_list = p == 0;
#define JF_AROW(i) (by_list ? (uint32_t)alist[i] : (uint32_t)(i))
#define JF_AKEY(i) cur_fp[cur_ord[JF_AROW(i)]]
#define JF_BKEY(i, eb) make_uint4(key[i], (eb).x, (eb).y, (eb).z)
      // the heap in use has room for every candidate: new rows append to
      // it; else every kept row is copied, in order, to the other heap
      const bool in_place = heap_top + n_c <= F;
      JF_COUNT(JF_S_IN_PLACE, in_place);
      int n_keep = 0, n_wl2 = 0, n_fresh = 0;
      for (int r0 = 0; r0 < N; r0 += JF_T * per) {
        const int d0 = min(r0 + tid * per, N);
        const int nout = min(d0 + per, N) - d0;
        uint32_t ref[JF_IPT];
        uint32_t keepm = 0u, workm = 0u, freshm = 0u;
        if (nout > 0) {
          int lo = max(0, d0 - n_b), hi = min(d0, n_am);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            const int bi = d0 - 1 - mid;
            const uint4 eb = ent[val[bi]];
            if (jf_le(JF_AKEY(mid), JF_BKEY(bi, eb)))
              lo = mid + 1;
            else
              hi = mid;
          }
          int ia = lo, ib = d0 - lo;
          uint4 ka = make_uint4(0u, 0u, 0u, 0u), kb = ka, prev = ka;
          uint32_t pb = 0u;
          bool has_prev = d0 > 0;
          if (ia > 0) prev = JF_AKEY(ia - 1);
          if (ib > 0) {  // the later of the two in merge order
            const uint4 eb = ent[val[ib - 1]];
            const uint4 hb = JF_BKEY(ib - 1, eb);
            if (ia == 0 || jf_le(prev, hb)) prev = hb;
          }
          bool va = ia < n_am, vb = ib < n_b;
          if (va) ka = JF_AKEY(ia);
          if (vb) {
            const uint4 eb = ent[val[ib]];
            kb = JF_BKEY(ib, eb);
            pb = eb.w;
          }
#pragma unroll
          for (int x = 0; x < JF_IPT; ++x) {
            ref[x] = 0u;
            if (x < nout) {
              const bool take_a = va && (!vb || jf_le(ka, kb));
              const uint4 h = take_a ? ka : kb;
              const uint32_t pi = pb;
              if (take_a) {
                ref[x] = (uint32_t)ia;
                ++ia;
                va = ia < n_am;
                if (va) ka = JF_AKEY(ia);
              } else {
                ref[x] = JF_B_REF | (uint32_t)ib;
                ++ib;
                vb = ib < n_b;
                if (vb) {
                  const uint4 eb = ent[val[ib]];
                  kb = JF_BKEY(ib, eb);
                  pb = eb.w;
                }
              }
              if (!has_prev || !jf_eq(h, prev)) {
                keepm |= 1u << x;
                if (!take_a && pi >= (uint32_t)F) freshm |= 1u << x;
                // a fresh config goes back to work while it lacks s: its
                // parent lacked s, so it has s only if its op's slot is s
                if (!take_a && pi >= (uint32_t)F &&
                    o_slot[(pi - (uint32_t)F) % (uint32_t)C] != s)
                  workm |= 1u << x;
              }
              prev = h;
              has_prev = true;
            }
          }
        }
        JF_MARK(JF_S_MERGE);
        // three counts packed, 21 bits each: kept, back to work, fresh
        long long tot;
        const long long pre = jf_scan(
            __popc(keepm) + ((long long)__popc(workm) << 21) +
                ((long long)__popc(freshm) << 42),
            &tot, sh, par);
        // each kept output's owner writes it: a row that was one keeps its
        // slot (in place) or is copied to row r of the other heap; a fresh
        // one goes to the next free slot, or to row r of the other heap
        int r = n_keep + JF_C21(pre, 0), w = n_wl2 + JF_C21(pre, 1);
        int fr = heap_top + n_fresh + JF_C21(pre, 2);
#pragma unroll
        for (int x = 0; x < JF_IPT; ++x) {
          if (!((keepm >> x) & 1u)) continue;
          const bool fresh = (freshm >> x) & 1u;
          if (r < F) {
            uint32_t pi = ref[x];  // a seen row's index in A, or the pool's
            uint4 h = make_uint4(0u, 0u, 0u, 0u);
            int so = -1;          // an established row's heap slot
            if (pi & JF_B_REF) {
              const int ib = (int)(pi & ~JF_B_REF);
              const uint4 eb = ent[val[ib]];
              h = JF_BKEY(ib, eb);
              pi = eb.w;
              if (!fresh) so = cur_ord[pi];  // a seen row the pool sorted
            } else {
              so = cur_ord[JF_AROW(pi)];
            }
            int dst;
            if (!fresh) {  // an established config: it retires
              dst = in_place ? so : r;
              if (!in_place) {
                const uint4 hf = cur_fp[so];
                jf_copy_row(cur_lin + (size_t)so * B, cur_st + (size_t)so * S,
                            alt_lin + (size_t)r * B, alt_st + (size_t)r * S,
                            B, S, -1, 0u);
                alt_fp[r] = hf;
              }
            } else {  // a fresh one: its parent's row with one op applied
              const int c = (int)(pi - (uint32_t)F), f = c / C, j = c - f * C;
              const int sl = o_slot[j], ph = cur_ord[f];
              const int* ps = cur_st + (size_t)ph * S;
              dst = in_place ? fr : r;
              uint32_t* dl = (in_place ? cur_lin : alt_lin) + (size_t)dst * B;
              int32_t* ds = (in_place ? cur_st : alt_st) + (size_t)dst * S;
              jf_copy_row(cur_lin + (size_t)ph * B, ps, dl, ds, B, 0, sl >> 5,
                          1u << (sl & 31));
              for (int y = 0; y < S; ++y)
                ds[y] = jf_post(model, ps, y, o_f[j], o_a + (size_t)j * A);
              (in_place ? cur_fp : alt_fp)[dst] = h;
            }
            alt_ord[r] = dst;
            if ((workm >> x) & 1u) {
              wl[w] = r;
              wslot[w] = dst;
            }
          }
          w += (workm >> x) & 1u;
          fr += fresh;
          ++r;
        }
        n_keep += JF_C21(tot, 0);
        n_wl2 += JF_C21(tot, 1);
        n_fresh += JF_C21(tot, 2);
        JF_MARK(JF_S_COMPACT);
      }
#undef JF_AROW
#undef JF_AKEY
#undef JF_BKEY
      // rows past `rows` are read by nothing before the fold's end, which
      // writes them as zeros
      rows = min(n_keep, F);
      __syncthreads();
      ovf = ovf || n_keep > F;
      int32_t* to = cur_ord;
      cur_ord = alt_ord;
      alt_ord = to;
      if (in_place) {
        heap_top += n_fresh;
      } else {
        uint32_t* tl = cur_lin;
        cur_lin = alt_lin;
        alt_lin = tl;
        int32_t* ts = cur_st;
        cur_st = alt_st;
        alt_st = ts;
        uint4* tf = cur_fp;
        cur_fp = alt_fp;
        alt_fp = tf;
        heap_top = rows;
      }
      cur_rows = rows;
      full = false;
      ++p;
      stp += d_steps;
      n_wl = n_wl2;
      go = n_wl > 0 && !ovf && p < C + 1;
      JF_MARK(JF_S_COMPACT);
      JF_COUNT(JF_S_PASSES, 1);
    }

    // -- the frontier after the return: the rows that hold s ------------
    // (rows past live_hi were not live, nor are rows past a pass's rows)
    int fin = 0;
    const int f_hi = p > 0 ? max(live_hi, rows) : live_hi;
    for (int f = tid; f < f_hi; f += JF_T) {
      const bool seen = p > 0 ? f < rows : liveO[f] != 0;
      const uint8_t x =
          seen && (cur_lin[(size_t)cur_ord[f] * B + word] & bit);
      liveO[f] = x;
      fin |= x;
    }
    if (p > 0) live_hi = rows;
    fin = __syncthreads_or(fin);
    if (tid == 0) openO[word] &= ~bit;
    const bool violated = !fin && !ovf;
    status = ovf ? 2 : (violated ? 1 : 0);
    if (violated) viol = s;
    passes += p;
    steps = stp;
    __syncthreads();
    JF_MARK(JF_S_RETURN);
  }

  // the rows back into the outputs, zeros past the last pass's rows;
  // sealed slots cleared in every row
  const uint32_t* cw = clear_w + (size_t)k * B;
  for (size_t i = tid; i < FB; i += JF_T) {
    const int f = (int)(i / B), y = (int)(i - (size_t)f * B);
    linO[i] = f < cur_rows ? cur_lin[(size_t)cur_ord[f] * B + y] & ~cw[y] : 0u;
  }
  for (size_t i = tid; i < FS; i += JF_T) {
    const int f = (int)(i / S), y = (int)(i - (size_t)f * S);
    stO[i] = f < cur_rows ? cur_st[(size_t)cur_ord[f] * S + y] : 0;
  }
  int n_live = 0;
  for (int f = tid; f < F; f += JF_T) n_live += liveO[f];
  int tot;
  jf_scan(n_live, &tot, sh, par);
  if (tid == 0) {
    int32_t* rk = res + (size_t)k * 5;
    rk[0] = status;
    rk[1] = viol;
    rk[2] = passes;
    rk[3] = steps;
    rk[4] = tot;
  }
  JF_MARK(JF_S_RETURN);
  if (clk != nullptr && tid < JF_STATS)
    clk[(size_t)k * JF_STATS + tid] += acc[tid];
}

// A block of 1024 threads through `n` barriers, each after a shared write:
// the cost of one block-wide barrier, for the latency floor chip_smoke.py
// reports (a pass cannot take fewer than two: its expansion must finish
// before its dedup, its dedup before the next pass). It keeps the first
// kernel's block of 1024 threads, whatever JF_T is, so the floor stays
// comparable.
#define JF_PROBE_T 1024
__global__ void __launch_bounds__(JF_PROBE_T) jf_barrier_probe(int n,
                                                               int* out) {
  __shared__ int x[JF_PROBE_T];
  int v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    x[threadIdx.x] = v;
    __syncthreads();
    v += x[(threadIdx.x + 1) & (JF_PROBE_T - 1)];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = v;
}

extern "C" int jf_barrier_probe_launch(int n, void* out, void* stream) {
  jf_barrier_probe<<<1, JF_PROBE_T, 0, (cudaStream_t)stream>>>(n,
                                                                (int*)out);
  return (int)cudaGetLastError();
}

// One block per lane (K blocks). The layout is fold_kernel.plan's; scratch
// holds K * layout->lane_bytes; the shared pool takes JF_ENTRY bytes of
// dynamic shared memory an entry, whose ceiling is raised once, to the most
// a launch has asked for (an error there is returned). clocks is null or K * JF_STATS
// int64 to add the statistics into. Refused arguments return
// cudaErrorInvalidValue.
extern "C" int jf_fold_launch(const void* lin, const void* st,
                              const void* live, const void* open_w,
                              const void* w_f, const void* w_args,
                              const void* w_ret, const void* clear_w,
                              const void* cols, const void* ev,
                              void* lin_out, void* st_out, void* live_out,
                              void* open_out, void* res, void* scratch,
                              const JfLayout* layout, int K, int F, int B,
                              int S, int A, int C, int E, int model,
                              void* clocks, void* stream) {
  static int smem_ceiling = 0;
  if (K < 1 || F < 1 || B < 1 || S < 1 || A < 1 || C < 1 || E < 0 ||
      model < 0 || model > 3 || (model < 3 && S != 1) ||
      (model == 1 && A < 2) || (model == 3 && S != A) ||
      (long long)F * (C + 1) > 2147483647LL || scratch == nullptr ||
      layout == nullptr || layout->smem_items < 0 ||
      layout->smem_items > JF_TILE)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)layout->smem_items * JF_ENTRY;
  if (smem > __atomic_load_n(&smem_ceiling, __ATOMIC_ACQUIRE)) {
    const cudaError_t err = cudaFuncSetAttribute(
        jf_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int seen = __atomic_load_n(&smem_ceiling, __ATOMIC_ACQUIRE);
    while (seen < smem &&
           !__atomic_compare_exchange_n(&smem_ceiling, &seen, smem, false,
                                        __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE)) {
    }
  }
  jf_fold_kernel<<<K, JF_T, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)lin, (const int32_t*)st, (const uint8_t*)live,
      (const uint32_t*)open_w, (const int32_t*)w_f, (const int32_t*)w_args,
      (const int32_t*)w_ret, (const uint32_t*)clear_w, (const uint32_t*)cols,
      (const int32_t*)ev, (uint32_t*)lin_out, (int32_t*)st_out,
      (uint8_t*)live_out, (uint32_t*)open_out, (int32_t*)res,
      (unsigned char*)scratch, *layout, F, B, S, A, C, E, model,
      (long long*)clocks);
  return (int)cudaGetLastError();
}
