// Greedy WGL rollout for the single-key search, hand-written for Hopper
// (sm_90a).
//
// Replaces jepsen_tpu/checker/pallas_rollout.py:build_fused_rollout (the
// Pallas kernel at :210-284, launched at :286). Same contract, bit for bit:
// for each of NS seed configurations of one key, R greedy WGL steps. At a
// step, rm = min ret over the unlinearized ops; an op is eligible when it is
// unlinearized and invoke < rm; the chain takes the first eligible op in
// index (= priority) order whose model step succeeds, flips it out of the
// bitset and takes its post-state. Outputs j[s][t] (the op taken, -1 from
// the step the chain wedges onward) and st[s][t][:] (the state after the
// step, repeated once the chain is dead). A seed with seed_ok == 0 is dead
// from step 0. Padding rows (invoke INF32-1, ret INF32) need no special
// case: the rule above treats them exactly as the reference does.
//
// What bounds it. A chain is R dependent steps, and the work of one step is
// small (a few dozen ops near the chain's frontier), so the kernel is bound
// by the latency of one step times the chain's live steps, not by bytes
// (a few hundred KB per launch) or operations. Every design choice below
// cuts the dependent latency of a step or keeps it from growing with n.
//
// 1. rm is kept, not recomputed. Each chain keeps a min tree over its
//    bitset words: level 0 holds, per 32-op word, the min ret and the min
//    invoke over the word's unlinearized ops (INF32 when it has none); each
//    level above holds the mins of 32 entries below it, up to a top level of
//    at most 32 entries (2 levels at n = 8192, 3 at n = 131072, at most 4);
//    each level is padded to whole blocks of 32 so that every read is a
//    plain aligned warp load. rm = min(rest, the min over the frontier
//    word), where rest, the exact min ret outside the frontier word, is one
//    warp reduction over the siblings of the word's ancestors, taken when
//    the chain enters the word. When an op outside it is flipped, its word's
//    entry is recomputed by one warp (__reduce_min_sync over the 32 ops) and
//    carried up the levels, one pair of reductions each. Nothing assumes
//    that the ops are sorted by ret. The block builds the tree from the
//    seed bitset once, at the start of the launch.
// 2. The candidate search starts at the chain's frontier (the first bitset
//    word with an unlinearized op, which only moves forward) and stops at
//    the first 32-op tile with a hit. The frontier word is the first tile;
//    its ops live in registers (lane l holds op 32f+l's invoke, ret and
//    fields), so the common step -- the op taken is in the frontier word --
//    reads no memory and leaves the tree alone (the word's entry is written
//    back when the word fills up or a step must look past it). Past the
//    frontier word, the tiles to test are the words whose min invoke is
//    below rm: the tree finds the first block of 32 words that has any,
//    with one __ballot_sync per level, up then down, so words with no
//    eligible op are skipped, however many there are. A tile test is one
//    __ballot_sync over "unlinearized and invoke < rm and the model step
//    succeeds"; __ffs gives the lowest such op, which is the op the
//    reference's full sweep takes (the lowest eligible index whose step
//    succeeds). The worst case is a step whose eligible ops near the
//    frontier all fail, behind many words of eligible ops that fail too
//    (crashed ops: ret INF32, early invoke, so they sort to the tail and
//    are always eligible). There the search is widened: a round tests the
//    next JT_WIDE = 4 candidate words at once, every load issued before any
//    test, so a round costs about one word's latency. It stays in one warp
//    with no barrier, and a step whose first candidate word hits pays only
//    for the three other words' loads and ballots, issued beside it.
// 3. One warp rolls one chain. The step is warp-synchronous: registers,
//    warp reductions, ballots, a shuffle and, off the common path, shared
//    memory with __syncwarp; no __syncthreads. A block holds one chain, so
//    the NS chains run on NS SMs; the block's other warps only help stage
//    the columns and build the tree. (Eight chains per block, one warp
//    each, staging the columns once for all of them, was slower at every
//    shape measured: PERF.md.)
// 4. The hot columns are staged with Hopper's bulk asynchronous copy. Tile
//    tests read invoke and ret; where they and the model step's fields,
//    packed (24 bytes per op in all: 192 KB at n = 8192), fit in shared
//    memory beside the chain's state, one thread loads invoke and ret with
//    cp.async.bulk completing on an mbarrier while the other threads load
//    the seed bitset and pack the fields. Where they do not, every column
//    is read through L1/L2. Where the chain's state (bitset plus tree) does
//    not fit in shared memory, it lives in a global scratch buffer the
//    wrapper allocates. The kernel is compiled once per place (MODE) and
//    tree depth (NL), so every load is compiled for its memory.
//
// rollout.py:plan owns the layout -- the tree's levels, the state's size,
// where each part lives -- and passes it in a JtLayout; nothing here
// recomputes it.
//
// The model step is a switch on a model id (0 register, 1 cas-register,
// 2 mutex) mirroring _register_step, _cas_step and _mutex_step of
// jepsen_tpu_torch/models, NIL = -2^31 included; the state is one word.

#include <cuda_runtime.h>
#include <stdint.h>

#define JT_NIL (-2147483647 - 1)
#define JT_INF32 2147483647
#define JT_THREADS 1024
#define JT_WARPS (JT_THREADS / 32)
#define JT_FULL 0xffffffffu
#define JT_MAX_LEVELS 4
#define JT_WIDE 4  // words one search round tests at once

// The fields the model step reads, packed: {f, args[0], args[1] (0 when
// A == 1), rets[0]}.
__device__ __forceinline__ int4 jt_fields(const int* __restrict__ fop,
                                          const int* __restrict__ args,
                                          const int* __restrict__ rets, int i,
                                          int A) {
  const int* a = args + (size_t)i * A;
  return make_int4(__ldg(fop + i), __ldg(a), A > 1 ? __ldg(a + 1) : 0,
                   __ldg(rets + (size_t)i * A));
}

// Model step for one op: returns ok, writes the post-state to *nv. All
// three models are evaluated and one is selected, so the step compiles to
// selects, not branches.
__device__ __forceinline__ bool jt_step(int model, int v, int4 o, int* nv) {
  const int f = o.x, a0 = o.y, a1 = o.z, r0 = o.w;
  const bool f0 = f == 0, f1 = f == 1, f2 = f == 2;
  const bool read_ok = r0 == JT_NIL || r0 == v;
  const bool cas_ok = f2 && v == a0;
  // register: F_READ 0, F_WRITE 1 (any f but 1 reads)
  const int nv_reg = f1 ? a0 : v;
  const bool ok_reg = f1 || read_ok;
  // cas-register: F_READ 0, F_WRITE 1, F_CAS 2
  const int nv_cas = f1 ? a0 : (cas_ok ? a1 : v);
  const bool ok_cas = f1 || cas_ok || (f0 && read_ok);
  // mutex: F_ACQUIRE 0, F_RELEASE 1 (any f but 0 releases)
  const int nv_mtx = f0 ? 1 : 0;
  const bool ok_mtx = f0 ? v == 0 : v == 1;
  *nv = model == 0 ? nv_reg : (model == 1 ? nv_cas : nv_mtx);
  return model == 0 ? ok_reg : (model == 1 ? ok_cas : ok_mtx);
}

__device__ __forceinline__ int jt_min(int v) {
  return __reduce_min_sync(JT_FULL, v);
}

// The launch's layout, from rollout.py:plan. The min tree over B bitset
// words: level k has size[k] entries (.x = min ret, .y = min invoke),
// size[0] = B, size[k+1] = ceil(size[k] / 32), up to the first level of
// <= 32 entries; level k is stored padded to pad[k] = 32 * size[k+1]
// entries (32 at the top), the padding INF32, at off[k] (in int2 units),
// so that a warp reads any aligned block of 32 entries without a bounds
// test. A chain's state is the tree, then at lin_off the bitset padded to
// pad[0] words (the padding all ones: no op there), state_bytes in all.
// In shared memory: the mbarrier at 0, invoke and ret at 16, the packed
// fields at ops_off (when staged), the chain's state at state_off.
struct JtLayout {
  int size[JT_MAX_LEVELS];
  int pad[JT_MAX_LEVELS];
  int off[JT_MAX_LEVELS];
  long long lin_off;
  long long state_bytes;
  long long ops_off;
  long long state_off;
};

// The words at or after lb whose min invoke over unlinearized ops is < rm
// (each holds an eligible op), as far as the first block of 32 level-0
// entries that has one: that block's first word and the mask of such words
// in it, at or after lb (0 when no word is left). Up the levels from lb
// until a level has such an entry at or after the position, then down to
// level 0 taking the first such child: one ballot per level visited.
struct JtNext {
  int base;
  uint32_t mask;
};

template <int NL>
__device__ __forceinline__ JtNext jt_next_words(const int2* tree,
                                                const JtLayout& tr, int lb,
                                                int rm, int lane) {
  int pos = lb, found = -1;
  JtNext nx = {lb & ~31, 0u};
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    if (found < 0) {
      const int base = pos & ~31;
      const bool in = pos < tr.pad[k];
      const int y = tree[tr.off[k] + min(base, tr.pad[k] - 32) + lane].y;
      const uint32_t m = __ballot_sync(JT_FULL, y < rm) &
                         (in ? JT_FULL << (pos & 31) : 0u);
      if (m) {
        if (k == 0) nx.mask = m;
        pos = base + __ffs(m) - 1;
        found = k;
      } else {
        pos = (pos >> 5) + 1;  // the rest of this block is done: go up
      }
    }
  }
  if (found < 0) return nx;
#pragma unroll
  for (int k = NL - 2; k >= 0; --k) {
    if (k < found) {  // an entry < rm has a child < rm: the min says so
      const int y = tree[tr.off[k] + (pos << 5) + lane].y;
      const uint32_t m = __ballot_sync(JT_FULL, y < rm);
      if (k == 0) nx = {pos << 5, m};
      pos = (pos << 5) + __ffs(m) - 1;
    }
  }
  return nx;
}

// The blocks of 32 entries that hold word w's entry and each of its
// ancestors, one per level, loaded together.
template <int NL>
__device__ __forceinline__ void jt_tree_blocks(const int2* tree,
                                               const JtLayout& tr, int w,
                                               int lane, int2 (&blk)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k)
    blk[k] = tree[tr.off[k] + ((w >> (5 * k)) & ~31) + lane];
}

// Word pos's level-0 entry became (rmin, imin): write it and carry it up
// the levels (blk from jt_tree_blocks), one pair of warp reductions per
// level and no ballot or branch between them. Returns the min over the
// top level. The callers do not need it, but this form (the top-level
// reduction included) ran the kernel 15-22% faster at n = 8192 on an
// NVIDIA H100 80GB HBM3 at 700 W than one that skips it (PERF.md, design
// steps).
template <int NL>
__device__ __forceinline__ int jt_tree_update(int2* tree, const JtLayout& tr,
                                              const int2 (&blk)[NL], int pos,
                                              int rmin, int imin, int lane) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    int2 ch = blk[k];
    if (lane == (pos & 31)) {
      ch = make_int2(rmin, imin);
      tree[tr.off[k] + pos] = ch;
    }
    rmin = jt_min(ch.x);
    if (k + 1 < NL) imin = jt_min(ch.y);
    pos >>= 5;
  }
  return rmin;
}

// First word >= from that still has an unlinearized op, else B (the
// padding words are all ones).
__device__ __forceinline__ int jt_frontier(const uint32_t* lin, int B,
                                           int from, int lane) {
  for (int b = from & ~31; b < B; b += 32) {
    const uint32_t m = __ballot_sync(JT_FULL, lin[b + lane] != JT_FULL) &
                       (b < from ? JT_FULL << (from & 31) : JT_FULL);
    if (m) return b + __ffs(m) - 1;
  }
  return B;
}

// The frontier word f held in registers: lw its bits; lane l's op 32f+l's
// invoke, ret and step fields; rest the min ret over the unlinearized ops
// outside word f (exact while no other word changes).
struct JtWord {
  uint32_t lw;
  int inv, ret, rest;
  int4 o;
};

// Word f into registers, and the min ret outside it: per level, the
// entries of f's ancestor block other than f's ancestor itself, then one
// warp reduction.
template <int NL, bool OPS>
__device__ __forceinline__ JtWord jt_enter(
    const uint32_t* lin, const int2* tree, const JtLayout& tr, const int* inv,
    const int* rt, const int4* ops, const int* __restrict__ fop,
    const int* __restrict__ args, const int* __restrict__ rets, int A, int f,
    int lane) {
  JtWord fw;
  const int i = (f << 5) + lane;
  fw.lw = lin[f];
  fw.inv = inv[i];
  fw.ret = rt[i];
  fw.o = OPS ? ops[i] : jt_fields(fop, args, rets, i, A);
  int r = JT_INF32;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int pk = f >> (5 * k);
    const int x = tree[tr.off[k] + (pk & ~31) + lane].x;
    r = lane == (pk & 31) ? r : min(r, x);
  }
  fw.rest = jt_min(r);
  return fw;
}

// Write word f's bits and tree entry back (the change carried up).
template <int NL>
__device__ __forceinline__ void jt_flush(uint32_t* lin, int2* tree,
                                         const JtLayout& tr, const JtWord& fw,
                                         int f, int lane) {
  const bool u = !((fw.lw >> lane) & 1u);
  int2 blk[NL];
  jt_tree_blocks<NL>(tree, tr, f, lane, blk);
  if (lane == 0) lin[f] = fw.lw;
  jt_tree_update<NL>(tree, tr, blk, f, jt_min(u ? fw.ret : JT_INF32),
                     jt_min(u ? fw.inv : JT_INF32), lane);
  __syncwarp();
}

__device__ __forceinline__ void jt_mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void jt_mbar_expect(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the mbarrier's phase `parity` to complete. A copy that never
// lands traps (the launch fails) after ~2^26 tries instead of hanging.
__device__ __forceinline__ void jt_mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on the mbarrier.
__device__ __forceinline__ void jt_bulk_load(void* dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(d),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// MODE says where the data lives, so that every load is compiled for its
// memory (LDS for shared, LDG for global): 0 chain state in global
// scratch, op columns global; 1 state in shared memory; 2 also invoke/ret
// (bulk copy) and the step's fields, packed, in shared memory. One block
// per chain.
template <int NL, int MODE>
__global__ void __launch_bounds__(JT_THREADS)
jt_rollout_kernel(const uint32_t* __restrict__ seed_lin,
                  const int32_t* __restrict__ seed_st,
                  const uint8_t* __restrict__ seed_ok,
                  const int32_t* __restrict__ invoke,
                  const int32_t* __restrict__ ret,
                  const int32_t* __restrict__ fop,
                  const int32_t* __restrict__ args,
                  const int32_t* __restrict__ rets,
                  int32_t* __restrict__ j_out, int32_t* __restrict__ st_out,
                  unsigned char* scratch, const JtLayout tr, int R, int n,
                  int B, int A, int model) {
  constexpr bool STATE_SMEM = MODE >= 1, STAGED = MODE == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s = blockIdx.x;
  const bool live = seed_ok[s] != 0;  // the same for the whole block

  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  int* s_cols = (int*)(smem + 16);
  const int* inv = STAGED ? s_cols : invoke;
  const int* rt = STAGED ? s_cols + n : ret;
  int4* ops = (int4*)(smem + tr.ops_off);
  unsigned char* state = STATE_SMEM ? smem + tr.state_off
                                    : scratch + (size_t)s * tr.state_bytes;
  int2* tree = (int2*)state;
  uint32_t* lin = (uint32_t*)(state + tr.lin_off);
  if (STAGED && tid == 0) jt_mbar_init(bar);
  __syncthreads();
  if (STAGED && tid == 0) {
    jt_mbar_expect(bar, (uint32_t)(8 * n));
    jt_bulk_load(s_cols, invoke, (uint32_t)(4 * n), bar);
    jt_bulk_load(s_cols + n, ret, (uint32_t)(4 * n), bar);
  }
  // while the bulk copy runs: the seed bitset (padding words all ones)
  // and the packed fields
  for (int w = tid; w < tr.pad[0]; w += JT_THREADS)
    lin[w] = w < B ? seed_lin[(size_t)s * B + w] : JT_FULL;
  if (STAGED)
    for (int i = tid; i < n; i += JT_THREADS)
      ops[i] = jt_fields(fop, args, rets, i, A);
  if (STAGED) jt_mbar_wait(bar, 0);
  __syncthreads();

  // build the tree of a live chain: level 0 from the ops, one warp per
  // word; each level above from the one below, one warp per entry;
  // padding entries INF32
  if (live) {
    for (int w = warp; w < tr.pad[0]; w += JT_WARPS) {
      int2 e = make_int2(JT_INF32, JT_INF32);
      if (w < B) {
        const int i = (w << 5) + lane;
        const bool u = !((lin[w] >> lane) & 1u);
        e = make_int2(jt_min(u ? rt[i] : JT_INF32),
                      jt_min(u ? inv[i] : JT_INF32));
      }
      if (lane == 0) tree[w] = e;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 1; k < NL; ++k) {
    if (live) {
      for (int e = warp; e < tr.pad[k]; e += JT_WARPS) {
        int2 x = make_int2(JT_INF32, JT_INF32);
        if (e < tr.size[k]) {
          x = tree[tr.off[k - 1] + (e << 5) + lane];
          x = make_int2(jt_min(x.x), jt_min(x.y));
        }
        if (lane == 0) tree[tr.off[k] + e] = x;
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;

  // one warp rolls chain s. The frontier word f (the first with an
  // unlinearized op) lives in registers (fw, see JtWord). If word f holds
  // an eligible op whose
  // step succeeds, it is the op to take (no lower index is unlinearized),
  // so such a step reads no memory and leaves the tree alone: the tree's
  // entry for f is stale (dirty) until word f fills up or a step has to
  // search past it, and is flushed then.
  int32_t* jrow = j_out + (size_t)s * R;
  int32_t* srow = st_out + (size_t)s * R;
  int v = seed_st[s];  // S == 1
  bool alive = live;
  int f = B;
  bool dirty = false;
  JtWord fw = {JT_FULL, JT_INF32, JT_INF32, JT_INF32, make_int4(0, 0, 0, 0)};
#define JT_ENTER()                                                         \
  jt_enter<NL, STAGED>(lin, tree, tr, inv, rt, ops, fop, args, rets, A, f, lane)
  if (alive) {
    f = jt_frontier(lin, B, 0, lane);
    if (f < B) fw = JT_ENTER();
  }
  int t = 0;
  for (; alive && t < R; ++t) {
    int jf = -1;
    if (f < B) {
      const bool fu = !((fw.lw >> lane) & 1u);
      const int rm = min(fw.rest, jt_min(fu ? fw.ret : JT_INF32));
      int nv;
      const bool stepped = jt_step(model, v, fw.o, &nv);
      const uint32_t m = __ballot_sync(JT_FULL, fu & (fw.inv < rm) & stepped);
      if (m) {  // the op is in word f
        const int l = __ffs(m) - 1;
        jf = (f << 5) + l;
        v = __shfl_sync(JT_FULL, nv, l);
        fw.lw |= 1u << l;
        dirty = true;
        if (fw.lw == JT_FULL) {  // word f is done: on to the next frontier
          jt_flush<NL>(lin, tree, tr, fw, f, lane);
          dirty = false;
          f = jt_frontier(lin, B, f + 1, lane);
          if (f < B) fw = JT_ENTER();
        }
      } else {  // past word f: the tree finds the next words to test
        if (dirty) jt_flush<NL>(lin, tree, tr, fw, f, lane);
        dirty = false;
        uint32_t cand = 0;  // words of block `base` left to test
        int base = 0;
        for (int lb = f + 1;;) {
          if (!cand) {
            const JtNext nx = jt_next_words<NL>(tree, tr, lb, rm, lane);
            if (!nx.mask) break;  // no word left with an eligible op
            base = nx.base;
            cand = nx.mask;
          }
          // the next JT_WIDE candidate words, tested at once: every load
          // is issued before any test, so a round costs about one word's
          // latency
          int wk[JT_WIDE], nvk[JT_WIDE];
          uint32_t lwk[JT_WIDE], mk[JT_WIDE];
          int ivk[JT_WIDE];
          int4 ok4[JT_WIDE];
          bool has[JT_WIDE];
#pragma unroll
          for (int k = 0; k < JT_WIDE; ++k) {
            has[k] = cand != 0;
            wk[k] = has[k] ? base + __ffs(cand) - 1 : base;
            cand &= cand - 1;
          }
#pragma unroll
          for (int k = 0; k < JT_WIDE; ++k) {
            const int i = (wk[k] << 5) + lane;
            lwk[k] = lin[wk[k]];
            ivk[k] = inv[i];
            ok4[k] = STAGED ? ops[i] : make_int4(0, 0, 0, 0);
          }
#pragma unroll
          for (int k = 0; k < JT_WIDE; ++k) {
            const bool elig =
                has[k] && !((lwk[k] >> lane) & 1u) && ivk[k] < rm;
            if (!STAGED && elig)
              ok4[k] = jt_fields(fop, args, rets, (wk[k] << 5) + lane, A);
            const bool ok = jt_step(model, v, ok4[k], &nvk[k]);
            mk[k] = __ballot_sync(JT_FULL, elig & ok);
          }
          int w = -1, l = 0, nw = 0;  // the first word with a hit
#pragma unroll
          for (int k = JT_WIDE - 1; k >= 0; --k) {
            if (mk[k]) {
              w = wk[k];
              l = __ffs(mk[k]) - 1;
              nw = nvk[k];
            }
          }
          if (w >= 0) {
            jf = (w << 5) + l;
            v = __shfl_sync(JT_FULL, nw, l);
            const int i = (w << 5) + lane;
            int2 blk[NL];
            jt_tree_blocks<NL>(tree, tr, w, lane, blk);
            const uint32_t lw = lin[w];
            const int iv = inv[i], ri = rt[i];
            __syncwarp();
            if (lane == 0) lin[w] = lw | (1u << l);
            const bool u2 = !((lw >> lane) & 1u) && lane != l;
            jt_tree_update<NL>(tree, tr, blk, w, jt_min(u2 ? ri : JT_INF32),
                               jt_min(u2 ? iv : JT_INF32), lane);
            __syncwarp();
            fw = JT_ENTER();  // word w changed what lies outside word f
            break;
          }
          lb = base + 32;  // used once every word of block `base` failed
        }
      }
    }
    if (jf < 0) {
      alive = false;  // wedged: this step and the rest are -1
      break;
    }
    if (lane == 0) {
      jrow[t] = jf;
      srow[t] = v;
    }
  }
#undef JT_ENTER
  for (int u = t + lane; u < R; u += 32) {
    jrow[u] = -1;
    srow[u] = v;
  }
}

// The common step alone, for the latency floor chip_smoke.py reports:
// one warp whose frontier word is in registers and every op of it
// eligible, rolled `steps` steps -- the rm reduction, the model step, the
// ballot, __ffs and the shuffle of the state, the same dependent chain as
// the common step above, with no memory access. `f` is the ops' function
// (1, a write, succeeds in every model but mutex's release from 0), a
// parameter so that the model step is not folded away; the word refills
// when it is full. out[0], out[1]: the final state and bits.
__global__ void jt_step_probe(int model, int f, int steps, int* out) {
  const int lane = threadIdx.x;
  const int inv = lane, ret = 1000 + lane, rest = JT_INF32 - f;
  const int4 o = make_int4(f, lane, lane + 1, lane);
  uint32_t lw = 0;
  int v = 0;
  for (int t = 0; t < steps; ++t) {
    const bool fu = !((lw >> lane) & 1u);
    const int rm = min(rest, jt_min(fu ? ret : JT_INF32));
    int nv;
    const bool stepped = jt_step(model, v, o, &nv);
    const uint32_t m = __ballot_sync(JT_FULL, fu & (inv < rm) & stepped);
    if (m) {
      const int l = __ffs(m) - 1;
      v = __shfl_sync(JT_FULL, nv, l);
      lw |= 1u << l;
      if (lw == JT_FULL) lw = 0;
    } else {
      lw = 0;
    }
  }
  if (lane == 0) {
    out[0] = v;
    out[1] = (int)lw;
  }
}

extern "C" int jt_step_probe_launch(int model, int f, int steps, void* out,
                                    void* stream) {
  jt_step_probe<<<1, 32, 0, (cudaStream_t)stream>>>(model, f, steps,
                                                    (int*)out);
  return (int)cudaGetLastError();
}

template <int NL, int MODE>
static int jt_launch(int NS, size_t smem, cudaStream_t stream,
                     const void* seed_lin, const void* seed_st,
                     const void* seed_ok, const void* invoke, const void* ret,
                     const void* fop, const void* args, const void* rets,
                     void* j_out, void* st_out, void* scratch,
                     const JtLayout& tr, int R, int n, int B, int A,
                     int model) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        jt_rollout_kernel<NL, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  jt_rollout_kernel<NL, MODE><<<NS, JT_THREADS, smem, stream>>>(
      (const uint32_t*)seed_lin, (const int32_t*)seed_st,
      (const uint8_t*)seed_ok, (const int32_t*)invoke, (const int32_t*)ret,
      (const int32_t*)fop, (const int32_t*)args, (const int32_t*)rets,
      (int32_t*)j_out, (int32_t*)st_out, (unsigned char*)scratch, tr, R, n,
      B, A, model);
  return (int)cudaGetLastError();
}

template <int NL>
static int jt_launch_mode(int mode, int NS, size_t smem, cudaStream_t strm,
                          const void* seed_lin, const void* seed_st,
                          const void* seed_ok, const void* invoke,
                          const void* ret, const void* fop, const void* args,
                          const void* rets, void* j_out, void* st_out,
                          void* scratch, const JtLayout& tr, int R, int n,
                          int B, int A, int model) {
#define JT_ARGS                                                              \
  NS, smem, strm, seed_lin, seed_st, seed_ok, invoke, ret, fop, args, rets,  \
      j_out, st_out, scratch, tr, R, n, B, A, model
  switch (mode) {
    case 0: return jt_launch<NL, 0>(JT_ARGS);
    case 1: return jt_launch<NL, 1>(JT_ARGS);
    default: return jt_launch<NL, 2>(JT_ARGS);
  }
}

// One block per chain (NS blocks). The layout is rollout.py:plan's:
// `levels` tree levels, `staged` op columns in shared memory (needs
// state_smem and 16-byte aligned invoke/ret, as the bulk copy does),
// `state_smem` the chain's state in shared memory, else in `scratch`
// (NS * tr->state_bytes), `smem` dynamic shared bytes. Refused
// combinations return cudaErrorInvalidValue or cudaErrorMisalignedAddress.
extern "C" int jt_rollout_launch(const void* seed_lin, const void* seed_st,
                                 const void* seed_ok, const void* invoke,
                                 const void* ret, const void* fop,
                                 const void* args, const void* rets,
                                 void* j_out, void* st_out, void* scratch,
                                 const JtLayout* layout, int NS, int R, int n,
                                 int B, int A, int model, int levels,
                                 int staged, int state_smem, long long smem,
                                 void* stream) {
  if (levels < 1 || levels > JT_MAX_LEVELS || n != 32 * B || NS < 1 ||
      R < 1 || smem < 0 || (staged && !state_smem) ||
      (!state_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (staged && (((uintptr_t)invoke | (uintptr_t)ret) & 15))
    return (int)cudaErrorMisalignedAddress;
  const JtLayout& tr = *layout;
  const int mode = state_smem ? 1 + (staged != 0) : 0;
  cudaStream_t strm = (cudaStream_t)stream;
  switch (levels) {
    case 1: return jt_launch_mode<1>(mode, JT_ARGS);
    case 2: return jt_launch_mode<2>(mode, JT_ARGS);
    case 3: return jt_launch_mode<3>(mode, JT_ARGS);
    default: return jt_launch_mode<4>(mode, JT_ARGS);
  }
#undef JT_ARGS
}
