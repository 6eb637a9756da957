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
// the pool (the F rows so far, then the F*C candidates, pool index F + f*C
// + j) is ordered by (h1, h2, h3, h4, pool index) over the valid entries,
// h1..h4 the four multiply-shift fingerprints of fold_kernel.plain; an
// entry whose four fingerprints equal its predecessor's is a duplicate;
// the survivors take rows 0.. in that order, a rank past F is dropped and
// sets overflow. Passes stop when no work is left, at overflow, or at C + 1
// passes. A return with more than C open slots overflows at once. After a
// return the frontier is the rows that hold s; none is a violation. A lane
// whose status is not 0 treats every later event as a no-op. clear_w is
// applied once, at the end.
//
// What bounds it. A pass depends on the pass before it, and a return on the
// return before it, so a lane is a chain of passes; the lanes are
// independent. The bytes a pass moves are its rows and pool: reading the
// F rows and writing the valid pool entries (20 bytes each) and, in the
// sort, reading and writing each entry's key and index once per radix
// digit; all of it stays in L2 at the shapes the streams use (a few MB a
// lane). So the kernel is bound by the latency of a pass's dependent
// phases (block barriers, L2 round trips) times the passes, not by bytes
// or operations. The design keeps a pass's work proportional to the
// entries that exist, not to F * (C + 1):
//
// 1. One block of 1024 threads per lane, so the lanes run on K SMs with no
//    grid-wide barrier (folds run concurrently from several threads, and a
//    cooperative grid could deadlock against another fold's blocks). Every
//    phase of a pass is a loop over 1024-wide tiles with block scans.
// 2. Only valid entries enter the pool: the rows that are seen, then, for
//    each work row (a compacted list) and each open op, the candidates whose
//    step succeeds. Both are written in pool-index order (block scans), so
//    a stable sort by h1 alone orders them by (h1, pool index).
// 3. The sort is a block-wide LSD radix sort of (h1, entry) pairs, four
//    8-bit digits, stable: per 1024-entry tile, ranks within a warp come
//    from __match_any_sync, the warps' offsets from a per-digit scan over
//    the 32 warps. Runs of equal h1 (duplicates, mostly: a config reached
//    from several parents) are then put in (h2, h3, h4, pool index) order
//    by one thread each.
// 4. The dedup and the compaction are one pass over the sorted entries: a
//    block scan of the "differs from its predecessor" flag gives each
//    survivor its row, and the survivor's row is rebuilt from its pool
//    index (a seen row, or a parent row with one bit set and the model's
//    post-state), written to the other of two row buffers.
//
// fold_kernel.plan owns the scratch layout (per lane: the second row
// buffer, the flags, the work list, the open ops, the pool's keys, indices
// and fingerprints) and passes it in a JfLayout; nothing here recomputes
// it. Making the kernel fast (a cluster per lane sharing the sort over
// distributed shared memory, fingerprints kept per row across passes) is
// later work.
//
// The model step is a switch on a model id: 0 register, 1 cas-register,
// 2 mutex (S = 1), 3 multi-register (S = A, any width), mirroring
// _register_step, _cas_step, _mutex_step and _multi_step of
// jepsen_tpu_torch/models, NIL = -2^31 included.

#include <cuda_runtime.h>
#include <stdint.h>

#define JF_NIL (-2147483647 - 1)
#define JF_T 1024
#define JF_W (JF_T / 32)
#define JF_FULL 0xffffffffu

// Per-lane scratch: byte offsets into a lane's slice of lane_bytes, from
// fold_kernel.plan.
struct JfLayout {
  long long lane_bytes;
  long long lin_alt;   // F * B uint32: the second row buffer's bitsets
  long long st_alt;    // F * S int32: its states
  long long seen;      // F uint8: rows that are configs
  long long work;      // F uint8: rows still to expand
  long long worklist;  // F int32: the work rows, ascending
  long long ops;       // C * (2 + 2A) int32: open slots, f, args, rets
  long long key0, val0, key1, val1;  // P uint32 each: h1, entry
  long long efp;       // P uint4: h2, h3, h4, pool index
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

// The four fingerprints of a config: its B bitset words (word xw OR'd with
// xb), then its S state words (st itself, or the post-state of op (f, a)
// when post). cols holds the four per-word multiplier rows, B + S each.
__device__ __forceinline__ void jf_fp(const uint32_t* lin, int B, int xw,
                                      uint32_t xb, const int* st, int S,
                                      bool post, int model, int f,
                                      const int* a,
                                      const uint32_t* __restrict__ cols,
                                      uint32_t h[4]) {
  const int n = B + S;
  h[0] = h[1] = h[2] = h[3] = 0u;
  for (int i = 0; i < n; ++i) {
    uint32_t w;
    if (i < B)
      w = lin[i] | (i == xw ? xb : 0u);
    else
      w = (uint32_t)(post ? jf_post(model, st, i - B, f, a) : st[i - B]);
#pragma unroll
    for (int c = 0; c < 4; ++c) h[c] += jf_mix(w, __ldg(cols + c * n + i));
  }
}

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread calls it; sh holds JF_W + 1 ints.
__device__ __forceinline__ int jf_scan(int v, int* total, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(JF_FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int t = sh[lane];
    int s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(JF_FULL, s, o);
      if (lane >= o) s += y;
    }
    sh[lane] = s - t;
    if (lane == 31) sh[JF_W] = s;
  }
  __syncthreads();
  const int r = sh[warp] + x - v;
  *total = sh[JF_W];
  __syncthreads();
  return r;
}

// Whether entry a orders before entry b among equal h1: (h2, h3, h4, pool
// index).
__device__ __forceinline__ bool jf_less(uint4 a, uint4 b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.z != b.z) return a.z < b.z;
  return a.w < b.w;
}

// One lane per block: lin (K,F,B), st (K,F,S), live (K,F) uint8, open_w
// (K,B), w_f (K,NW), w_args/w_ret (K,NW,A), clear_w (K,B), ev (K,2,E): kinds
// then slots; cols (4,B+S) uint32. Outputs lin_out, st_out, live_out,
// open_out shaped as the inputs, res (K,5): status, viol, passes, steps,
// n_live.
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
               int B, int S, int A, int C, int E, int model) {
  __shared__ int sh[JF_W + 1];
  __shared__ int hist[256];
  __shared__ int wcnt[JF_W][256];
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int NW = B * 32;
  const size_t FB = (size_t)F * B, FS = (size_t)F * S;

  unsigned char* base = scratch + (size_t)k * L.lane_bytes;
  uint32_t* alt_lin = (uint32_t*)(base + L.lin_alt);
  int32_t* alt_st = (int32_t*)(base + L.st_alt);
  uint8_t* seen = base + L.seen;
  uint8_t* work = base + L.work;
  int32_t* wl = (int32_t*)(base + L.worklist);
  int32_t* o_slot = (int32_t*)(base + L.ops);
  int32_t* o_f = o_slot + C;
  int32_t* o_a = o_f + C;
  int32_t* o_r = o_a + (size_t)C * A;
  uint32_t* key[2] = {(uint32_t*)(base + L.key0), (uint32_t*)(base + L.key1)};
  uint32_t* val[2] = {(uint32_t*)(base + L.val0), (uint32_t*)(base + L.val1)};
  uint4* efp = (uint4*)(base + L.efp);

  uint32_t* linO = lin_out + (size_t)k * FB;
  int32_t* stO = st_out + (size_t)k * FS;
  uint8_t* liveO = live_out + (size_t)k * F;
  uint32_t* openO = open_out + (size_t)k * B;
  const int32_t* wf = w_f + (size_t)k * NW;
  const int32_t* wa = w_args + (size_t)k * NW * A;
  const int32_t* wr = w_ret + (size_t)k * NW * A;
  const int32_t* kinds = ev + (size_t)k * 2 * E;
  const int32_t* slots = kinds + E;

  for (size_t i = tid; i < FB; i += JF_T) linO[i] = lin_in[k * FB + i];
  for (size_t i = tid; i < FS; i += JF_T) stO[i] = st_in[k * FS + i];
  for (int i = tid; i < F; i += JF_T) liveO[i] = live_in[(size_t)k * F + i];
  for (int i = tid; i < B; i += JF_T) openO[i] = open_in[(size_t)k * B + i];
  __syncthreads();

  // the rows in use and the other buffer; they swap after every pass
  uint32_t* cur_lin = linO;
  int32_t* cur_st = stO;
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

    // -- a return of slot s: the open ops, the first C ascending ----------
    int n_open = 0;
    for (int w0 = 0; w0 < B; w0 += JF_T) {
      const int w = w0 + tid;
      uint32_t ow = w < B ? openO[w] : 0u;
      int tot;
      int r = n_open + jf_scan(__popc(ow), &tot, sh);
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

    // seen = live; work = live rows without s
    int any = 0;
    for (int f = tid; f < F; f += JF_T) {
      const uint8_t l = liveO[f];
      const uint8_t w = l && !(cur_lin[(size_t)f * B + word] & bit);
      seen[f] = l;
      work[f] = w;
      any |= w;
    }
    any = __syncthreads_or(any);
    int p = 0, stp = steps;
    bool go = any && !ovf;

    while (go) {
      // -- A. the seen rows enter the pool (pool index f); the work list --
      int n_ent = 0, n_wl = 0;
      for (int f0 = 0; f0 < F; f0 += JF_T) {
        const int f = f0 + tid;
        const int sv = f < F && seen[f], wv = f < F && work[f];
        int tot;
        const int pre = jf_scan(sv | (wv << 16), &tot, sh);
        if (sv) {
          uint32_t h[4];
          jf_fp(cur_lin + (size_t)f * B, B, -1, 0u, cur_st + (size_t)f * S, S,
                false, model, 0, nullptr, cols, h);
          const int e = n_ent + (pre & 0xffff);
          key[0][e] = h[0];
          val[0][e] = e;
          efp[e] = make_uint4(h[1], h[2], h[3], (uint32_t)f);
        }
        if (wv) wl[n_wl + (pre >> 16)] = f;
        n_ent += tot & 0xffff;
        n_wl += tot >> 16;
      }
      __syncthreads();

      // -- B. the candidates (pool index F + f*C + j) whose step succeeds --
      int inc = 0;
      const int nq = n_wl * nj;
      for (int q0 = 0; q0 < nq; q0 += JF_T) {
        const int q = q0 + tid;
        int f = 0, j = 0, sl = 0;
        bool v = false;
        if (q < nq) {
          const int w = q / nj;
          j = q - w * nj;
          f = wl[w];
          sl = o_slot[j];
          const bool pok =
              !((cur_lin[(size_t)f * B + (sl >> 5)] >> (sl & 31)) & 1u);
          inc += pok;
          v = pok && jf_ok(model, cur_st + (size_t)f * S, S, o_f[j],
                           o_a + (size_t)j * A, o_r + (size_t)j * A);
        }
        int tot;
        const int pre = jf_scan(v, &tot, sh);
        if (v) {
          uint32_t h[4];
          jf_fp(cur_lin + (size_t)f * B, B, sl >> 5, 1u << (sl & 31),
                cur_st + (size_t)f * S, S, true, model, o_f[j],
                o_a + (size_t)j * A, cols, h);
          const int e = n_ent + pre;
          key[0][e] = h[0];
          val[0][e] = e;
          efp[e] = make_uint4(h[1], h[2], h[3], (uint32_t)(F + f * C + j));
        }
        n_ent += tot;
      }
      int d_steps;
      jf_scan(inc, &d_steps, sh);
      const int N = n_ent;

      // -- C. stable LSD radix sort of (h1, entry), four 8-bit digits ----
      for (int pass = 0; pass < 4; ++pass) {
        const int shift = 8 * pass;
        const uint32_t* ki = key[pass & 1];
        const uint32_t* vi = val[pass & 1];
        uint32_t* ko = key[(pass & 1) ^ 1];
        uint32_t* vo = val[(pass & 1) ^ 1];
        if (tid < 256) hist[tid] = 0;
        __syncthreads();
        for (int i = tid; i < N; i += JF_T)
          atomicAdd(&hist[(ki[i] >> shift) & 255], 1);
        __syncthreads();
        {
          int tot;
          const int pre = jf_scan(tid < 256 ? hist[tid] : 0, &tot, sh);
          if (tid < 256) hist[tid] = pre;
        }
        for (int i0 = 0; i0 < N; i0 += JF_T) {
          const int i = i0 + tid;
          const bool v = i < N;
          const uint32_t kk = v ? ki[i] : 0u, vv = v ? vi[i] : 0u;
          const int d = v ? (int)((kk >> shift) & 255) : 256;
          for (int x = tid; x < JF_W * 256; x += JF_T) (&wcnt[0][0])[x] = 0;
          __syncthreads();
          const uint32_t peers = __match_any_sync(JF_FULL, d);
          const int rk = __popc(peers & ((1u << lane) - 1u));
          if (v && rk == 0) wcnt[warp][d] = __popc(peers);
          __syncthreads();
          if (tid < 256) {  // the warps' offsets for digit tid, in order
            int run = hist[tid];
            for (int w = 0; w < JF_W; ++w) {
              const int c = wcnt[w][tid];
              wcnt[w][tid] = run;
              run += c;
            }
            hist[tid] = run;
          }
          __syncthreads();
          if (v) {
            const int dst = wcnt[warp][d] + rk;
            ko[dst] = kk;
            vo[dst] = vv;
          }
          __syncthreads();
        }
      }
      const uint32_t* sk = key[0];
      uint32_t* sv = val[0];

      // -- D. runs of equal h1 into (h2, h3, h4, pool index) order --------
      for (int i = tid; i < N; i += JF_T) {
        if (i > 0 && sk[i - 1] == sk[i]) continue;
        int e = i + 1;
        while (e < N && sk[e] == sk[i]) ++e;
        for (int a = i + 1; a < e; ++a) {  // insertion sort, one thread
          const uint32_t x = sv[a];
          const uint4 fx = efp[x];
          int b = a - 1;
          while (b >= i && jf_less(fx, efp[sv[b]])) {
            sv[b + 1] = sv[b];
            --b;
          }
          sv[b + 1] = x;
        }
      }
      __syncthreads();

      // -- E. dedup and compaction into the other row buffer -------------
      int n_keep = 0, anyw = 0;
      for (int i0 = 0; i0 < N; i0 += JF_T) {
        const int i = i0 + tid;
        bool kp = false;
        uint4 me = make_uint4(0, 0, 0, 0);
        if (i < N) {
          me = efp[sv[i]];
          kp = i == 0 || sk[i - 1] != sk[i];
          if (!kp) {
            const uint4 pv = efp[sv[i - 1]];
            kp = pv.x != me.x || pv.y != me.y || pv.z != me.z;
          }
        }
        int tot;
        const int r = n_keep + jf_scan(kp, &tot, sh);
        if (kp && r < F) {
          const int pi = (int)me.w;
          uint32_t* dl = alt_lin + (size_t)r * B;
          int32_t* ds = alt_st + (size_t)r * S;
          bool w = false;
          if (pi < F) {  // an established config: it retires
            for (int x = 0; x < B; ++x) dl[x] = cur_lin[(size_t)pi * B + x];
            for (int x = 0; x < S; ++x) ds[x] = cur_st[(size_t)pi * S + x];
          } else {  // a fresh one: back to work while it lacks s
            const int c = pi - F, f = c / C, j = c - f * C;
            const int sl = o_slot[j];
            const int* ps = cur_st + (size_t)f * S;
            for (int x = 0; x < B; ++x)
              dl[x] = cur_lin[(size_t)f * B + x] |
                      (x == (sl >> 5) ? 1u << (sl & 31) : 0u);
            for (int x = 0; x < S; ++x)
              ds[x] = jf_post(model, ps, x, o_f[j], o_a + (size_t)j * A);
            w = !(dl[word] & bit);
          }
          seen[r] = 1;
          work[r] = w;
          anyw |= w;
        }
        n_keep += tot;
      }
      const int rows = min(n_keep, F);
      for (size_t i = (size_t)rows * B + tid; i < FB; i += JF_T) alt_lin[i] = 0;
      for (size_t i = (size_t)rows * S + tid; i < FS; i += JF_T) alt_st[i] = 0;
      for (int i = rows + tid; i < F; i += JF_T) {
        seen[i] = 0;
        work[i] = 0;
      }
      anyw = __syncthreads_or(anyw);
      ovf = ovf || n_keep > F;
      uint32_t* tl = cur_lin;
      cur_lin = alt_lin;
      alt_lin = tl;
      int32_t* ts = cur_st;
      cur_st = alt_st;
      alt_st = ts;
      ++p;
      stp += d_steps;
      go = anyw && !ovf && p < C + 1;
    }

    // -- the frontier after the return: the rows that hold s ------------
    int fin = 0;
    for (int f = tid; f < F; f += JF_T) {
      const uint8_t x = seen[f] && (cur_lin[(size_t)f * B + word] & bit);
      liveO[f] = x;
      fin |= x;
    }
    fin = __syncthreads_or(fin);
    if (tid == 0) openO[word] &= ~bit;
    const bool violated = !fin && !ovf;
    status = ovf ? 2 : (violated ? 1 : 0);
    if (violated) viol = s;
    passes += p;
    steps = stp;
    __syncthreads();
  }

  // the rows back into the outputs; sealed slots cleared in every row
  const uint32_t* cw = clear_w + (size_t)k * B;
  for (size_t i = tid; i < FB; i += JF_T)
    linO[i] = cur_lin[i] & ~cw[i % B];
  if (cur_st != stO)
    for (size_t i = tid; i < FS; i += JF_T) stO[i] = cur_st[i];
  int n_live = 0;
  for (int f = tid; f < F; f += JF_T) n_live += liveO[f];
  int tot;
  jf_scan(n_live, &tot, sh);
  if (tid == 0) {
    int32_t* rk = res + (size_t)k * 5;
    rk[0] = status;
    rk[1] = viol;
    rk[2] = passes;
    rk[3] = steps;
    rk[4] = tot;
  }
}

// A block of 1024 threads through `n` barriers, each after a shared write:
// the cost of one block-wide barrier, for the latency floor chip_smoke.py
// reports (a pass cannot take fewer than two: its expansion must finish
// before its dedup, its dedup before the next pass).
__global__ void __launch_bounds__(JF_T) jf_barrier_probe(int n, int* out) {
  __shared__ int x[JF_T];
  int v = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    x[threadIdx.x] = v;
    __syncthreads();
    v += x[(threadIdx.x + 1) & (JF_T - 1)];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = v;
}

extern "C" int jf_barrier_probe_launch(int n, void* out, void* stream) {
  jf_barrier_probe<<<1, JF_T, 0, (cudaStream_t)stream>>>(n, (int*)out);
  return (int)cudaGetLastError();
}

// One block per lane (K blocks). The layout is fold_kernel.plan's; scratch
// holds K * layout->lane_bytes. Refused arguments return
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
                              void* stream) {
  if (K < 1 || F < 1 || B < 1 || S < 1 || A < 1 || C < 1 || E < 0 ||
      model < 0 || model > 3 || (model < 3 && S != 1) ||
      (model == 1 && A < 2) || (model == 3 && S != A) ||
      (long long)F * (C + 1) > 2147483647LL || scratch == nullptr ||
      layout == nullptr)
    return (int)cudaErrorInvalidValue;
  jf_fold_kernel<<<K, JF_T, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lin, (const int32_t*)st, (const uint8_t*)live,
      (const uint32_t*)open_w, (const int32_t*)w_f, (const int32_t*)w_args,
      (const int32_t*)w_ret, (const uint32_t*)clear_w, (const uint32_t*)cols,
      (const int32_t*)ev, (uint32_t*)lin_out, (int32_t*)st_out,
      (uint8_t*)live_out, (uint32_t*)open_out, (int32_t*)res,
      (unsigned char*)scratch, *layout, F, B, S, A, C, E, model);
  return (int)cudaGetLastError();
}
