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
// Design. One block per chain (grid = NS). The chain's packed bitset (B = n/32
// words) lives in shared memory; threads stride over the n ops, so op i is
// owned by thread i % blockDim and bitset word w by one warp. Each step is
// two block-wide min-reductions (warp __reduce_min_sync, then one
// __syncthreads over per-warp partials, double-buffered so no second barrier
// is needed): rm first, then the first index that is eligible and whose
// model step succeeds. Every thread then knows jf; the thread owning op jf
// sets its bit and __syncwarp publishes it to the only warp that reads that
// word. Every thread replays the model step of op jf itself, so the state
// stays in registers and needs no broadcast. Thread 0 writes the outputs.
// The model step is a switch on a model id (0 register, 1 cas-register,
// 2 mutex) mirroring _register_step, _cas_step and _mutex_step of
// jepsen_tpu_torch/models, NIL = -2^31 included; the state is one word.
//
// Bound. Inputs n*(3+2A)*4 + NS*(B+S)*4 bytes, outputs NS*R*(1+S)*4 bytes:
// a few hundred KB at the main-path shape (NS=8, R=1024, n=8192), so memory
// is not the limit. The work is about R*NS*n element-steps of a dozen
// integer operations, which sets the least time. In practice the chain of R
// dependent steps, each with two barrier reductions, is the limit: the
// kernel is latency-bound and uses NS of the card's SMs.
//
// Left for later: a chain split across a thread-block cluster with DSMEM
// reductions (more SMs per chain), one pass over the op columns serving all
// NS chains, and packed op columns (invoke/ret/f/args in one record).

#include <cuda_runtime.h>
#include <stdint.h>

#define JT_NIL (-2147483647 - 1)
#define JT_INF32 2147483647
#define JT_THREADS 512
#define JT_WARPS (JT_THREADS / 32)

// Model step for one op: returns ok, writes the post-state to *nv.
__device__ __forceinline__ bool jt_step(int model, int v, int f,
                                        const int* __restrict__ a,
                                        const int* __restrict__ r, int* nv) {
  if (model == 0) {  // register: F_READ 0, F_WRITE 1
    bool is_write = f == 1;
    int r0 = __ldg(r);
    *nv = is_write ? __ldg(a) : v;
    return is_write || r0 == JT_NIL || r0 == v;
  }
  if (model == 1) {  // cas-register: F_READ 0, F_WRITE 1, F_CAS 2
    bool is_write = f == 1, is_cas = f == 2, is_read = f == 0;
    int a0 = __ldg(a);
    bool cas_ok = v == a0;
    int r0 = __ldg(r);
    *nv = is_write ? a0 : ((is_cas && cas_ok) ? __ldg(a + 1) : v);
    return is_write || (is_cas && cas_ok) ||
           (is_read && (r0 == JT_NIL || r0 == v));
  }
  // mutex: F_ACQUIRE 0, F_RELEASE 1
  bool is_acq = f == 0;
  *nv = is_acq ? 1 : 0;
  return is_acq ? v == 0 : v == 1;
}

__device__ __forceinline__ int jt_block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = lane < JT_WARPS ? red[lane] : JT_INF32;
  return __reduce_min_sync(0xffffffffu, r);
}

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
                  int R, int n, int B, int A, int model) {
  extern __shared__ uint32_t lin[];          // B words
  __shared__ int red[2][JT_WARPS];           // double-buffered partials
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  for (int w = tid; w < B; w += JT_THREADS)
    lin[w] = seed_lin[(size_t)s * B + w];
  int v = seed_st[s];                        // S == 1
  bool alive = seed_ok[s] != 0;
  __syncthreads();

  for (int t = 0; t < R; ++t) {
    int jt = -1;
    if (alive) {
      // pass A: rm = min ret over unlinearized ops
      int loc = JT_INF32;
      for (int i = tid; i < n; i += JT_THREADS) {
        if (!((lin[i >> 5] >> (i & 31)) & 1u)) loc = min(loc, __ldg(ret + i));
      }
      const int rm = jt_block_min(loc, red[0]);
      // pass B: first eligible op whose step succeeds; a thread's ops
      // rise with i, so its first success is its candidate
      int cand = n;
      for (int i = tid; i < n; i += JT_THREADS) {
        if (((lin[i >> 5] >> (i & 31)) & 1u) || __ldg(invoke + i) >= rm)
          continue;
        int nv;
        if (jt_step(model, v, __ldg(fop + i), args + (size_t)i * A,
                    rets + (size_t)i * A, &nv)) {
          cand = i;
          break;
        }
      }
      const int jf = jt_block_min(cand, red[1]);
      if (jf < n) {
        // only the warp owning word jf >> 5 ever reads it
        if (tid == jf % JT_THREADS) lin[jf >> 5] |= 1u << (jf & 31);
        __syncwarp();
        int nv;
        jt_step(model, v, __ldg(fop + jf), args + (size_t)jf * A,
                rets + (size_t)jf * A, &nv);
        v = nv;
        jt = jf;
      } else {
        alive = false;
      }
    }
    if (tid == 0) {
      j_out[(size_t)s * R + t] = jt;
      st_out[(size_t)s * R + t] = v;
    }
  }
}

extern "C" int jt_rollout_launch(const void* seed_lin, const void* seed_st,
                                 const void* seed_ok, const void* invoke,
                                 const void* ret, const void* fop,
                                 const void* args, const void* rets,
                                 void* j_out, void* st_out, int NS, int R,
                                 int n, int B, int A, int model,
                                 void* stream) {
  const size_t smem = (size_t)B * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        jt_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  jt_rollout_kernel<<<NS, JT_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)seed_lin, (const int32_t*)seed_st,
      (const uint8_t*)seed_ok, (const int32_t*)invoke, (const int32_t*)ret,
      (const int32_t*)fop, (const int32_t*)args, (const int32_t*)rets,
      (int32_t*)j_out, (int32_t*)st_out, R, n, B, A, model);
  return (int)cudaGetLastError();
}
