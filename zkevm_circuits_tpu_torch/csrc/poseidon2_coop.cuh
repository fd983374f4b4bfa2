// Lane-parallel ("cooperative") Poseidon2-Goldilocks permutation for Hopper,
// and the two kernels built on it.  Included by poseidon2.cu, whose field code
// (gl_add, gl_mul, sbox7, gl_canon) and __constant__ round constants it shares.
//
// Like the thread-per-state kernel of poseidon2.cu it replaces the fused
// Pallas kernel of the JAX package (zkevm_circuits_tpu/ops/poseidon2_pallas.py,
// body `_kernel`, :89-120), and, for the chain kernel, the `lax.scan` around it
// in zkevm_circuits_tpu/ops/queues.py:check_chain_segmented.
//
// Why a second form.  One thread per state is a chain of about 22 thousand
// dependent-ish 32-bit integer instructions.  At 2^16 states and more the card
// hides that behind other warps and the kernel runs at its integer-throughput
// bound.  At 2,048 states (one step of the segmented chain recompute), at one
// state (a transcript sponge) or at 20 (a query's path check) there are no
// other warps: the time is one thread's latency, and a sequential chain of 512
// such steps cannot be batched wider.  Here one state is spread over the 4
// threads of a group, 8 groups a warp, so that its lanes' S-boxes and products
// run side by side: thread t of the group holds lanes t, 4 + t, 8 + t (column
// t of the three 4-blocks), and all four threads work.  (A grouping of 16
// threads, one lane each, was measured too and was slower from 2^11 states on
// and for the chain: a third of its threads idle through the partial rounds.)
//
// The column sums of M_E are thread-local; M4 needs the other three lanes of a
// 4-block: three xor-shuffles, after which a thread forms its own row of M4 as
// one small linear combination (rows 0 and 2 are 5a + 7b + c + 3d, rows 1 and
// 3 are 6a + 4b + c + d of the lanes at xor 0, 1, 2, 3), summed in two 36-bit
// halves and reduced once.  In a partial round the sum of the lanes other than
// lane 0 and their products with mu - 1 do not depend on the S-box, so they
// run beside it; after the S-box one broadcast, one product on lane 0 and two
// additions remain.  Every shuffle names only its own group's threads, so the
// groups of a warp may diverge (a group whose step is not executed skips it,
// a group beyond the batch returns).
//
// What bounds the kernels: the same integer work as poseidon2.cu (about 22
// thousand 32-bit integer instructions a state), never the bytes (96 in and
// out a state; 65 a chain step).  The chain kernel also has a floor that no
// width removes: `stride` permutations in a row, each as deep as its lane-0
// chain (22 partial rounds of three dependent products).
//
// Per-lane round constants are read from __constant__ memory with an index
// that differs between the threads of a group (4 addresses a warp, which the
// constant cache serves one after the other).  That is 8 reads a permutation
// per lane held; each is fetched a round ahead of its use, so the wait is
// behind that round's arithmetic.  mu - 1 is kept in registers.

#pragma once

static constexpr int COOP_GROUP = 4;  // threads a state
static constexpr int COOP_LANES = 3;  // lanes a thread holds

struct Coop {
  u64 x[COOP_LANES];
  u64 mu[COOP_LANES];  // mu - 1 of those lanes
  unsigned mask;       // this group's threads within the warp
  int t;               // thread within the group
  unsigned ca, cb, cd; // this thread's row of M4, for the lanes at xor 0, 1, 3 (xor 2 has 1)

  __device__ __forceinline__ int lane(int k) const { return 4 * k + t; }
};

__device__ __forceinline__ void coop_init(Coop& c) {
  int warp_lane = threadIdx.x & 31;
  c.t = warp_lane & 3;
  c.mask = 0xFu << (warp_lane & ~3);
  bool odd = c.t & 1;
  c.ca = odd ? 6u : 5u;
  c.cb = odd ? 4u : 7u;
  c.cd = odd ? 1u : 3u;
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) c.mu[k] = c_mu_m1[c.lane(k)];
}

// ca*a + cb*b + c + cd*d for any u64 a..d and coefficients below 8; canonical.
__device__ __forceinline__ u64 gl_lin4(u64 a, u64 b, u64 c, u64 d,
                                       unsigned ca, unsigned cb, unsigned cd) {
  u64 lo = (u64)(unsigned)a * ca + (u64)(unsigned)b * cb + (u64)(unsigned)c + (u64)(unsigned)d * cd;
  u64 hi = (a >> 32) * ca + (b >> 32) * cb + (c >> 32) + (d >> 32) * cd;
  // the value is hi * 2^32 + lo with lo, hi < 2^36; the part of hi above 2^32
  // stands at 2^64 == 2^32 - 1
  u64 small = lo + (hi >> 32) * GL_EPS;       // < 2^37
  u64 t = (hi << 32) + small;
  t += (t < small) ? GL_EPS : 0;              // one carry at most, and then t < 2^38
  return gl_canon(t);
}

// M_E on a state spread over the group.
__device__ __forceinline__ void coop_ext_matrix(Coop& c) {
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) {
    u64 a = c.x[k];
    u64 b = __shfl_xor_sync(c.mask, a, 1, COOP_GROUP);
    u64 cc = __shfl_xor_sync(c.mask, a, 2, COOP_GROUP);
    u64 d = __shfl_xor_sync(c.mask, a, 3, COOP_GROUP);
    c.x[k] = gl_lin4(a, b, cc, d, c.ca, c.cb, c.cd);
  }
  u64 sum = gl_add(gl_add(c.x[0], c.x[1]), c.x[2]);
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) c.x[k] = gl_add(c.x[k], sum);
}

// external rounds first .. first + 3
__device__ __forceinline__ void coop_full_rounds(Coop& c, int first) {
  u64 next[COOP_LANES];
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) next[k] = c_ext_rc[first][c.lane(k)];
#pragma unroll 1
  for (int r = first; r < first + 4; ++r) {
    u64 rc[COOP_LANES];
    int ahead = (r < 7) ? r + 1 : 7;
#pragma unroll
    for (int k = 0; k < COOP_LANES; ++k) {
      rc[k] = next[k];
      next[k] = c_ext_rc[ahead][c.lane(k)];
    }
#pragma unroll
    for (int k = 0; k < COOP_LANES; ++k) c.x[k] = sbox7(gl_add(c.x[k], rc[k]));
    coop_ext_matrix(c);
  }
}

__device__ __forceinline__ void coop_partial_rounds(Coop& c) {
#pragma unroll 1
  for (int r = 0; r < 22; ++r) {
    // the S-box of lane 0 (its value counts on thread 0 only), sent to all
    u64 s0 = __shfl_sync(c.mask, sbox7(gl_add(c.x[0], c_int_rc[r])), 0, COOP_GROUP);
    // beside it: the sum of the other eleven lanes
    u64 rest = (c.t == 0) ? 0 : c.x[0];
#pragma unroll
    for (int k = 1; k < COOP_LANES; ++k) rest = gl_add(rest, c.x[k]);
#pragma unroll
    for (int m = 1; m < COOP_GROUP; m <<= 1)
      rest = gl_add(rest, __shfl_xor_sync(c.mask, rest, m, COOP_GROUP));
    u64 total = gl_add(rest, s0);
    u64 x0 = (c.t == 0) ? s0 : c.x[0];
    c.x[0] = gl_add(total, gl_mul(x0, c.mu[0]));
#pragma unroll
    for (int k = 1; k < COOP_LANES; ++k) c.x[k] = gl_add(total, gl_mul(c.x[k], c.mu[k]));
  }
}

// canonical lanes in, canonical lanes out
__device__ __forceinline__ void coop_permute(Coop& c) {
  coop_ext_matrix(c);
  coop_full_rounds(c, 0);
  coop_partial_rounds(c);
  coop_full_rounds(c, 4);
}

__device__ __forceinline__ void coop_load(Coop& c, const u64* __restrict__ src) {
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) c.x[k] = gl_canon(src[c.lane(k)]);
}

__device__ __forceinline__ void coop_store(const Coop& c, u64* __restrict__ dst) {
#pragma unroll
  for (int k = 0; k < COOP_LANES; ++k) dst[c.lane(k)] = c.x[k];
}

static constexpr int COOP_THREADS = 32;  // one warp a block, so that few groups spread over all SMs

// Kernel B: n states, one group each.
__global__ void __launch_bounds__(COOP_THREADS)
poseidon2_permute_small_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long n) {
  long long group = ((long long)blockIdx.x * COOP_THREADS + threadIdx.x) / COOP_GROUP;
  if (group >= n) return;
  Coop c;
  coop_init(c);
  coop_load(c, in + group * 12);
  coop_permute(c);
  coop_store(c, out + group * 12);
}

// Kernel A: the segmented sponge chain.  One group a segment: from
// boundaries[s] it absorbs (replaces lanes 0..7 by) the segment's `stride`
// encodings one after the other, a permutation after each, skipping the rows
// whose `execute` byte is 0, and writes the landing state.  The state stays in
// registers for the whole segment.  The encodings are read where they lie,
// (n, 8) row-major: a segment's rows are one contiguous block, a row is 64
// bytes, and the row of step k + 1 is loaded into registers before step k is
// permuted, so that its latency lies behind microseconds of arithmetic.  At 64
// bytes a step there is nothing for shared memory, cp.async or TMA to win.
// blockIdx.y picks one of up to two chains of the same shape, so that both
// chains of one evaluation share the card.
struct ChainArgs {
  const u64* boundaries;         // (segments + 1, 12)
  const u64* encodings;          // (segments * stride, 8)
  const unsigned char* execute;  // (segments * stride,)
  u64* landing;                  // (segments, 12)
};

__global__ void __launch_bounds__(COOP_THREADS)
poseidon2_chain_segmented_kernel(ChainArgs first, ChainArgs second, long long segments,
                                 long long stride) {
  long long seg = ((long long)blockIdx.x * COOP_THREADS + threadIdx.x) / COOP_GROUP;
  if (seg >= segments) return;
  const ChainArgs a = blockIdx.y ? second : first;
  Coop c;
  coop_init(c);
  coop_load(c, a.boundaries + seg * 12);

  // a thread holds two of the eight rate lanes: t and 4 + t
  constexpr int R = 2;
  const u64* enc = a.encodings + seg * stride * 8;
  const unsigned char* exe = a.execute + seg * stride;
  u64 row[R];
  unsigned char run = exe[0];
#pragma unroll
  for (int k = 0; k < R; ++k) row[k] = enc[c.lane(k)];

#pragma unroll 1
  for (long long step = 0; step < stride; ++step) {
    u64 cur[R];
    unsigned char run_now = run;
#pragma unroll
    for (int k = 0; k < R; ++k) cur[k] = row[k];
    if (step + 1 < stride) {
      run = exe[step + 1];
#pragma unroll
      for (int k = 0; k < R; ++k) row[k] = enc[(step + 1) * 8 + c.lane(k)];
    }
    if (run_now) {  // the same for every thread of the group
#pragma unroll
      for (int k = 0; k < R; ++k) c.x[k] = gl_canon(cur[k]);
      coop_permute(c);
    }
  }
  coop_store(c, a.landing + seg * 12);
}
