// Poseidon2-Goldilocks width-12 permutation for Hopper (sm_90a).
//
// Replaces the fused Pallas kernel of the JAX package:
// zkevm_circuits_tpu/ops/poseidon2_pallas.py, body `_kernel` (:89-120),
// launched by `_permutation_lane0` (pallas_call at :142).  Same round
// structure: an initial M_E, 4 full rounds (add RC, x^7, M_E), 22 partial
// rounds (x^7 on lane 0, M_I = J + diag(mu - 1)), 4 full rounds, canonical
// output.
//
// What bounds it on an H100: integer multiplies.  One state costs about 740
// 64x64 -> 128 products over the 30 rounds (8 full rounds x 12 lanes x 4 for
// x^7, 22 partial rounds x (4 + 12)), each a __umul64hi plus a low multiply
// plus the reduction, against 192 bytes moved (96 in, 96 out).  That is
// thousands of integer instructions per byte, far above the card's ratio of
// issue rate to HBM bandwidth, so the kernel is compute-bound.
//
// Design: one thread per state, the 12 lanes as uint64_t in registers for
// all 30 rounds, so device memory is touched once on the way in and once on
// the way out.  The round constants sit in __constant__ memory: every thread
// of a warp reads the same constant in the same round, which the constant
// cache broadcasts.  The reduction is branch-free (selects, no divergence).
// Inputs are (N, 12) row-major; a thread's 96-byte row is read uncoalesced,
// which costs little against the arithmetic.
//
// Small batches and sequential chains, where one thread per state is bound by
// its own latency, go to the lane-parallel kernels of poseidon2_coop.cuh
// (included below; it shares the field code and the constants of this file).
//
// C interface (loaded with ctypes; every pointer and the stream are void*):
//   int zk_poseidon2_init(const uint64_t* ext_rc /*8x12*/,
//                         const uint64_t* int_rc /*22*/,
//                         const uint64_t* mu_minus_1 /*12*/);
//   int zk_poseidon2_permute(const uint64_t* in, uint64_t* out,
//                            long long n, void* stream);
//   int zk_poseidon2_permute_small(const uint64_t* in, uint64_t* out,
//                                  long long n, void* stream);
//   int zk_poseidon2_chain_segmented(b0, e0, x0, landing0, b1, e1, x1, landing1,
//                                    int chains, long long segments,
//                                    long long stride, void* stream);
// All return the cudaError_t of the call (0 on success); `chains` other than 1
// or 2 returns cudaErrorInvalidValue.

#include <cstdint>
#include <cuda_runtime.h>

typedef uint64_t u64;

static constexpr u64 GL_P = 0xFFFFFFFF00000001ULL;
static constexpr u64 GL_EPS = 0xFFFFFFFFULL;  // 2^64 - p

__constant__ u64 c_ext_rc[8][12];
__constant__ u64 c_int_rc[22];
__constant__ u64 c_mu_m1[12];

__device__ __forceinline__ u64 gl_canon(u64 x) { return x >= GL_P ? x - GL_P : x; }

// canonical inputs -> canonical output
__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  u64 t = s + GL_EPS;          // s - p (mod 2^64)
  return (s < a || s >= GL_P) ? t : s;
}

// any u64 inputs -> canonical output
__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  u64 hi_hi = hi >> 32;
  u64 hi_lo = hi & GL_EPS;
  u64 t0 = lo - hi_hi;
  t0 -= (lo < hi_hi) ? GL_EPS : 0;            // 2^96 == -1
  u64 t1 = (hi_lo << 32) - hi_lo;             // hi_lo * (2^32 - 1)
  u64 t2 = t0 + t1;
  t2 += (t2 < t0) ? GL_EPS : 0;               // 2^64 == 2^32 - 1
  return gl_canon(t2);
}

__device__ __forceinline__ u64 sbox7(u64 x) {
  u64 x2 = gl_mul(x, x);
  u64 x3 = gl_mul(x2, x);
  u64 x4 = gl_mul(x2, x2);
  return gl_mul(x3, x4);
}

__device__ __forceinline__ void m4(u64* v) {
  u64 t0 = gl_add(v[0], v[1]);
  u64 t1 = gl_add(v[2], v[3]);
  u64 t2 = gl_add(gl_add(v[1], v[1]), t1);
  u64 t3 = gl_add(gl_add(v[3], v[3]), t0);
  u64 t1_2 = gl_add(t1, t1);
  u64 t0_2 = gl_add(t0, t0);
  u64 t4 = gl_add(gl_add(t1_2, t1_2), t3);
  u64 t5 = gl_add(gl_add(t0_2, t0_2), t2);
  v[0] = gl_add(t3, t5);
  v[1] = t5;
  v[2] = gl_add(t2, t4);
  v[3] = t4;
}

__device__ __forceinline__ void ext_matrix(u64* s) {
  m4(s);
  m4(s + 4);
  m4(s + 8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    u64 sum = gl_add(gl_add(s[j], s[4 + j]), s[8 + j]);
    s[j] = gl_add(s[j], sum);
    s[4 + j] = gl_add(s[4 + j], sum);
    s[8 + j] = gl_add(s[8 + j], sum);
  }
}

__device__ __forceinline__ void full_round(u64* s, int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox7(gl_add(s[i], c_ext_rc[r][i]));
  ext_matrix(s);
}

__global__ void __launch_bounds__(128)
poseidon2_permute_kernel(const u64* __restrict__ in, u64* __restrict__ out, long long n) {
  long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const u64* src = in + row * 12;
  u64 s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl_canon(src[i]);

  ext_matrix(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = 0; r < 22; ++r) {
    s[0] = sbox7(gl_add(s[0], c_int_rc[r]));
    u64 total = s[0];
#pragma unroll
    for (int i = 1; i < 12; ++i) total = gl_add(total, s[i]);
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = gl_add(total, gl_mul(s[i], c_mu_m1[i]));
  }
#pragma unroll 1
  for (int r = 4; r < 8; ++r) full_round(s, r);

  u64* dst = out + row * 12;
#pragma unroll
  for (int i = 0; i < 12; ++i) dst[i] = s[i];
}

#include "poseidon2_coop.cuh"

extern "C" int zk_poseidon2_init(const u64* ext_rc, const u64* int_rc, const u64* mu_m1) {
  cudaError_t e = cudaMemcpyToSymbol(c_ext_rc, ext_rc, sizeof(u64) * 8 * 12);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbol(c_int_rc, int_rc, sizeof(u64) * 22);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(c_mu_m1, mu_m1, sizeof(u64) * 12);
}

extern "C" int zk_poseidon2_permute(const u64* in, u64* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  long long blocks = (n + threads - 1) / threads;
  poseidon2_permute_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

static unsigned int coop_blocks(long long groups) {
  long long per_block = COOP_THREADS / COOP_GROUP;
  return (unsigned int)((groups + per_block - 1) / per_block);
}

extern "C" int zk_poseidon2_permute_small(const u64* in, u64* out, long long n, void* stream) {
  if (n <= 0) return 0;
  poseidon2_permute_small_kernel<<<coop_blocks(n), COOP_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int zk_poseidon2_chain_segmented(
    const u64* boundaries0, const u64* encodings0, const unsigned char* execute0, u64* landing0,
    const u64* boundaries1, const u64* encodings1, const unsigned char* execute1, u64* landing1,
    int chains, long long segments, long long stride, void* stream) {
  if (chains != 1 && chains != 2) return (int)cudaErrorInvalidValue;
  if (segments <= 0 || stride <= 0) return 0;
  ChainArgs first = {boundaries0, encodings0, execute0, landing0};
  ChainArgs second = {boundaries1, encodings1, execute1, landing1};
  dim3 grid(coop_blocks(segments), (unsigned int)chains);
  poseidon2_chain_segmented_kernel<<<grid, COOP_THREADS, 0, (cudaStream_t)stream>>>(
      first, second, segments, stride);
  return (int)cudaGetLastError();
}
