// fused_step.cuh — tile machinery of K1 (one sub-step of a fused stencil
// chunk) and K7 (the same sub-step for N independent ensemble members in
// one launch) for NVIDIA Hopper, sm_90a.
//
// (K5, one sub-step over a box of one shard, and K6, several stages per
// launch, follow below with their own notes.)
//
// K1 replaces the inner `kernel` of build_pallas_chunk
// (yask_tpu/ops/pallas_stencil.py) for one sub-step; K7 replaces the
// jax.vmap of that chunk in EnsembleRun._batched_chunk_fn
// (yask_tpu/runtime/ensemble.py).  The wrappers in
// yask_tpu_torch/ops/fused_stencil.py launch one of them once per step and
// rotate the step rings between launches.  ops/cuda_emit.py prints, per
// solution, a `Spec` struct holding the per-point update (`Spec::point`)
// and the compile-time tables used below, then instantiates
// YT_FUSED_STEP_ENTRY (K1) and YT_FUSED_BATCHED_ENTRY (K7).
//
// K7 is K1 with a member axis: every state array is a contiguous
// (N, *shape) stack, each input and output carries a 64-bit member stride,
// and the grid folds the member into blockIdx.z (z = member * ceil(n0/T0)
// + slot-0 block).  A block stages and computes exactly what a K1 block
// does, offset by its member, so each member gets the bits a solo K1
// launch gives it.  It is bound by bytes as K1 is (N times K1's traffic);
// its gain over N K1 launches is N-1 launch gaps and one grid that fills
// the card when one member alone would not.
//
// Design (a first cut that is simple and right):
//   * a block owns T0 x T1 x T2 interior points (slot 2 = the contiguous
//     minor dim, one thread per point in slots 1-2, a loop over slot 0);
//   * every input of a full-dim var read at a spatial offset is staged,
//     with its halo, in dynamic shared memory (coalesced rows of the
//     minor dim; cells beyond the padded array are zero);
//   * other inputs (same-point reads, partial-dim vars) are read from
//     global memory; a var lacking a dim has stride 0 in it;
//   * every interior point is computed and written; threads outside the
//     interior (ragged edge) write nothing.  Outputs are fresh zeroed
//     tensors, so pads stay zero and no launch writes what it reads.
//
// The same Spec compiles on the host (no __CUDACC__): host_step() runs
// the point function over the interior with global reads only, which is
// how the CPU tests check the emitted arithmetic with g++.
//
// Element size 2: real_t is bf16_t (__nv_bfloat16 on the device), the
// storage; the point function reads it widened (to_f) and computes in
// float (Calc<real_t>::type), rounding each op on bfloat16 values once
// (rbf), and a store rounds to bfloat16 (Calc<real_t>::store).  The host build has its own bf16_t with the same
// round-to-nearest-even from float, so g++ checks the emitted arithmetic
// at element size 2 too.
//
// Misc dims and partial-dim outputs need nothing here: a misc slice is an
// input or output of its own (its own interior pointer, the var's domain
// strides), a var lacking a slot has stride 0 in it, and out_slab (when
// the Spec prints it) says which slots a partial-dim output lacks, so
// that only the points at index 0 of those slots store it.
//
// More than three domain dims (the reference's grid runs over every lead
// dim, pallas_stencil.py:1442): the Spec prints NOUTER, the count of
// outer dims, which take the slots 3, 4, ... past the three of the tile.
// They fold into the grid as K7's member does: blockIdx.z = q * ceil(n0 /
// T0) + slot-0 block, q the flat index of the block's outer cell, so
// every block owns one index of each outer dim.  Each array carries a
// stride per outer slot after its three (in_s, out_s), p.n holds the
// outer extents after the three, and the point function sees the outer
// indices in g[3 + j].  A read at an outer offset is an input of its own
// whose interior pointer the wrapper shifts by that offset, so the
// three-offset reads (rd.at(o0, o1, o2)) and the tiles stay as they are.
// What bounds it: bytes, as K1 (test_4d moves 8 B per point per step);
// an outer cell's tile re-reads its neighbours' planes from L2, not from
// device memory.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define YT_HD __host__ __device__
#else
#define YT_HD
#endif
// A CUDA runtime header that defines YT_HOST_BF16 (the CPU emulation's)
// takes the host bf16_t on the device path too.
#if defined(__CUDACC__) && !defined(YT_HOST_BF16)
#include <cuda_bf16.h>
#endif

namespace yt {

typedef long long idx_t;

// ---- bfloat16 storage ---------------------------------------------------
#if defined(__CUDACC__) && !defined(YT_HOST_BF16)
typedef __nv_bfloat16 bf16_t;
YT_HD inline float to_f(bf16_t x) { return __bfloat162float(x); }
YT_HD inline bf16_t to_bf16(float x) { return __float2bfloat16_rn(x); }
#else
// float -> bfloat16, round to nearest even (NaN -> the quiet NaN 0x7fc0),
// as PyTorch's and the device's conversions do
struct bf16_t {
  uint16_t bits;
  bf16_t() = default;
  YT_HD explicit bf16_t(float f) {
    uint32_t u;
    memcpy(&u, &f, 4);
    bits = (u & 0x7fffffffu) > 0x7f800000u
               ? uint16_t(0x7fc0)
               : uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
};
YT_HD inline float to_f(bf16_t x) {
  const uint32_t u = uint32_t(x.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
YT_HD inline bf16_t to_bf16(float x) { return bf16_t(x); }
#endif
// an op's bfloat16 result: computed in float, rounded once
YT_HD inline float rbf(float x) { return to_f(to_bf16(x)); }

// What the point functions compute in, and a store back to real_t.
template <typename R>
struct Calc {
  typedef R type;
  YT_HD static R store(R v) { return v; }
};
template <>
struct Calc<bf16_t> {
  typedef float type;
  YT_HD static bf16_t store(float v) { return to_bf16(v); }
};
template <class S>
using CalcOf = typename Calc<typename S::real_t>::type;

// The outer dims a Spec folds into the grid: its NOUTER where it prints
// one (more than three domain dims), else 0.
template <class S, class = void>
struct OuterOf {
  static constexpr int N = 0;
};
template <class S>
struct OuterOf<S, std::void_t<decltype(S::NOUTER)>> {
  static constexpr int N = S::NOUTER;
};

// Index j of the outer cell q (the last outer dim varies fastest); n is
// p.n, whose outer extents follow the three slots.
template <class S>
YT_HD inline int outer_idx(const int* n, int q, int j) {
  constexpr int N = OuterOf<S>::N;
  if constexpr (N == 1) {
    (void)n; (void)j;
    return q;
  } else {
    for (int i = N - 1; i > j; --i) q /= n[3 + i];
    return q % n[3 + j];
  }
}

// The number of outer cells (1 without outer dims).
template <class S>
YT_HD inline int outer_cells(const int* n) {
  int c = 1;
  for (int j = 0; j < OuterOf<S>::N; ++j) c *= n[3 + j];
  return c;
}

// g[3 + j] = the outer indices of cell q.
template <class S>
YT_HD inline void fill_outer(int* g, const int* n, int q) {
  for (int j = 0; j < OuterOf<S>::N; ++j) g[3 + j] = outer_idx<S>(n, q, j);
}

// The used slots output o's var lacks (a partial-dim written var): the
// Spec's out_slab bitmask where it prints one, else 0.
template <class S, class = void>
struct SlabOf {
  YT_HD static constexpr int get(int) { return 0; }
};
template <class S>
struct SlabOf<S, std::void_t<decltype(S::out_slab(0))>> {
  YT_HD static constexpr int get(int o) { return S::out_slab(o); }
};

// Does the point at interior (g0, g1, g2) of outer cell q (of extents n)
// store output o?  Every point, except that a partial-dim output's slab is
// stored by the points at index 0 of each slot its var lacks (every block
// computes the same slab).
template <class S>
YT_HD inline bool stores(int o, int g0, int g1, int g2, int q = 0,
                         const int* n = nullptr) {
  const int m = SlabOf<S>::get(o);
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j)
      if ((m >> (3 + j) & 1) && outer_idx<S>(n, q, j)) return false;
  } else {
    (void)q; (void)n;
  }
  return !(((m & 1) && g0) || ((m & 2) && g1) || ((m & 4) && g2));
}

// ---- math, overloaded by type (the emitted code calls f_<name>) -------
#define YT_MATH1(NAME, F32, F64)                                   \
  YT_HD inline float f_##NAME(float x) { return F32(x); }          \
  YT_HD inline double f_##NAME(double x) { return F64(x); }
YT_MATH1(sqrt, sqrtf, sqrt)
YT_MATH1(cbrt, cbrtf, cbrt)
YT_MATH1(fabs, fabsf, fabs)
YT_MATH1(erf, erff, erf)
YT_MATH1(exp, expf, exp)
YT_MATH1(log, logf, log)
YT_MATH1(atan, atanf, atan)
YT_MATH1(sin, sinf, sin)
YT_MATH1(cos, cosf, cos)
YT_MATH1(tan, tanf, tan)
YT_MATH1(asin, asinf, asin)
YT_MATH1(acos, acosf, acos)
#undef YT_MATH1

YT_HD inline float f_pow(float x, float y) { return powf(x, y); }
YT_HD inline double f_pow(double x, double y) { return pow(x, y); }

// torch.maximum/minimum: a NaN operand propagates
template <typename T>
YT_HD inline T f_max(T x, T y) { return (x != x || x > y) ? x : y; }
template <typename T>
YT_HD inline T f_min(T x, T y) { return (x != x || x < y) ? x : y; }

// Python/torch `%`: the result takes the divisor's sign
template <typename T>
YT_HD inline T f_mod(T a, T b) {
  T r = fmod(a, b);
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
YT_HD inline int i_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// ---- launch parameters -------------------------------------------------
// NO: the outer dims (slots 3, 4, ...), each with a stride per array and
// an extent in n after the three slots.
template <typename real_t, int NIN, int NOUT, int NO = 0>
struct Params {
  const real_t* in[NIN > 0 ? NIN : 1];  // interior-origin pointers (member 0)
  // element strides per slot, outer slots after the three (0: dim absent)
  idx_t in_s[NIN > 0 ? NIN : 1][3 + NO];
  idx_t in_ms[NIN > 0 ? NIN : 1];       // element stride between members
  real_t* out[NOUT];                    // interior-origin pointers (member 0)
  idx_t out_s[NOUT][3 + NO];
  idx_t out_ms[NOUT];
  int n[3 + NO];                        // interior extents (1: slot unused)
  int t;                                // step index of the newest inputs
  int nm;                               // members (1 for K1)
};

template <class S>
using ParamsOf = Params<typename S::real_t, S::NIN, S::NOUT, OuterOf<S>::N>;

// The element offset of an array's member m (K7: member stride ms), or of
// outer cell m when the Spec has outer dims (strides s[3 + j]; K7 refuses
// them); n is p.n.
template <class S>
YT_HD inline idx_t cell_base(const int* n, int m, idx_t ms, const idx_t* s) {
  if constexpr (OuterOf<S>::N == 0) {
    (void)n; (void)s;
    return m * ms;
  } else {
    (void)ms;
    idx_t off = 0;
    for (int j = 0; j < OuterOf<S>::N; ++j)
      off += idx_t(outer_idx<S>(n, m, j)) * s[3 + j];
    return off;
  }
}

// Inputs are never written during a launch (outputs are fresh tensors), so
// on the device they go through the read-only data path (__ldg), which
// also lets the compiler hoist a point's loads above earlier stores.
template <class S>
YT_HD inline typename S::real_t global_at(const ParamsOf<S>& p, int a, int m,
                                          idx_t c0, idx_t c1, idx_t c2) {
  const typename S::real_t* q =
      p.in[a] + (cell_base<S>(p.n, m, p.in_ms[a], p.in_s[a])
                 + c0 * p.in_s[a][0] + c1 * p.in_s[a][1] + c2 * p.in_s[a][2]);
#ifdef __CUDA_ARCH__
  return __ldg(q);
#else
  return *q;
#endif
}

// Reads every input from global memory (the host path).
template <class S>
struct GlobalReader {
  const ParamsOf<S>* p;
  int m;           // member
  int g0, g1, g2;
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    return global_at<S>(*p, A, m, g0 + o0, g1 + o1, g2 + o2);
  }
};

// Reads staged inputs from the shared-memory tile, the rest from global.
template <class S>
struct TileReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int m;           // member
  int l0, l1, l2;  // point within the block's tile
  int g0, g1, g2;  // point in the interior
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0) {
      constexpr int E1 = S::T1 + S::halo_lo1(k) + S::halo_hi1(k);
      constexpr int E2 = S::T2 + S::halo_lo2(k) + S::halo_hi2(k);
      return smem[S::tile_offset(k)
                  + ((l0 + S::halo_lo0(k) + o0) * E1
                     + (l1 + S::halo_lo1(k) + o1)) * E2
                  + (l2 + S::halo_lo2(k) + o2)];
    } else {
      return global_at<S>(*p, A, m, g0 + o0, g1 + o1, g2 + o2);
    }
  }
};

template <class S>
void fill_params(ParamsOf<S>& p, void* in_ptrs, void* in_strides,
                 void* out_ptrs, void* out_strides, void* sizes, int t) {
  typedef typename S::real_t real_t;
  constexpr int NS = 3 + OuterOf<S>::N;  // slots, outer ones included
  void** ip = static_cast<void**>(in_ptrs);
  const idx_t* is = static_cast<const idx_t*>(in_strides);
  for (int a = 0; a < S::NIN; ++a) {
    p.in[a] = static_cast<const real_t*>(ip[a]);
    for (int s = 0; s < NS; ++s) p.in_s[a][s] = is[NS * a + s];
  }
  void** op = static_cast<void**>(out_ptrs);
  const idx_t* os = static_cast<const idx_t*>(out_strides);
  for (int o = 0; o < S::NOUT; ++o) {
    p.out[o] = static_cast<real_t*>(op[o]);
    for (int s = 0; s < NS; ++s) p.out_s[o][s] = os[NS * o + s];
  }
  const int* n = static_cast<const int*>(sizes);
  for (int s = 0; s < NS; ++s) p.n[s] = n[s];
  p.t = t;
  for (int a = 0; a < (S::NIN > 0 ? S::NIN : 1); ++a) p.in_ms[a] = 0;
  for (int o = 0; o < S::NOUT; ++o) p.out_ms[o] = 0;
  p.nm = 1;
}

// m: the member (K7) or the outer cell
template <class S>
YT_HD inline void store(const ParamsOf<S>& p, int m, int g0, int g1, int g2,
                        const CalcOf<S>* out) {
  for (int o = 0; o < S::NOUT; ++o)
    if (stores<S>(o, g0, g1, g2, m, p.n))
      p.out[o][cell_base<S>(p.n, m, p.out_ms[o], p.out_s[o])
               + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
               + g2 * p.out_s[o][2]] =
          Calc<typename S::real_t>::store(out[o]);
}

// ---- host path: the same point function over every member's interior --
// (or every outer cell's)
template <class S>
int host_step(const ParamsOf<S>& p) {
  const int nq = OuterOf<S>::N > 0 ? outer_cells<S>(p.n) : p.nm;
  for (int m = 0; m < nq; ++m)
    for (int g0 = 0; g0 < p.n[0]; ++g0)
      for (int g1 = 0; g1 < p.n[1]; ++g1)
        for (int g2 = 0; g2 < p.n[2]; ++g2) {
          const GlobalReader<S> rd{&p, m, g0, g1, g2};
          int g[3 + OuterOf<S>::N] = {g0, g1, g2};
          fill_outer<S>(g, p.n, m);
          CalcOf<S> out[S::NOUT];
          S::point(rd, g, p.n, p.t, out);
          store<S>(p, m, g0, g1, g2, out);
        }
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// BATCH = false is K1 (one member, no member offsets); BATCH = true is K7,
// whose blockIdx.z also selects the member.  With outer dims, K1's
// blockIdx.z selects the outer cell the same way (m = q).
template <class S, bool BATCH>
__global__ void __launch_bounds__(S::T1 * S::T2)
fused_step_kernel(const __grid_constant__ ParamsOf<S> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  int m = 0, bz = blockIdx.z;
  if constexpr (BATCH || OuterOf<S>::N > 0) {
    const int nb0 = (p.n[0] + S::T0 - 1) / S::T0;
    m = bz / nb0;
    bz -= m * nb0;
  }
  const int b0 = bz * S::T0;
  const int b1 = blockIdx.y * S::T1;
  const int b2 = blockIdx.x * S::T2;
  const int tid = threadIdx.y * S::T2 + threadIdx.x;

  // 1) stage each tiled input's halo tile; cells outside [-halo, n+halo)
  //    (the ragged edge of the last blocks) are never read and hold 0.
  //    Each thread issues U independent loads before it stores any, so
  //    that many device-memory requests are in flight per thread:
  //    with one 512-thread block per SM (the tile fills shared memory) the
  //    staging is otherwise bound by one load's latency per cell.
  constexpr int NT = S::T1 * S::T2;
  constexpr int U = 16;
#pragma unroll
  for (int k = 0; k < S::NTILED; ++k) {
    const int a = S::tiled_input(k);
    const int h0 = S::halo_lo0(k), h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
    const int E1 = S::T1 + h1 + S::halo_hi1(k);
    const int E2 = S::T2 + h2 + S::halo_hi2(k);
    const int cells = (S::T0 + h0 + S::halo_hi0(k)) * E1 * E2;
    const int lim0 = p.n[0] + S::halo_hi0(k);
    const int lim1 = p.n[1] + S::halo_hi1(k);
    const int lim2 = p.n[2] + S::halo_hi2(k);
    real_t* dst = smem + S::tile_offset(k);
    for (int base = tid; base < cells; base += NT * U) {
      real_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * NT;
        const int e2 = i % E2;
        const int r = i / E2;
        const int c0 = b0 - h0 + r / E1;
        const int c1 = b1 - h1 + r % E1;
        const int c2 = b2 - h2 + e2;
        v[u] = (i < cells && c0 < lim0 && c1 < lim1 && c2 < lim2)
                   ? global_at<S>(p, a, m, c0, c1, c2) : real_t(0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * NT < cells) dst[base + u * NT] = v[u];
    }
  }
  __syncthreads();

  // 2) compute: one thread per (slot 1, slot 2) point, a loop over slot 0
  const int l1 = threadIdx.y, l2 = threadIdx.x;
  const int g1 = b1 + l1, g2 = b2 + l2;
  if (g1 >= p.n[1] || g2 >= p.n[2]) return;
#pragma unroll
  for (int l0 = 0; l0 < S::T0; ++l0) {
    const int g0 = b0 + l0;
    if (g0 >= p.n[0]) break;
    const TileReader<S> rd{&p, smem, m, l0, l1, l2, g0, g1, g2};
    int g[3 + OuterOf<S>::N] = {g0, g1, g2};
    fill_outer<S>(g, p.n, m);
    CalcOf<S> out[S::NOUT];
    S::point(rd, g, p.n, p.t, out);
    store<S>(p, m, g0, g1, g2, out);
  }
}

template <class S, bool BATCH>
int launch(const ParamsOf<S>& p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_step_kernel<S, BATCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const long long nb0 = (p.n[0] + S::T0 - 1) / S::T0;
  const long long gz = BATCH ? nb0 * p.nm : nb0 * outer_cells<S>(p.n);
  if (gz > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 block(S::T2, S::T1, 1);
  const dim3 grid((p.n[2] + S::T2 - 1) / S::T2, (p.n[1] + S::T1 - 1) / S::T1,
                  unsigned(gz));
  fused_step_kernel<S, BATCH><<<grid, block, smem, stream>>>(p);
  return int(cudaGetLastError());
}
#endif

template <class S>
int run(void* in_ptrs, void* in_strides, void* out_ptrs, void* out_strides,
        void* sizes, int t, void* stream) {
  ParamsOf<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
#ifdef __CUDACC__
  return launch<S, false>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_step<S>(p);
#endif
}

// K7: as run(), over `nm` members whose arrays sit `in_mstrides[a]` /
// `out_mstrides[o]` elements apart (arrays of idx_t).
template <class S>
int run_batched(void* in_ptrs, void* in_strides, void* in_mstrides,
                void* out_ptrs, void* out_strides, void* out_mstrides,
                void* sizes, int nm, int t, void* stream) {
  ParamsOf<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  const idx_t* ims = static_cast<const idx_t*>(in_mstrides);
  const idx_t* oms = static_cast<const idx_t*>(out_mstrides);
  for (int a = 0; a < S::NIN; ++a) p.in_ms[a] = ims[a];
  for (int o = 0; o < S::NOUT; ++o) p.out_ms[o] = oms[o];
  p.nm = nm;
#ifdef __CUDACC__
  return launch<S, true>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_step<S>(p);
#endif
}

// ==== K5: one sub-step over a box of one shard ==========================
// Replaces the region= arm (pallas_stencil.py:736-780) and the
// distributed=True arm (:781-811, the shard offsets added to the global
// index base at :1948-1953) of build_pallas_chunk, which
// parallel/shard_step.py's shard_pallas path runs per shard.  One launch
// computes one sub-step of a single-stage solution over a compute box
// [lo, hi) per slot in the shard's local interior coordinates: lo may be
// negative and hi may pass n, reaching into the ghost pads by the
// sub-step's expansion (the shard_pallas group grows the box by r per
// later sub-step), or the box is a core or shell region inside [0, n).
// The point function sees global coordinates: the shard's origin `off` is
// added to every coordinate and the global extents `gn` drive the domain
// conditions, so a cell outside the global domain is written as 0.
// Outputs are fresh zeroed tensors; the wrapper (fused_stencil.shard_step)
// keeps what the box writes in the ghosts for the later sub-steps of the
// group.
//
// What bounds it on an H100: bytes, as K1 (the same 16 B/pt per iso3dfd
// r=8 step over the box).  Design: K1's body with the box and the origin
// as runtime parameters: the grid covers hi - lo, the staging limits come
// from the box instead of [-halo, n + halo), and the point function is
// K1's (`Spec::point`, built with --fmad=false), so a shard's cell gets
// the bits a single-domain K1 launch gives it.
template <class S>
struct RegionParams {
  ParamsOf<S> p;     // K1's tables (p.n: the shard's interior extents)
  int lo[3], hi[3];  // the box, local interior coordinates
  int off[3];        // the shard's global origin
  int gn[3];         // the global domain extents
};

template <class S>
YT_HD inline bool in_global(const RegionParams<S>& p, const int* gg) {
  return gg[0] >= 0 && gg[0] < p.gn[0] && gg[1] >= 0 && gg[1] < p.gn[1]
         && gg[2] >= 0 && gg[2] < p.gn[2];
}

// ---- host path: the box with global reads -------------------------------
template <class S>
int host_region(const RegionParams<S>& p) {
  for (int g0 = p.lo[0]; g0 < p.hi[0]; ++g0)
    for (int g1 = p.lo[1]; g1 < p.hi[1]; ++g1)
      for (int g2 = p.lo[2]; g2 < p.hi[2]; ++g2) {
        const int gg[3] = {g0 + p.off[0], g1 + p.off[1], g2 + p.off[2]};
        CalcOf<S> out[S::NOUT];
        if (in_global<S>(p, gg)) {
          const GlobalReader<S> rd{&p.p, 0, g0, g1, g2};
          S::point(rd, gg, p.gn, p.p.t, out);
        } else {
          for (int o = 0; o < S::NOUT; ++o) out[o] = CalcOf<S>(0);
        }
        store<S>(p.p, 0, g0, g1, g2, out);
      }
  return 0;
}

#ifdef __CUDACC__
template <class S>
__global__ void __launch_bounds__(S::T1 * S::T2)
fused_region_kernel(const __grid_constant__ RegionParams<S> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsOf<S>& q = p.p;
  const int b0 = p.lo[0] + int(blockIdx.z) * S::T0;
  const int b1 = p.lo[1] + int(blockIdx.y) * S::T1;
  const int b2 = p.lo[2] + int(blockIdx.x) * S::T2;
  const int tid = threadIdx.y * S::T2 + threadIdx.x;

  // 1) stage each tiled input's halo tile as K1 does; cells past the
  //    box's read reach (the ragged edge of the last blocks) hold 0.  The
  //    wrapper checks that [lo - halo, hi + halo) lies inside the pads.
  constexpr int NT = S::T1 * S::T2;
  constexpr int U = 16;
#pragma unroll
  for (int k = 0; k < S::NTILED; ++k) {
    const int a = S::tiled_input(k);
    const int h0 = S::halo_lo0(k), h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
    const int E1 = S::T1 + h1 + S::halo_hi1(k);
    const int E2 = S::T2 + h2 + S::halo_hi2(k);
    const int cells = (S::T0 + h0 + S::halo_hi0(k)) * E1 * E2;
    const int lim0 = p.hi[0] + S::halo_hi0(k);
    const int lim1 = p.hi[1] + S::halo_hi1(k);
    const int lim2 = p.hi[2] + S::halo_hi2(k);
    real_t* dst = smem + S::tile_offset(k);
    for (int base = tid; base < cells; base += NT * U) {
      real_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * NT;
        const int e2 = i % E2;
        const int r = i / E2;
        const int c0 = b0 - h0 + r / E1;
        const int c1 = b1 - h1 + r % E1;
        const int c2 = b2 - h2 + e2;
        v[u] = (i < cells && c0 < lim0 && c1 < lim1 && c2 < lim2)
                   ? global_at<S>(q, a, 0, c0, c1, c2) : real_t(0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * NT < cells) dst[base + u * NT] = v[u];
    }
  }
  __syncthreads();

  // 2) compute the box's cells: the point function at global coordinates,
  //    0 outside the global domain
  const int l1 = threadIdx.y, l2 = threadIdx.x;
  const int g1 = b1 + l1, g2 = b2 + l2;
  if (g1 >= p.hi[1] || g2 >= p.hi[2]) return;
#pragma unroll
  for (int l0 = 0; l0 < S::T0; ++l0) {
    const int g0 = b0 + l0;
    if (g0 >= p.hi[0]) break;
    const int gg[3] = {g0 + p.off[0], g1 + p.off[1], g2 + p.off[2]};
    CalcOf<S> out[S::NOUT];
    if (in_global<S>(p, gg)) {
      const TileReader<S> rd{&q, smem, 0, l0, l1, l2, g0, g1, g2};
      S::point(rd, gg, p.gn, q.t, out);
    } else {
#pragma unroll
      for (int o = 0; o < S::NOUT; ++o) out[o] = CalcOf<S>(0);
    }
    store<S>(q, 0, g0, g1, g2, out);
  }
}

template <class S>
int launch_region(const RegionParams<S>& p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_region_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const long long gz = (p.hi[0] - p.lo[0] + S::T0 - 1) / S::T0;
  if (gz > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 block(S::T2, S::T1, 1);
  const dim3 grid((p.hi[2] - p.lo[2] + S::T2 - 1) / S::T2,
                  (p.hi[1] - p.lo[1] + S::T1 - 1) / S::T1, unsigned(gz));
  fused_region_kernel<S><<<grid, block, smem, stream>>>(p);
  return int(cudaGetLastError());
}
#endif

// K5: as run(), over the box `region` = int[12]: lo[3], hi[3], off[3],
// gn[3] per slot.
template <class S>
int run_region(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, void* region, int t,
               void* stream) {
  RegionParams<S> p;
  fill_params<S>(p.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  const int* r = static_cast<const int*>(region);
  for (int s = 0; s < 3; ++s) {
    p.lo[s] = r[s];
    p.hi[s] = r[3 + s];
    p.off[s] = r[6 + s];
    p.gn[s] = r[9 + s];
  }
  for (int s = 0; s < 3; ++s)
    if (p.hi[s] <= p.lo[s]) return 0;  // an empty box computes nothing
#ifdef __CUDACC__
  return launch_region<S>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_region<S>(p);
#endif
}

// ==== K6: several stages per launch =====================================
// Replaces the push= arm of build_pallas_chunk with its stage loop
// (pallas_stencil.py:495-563, :995-1058, :1859-1871, :2058-2188) and the
// scratch chains its tile evaluator computes in-tile (_TileEval.read
// :175-179, the stage loop's reset :2003 and scratch writes :2105-2147):
// one launch does every stage of one sub-step of a multi-stage solution,
// such as the merged RTM chain of ops/pipeline.py (forward step ->
// imaging condition -> smoothing), AWP's velocity, stress and boundary
// stages, or a solution with scratch vars such as TTI.  ops/cuda_emit.py
// prints Spec::stage<K> per sub-stage and the tables used below.
//
// What bounds it on an H100: bytes.  The merged pure RTM chain at r=2
// does ~60 FLOP per point and must move 20 B per point per step at fp32
// with the image pushed (pressure t, t-1 and vel read, pressure t+1 and
// smooth written): 0.80 ms per step at 512^3 over 3.35 TB/s against
// 0.13 ms of FLOPs.  What the design does about it: every intermediate a
// later stage reads at the same step stays in shared memory, so the chain
// moves what one stage would; a pushed var (read only that way) has no
// device-memory input or output at all; a scratch var never leaves
// shared memory.  The price is recomputation: a scratch tile covers the
// block grown by its write halo (TTI r=2 at 2x8x64: 4.8 cells per point).
//
// Design (a first cut that is simple and right):
//   * a block owns T0 x T1 x T2 interior points, as in K1.  The stages
//     split into sub-stages: one per scratch write halo of a scratch part
//     (its vars), then one for the stage's other parts.  Sub-stage K
//     covers the block grown by sub_lo/sub_hi(K) per slot: the read
//     widths of the later stages, plus a scratch var's write halo
//     (asymmetric, as ana.scratch_write_halo), so every input tile's
//     halo grows by that much;
//   * 1) stage the tiled inputs as K1 does, except that each holds what
//     its allocation holds (the pads included: a scratch var is computed
//     past the domain and reads them there) and 0 past it;
//   * 2) each sub-stage loops its threads over the cells of its region
//     (a grown region does not map one thread per point).  A cell outside
//     the plain version's region of the sub-stage -- the domain, grown by
//     the write halo for scratch (clip_lo/clip_hi) -- is not computed and
//     holds zero, which is what the plain version's zero pads give a later
//     stage's read there; a scratch cell inside it is computed, index
//     values < 0 or >= n included.  Results go to the sub-stage's
//     computed tiles in shared memory (one per var and writing sub-stage:
//     a var a later stage rewrites gets a second tile, so the rewrite
//     never writes what its neighbours still read, and a conditional
//     rewrite keeps the first tile's value as its base) and, for the
//     block's own interior points, to the fresh zeroed outputs of the
//     vars that are not pushed, by the last sub-stage that writes each;
//     __syncthreads between sub-stages.
//
// The host path (no __CUDACC__) runs each sub-stage over its plain region
// of the whole domain with global reads, keeping each computed tile in a
// zeroed host buffer over the domain grown by its sub-stage's region.
//
// Outer dims (NOUTER): a block owns one outer cell q, as in K1.  What a
// later stage reads at an outer offset, an earlier stage computes in an
// outer copy of its sub-stage, one per offset of its region (sub_dw(K,
// j)); a copy reads inputs that the wrapper shifted by its offset and
// writes tiles of its own, and is computed only where its outer index
// lies inside the plain region (oclip_lo/oclip_hi), else it holds 0.  A
// staged input whose outer index lies past its allocation (outer_alo/
// outer_ahi) is staged as 0.  The host path runs every outer cell in
// turn, its buffers zeroed for each.
//
// Element size 2: the staged and computed tiles are bf16_t, as the
// reference's VMEM tiles are in the program dtype (pallas_stencil.py:
// 2264-2289); a computed value is stored rounded once, as yask_tpu
// stores a stage's value or a scratch var.

// Reads of one sub-stage point: staged inputs from their tile (others
// from global memory) and earlier sub-stages' results from their computed
// tiles.
template <class S>
struct StageReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int q;           // the block's outer cell (0 without outer dims)
  int l0, l1, l2;  // point relative to the block origin (may lie in the
                   // expansion: < 0 or >= T)
  int g0, g1, g2;  // point in the interior (may lie past the domain)
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0) {
      constexpr int E1 = S::T1 + S::halo_lo1(k) + S::halo_hi1(k);
      constexpr int E2 = S::T2 + S::halo_lo2(k) + S::halo_hi2(k);
      return smem[S::tile_offset(k)
                  + ((l0 + S::halo_lo0(k) + o0) * E1
                     + (l1 + S::halo_lo1(k) + o1)) * E2
                  + (l2 + S::halo_lo2(k) + o2)];
    } else {
      return global_at<S>(*p, A, q, g0 + o0, g1 + o1, g2 + o2);
    }
  }
  template <int B>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2) const {
    constexpr int k = S::cmp_sub(B);
    constexpr int e0 = S::sub_lo0(k), e1 = S::sub_lo1(k), e2 = S::sub_lo2(k);
    constexpr int R1 = S::T1 + e1 + S::sub_hi1(k);
    constexpr int R2 = S::T2 + e2 + S::sub_hi2(k);
    return smem[S::cmp_offset(B) + ((l0 + e0 + o0) * R1 + (l1 + e1 + o1)) * R2
                + (l2 + e2 + o2)];
  }
};

// The host path's reader: global inputs, whole-domain computed buffers.
template <class S>
struct HostStageReader {
  const ParamsOf<S>* p;
  typename S::real_t* const* bufs;
  int q;           // the outer cell
  int g0, g1, g2;
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    return global_at<S>(*p, A, q, g0 + o0, g1 + o1, g2 + o2);
  }
  template <int B>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2) const {
    constexpr int k = S::cmp_sub(B);
    constexpr int e0 = S::sub_lo0(k), e1 = S::sub_lo1(k), e2 = S::sub_lo2(k);
    const idx_t R1 = p->n[1] + e1 + S::sub_hi1(k);
    const idx_t R2 = p->n[2] + e2 + S::sub_hi2(k);
    return bufs[B][((g0 + e0 + o0) * R1 + (g1 + e1 + o1)) * R2
                   + (g2 + e2 + o2)];
  }
};

// g[3 + j] = the outer indices of sub-stage K's copy in cell q (the
// cell's plus the copy's offset); returns whether they all lie inside
// the copy's plain region.
template <class S, int K>
YT_HD inline bool outer_copy(int* g, const int* n, int q) {
  bool in = true;
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j) {
      g[3 + j] = outer_idx<S>(n, q, j) + S::sub_dw(K, j);
      in = in && g[3 + j] >= -S::oclip_lo(K, j)
           && g[3 + j] < n[3 + j] + S::oclip_hi(K, j);
    }
  } else {
    (void)g; (void)n; (void)q;
  }
  return in;
}

template <class S, int K>
void host_stage(const ParamsOf<S>& p, typename S::real_t* const* bufs,
                int q) {
  typedef typename S::real_t real_t;
  constexpr int e0 = S::sub_lo0(K), e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
  const idx_t R1 = p.n[1] + e1 + S::sub_hi1(K);
  const idx_t R2 = p.n[2] + e2 + S::sub_hi2(K);
  int g[3 + OuterOf<S>::N];
  if (outer_copy<S, K>(g, p.n, q))
  for (int g0 = -S::clip_lo0(K); g0 < p.n[0] + S::clip_hi0(K); ++g0)
    for (int g1 = -S::clip_lo1(K); g1 < p.n[1] + S::clip_hi1(K); ++g1)
      for (int g2 = -S::clip_lo2(K); g2 < p.n[2] + S::clip_hi2(K); ++g2) {
        const HostStageReader<S> rd{&p, bufs, q, g0, g1, g2};
        g[0] = g0;
        g[1] = g1;
        g[2] = g2;
        CalcOf<S> v[S::MAXV];
        S::template stage<K>(rd, g, p.n, p.t, v);
        for (int j = 0; j < S::stage_nv(K); ++j) {
          const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
          const real_t w = Calc<real_t>::store(v[j]);
          if (o >= 0 && stores<S>(o, g0, g1, g2, q, p.n))
            p.out[o][cell_base<S>(p.n, q, p.out_ms[o], p.out_s[o])
                     + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                     + g2 * p.out_s[o][2]] = w;
          if (b >= 0)
            bufs[b][((g0 + e0) * R1 + (g1 + e1)) * R2 + (g2 + e2)] = w;
        }
      }
  if constexpr (K + 1 < S::NSTAGES) host_stage<S, K + 1>(p, bufs, q);
}

template <class S>
int host_stages(const ParamsOf<S>& p) {
  typedef typename S::real_t real_t;
  std::vector<std::vector<real_t>> store(S::NCMP);
  real_t* bufs[S::NCMP > 0 ? S::NCMP : 1] = {nullptr};
  for (int q = 0; q < outer_cells<S>(p.n); ++q) {
    for (int b = 0; b < S::NCMP; ++b) {
      const int k = S::cmp_sub(b);
      store[b].assign(size_t(p.n[0] + S::sub_lo0(k) + S::sub_hi0(k))
                          * size_t(p.n[1] + S::sub_lo1(k) + S::sub_hi1(k))
                          * size_t(p.n[2] + S::sub_lo2(k) + S::sub_hi2(k)),
                      real_t(0.0f));
      bufs[b] = store[b].data();
    }
    host_stage<S, 0>(p, bufs, q);
  }
  return 0;
}

#ifdef __CUDACC__
// One sub-stage over its region: a loop of the block's threads over its
// cells.
template <class S, int K>
__device__ __forceinline__ void device_stage(const ParamsOf<S>& p,
                                             typename S::real_t* smem,
                                             int q, int b0, int b1, int b2,
                                             int tid) {
  typedef typename S::real_t real_t;
  constexpr int NT = S::T1 * S::T2;
  constexpr int e0 = S::sub_lo0(K), e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
  constexpr int R0 = S::T0 + e0 + S::sub_hi0(K);
  constexpr int R1 = S::T1 + e1 + S::sub_hi1(K);
  constexpr int R2 = S::T2 + e2 + S::sub_hi2(K);
  constexpr int cells = R0 * R1 * R2;
  // the outer indices of this copy; a copy outside its plain region in an
  // outer dim holds 0 everywhere
  int g[3 + OuterOf<S>::N];
  const bool in_outer = outer_copy<S, K>(g, p.n, q);
  for (int i = tid; i < cells; i += NT) {
    const int l2 = i % R2 - e2;
    const int r = i / R2;
    const int l1 = r % R1 - e1;
    const int l0 = r / R1 - e0;
    const int g0 = b0 + l0, g1 = b1 + l1, g2 = b2 + l2;
    // the plain version's region: the domain, grown by a scratch var's
    // write halo
    const bool inside = g0 >= -S::clip_lo0(K) && g0 < p.n[0] + S::clip_hi0(K)
                        && g1 >= -S::clip_lo1(K)
                        && g1 < p.n[1] + S::clip_hi1(K)
                        && g2 >= -S::clip_lo2(K)
                        && g2 < p.n[2] + S::clip_hi2(K) && in_outer;
    CalcOf<S> v[S::MAXV];
    if (inside) {
      const StageReader<S> rd{&p, smem, q, l0, l1, l2, g0, g1, g2};
      g[0] = g0;
      g[1] = g1;
      g[2] = g2;
      S::template stage<K>(rd, g, p.n, p.t, v);
    } else {
#pragma unroll
      for (int j = 0; j < S::MAXV; ++j) v[j] = CalcOf<S>(0);
    }
    const bool own = l0 >= 0 && l0 < S::T0 && l1 >= 0 && l1 < S::T1
                     && l2 >= 0 && l2 < S::T2 && g0 < p.n[0] && g1 < p.n[1]
                     && g2 < p.n[2];
#pragma unroll
    for (int j = 0; j < S::MAXV; ++j) {
      if (j >= S::stage_nv(K)) break;
      const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
      const real_t w = Calc<real_t>::store(v[j]);
      if (o >= 0 && own && stores<S>(o, g0, g1, g2, q, p.n))
        p.out[o][cell_base<S>(p.n, q, p.out_ms[o], p.out_s[o])
                 + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                 + g2 * p.out_s[o][2]] = w;
      if (b >= 0)
        smem[S::cmp_offset(b) + ((l0 + e0) * R1 + (l1 + e1)) * R2
             + (l2 + e2)] = w;
    }
  }
  if constexpr (K + 1 < S::NSTAGES) {
    __syncthreads();
    device_stage<S, K + 1>(p, smem, q, b0, b1, b2, tid);
  }
}

// Is staged input k's outer index inside its allocation in outer cell q?
template <class S>
__device__ __forceinline__ bool outer_alloc(const ParamsOf<S>& p, int k,
                                            int q) {
  bool in = true;
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j) {
      const int c = outer_idx<S>(p.n, q, j);
      in = in && c >= -S::outer_alo(k, j)
           && c < p.n[3 + j] + S::outer_ahi(k, j);
    }
  } else {
    (void)p; (void)k; (void)q;
  }
  return in;
}

template <class S>
__global__ void __launch_bounds__(S::T1 * S::T2)
fused_stages_kernel(const __grid_constant__ ParamsOf<S> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  int q = 0, bz = blockIdx.z;
  if constexpr (OuterOf<S>::N > 0) {
    const int nb0 = (p.n[0] + S::T0 - 1) / S::T0;
    q = bz / nb0;
    bz -= q * nb0;
  }
  const int b0 = bz * S::T0;
  const int b1 = blockIdx.y * S::T1;
  const int b2 = blockIdx.x * S::T2;
  const int tid = threadIdx.y * S::T2 + threadIdx.x;

  // 1) stage each tiled input's halo tile (U loads in flight per thread,
  //    as K1); cells past the input's allocation hold 0
  constexpr int NT = S::T1 * S::T2;
  constexpr int U = 16;
#pragma unroll
  for (int k = 0; k < S::NTILED; ++k) {
    const int a = S::tiled_input(k);
    const int h0 = S::halo_lo0(k), h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
    const int E1 = S::T1 + h1 + S::halo_hi1(k);
    const int E2 = S::T2 + h2 + S::halo_hi2(k);
    const int cells = (S::T0 + h0 + S::halo_hi0(k)) * E1 * E2;
    const int lo0 = -S::alloc_lo0(k), lim0 = p.n[0] + S::alloc_hi0(k);
    const int lo1 = -S::alloc_lo1(k), lim1 = p.n[1] + S::alloc_hi1(k);
    const int lo2 = -S::alloc_lo2(k), lim2 = p.n[2] + S::alloc_hi2(k);
    const bool in_outer = outer_alloc<S>(p, k, q);
    real_t* dst = smem + S::tile_offset(k);
    for (int base = tid; base < cells; base += NT * U) {
      real_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * NT;
        const int e2 = i % E2;
        const int r = i / E2;
        const int c0 = b0 - h0 + r / E1;
        const int c1 = b1 - h1 + r % E1;
        const int c2 = b2 - h2 + e2;
        v[u] = (i < cells && c0 >= lo0 && c0 < lim0 && c1 >= lo1
                && c1 < lim1 && c2 >= lo2 && c2 < lim2 && in_outer)
                   ? global_at<S>(p, a, q, c0, c1, c2) : real_t(0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * NT < cells) dst[base + u * NT] = v[u];
    }
  }
  __syncthreads();

  // 2) the sub-stages in order, each over its region
  device_stage<S, 0>(p, smem, q, b0, b1, b2, tid);
}

template <class S>
int launch_stages(const ParamsOf<S>& p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_stages_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  const long long gz =
      (long long)((p.n[0] + S::T0 - 1) / S::T0) * outer_cells<S>(p.n);
  if (gz > 65535) return int(cudaErrorInvalidConfiguration);
  const dim3 block(S::T2, S::T1, 1);
  const dim3 grid((p.n[2] + S::T2 - 1) / S::T2, (p.n[1] + S::T1 - 1) / S::T1,
                  unsigned(gz));
  fused_stages_kernel<S><<<grid, block, smem, stream>>>(p);
  return int(cudaGetLastError());
}
#endif

// K6: as run(), every stage (and scratch sub-stage) of one sub-step.
template <class S>
int run_stages(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, int t, void* stream) {
  ParamsOf<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
#ifdef __CUDACC__
  return launch_stages<S>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_stages<S>(p);
#endif
}

}  // namespace yt

// The C entry point of one emitted kernel: pointers arrive as addresses of
// arrays (ctypes c_void_p); returns cudaGetLastError() (0 on the host).
#define YT_FUSED_STEP_ENTRY(NAME, S)                                         \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, int t, void* stream) { \
    return yt::run<S>(in_ptrs, in_strides, out_ptrs, out_strides, sizes, t,  \
                      stream);                                               \
  }

// The C entry point of K7 for the same Spec (member strides and count).
#define YT_FUSED_BATCHED_ENTRY(NAME, S)                                      \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* in_mstrides,    \
                      void* out_ptrs, void* out_strides, void* out_mstrides, \
                      void* sizes, int nm, int t, void* stream) {            \
    return yt::run_batched<S>(in_ptrs, in_strides, in_mstrides, out_ptrs,    \
                              out_strides, out_mstrides, sizes, nm, t,       \
                              stream);                                       \
  }

// The C entry point of K5 for the same Spec: K1's arguments, then the box,
// origin and global extents (int[12]) before the step index.
#define YT_FUSED_REGION_ENTRY(NAME, S)                                       \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, void* region, int t,   \
                      void* stream) {                                        \
    return yt::run_region<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, region, t, stream);                      \
  }

// The C entry point of K6 (K1's arguments) for a multi-stage Spec.
#define YT_FUSED_STAGES_ENTRY(NAME, S)                                       \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, int t, void* stream) { \
    return yt::run_stages<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, t, stream);                              \
  }
