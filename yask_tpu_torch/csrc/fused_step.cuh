// fused_step.cuh — tile machinery of K1 (one sub-step of a fused stencil
// chunk) and K7 (the same sub-step for N independent ensemble members in
// one launch) for NVIDIA Hopper, sm_90a.
//
// (K6, several stages per launch, and K5, one sub-step over a box of one
// shard on K1's or K6's body, follow below with their own notes.)
//
// K1 replaces the inner `kernel` of build_pallas_chunk
// (yask_tpu/ops/pallas_stencil.py) for one sub-step; K7 replaces the
// jax.vmap of that chunk in EnsembleRun._batched_chunk_fn
// (yask_tpu/runtime/ensemble.py).  The wrappers in
// yask_tpu_torch/ops/fused_stencil.py launch one of them once per step and
// rotate the step rings between launches.  ops/cuda_emit.py prints, per
// solution, a `Spec` struct holding the per-point update (`Spec::point`)
// and the compile-time tables used below, then instantiates
// YT_FUSED_STEP_ENTRY (K1), YT_FUSED_BATCHED_ENTRY (K7) and
// YT_FUSED_REGION_ENTRY (K5).
//
// K7 is K1 (or K6, below) with a member axis: every state array is a
// contiguous (N, *shape) stack, each input and output carries a 64-bit
// member stride, and the grid folds the member into its z cells (z =
// (member * outer cells + outer cell) * ceil(n0/T0) + slot-0 block).  A
// block stages and computes exactly what a solo block does, offset by its
// member, so each member gets the bits a solo launch gives it.  It is
// bound by bytes as K1 and K6 are (N times their traffic); its gain over
// N solo launches is N-1 launch gaps and one grid that fills the card when
// one member alone would not.
//
// The z cells (members x outer cells x slot-0 blocks) may pass CUDA's
// limit of 65535 on gridDim.z: the launch code walks them in launches of
// at most YT_MAX_GRID_Z cells each, the z origin of each in the params
// (p.z0).  Several launches rather than a grid-stride loop inside the
// kernel, because a block's threads leave early past the ragged edge and
// a loop would need a barrier between cells that those threads never
// reach.
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
// The most z cells one launch takes (CUDA's gridDim.z limit); the CPU
// emulation sets it small to walk the chunks on a small grid.
#ifndef YT_MAX_GRID_Z
#define YT_MAX_GRID_Z 65535
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

// The workspace arm (a Spec that prints WS_ELEMS): the tiles that do not
// fit shared memory live in the block's slice of WS_ELEMS elements of a
// device-memory workspace, at tile offsets from SMEM_ELEMS on.
template <class S, class = void>
struct WsOf {
  static constexpr bool value = false;
};
template <class S>
struct WsOf<S, std::void_t<decltype(S::WS_ELEMS)>> {
  static constexpr bool value = true;
};

// A tile's storage: shared memory, or past SMEM_ELEMS the workspace.
template <class S, class T>
YT_HD inline T* tile_at(T* smem, T* ws, int off) {
  if constexpr (WsOf<S>::value) {
    return off < S::SMEM_ELEMS ? smem + off : ws + (off - S::SMEM_ELEMS);
  } else {
    (void)ws;
    return smem + off;
  }
}

// K6's flat arm (a Spec that prints FLAT_NT: a solution that leaves slot
// 0 unused): FLAT_NT threads serve a T1 x T2 tile, the staged inputs
// double-buffered BUF_ELEMS elements apart.  NT is the body's thread
// count: FLAT_NT there, T1 x T2 elsewhere.
template <class S, class = void>
struct FlatOf {
  static constexpr bool value = false;
  static constexpr int NT = S::T1 * S::T2;
};
template <class S>
struct FlatOf<S, std::void_t<decltype(S::FLAT_NT)>> {
  static constexpr bool value = true;
  static constexpr int NT = S::FLAT_NT;
};

// Does the point at interior (g0, g1, g2) of outer cell q (of extents n)
// store output o?  Every point, except that a partial-dim output's slab is
// stored by the points at index 0 of each slot its var lacks (every block
// computes the same slab).  K5 (REGION, g box indices) stores it at the
// shard's index 0, box index -lo, which every shard holds inside the
// global domain.
template <class S, bool REGION = false>
YT_HD inline bool stores(int o, int g0, int g1, int g2, int q = 0,
                         const int* n = nullptr, const int* lo = nullptr) {
  const int m = SlabOf<S>::get(o);
  int z[3 + OuterOf<S>::N] = {};
  if constexpr (REGION) {
    for (int s = 0; s < 3 + OuterOf<S>::N; ++s) z[s] = lo[s];
  } else {
    (void)lo;
  }
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j)
      if ((m >> (3 + j) & 1) && outer_idx<S>(n, q, j) + z[3 + j])
        return false;
  } else {
    (void)q; (void)n;
  }
  return !(((m & 1) && g0 + z[0]) || ((m & 2) && g1 + z[1])
           || ((m & 4) && g2 + z[2]));
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
  int nm;                               // members (1 for a solo launch)
  long long z0;                         // this launch's first z cell
};

template <class S>
using ParamsOf = Params<typename S::real_t, S::NIN, S::NOUT, OuterOf<S>::N>;

// K5's launch (below): K1's or K6's tables with the pointers moved to the
// box's cell 0 and p.n holding the box's extents, so the tile machinery
// runs over the box as it runs over an interior; per slot (outer ones
// included) the box's origin in the shard's interior, the shard's
// interior extents, the box origin's global coordinate and the global
// extents.
template <class S>
struct RegionParams : ParamsOf<S> {
  int lo[3 + OuterOf<S>::N];
  int sn[3 + OuterOf<S>::N];
  int go[3 + OuterOf<S>::N];
  int gn[3 + OuterOf<S>::N];
};

// A kernel's parameters: K5's (REGION) or the others', and the workspace
// of the workspace arm (WsOf).
template <class S, bool REGION>
using BodyParams =
    typename std::conditional<REGION, RegionParams<S>, ParamsOf<S>>::type;
template <class S, bool REGION>
struct WsParams : BodyParams<S, REGION> {
  typename S::real_t* ws;  // WS_ELEMS elements per resident block
};
template <class S, bool REGION>
using ParamsArg =
    typename std::conditional<WsOf<S>::value, WsParams<S, REGION>,
                              BodyParams<S, REGION>>::type;

// Sets the workspace of the workspace arm (nothing for the others).
template <class S, class P>
void fill_ws(P& p, void* ws) {
  if constexpr (WsOf<S>::value)
    p.ws = static_cast<typename S::real_t*>(ws);
  else
    (void)p, (void)ws;
}

// The point function's coordinates and extents: K1's and K6's are the
// interior's; K5 adds the box's global origin to g (box indices) and
// returns whether the point lies inside the global domain.
template <class S, bool REGION>
YT_HD inline bool to_global(const ParamsArg<S, REGION>& p, int* g) {
  if constexpr (REGION) {
    bool in = true;
    for (int s = 0; s < 3 + OuterOf<S>::N; ++s) {
      g[s] += p.go[s];
      in = in && g[s] >= 0 && g[s] < p.gn[s];
    }
    return in;
  } else {
    (void)p; (void)g;
    return true;
  }
}

// The box's origin in the shard's interior in slot s (0 but in K5).
template <class S, bool REGION>
YT_HD inline int box_lo(const ParamsArg<S, REGION>& p, int s) {
  if constexpr (REGION)
    return p.lo[s];
  else
    return ((void)p, (void)s, 0);
}

// The extent of the array's interior in slot s: the shard's in K5 (p.n
// holds the box's there).
template <class S, bool REGION>
YT_HD inline int alloc_n(const ParamsArg<S, REGION>& p, int s) {
  if constexpr (REGION)
    return p.sn[s];
  else
    return p.n[s];
}

template <class S, bool REGION>
YT_HD inline const int* dom_of(const ParamsArg<S, REGION>& p) {
  if constexpr (REGION)
    return p.gn;
  else
    return p.n;
}

// The element offset of member m (member stride ms) in outer cell q
// (the array's strides s[3 + j] per outer dim); n is p.n.  The member
// stride need not be the product of the outer extents and strides (a
// stack may hold pads between its members).
template <class S>
YT_HD inline idx_t cell_base(const int* n, int m, int q, idx_t ms,
                             const idx_t* s) {
  idx_t off = idx_t(m) * ms;
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j)
      off += idx_t(outer_idx<S>(n, q, j)) * s[3 + j];
  } else {
    (void)n; (void)q; (void)s;
  }
  return off;
}

// Every z cell of a launch over p.nm members.
template <class S>
YT_HD inline long long z_cells(const int* n, int nm) {
  return (long long)((n[0] + S::T0 - 1) / S::T0) * outer_cells<S>(n) * nm;
}

// Inputs are never written during a launch (outputs are fresh tensors), so
// on the device they go through the read-only data path (__ldg), which
// also lets the compiler hoist a point's loads above earlier stores.
template <class S>
YT_HD inline typename S::real_t global_at(const ParamsOf<S>& p, int a, int m,
                                          int q, idx_t c0, idx_t c1,
                                          idx_t c2) {
  const typename S::real_t* r =
      p.in[a] + (cell_base<S>(p.n, m, q, p.in_ms[a], p.in_s[a])
                 + c0 * p.in_s[a][0] + c1 * p.in_s[a][1] + c2 * p.in_s[a][2]);
#ifdef __CUDA_ARCH__
  return __ldg(r);
#else
  return *r;
#endif
}

// Reads every input from global memory (the host path).
template <class S>
struct GlobalReader {
  const ParamsOf<S>* p;
  int m, q;        // member, outer cell
  int g0, g1, g2;
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    return global_at<S>(*p, A, m, q, g0 + o0, g1 + o1, g2 + o2);
  }
};

// Reads staged inputs from the shared-memory tile, the rest from global.
template <class S>
struct TileReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int m, q;        // member, outer cell
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
      return global_at<S>(*p, A, m, q, g0 + o0, g1 + o1, g2 + o2);
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
  p.z0 = 0;
}

// Sets the member strides (arrays of idx_t) and count of a batch (K7).
template <class S>
void fill_members(ParamsOf<S>& p, void* in_mstrides, void* out_mstrides,
                  int nm) {
  const idx_t* ims = static_cast<const idx_t*>(in_mstrides);
  const idx_t* oms = static_cast<const idx_t*>(out_mstrides);
  for (int a = 0; a < S::NIN; ++a) p.in_ms[a] = ims[a];
  for (int o = 0; o < S::NOUT; ++o) p.out_ms[o] = oms[o];
  p.nm = nm;
}

// m: the member, q: the outer cell
template <class S, bool REGION = false>
YT_HD inline void store(const ParamsArg<S, REGION>& p, int m, int q, int g0,
                        int g1, int g2, const CalcOf<S>* out) {
  const int* lo = nullptr;
  if constexpr (REGION) lo = p.lo;
  for (int o = 0; o < S::NOUT; ++o)
    if (stores<S, REGION>(o, g0, g1, g2, q, p.n, lo))
      p.out[o][cell_base<S>(p.n, m, q, p.out_ms[o], p.out_s[o])
               + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
               + g2 * p.out_s[o][2]] =
          Calc<typename S::real_t>::store(out[o]);
}

// One point of K1's body: the point function at (g0, g1, g2) of outer
// cell q, reading through rd; K5 (REGION) computes it at global
// coordinates and 0 outside the global domain.
template <class S, bool REGION, class RD>
YT_HD inline void point_at(const ParamsArg<S, REGION>& p, const RD& rd,
                           int q, int g0, int g1, int g2,
                           CalcOf<S>* out) {
  int g[3 + OuterOf<S>::N] = {g0, g1, g2};
  fill_outer<S>(g, p.n, q);
  if (to_global<S, REGION>(p, g)) {
    S::point(rd, g, dom_of<S, REGION>(p), p.t, out);
  } else {
    for (int o = 0; o < S::NOUT; ++o) out[o] = CalcOf<S>(0);
  }
}

// ---- host path: the same point function over every member's interior --
// (each outer cell's; K5: the box's)
template <class S, bool REGION = false>
int host_step(const ParamsArg<S, REGION>& p) {
  for (int m = 0; m < p.nm; ++m)
    for (int q = 0; q < outer_cells<S>(p.n); ++q)
      for (int g0 = 0; g0 < p.n[0]; ++g0)
        for (int g1 = 0; g1 < p.n[1]; ++g1)
          for (int g2 = 0; g2 < p.n[2]; ++g2) {
            const GlobalReader<S> rd{&p, m, q, g0, g1, g2};
            CalcOf<S> out[S::NOUT];
            point_at<S, REGION>(p, rd, q, g0, g1, g2, out);
            store<S, REGION>(p, m, q, g0, g1, g2, out);
          }
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// The cp.async primitives (the stream arm's and K6's flat arm's).  A CUDA
// runtime header that defines YT_CP_ASYNC_HOOKS supplies them instead (the
// CPU emulation of these kernels does, to defer each copy to its wait).
#ifndef YT_CP_ASYNC_HOOKS
// Copy BYTES from global to shared memory, or fill them with zero when
// !fill (src-size 0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(fill ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// The member m, outer cell q and slot-0 block b of the z cell z (a
// block's own, p.z0 + blockIdx.z, or one of its tile walk) = (m * outer
// cells + q) * ceil(n0 / T0) + b.
// BATCH = false is a solo launch (K1, K6): m is 0 at compile time, so no
// member offset is computed, and without outer dims neither is q.
template <class S, bool BATCH>
__device__ __forceinline__ void split_z(const ParamsOf<S>& p, int z, int& m,
                                        int& q, int& b) {
  m = 0;
  q = 0;
  b = z;
  if constexpr (BATCH || OuterOf<S>::N > 0) {
    const int nb0 = (p.n[0] + S::T0 - 1) / S::T0;
    const int r = z / nb0;
    b = z - r * nb0;
    if constexpr (BATCH) {
      const int nq = outer_cells<S>(p.n);
      m = r / nq;
      q = r - m * nq;
    } else {
      q = r;
    }
  }
}

// K1 (BATCH = false) and K7 over K1's body (BATCH = true): the z cell
// selects the member, the outer cell and the slot-0 block.  K5 over K1's
// body (REGION = true, below) runs the same code over a box.
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::T1 * S::T2)
fused_step_kernel(const __grid_constant__ ParamsArg<S, REGION> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  int m, q, bz;
  split_z<S, BATCH>(p, int(p.z0) + int(blockIdx.z), m, q, bz);
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
                   ? global_at<S>(p, a, m, q, c0, c1, c2) : real_t(0.0f);
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
    const TileReader<S> rd{&p, smem, m, q, l0, l1, l2, g0, g1, g2};
    CalcOf<S> out[S::NOUT];
    point_at<S, REGION>(p, rd, q, g0, g1, g2, out);
    store<S, REGION>(p, m, q, g0, g1, g2, out);
  }
}

// The z cells [0, gz) in launches of at most YT_MAX_GRID_Z each, with
// their origin in p.z0; `kernel` launches one on `grid`.  A block finds
// its z cell in 32 bits (split_z).
template <class F>
int launch_z(long long& z0, long long gz, dim3 grid, F kernel) {
  if (gz > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  for (z0 = 0; z0 < gz; z0 += YT_MAX_GRID_Z) {
    grid.z = unsigned(gz - z0 < YT_MAX_GRID_Z ? gz - z0 : YT_MAX_GRID_Z);
    kernel(grid);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
  }
  return 0;
}

// The workspace arms (K6's body here, K4's passes): a grid of at most the
// card's resident blocks, each walking tiles blockIdx.x, + gridDim.x, ...
// below `tiles` with its own slice of a device-memory workspace.  The walk
// is block-uniform, so every thread meets every barrier, and a barrier
// parts one tile's last reads from the next tile's staging.
template <class F>
__device__ __forceinline__ void walk_tiles(long long tiles, F tile) {
  for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
    if (i != (long long)blockIdx.x) __syncthreads();
    tile(i);
  }
}

// The blocks of `kernel` the card holds at once: its SMs times the blocks
// one SM holds (threads, registers, `smem` bytes of dynamic shared memory,
// which it sets); a negative CUDA error where a query fails.
template <class K>
int resident_of(K* kernel, int threads, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads,
                                                      smem);
  if (e != cudaSuccess) return -int(e);
  return sms * (per > 0 ? per : 1);
}

template <class S, bool BATCH, bool REGION = false>
int launch(ParamsArg<S, REGION> p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      fused_step_kernel<S, BATCH, REGION>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const dim3 block(S::T2, S::T1, 1);
  return launch_z(p.z0, z_cells<S>(p.n, p.nm),
                  dim3((p.n[2] + S::T2 - 1) / S::T2,
                       (p.n[1] + S::T1 - 1) / S::T1),
                  [&](dim3 grid) {
    fused_step_kernel<S, BATCH, REGION><<<grid, block, smem, stream>>>(p);
  });
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
// K7 over K6 (a member batch of a multi-stage, scratch or rewrite
// solution): a block owns one member as well, which only offsets its
// global reads and stores (the member stride); its tiles, and every
// clip and allocation bound, are those of the outer cell and the block,
// so shared memory does not grow with the members and each member gets
// the bits of a solo launch.  The host path runs every member in turn.
//
// Element size 2: the staged and computed tiles are bf16_t, as the
// reference's VMEM tiles are in the program dtype (pallas_stencil.py:
// 2264-2289); a computed value is stored rounded once, as yask_tpu
// stores a stage's value or a scratch var.
//
// The workspace arm (WsOf: the Spec prints WS_ELEMS), where the tiles fit
// no rung of the emitter's shared-memory ladder (tti, ssg, fsg at r=8):
// the tiles take shared memory in order while they fit and the rest live
// in a device-memory workspace, WS_ELEMS elements per block, at tile
// offsets from SMEM_ELEMS on (tile_at).  A launch runs at most the card's
// resident blocks (stages_resident), each walking tiles blockIdx.x, +
// gridDim.x, ... with its own slice, as K4's passes do; the walk is
// block-uniform, so every thread meets every barrier, and a barrier
// parts one tile's last reads from the next tile's staging.  A
// single-stage solution past shared memory takes this body too (one
// sub-stage over the block).  K7 and K5 run it as they run K6's body:
// the member, the outer cell and the slot-0 block come from the walk's
// z cell (split_z), the box offsets stay as they are.  What bounds it:
// the workspace's traffic and the recompute (computed cells per useful
// point: tti r=8 23.5 at 8x8x64), not the state's bytes.
//
// The flat arm (FlatOf: the Spec prints FLAT_NT), for a solution that
// leaves slot 0 unused (the 1-D and 2-D solutions K6 carries: gaussian,
// box, the SWE, ...), solo, in member batches and on shards' boxes.  What
// held the 1x8x64 tile there: one point per thread, 1.59 staged cells per
// point at r=2, and a block that stages and then computes, so its load
// latency overlaps nothing inside it (PERF.md has the times).  Design:
//   * wide tiles (T1 x T2, e.g. 64x64) served by FLAT_NT threads, so a
//     thread computes several points of each sub-stage (device_stage
//     already strides its cells by the thread count) and a tile stages
//     ~1.13 cells per point and input at r=2;
//   * the card's resident blocks, each walking tiles (as the workspace
//     arm does); the member and the box offsets ride the walk index;
//   * the staged inputs in two buffers: tile n + 1's inputs are copied
//     with cp.async (flat_fetch) while tile n computes (flat_stages_kernel);
//     computed tiles stay single-buffered;
//   * every output cell written once: interior cells by the sub-stages,
//     pads by flat_pads, so the wrapper's outputs come from torch.empty
//     (a partial-dim output and a var with unwritten misc slices keep the
//     wrapper's zeroed tensor or copy; K5 keeps its allocation rules).
// Where no rung of the emitter's flat ladder fits both buffers and the
// computed tiles in 227 KB, the solution keeps the 1x8x64 ladder (and the
// workspace arm).  The same Spec::stage<K>, the same bits.

// Reads of one sub-stage point: staged inputs from their tile (others
// from global memory) and earlier sub-stages' results from their computed
// tiles.
template <class S>
struct StageReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int m;           // the block's member (0 in a solo launch)
  int q;           // the block's outer cell (0 without outer dims)
  int l0, l1, l2;  // point relative to the block origin (may lie in the
                   // expansion: < 0 or >= T)
  int g0, g1, g2;  // point in the interior (may lie past the domain)
  const typename S::real_t* ws;  // the block's workspace slice (WsOf)
  int ib;          // the flat arm: its staged inputs' buffer (0 or BUF_ELEMS)
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0) {
      constexpr int E1 = S::T1 + S::halo_lo1(k) + S::halo_hi1(k);
      constexpr int E2 = S::T2 + S::halo_lo2(k) + S::halo_hi2(k);
      const typename S::real_t* tile = tile_at<S>(smem, ws, S::tile_offset(k));
      if constexpr (FlatOf<S>::value) tile += ib;
      return tile[
          ((l0 + S::halo_lo0(k) + o0) * E1 + (l1 + S::halo_lo1(k) + o1)) * E2
          + (l2 + S::halo_lo2(k) + o2)];
    } else {
      return global_at<S>(*p, A, m, q, g0 + o0, g1 + o1, g2 + o2);
    }
  }
  template <int B>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2) const {
    constexpr int k = S::cmp_sub(B);
    constexpr int e0 = S::sub_lo0(k), e1 = S::sub_lo1(k), e2 = S::sub_lo2(k);
    constexpr int R1 = S::T1 + e1 + S::sub_hi1(k);
    constexpr int R2 = S::T2 + e2 + S::sub_hi2(k);
    return tile_at<S>(smem, ws, S::cmp_offset(B))[
        ((l0 + e0 + o0) * R1 + (l1 + e1 + o1)) * R2 + (l2 + e2 + o2)];
  }
};

// The host path's reader: global inputs, whole-domain computed buffers.
template <class S>
struct HostStageReader {
  const ParamsOf<S>* p;
  typename S::real_t* const* bufs;
  int m, q;        // the member, the outer cell
  int g0, g1, g2;
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    return global_at<S>(*p, A, m, q, g0 + o0, g1 + o1, g2 + o2);
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
// cell's plus the copy's offset; K5's are global); returns whether they
// all lie inside the copy's plain region.
template <class S, int K, bool REGION>
YT_HD inline bool outer_copy(int* g, const ParamsArg<S, REGION>& p, int q) {
  bool in = true;
  if constexpr (OuterOf<S>::N > 0) {
    const int* dn = dom_of<S, REGION>(p);
    for (int j = 0; j < OuterOf<S>::N; ++j) {
      g[3 + j] = outer_idx<S>(p.n, q, j) + S::sub_dw(K, j);
      if constexpr (REGION) g[3 + j] += p.go[3 + j];
      in = in && g[3 + j] >= -S::oclip_lo(K, j)
           && g[3 + j] < dn[3 + j] + S::oclip_hi(K, j);
    }
  } else {
    (void)g; (void)p; (void)q;
  }
  return in;
}

// Sub-stage K's clip and region per slot s < 3.
template <class S, int K>
YT_HD constexpr int clip_lo_of(int s) {
  return s == 0 ? S::clip_lo0(K) : s == 1 ? S::clip_lo1(K) : S::clip_lo2(K);
}
template <class S, int K>
YT_HD constexpr int clip_hi_of(int s) {
  return s == 0 ? S::clip_hi0(K) : s == 1 ? S::clip_hi1(K) : S::clip_hi2(K);
}
template <class S, int K>
YT_HD constexpr int sub_lo_of(int s) {
  return s == 0 ? S::sub_lo0(K) : s == 1 ? S::sub_lo1(K) : S::sub_lo2(K);
}
template <class S, int K>
YT_HD constexpr int sub_hi_of(int s) {
  return s == 0 ? S::sub_hi0(K) : s == 1 ? S::sub_hi1(K) : S::sub_hi2(K);
}

// The plain version's region of sub-stage K in slot s < 3, [lo, hi):
// the domain grown by the sub-stage's clip (a scratch var's write halo).
// K5 clips at the global domain, not at the shard's (past an inner shard
// face lie the neighbour's cells, which the sub-stage computes), in box
// indices, and keeps to the box grown by the sub-stage's region (what
// the later sub-stages read; past it the ragged last blocks would read
// past the pads).
template <class S, int K, bool REGION>
YT_HD inline void plain_region(const ParamsArg<S, REGION>& p, int s, int& lo,
                               int& hi) {
  lo = -clip_lo_of<S, K>(s);
  hi = p.n[s] + clip_hi_of<S, K>(s);
  if constexpr (REGION) {
    lo -= p.go[s];
    hi = p.gn[s] + clip_hi_of<S, K>(s) - p.go[s];
    if (lo < -sub_lo_of<S, K>(s)) lo = -sub_lo_of<S, K>(s);
    if (hi > p.n[s] + sub_hi_of<S, K>(s)) hi = p.n[s] + sub_hi_of<S, K>(s);
  }
}

// One sub-stage point: stage<K> at (g0, g1, g2) (g[3..]: the copy's outer
// indices), at global coordinates in K5.
template <class S, int K, bool REGION, class RD>
YT_HD inline void stage_at(const ParamsArg<S, REGION>& p, const RD& rd,
                           int* g, int g0, int g1, int g2,
                           CalcOf<S>* v) {
  g[0] = g0;
  g[1] = g1;
  g[2] = g2;
  if constexpr (REGION)
    for (int s = 0; s < 3; ++s) g[s] += p.go[s];
  S::template stage<K>(rd, g, dom_of<S, REGION>(p), p.t, v);
}

template <class S, int K, bool REGION>
void host_stage(const ParamsArg<S, REGION>& p,
                typename S::real_t* const* bufs, int m, int q) {
  typedef typename S::real_t real_t;
  constexpr int e0 = S::sub_lo0(K), e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
  const idx_t R1 = p.n[1] + e1 + S::sub_hi1(K);
  const idx_t R2 = p.n[2] + e2 + S::sub_hi2(K);
  const int* lo = nullptr;
  if constexpr (REGION) lo = p.lo;
  int plo[3], phi[3];
  for (int s = 0; s < 3; ++s) plain_region<S, K, REGION>(p, s, plo[s], phi[s]);
  int g[3 + OuterOf<S>::N];
  if (outer_copy<S, K, REGION>(g, p, q))
  for (int g0 = plo[0]; g0 < phi[0]; ++g0)
    for (int g1 = plo[1]; g1 < phi[1]; ++g1)
      for (int g2 = plo[2]; g2 < phi[2]; ++g2) {
        const HostStageReader<S> rd{&p, bufs, m, q, g0, g1, g2};
        CalcOf<S> v[S::MAXV];
        stage_at<S, K, REGION>(p, rd, g, g0, g1, g2, v);
        // K5's plain region reaches past the box: only the box stores
        const bool own = !REGION || (g0 >= 0 && g0 < p.n[0] && g1 >= 0
                                     && g1 < p.n[1] && g2 >= 0
                                     && g2 < p.n[2]);
        for (int j = 0; j < S::stage_nv(K); ++j) {
          const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
          const real_t w = Calc<real_t>::store(v[j]);
          if (o >= 0 && own
              && stores<S, REGION>(o, g0, g1, g2, q, p.n, lo))
            p.out[o][cell_base<S>(p.n, m, q, p.out_ms[o], p.out_s[o])
                     + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                     + g2 * p.out_s[o][2]] = w;
          if (b >= 0)
            bufs[b][((g0 + e0) * R1 + (g1 + e1)) * R2 + (g2 + e2)] = w;
        }
      }
  if constexpr (K + 1 < S::NSTAGES)
    host_stage<S, K + 1, REGION>(p, bufs, m, q);
}

// Every output cell outside the interior gets 0, the outer slots' pads
// included (the pad pass of a Spec with outer dims): the cells numbered
// first, first + stride, ... of slab j = 2u (below) or 2u + 1 (above)
// slot u, the slots before u over the interior, those after it padded;
// the minor slot varies fastest, then slots 1, 0, then the outer slots
// from the last.  pad(o, 2u + side) is output o's pad below (side 0) or
// above slot u: the Spec's out_pad (K6) or the launch's table (K1's
// stream arm).
template <class S, class P, class PAD>
YT_HD inline void outer_pads(const P& p, const PAD& pad, long long first,
                             long long stride) {
  typedef typename S::real_t real_t;
  constexpr int NS = 3 + OuterOf<S>::N;
  int order[NS];
  order[0] = 2;
  order[1] = 1;
  order[2] = 0;
  for (int u = 3; u < NS; ++u) order[u] = NS + 2 - u;
  for (int m = 0; m < p.nm; ++m)
    for (int o = 0; o < S::NOUT; ++o) {
      real_t* out = p.out[o] + idx_t(m) * p.out_ms[o];
      for (int j = 0; j < 2 * NS; ++j) {
        const int u0 = j / 2;
        int lo[NS], hi[NS];
        long long cells = 1;
        for (int u = 0; u < NS; ++u) {
          const int plo = pad(o, 2 * u), phi = pad(o, 2 * u + 1);
          lo[u] = u < u0 ? 0 : u > u0 || j % 2 == 0 ? -plo : p.n[u];
          hi[u] = u < u0 ? p.n[u]
                  : u > u0 || j % 2 == 1 ? p.n[u] + phi : 0;
          cells *= hi[u] - lo[u];
        }
        for (long long i = first; i < cells; i += stride) {
          long long r = i;
          idx_t off = 0;
          for (int v = 0; v < NS; ++v) {
            const int u = order[v];
            const long long w = hi[u] - lo[u];
            off += idx_t(lo[u] + r % w) * p.out_s[o][u];
            r /= w;
          }
          out[off] = real_t(0.0f);
        }
      }
    }
}

// The flat arm's solo and batch launches write every cell of their
// outputs: 0 into the pad cells numbered first, first + stride, ... of
// every output slice of every member (its pads per slot, out_pad), slot by
// slot as the stream arm's zero_pads does.  A partial-dim output's tensor
// comes zeroed from the wrapper.
template <class S, class P>
YT_HD inline void flat_pads(const P& p, long long first, long long stride) {
  typedef typename S::real_t real_t;
  if constexpr (OuterOf<S>::N > 0) {
    // the stream arm past three domain dims: every slot's pads
    outer_pads<S>(p, [](int o, int k) { return S::out_pad(o, k); }, first,
                  stride);
    return;
  }
  for (int m = 0; m < p.nm; ++m)
    for (int o = 0; o < S::NOUT; ++o) {
      if (SlabOf<S>::get(o)) continue;
      real_t* out = p.out[o] + cell_base<S>(p.n, m, 0, p.out_ms[o],
                                             p.out_s[o]);
      // slab j: slot j / 2 below (j even) or above the interior, the
      // slots before it over the interior, those after it padded
      for (int j = 0; j < 6; ++j) {
        int lo[3], hi[3];
        for (int u = 0; u < 3; ++u) {
          const int plo = S::out_pad(o, 2 * u), phi = S::out_pad(o, 2 * u + 1);
          lo[u] = u < j / 2 ? 0 : u > j / 2 || j % 2 == 0 ? -plo : p.n[u];
          hi[u] = u < j / 2 ? p.n[u]
                  : u > j / 2 || j % 2 == 1 ? p.n[u] + phi : 0;
        }
        const long long w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
        const long long cells = (long long)(hi[0] - lo[0]) * w1 * w2;
        for (long long i = first; i < cells; i += stride) {
          const long long r = i / w2;
          out[(lo[0] + r / w1) * p.out_s[o][0]
              + (lo[1] + r % w1) * p.out_s[o][1]
              + (lo[2] + i % w2) * p.out_s[o][2]] = real_t(0.0f);
        }
      }
    }
}

template <class S, bool REGION = false>
int host_stages(const ParamsArg<S, REGION>& p) {
  typedef typename S::real_t real_t;
  std::vector<std::vector<real_t>> store(S::NCMP);
  real_t* bufs[S::NCMP > 0 ? S::NCMP : 1] = {nullptr};
  for (int m = 0; m < p.nm; ++m)
    for (int q = 0; q < outer_cells<S>(p.n); ++q) {
      for (int b = 0; b < S::NCMP; ++b) {
        const int k = S::cmp_sub(b);
        store[b].assign(size_t(p.n[0] + S::sub_lo0(k) + S::sub_hi0(k))
                            * size_t(p.n[1] + S::sub_lo1(k) + S::sub_hi1(k))
                            * size_t(p.n[2] + S::sub_lo2(k) + S::sub_hi2(k)),
                        real_t(0.0f));
        bufs[b] = store[b].data();
      }
      host_stage<S, 0, REGION>(p, bufs, m, q);
    }
  if constexpr (FlatOf<S>::value && !REGION) flat_pads<S>(p, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// One sub-stage over its region: a loop of the block's threads over its
// cells (ib: the flat arm's staged buffer).
template <class S, int K, bool REGION>
__device__ __forceinline__ void device_stage(const ParamsArg<S, REGION>& p,
                                             typename S::real_t* smem,
                                             typename S::real_t* ws,
                                             int m, int q, int b0, int b1,
                                             int b2, int tid, int ib = 0) {
  typedef typename S::real_t real_t;
  constexpr int NT = FlatOf<S>::NT;
  constexpr int e0 = S::sub_lo0(K), e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
  constexpr int R0 = S::T0 + e0 + S::sub_hi0(K);
  constexpr int R1 = S::T1 + e1 + S::sub_hi1(K);
  constexpr int R2 = S::T2 + e2 + S::sub_hi2(K);
  constexpr int cells = R0 * R1 * R2;
  const int* lo = nullptr;
  if constexpr (REGION) lo = p.lo;
  // the outer indices of this copy; a copy outside its plain region in an
  // outer dim holds 0 everywhere
  int g[3 + OuterOf<S>::N];
  const bool in_outer = outer_copy<S, K, REGION>(g, p, q);
  int plo[3], phi[3];
  for (int s = 0; s < 3; ++s) plain_region<S, K, REGION>(p, s, plo[s], phi[s]);
  for (int i = tid; i < cells; i += NT) {
    const int l2 = i % R2 - e2;
    const int r = i / R2;
    const int l1 = r % R1 - e1;
    const int l0 = r / R1 - e0;
    const int g0 = b0 + l0, g1 = b1 + l1, g2 = b2 + l2;
    // the plain version's region: the domain, grown by a scratch var's
    // write halo
    const bool inside = g0 >= plo[0] && g0 < phi[0] && g1 >= plo[1]
                        && g1 < phi[1] && g2 >= plo[2] && g2 < phi[2]
                        && in_outer;
    CalcOf<S> v[S::MAXV];
    if (inside) {
      const StageReader<S> rd{&p, smem, m, q, l0, l1, l2, g0, g1, g2, ws,
                              ib};
      stage_at<S, K, REGION>(p, rd, g, g0, g1, g2, v);
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
      if (o >= 0 && own && stores<S, REGION>(o, g0, g1, g2, q, p.n, lo))
        p.out[o][cell_base<S>(p.n, m, q, p.out_ms[o], p.out_s[o])
                 + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                 + g2 * p.out_s[o][2]] = w;
      if (b >= 0)
        tile_at<S>(smem, ws, S::cmp_offset(b))[((l0 + e0) * R1 + (l1 + e1))
                                               * R2 + (l2 + e2)] = w;
    }
  }
  if constexpr (K + 1 < S::NSTAGES) {
    __syncthreads();
    device_stage<S, K + 1, REGION>(p, smem, ws, m, q, b0, b1, b2, tid, ib);
  }
}

// Is staged input k's outer index inside its allocation in outer cell q?
template <class S, bool REGION>
__device__ __forceinline__ bool outer_alloc(const ParamsArg<S, REGION>& p,
                                            int k, int q) {
  bool in = true;
  if constexpr (OuterOf<S>::N > 0) {
    for (int j = 0; j < OuterOf<S>::N; ++j) {
      const int c = outer_idx<S>(p.n, q, j) + box_lo<S, REGION>(p, 3 + j);
      in = in && c >= -S::outer_alo(k, j)
           && c < alloc_n<S, REGION>(p, 3 + j) + S::outer_ahi(k, j);
    }
  } else {
    (void)p; (void)k; (void)q;
  }
  return in;
}

// One tile of K6's body: the block's own (z cell, y and x blocks), or one
// of its tile walk with its workspace slice ws (the workspace arm).
template <class S, bool BATCH, bool REGION>
__device__ __forceinline__ void stages_tile(const ParamsArg<S, REGION>& p,
                                            typename S::real_t* smem,
                                            typename S::real_t* ws, int z,
                                            int by, int bx, int tid) {
  typedef typename S::real_t real_t;
  int m, q, bz;
  split_z<S, BATCH>(p, z, m, q, bz);
  const int b0 = bz * S::T0;
  const int b1 = by * S::T1;
  const int b2 = bx * S::T2;

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
    const int x0 = box_lo<S, REGION>(p, 0), x1 = box_lo<S, REGION>(p, 1),
              x2 = box_lo<S, REGION>(p, 2);
    const int lo0 = -S::alloc_lo0(k) - x0;
    const int lim0 = alloc_n<S, REGION>(p, 0) + S::alloc_hi0(k) - x0;
    const int lo1 = -S::alloc_lo1(k) - x1;
    const int lim1 = alloc_n<S, REGION>(p, 1) + S::alloc_hi1(k) - x1;
    const int lo2 = -S::alloc_lo2(k) - x2;
    const int lim2 = alloc_n<S, REGION>(p, 2) + S::alloc_hi2(k) - x2;
    const bool in_outer = outer_alloc<S, REGION>(p, k, q);
    real_t* dst = tile_at<S>(smem, ws, S::tile_offset(k));
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
                   ? global_at<S>(p, a, m, q, c0, c1, c2) : real_t(0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * NT < cells) dst[base + u * NT] = v[u];
    }
  }
  __syncthreads();

  // 2) the sub-stages in order, each over its region
  device_stage<S, 0, REGION>(p, smem, ws, m, q, b0, b1, b2, tid);
}

// K6 (BATCH = false) and K7 over K6's body (BATCH = true); K5 over K6's
// body (REGION = true, below) runs the same code over a box.  The
// workspace arm (WsOf) runs a grid of at most the card's resident blocks,
// each walking tiles blockIdx.x, + gridDim.x, ... (x blocks fastest, then
// y, then z cells) with its own slice of the workspace; the walk is
// block-uniform, so every thread meets every barrier.
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::T1 * S::T2)
fused_stages_kernel(const __grid_constant__ ParamsArg<S, REGION> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const int tid = threadIdx.y * S::T2 + threadIdx.x;
  if constexpr (WsOf<S>::value) {
    real_t* ws = p.ws + (long long)blockIdx.x * S::WS_ELEMS;
    const long long gx = (p.n[2] + S::T2 - 1) / S::T2;
    const long long gy = (p.n[1] + S::T1 - 1) / S::T1;
    walk_tiles(z_cells<S>(p.n, p.nm) * gy * gx, [&](long long i) {
      const long long zy = i / gx;
      stages_tile<S, BATCH, REGION>(p, smem, ws, int(zy / gy),
                                    int(zy % gy), int(i % gx), tid);
    });
  } else {
    stages_tile<S, BATCH, REGION>(p, smem, nullptr,
                                  int(p.z0) + int(blockIdx.z), blockIdx.y,
                                  blockIdx.x, tid);
  }
}

// The flat arm: issue the copies of tile i's staged inputs (i in the walk
// of gy x gx tiles per z cell) into the staged buffer at buf; cells past
// an input's allocation get 0 (the copy's src-size-0 form).  A halo row's
// origin b2 - h2 need not be 16-byte aligned: 16-byte copies where the
// rows' cells and their sources line up, 4-byte (8 at fp64) ones at the
// rows' ends and where they do not.  At element size 2 each thread copies
// a 4-byte pair of shared memory when its two cells come from one aligned
// pair of global memory (or both hold 0); a pair at a tile's ends, or one
// that is not such a pair, goes by plain loads and stores, which the
// barrier before the tile's compute orders as it orders the copies.
template <class S, bool BATCH, bool REGION>
__device__ __forceinline__ void flat_fetch(const ParamsArg<S, REGION>& p,
                                           typename S::real_t* buf,
                                           long long i, long long gy,
                                           long long gx, int tid) {
  typedef typename S::real_t real_t;
  constexpr int NT = S::FLAT_NT;
  const long long zy = i / gx;
  int m, q, bz;
  split_z<S, BATCH>(p, int(zy / gy), m, q, bz);
  const int b0 = bz * S::T0;
  const int b1 = int(zy % gy) * S::T1;
  const int b2 = int(i % gx) * S::T2;
#pragma unroll
  for (int k = 0; k < S::NTILED; ++k) {
    const int a = S::tiled_input(k);
    const int h0 = S::halo_lo0(k), h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
    const int E1 = S::T1 + h1 + S::halo_hi1(k);
    const int E2 = S::T2 + h2 + S::halo_hi2(k);
    const int cells = (S::T0 + h0 + S::halo_hi0(k)) * E1 * E2;
    const int x0 = box_lo<S, REGION>(p, 0), x1 = box_lo<S, REGION>(p, 1),
              x2 = box_lo<S, REGION>(p, 2);
    const int lo0 = -S::alloc_lo0(k) - x0;
    const int lim0 = alloc_n<S, REGION>(p, 0) + S::alloc_hi0(k) - x0;
    const int lo1 = -S::alloc_lo1(k) - x1;
    const int lim1 = alloc_n<S, REGION>(p, 1) + S::alloc_hi1(k) - x1;
    const int lo2 = -S::alloc_lo2(k) - x2;
    const int lim2 = alloc_n<S, REGION>(p, 2) + S::alloc_hi2(k) - x2;
    const bool in_outer = outer_alloc<S, REGION>(p, k, q);
    const real_t* src = p.in[a] + cell_base<S>(p.n, m, q, p.in_ms[a],
                                               p.in_s[a]);
    real_t* dst = buf + S::tile_offset(k);
    if constexpr (sizeof(real_t) != 2) {
      // Where a row is a whole number of 16-byte units and every row's
      // cells and their sources lie alike in them (a unit minor stride,
      // row strides equal modulo the unit, the first cell's phases equal),
      // a row goes in slots of V cells: a slot inside the read reach, or
      // wholly past it (zeros), is one 16-byte copy, a slot across its
      // edge goes cell by cell; index arithmetic per slot.  Elsewhere
      // consecutive threads copy consecutive cells (rows of a ragged
      // number of units lost more to their split end slots than the
      // copies saved, on swe2d's 66-cell rows).
      constexpr int V = 16 / int(sizeof(real_t));
      const idx_t* st = p.in_s[a];
      const real_t* src0 = src + ((b0 - h0) * st[0] + (b1 - h1) * st[1]
                                  + (b2 - h2) * st[2]);
      const bool lines_up =
          E2 % V == 0 && st[2] == 1 && (E1 == 1 || (E2 - st[1]) % V == 0)
          && !((reinterpret_cast<unsigned long long>(dst)
                - reinterpret_cast<unsigned long long>(src0)) & 15);
      if (lines_up) {
        const int NV = E2 / V + 2;  // a row's slots, the lead one included
        const unsigned long long zero16 =
            reinterpret_cast<unsigned long long>(p.in[a]) & ~15ull;
        for (int j = tid; j < cells / E2 * NV; j += NT) {
          const int r = j / NV;
          real_t* drow = dst + r * E2;
          const int e = (j - r * NV) * V
                        - int(reinterpret_cast<unsigned long long>(drow)
                              / sizeof(real_t) % V);
          if (e >= E2 || e + V <= 0) continue;
          const int c0 = b0 - h0 + r / E1;
          const int c1 = b1 - h1 + r % E1;
          const int c2 = b2 - h2 + e;
          const bool in_row = c0 >= lo0 && c0 < lim0 && c1 >= lo1
                              && c1 < lim1 && in_outer;
          const real_t* s = src + (c0 * st[0] + c1 * st[1] + c2);
          const bool whole = e >= 0 && e + V <= E2;
          if (whole && (!in_row || c2 >= lim2 || c2 + V <= lo2)) {
            cp_async<16>(drow + e, reinterpret_cast<const real_t*>(zero16),
                         false);
          } else if (whole && c2 >= lo2 && c2 + V <= lim2) {
            cp_async<16>(drow + e, s, true);
          } else {
            for (int u = 0; u < V; ++u) {
              if (e + u < 0 || e + u >= E2) continue;
              const bool ok = in_row && c2 + u >= lo2 && c2 + u < lim2;
              cp_async<int(sizeof(real_t))>(drow + e + u,
                                            ok ? s + u : p.in[a], ok);
            }
          }
        }
      } else {
        for (int e = tid; e < cells; e += NT) {
          const int r = e / E2;
          const int c0 = b0 - h0 + r / E1;
          const int c1 = b1 - h1 + r % E1;
          const int c2 = b2 - h2 + e % E2;
          const bool ok = c0 >= lo0 && c0 < lim0 && c1 >= lo1 && c1 < lim1
                          && c2 >= lo2 && c2 < lim2 && in_outer;
          cp_async<int(sizeof(real_t))>(
              dst + e, ok ? src + (c0 * st[0] + c1 * st[1] + c2 * st[2])
                          : p.in[a], ok);
        }
      }
    } else {
      // the source of cell e of the tile, nullptr where it holds 0
      auto at = [&](int e) -> const real_t* {
        const int r = e / E2;
        const int c0 = b0 - h0 + r / E1;
        const int c1 = b1 - h1 + r % E1;
        const int c2 = b2 - h2 + e % E2;
        return c0 >= lo0 && c0 < lim0 && c1 >= lo1 && c1 < lim1
                       && c2 >= lo2 && c2 < lim2 && in_outer
                   ? src + (c0 * p.in_s[a][0] + c1 * p.in_s[a][1]
                            + c2 * p.in_s[a][2])
                   : nullptr;
      };
      // pair j holds cells 2 j - lead and 2 j - lead + 1
      const int lead = int((reinterpret_cast<unsigned long long>(dst) >> 1)
                           & 1);
      for (int j = tid; 2 * j < cells + lead; j += NT) {
        const int e = 2 * j - lead;
        const bool in0 = e >= 0, in1 = e + 1 < cells;
        const real_t* s0 = in0 ? at(e) : nullptr;
        const real_t* s1 = in1 ? at(e + 1) : nullptr;
        const bool pair = in0 && in1
            && (s0 ? s1 == s0 + 1
                         && !(reinterpret_cast<unsigned long long>(s0) & 3)
                   : s1 == nullptr);
        if (pair) {
          cp_async<4>(dst + e, s0 ? s0 : p.in[a], s0 != nullptr);
        } else {
          if (in0) dst[e] = s0 ? s0[0] : real_t(0.0f);
          if (in1) dst[e + 1] = s1 ? s1[0] : real_t(0.0f);
        }
      }
    }
  }
}

// K6's flat arm (FlatOf) and K7's and K5's over it: a grid of at most the
// card's resident blocks, each walking tiles blockIdx.x, + gridDim.x, ...
// (x blocks fastest, then y, then z cells).  While tile n computes from
// one staged buffer, the copies of tile n + 1's staged inputs fill the
// other.  Per tile: wait for this thread's copies, one barrier (every
// thread's copies have landed, and every thread has finished tile n - 1,
// whose buffer the next copies refill and whose computed tiles the next
// sub-stages rewrite), issue tile n + 1's copies, then the sub-stages
// with their barriers.  Computed tiles are single-buffered.  A block's
// last tile issues an empty group.  Then the solo and batch launches
// zero the outputs' pads (flat_pads), so every output cell is written
// once.
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::FLAT_NT, S::FLAT_MIN)
flat_stages_kernel(const __grid_constant__ ParamsArg<S, REGION> p) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const int tid = threadIdx.x;
  const long long gx = (p.n[2] + S::T2 - 1) / S::T2;
  const long long gy = (p.n[1] + S::T1 - 1) / S::T1;
  const long long tiles = z_cells<S>(p.n, p.nm) * gy * gx;
  long long i = blockIdx.x;
  if (i < tiles) flat_fetch<S, BATCH, REGION>(p, smem, i, gy, gx, tid);
  cp_async_commit();
  for (int ib = 0; i < tiles; i += gridDim.x, ib ^= S::BUF_ELEMS) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + gridDim.x < tiles)
      flat_fetch<S, BATCH, REGION>(p, smem + (ib ^ S::BUF_ELEMS),
                                   i + gridDim.x, gy, gx, tid);
    cp_async_commit();
    const long long zy = i / gx;
    int m, q, bz;
    split_z<S, BATCH>(p, int(zy / gy), m, q, bz);
    device_stage<S, 0, REGION>(p, smem, nullptr, m, q, bz * S::T0,
                               int(zy % gy) * S::T1, int(i % gx) * S::T2,
                               tid, ib);
  }
  if constexpr (!REGION)
    flat_pads<S>(p, (long long)blockIdx.x * S::FLAT_NT + tid,
                 (long long)gridDim.x * S::FLAT_NT);
}

// The blocks of K6's body (solo, BATCH or REGION) the card holds at once.
template <class S, bool BATCH, bool REGION>
int stages_resident() {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  if constexpr (FlatOf<S>::value)
    return resident_of(flat_stages_kernel<S, BATCH, REGION>, S::FLAT_NT,
                       smem);
  else
    return resident_of(fused_stages_kernel<S, BATCH, REGION>, S::T1 * S::T2,
                       smem);
}

template <class S, bool BATCH, bool REGION = false>
int launch_stages(ParamsArg<S, REGION> p, long long nres,
                  cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SMEM_ELEMS;
  if constexpr (FlatOf<S>::value) {
    // the flat arm: at most nres blocks (the wrapper's count from
    // stages_resident), each walking tiles
    if (nres < 1) return int(cudaErrorInvalidConfiguration);
    const cudaError_t e = cudaFuncSetAttribute(
        flat_stages_kernel<S, BATCH, REGION>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    const long long tiles = z_cells<S>(p.n, p.nm)
                            * ((p.n[1] + S::T1 - 1) / S::T1)
                            * ((p.n[2] + S::T2 - 1) / S::T2);
    if (tiles < 1) return 0;
    const dim3 grid(unsigned(tiles < nres ? tiles : nres));
    const dim3 block(S::FLAT_NT, 1, 1);
    flat_stages_kernel<S, BATCH, REGION><<<grid, block, smem, stream>>>(p);
    return int(cudaGetLastError());
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        fused_stages_kernel<S, BATCH, REGION>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    const dim3 block(S::T2, S::T1, 1);
    const long long gz = z_cells<S>(p.n, p.nm);
    dim3 cols((p.n[2] + S::T2 - 1) / S::T2, (p.n[1] + S::T1 - 1) / S::T1);
    long long walk = gz;  // z cells of the launches: one walk for the arm
    if constexpr (WsOf<S>::value) {
      const long long tiles = gz * cols.x * cols.y;
      if (p.ws == nullptr || nres < 1)
        return int(cudaErrorInvalidConfiguration);
      cols = dim3(unsigned(tiles < nres ? tiles : nres));
      walk = tiles > 0 ? 1 : 0;
    } else {
      (void)nres;
    }
    return launch_z(p.z0, walk, cols, [&](dim3 grid) {
      fused_stages_kernel<S, BATCH, REGION><<<grid, block, smem, stream>>>(p);
    });
  }
}
#endif

// K6: as run(), every stage (and scratch sub-stage) of one sub-step; the
// workspace arm's ws holds nres resident blocks' slices (the host path
// needs none).
template <class S>
int run_stages(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, int t, void* stream,
               void* ws = nullptr, long long nres = 0) {
  ParamsArg<S, false> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_ws<S>(p, ws);
#ifdef __CUDACC__
  return launch_stages<S, false>(p, nres, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  (void)nres;
  return host_stages<S>(p);
#endif
}

// Is S a K6 Spec (sub-stages)?
template <class S, class = void>
struct IsStages : std::false_type {};
template <class S>
struct IsStages<S, std::void_t<decltype(S::NSTAGES)>> : std::true_type {};

// K7: as run() (K1's Spec) or run_stages() (K6's), over `nm` members
// whose arrays sit `in_mstrides[a]` / `out_mstrides[o]` elements apart
// (arrays of idx_t).
template <class S>
int run_batched(void* in_ptrs, void* in_strides, void* in_mstrides,
                void* out_ptrs, void* out_strides, void* out_mstrides,
                void* sizes, int nm, int t, void* stream, void* ws = nullptr,
                long long nres = 0) {
  ParamsArg<S, false> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_members<S>(p, in_mstrides, out_mstrides, nm);
  fill_ws<S>(p, ws);
#ifdef __CUDACC__
  if constexpr (IsStages<S>::value)
    return launch_stages<S, true>(p, nres,
                                  static_cast<cudaStream_t>(stream));
  else
    return launch<S, true>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  (void)nres;
  if constexpr (IsStages<S>::value)
    return host_stages<S>(p);
  else
    return host_step<S>(p);
#endif
}

// ==== K5: one sub-step over a box of one shard ==========================
// Replaces the region= arm (pallas_stencil.py:736-780) and the
// distributed=True arm (:781-811, the shard offsets added to the global
// index base at :1948-1953) of build_pallas_chunk, which
// parallel/shard_step.py's shard_pallas path runs per shard: the
// distributed chunk takes every arm the single-domain one takes, so K5
// runs over K1's body (one stage) or K6's (several stages, scratch
// sub-stages, rewrites), with misc slices, partial-dim outputs, element
// size 2 and outer dims alike.  One launch computes one sub-step over a
// compute box [lo, hi) per slot (outer ones included) in the shard's
// interior coordinates: lo may be negative and hi may pass n, reaching
// into the ghost pads by the sub-step's expansion (the shard_pallas group
// grows the box by the step's reach per later sub-step), or the box is a
// core or shell region inside it.
//
// Design: the body's kernel instantiated with REGION = true, its
// parameters K1's or K6's tables with every pointer moved to the box's
// cell 0 and p.n set to the box's extents, so the grid, the staging, the
// sub-stage regions and the stores run over the box as they run over an
// interior.  What changes with REGION: the point function sees global
// coordinates (the box's global origin added) and the global extents; a
// point outside the global domain is 0; K6's plain region clips at the
// global domain grown by a scratch var's write halo (past an inner shard
// face the neighbour's cells are real domain cells), inside the box grown
// by the sub-stage's region; a staged input's allocation bounds are the
// shard's; a partial-dim output is stored at the shard's index 0 of the
// dims it lacks, so every shard of a row of shards computes and stores
// the same slab.  As the reference's distributed chunk, K5 never pushes.
// Outputs are fresh zeroed tensors (or copies of the evicted slot for a
// var whose misc slices are not all written); the wrapper
// (fused_stencil.shard_step) keeps what the box writes in the ghosts for
// the later sub-steps of the group.
//
// What bounds it on an H100: bytes, as its body (16 B/pt per iso3dfd r=8
// step over the box, 48 on tti r=2); REGION costs the solo kernels
// nothing, as it is a template parameter.
//
// set_region reads the box table (int[4 * (3 + NOUTER)]: lo, hi, the
// shard's origin and the global extents per slot) into p, which K6's
// stream arm over a box (stream_stages.cuh) shares; false for an empty
// box.
template <class S>
bool set_region(ParamsArg<S, true>& p, const void* region) {
  constexpr int NS = 3 + OuterOf<S>::N;
  const int* r = static_cast<const int*>(region);
  for (int s = 0; s < NS; ++s)
    if (r[NS + s] <= r[s]) return false;
  for (int s = 0; s < NS; ++s) {
    p.lo[s] = r[s];
    p.sn[s] = p.n[s];
    p.n[s] = r[NS + s] - r[s];
    p.go[s] = r[s] + r[2 * NS + s];
    p.gn[s] = r[3 * NS + s];
  }
  for (int a = 0; a < S::NIN; ++a)
    for (int s = 0; s < NS; ++s) p.in[a] += p.lo[s] * p.in_s[a][s];
  for (int o = 0; o < S::NOUT; ++o)
    for (int s = 0; s < NS; ++s) p.out[o] += p.lo[s] * p.out_s[o][s];
  return true;
}

template <class S>
int run_region(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, void* region, int t,
               void* stream, void* ws = nullptr, long long nres = 0) {
  ParamsArg<S, true> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_ws<S>(p, ws);
  if (!set_region<S>(p, region)) return 0;  // an empty box: nothing
#ifdef __CUDACC__
  if constexpr (IsStages<S>::value)
    return launch_stages<S, false, true>(p, nres,
                                         static_cast<cudaStream_t>(stream));
  else
    return launch<S, false, true>(p, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  (void)nres;
  if constexpr (IsStages<S>::value)
    return host_stages<S, true>(p);
  else
    return host_step<S, true>(p);
#endif
}

// The resident blocks of the workspace arm's or the flat arm's kernel for
// a launch of kind 0 (solo), 1 (member batch) or 2 (a shard's box); 1 on
// the host.
template <class S>
int resident_stages(int kind) {
#ifdef __CUDACC__
  return kind == 1   ? stages_resident<S, true, false>()
         : kind == 2 ? stages_resident<S, false, true>()
                     : stages_resident<S, false, false>();
#else
  (void)kind;
  return 1;
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

// The C entry point of K7 for the same Spec, K1's or K6's (member
// strides and count).
#define YT_FUSED_BATCHED_ENTRY(NAME, S)                                      \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* in_mstrides,    \
                      void* out_ptrs, void* out_strides, void* out_mstrides, \
                      void* sizes, int nm, int t, void* stream) {            \
    return yt::run_batched<S>(in_ptrs, in_strides, in_mstrides, out_ptrs,    \
                              out_strides, out_mstrides, sizes, nm, t,       \
                              stream);                                       \
  }

// The C entry point of K5 for the same Spec, K1's or K6's: K1's arguments,
// then the box, the shard's origin and the global extents (int[4 * (3 +
// NOUTER)]) before the step index.
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

// The C entry points of the arms whose blocks walk tiles, the workspace
// arm (a K6 Spec printing WS_ELEMS) and the flat arm (FLAT_NT): K6's, K7's
// and K5's arguments with the workspace (WS_ELEMS elements per resident
// block; null on the flat arm) and the resident blocks before the stream,
// and the resident blocks of a launch kind (resident_stages), which the
// wrapper asks once and passes to every launch.
#define YT_FUSED_WS_ENTRIES(NAME, S)                                         \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, int t, void* ws,       \
                      long long nres, void* stream) {                        \
    return yt::run_stages<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, t, stream, ws, nres);                    \
  }                                                                          \
  extern "C" int NAME##_batched(                                             \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, int nm, int t,     \
      void* ws, long long nres, void* stream) {                              \
    return yt::run_batched<S>(in_ptrs, in_strides, in_mstrides, out_ptrs,    \
                              out_strides, out_mstrides, sizes, nm, t,       \
                              stream, ws, nres);                             \
  }                                                                          \
  extern "C" int NAME##_region(void* in_ptrs, void* in_strides,              \
                               void* out_ptrs, void* out_strides,            \
                               void* sizes, void* region, int t, void* ws,   \
                               long long nres, void* stream) {               \
    return yt::run_region<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, region, t, stream, ws, nres);            \
  }                                                                          \
  extern "C" int NAME##_resident(int kind) {                                 \
    return yt::resident_stages<S>(kind);                                     \
  }
