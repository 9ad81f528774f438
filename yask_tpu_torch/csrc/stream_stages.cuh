// stream_stages.cuh — the stream arm of K6 (and of K7 over K6's body) for
// NVIDIA Hopper, sm_90a: every sub-stage of one sub-step of a multi-stage
// solution of three domain dims or more (the outer ones windows of the
// work items), each block walking slot 0 through rings of staged input
// planes and computed planes.
//
// It computes what K6 (fused_stages_kernel<S, false>), K7 over it
// (fused_stages_kernel<S, true>) and K5 over it (fused_stages_kernel<S,
// false, true>) compute, with the same Spec::stage<K>, so with
// --fmad=false it gives the same bits.  It replaces the stage loop of
// build_pallas_chunk (yask_tpu/ops/pallas_stencil.py:2058-2188, with its
// rewrite arm :2155-2187) under the input prefetch (:1815-1854) and the
// carry of staged planes along the stream dim (:1955-2056), as K1's stream
// arm (stream_step.cuh) does for one stage; with REGION, its region= and
// distributed=True arms (:736-811, :1948-1953; yask_tpu/parallel/
// shard_step.py:1093-1160) over one shard's box.
//
// What bounds it on an H100: bytes.  awp moves 112 B per point per step
// (its live inputs read once, its outputs written once): 4.49 ms at 512^3
// over 3.35 TB/s.  K6's body at the 1x4x64 tile awp's grown halos allow
// stages 141.6 cells per point, recomputes the velocity stage over 10.6x
// the useful cells, stages and then computes with one 256-thread block
// per SM, and zero-fills its outputs first.  Here:
//   * a block owns an SS_T1 x SS_T2 plane tile of (slot 1, slot 2), served
//     by SS_NT threads (a thread computes several points of a sub-stage,
//     as device_stage strides its cells), and walks a segment of slot 0 in
//     order; the card's resident blocks walk the work items (column x
//     segment x member), block-uniformly, so every thread meets every
//     barrier;
//   * sub-stage K computes plane z + ss_lag(K) at the walk's plane z, its
//     lag being how far above its own plane a later sub-stage reads it
//     (the emitter's sub_hi0): awp's velocities run at z + 2, the stresses
//     and memory variables at z.  So the velocities are computed once per
//     plane over the plane tile grown in-plane (1.4x the useful cells at
//     16x32), not over a 3-D tile grown in slot 0 too;
//   * each staged input has a ring of ss_depth(k) planes with its
//     in-plane halo: the planes its readers read at their lags (z -
//     ss_rlo(k) .. z + ss_rhi(k)), the SS_P planes in flight, and one
//     more, so one barrier per plane suffices (tile_planner.ring_depth's
//     rule: the slot the fetch at plane z refills was last read at plane
//     z - 2, before the barrier of plane z - 1);
//   * cp.async fetches plane z + ss_rhi(k) + SS_P of every ring under
//     plane z's compute, one group per plane: 16-byte copies where every
//     row of a ring lines up with its source (flat_fetch's rule: the row
//     strides a whole number of 16-byte units, the first cell's phase
//     that of the ring), 4 (8 at fp64) bytes elsewhere; a cell past the
//     input's allocation gets 0 (the src-size-0 form).  Inputs read only
//     at the point of a sub-stage that is not grown come from global
//     memory;
//   * at element size 2 (bfloat16) cp.async cannot copy one element: the
//     rings are filled with aligned 4-byte pairs, as K1's stream arm fills
//     its own (stream_step.cuh).  A ring row starts at the pair that holds
//     the row's first cell, one element early where that cell is the
//     second of its pair (ring_shift), and holds ring_row(k) elements.
//     The strides are even (the wrapper checks) and so is SS_T2, so the
//     shift is the same for every row, plane, block, member and outer
//     window of a launch; the reads add it.  A pair inside the
//     allocation's reach, or wholly past it, is one copy (16-byte slots
//     of 8 cells where the rows line up); a pair across its edge goes by
//     plain loads and stores, which the barrier before the plane's
//     compute orders as it orders the copies.  Computed rings and
//     workspace slices hold bfloat16 values each rounded once
//     (Calc<bf16_t>::store), as the body's stage tiles do;
//   * a computed tile a later sub-stage reads (a var and its writing
//     sub-stage: a rewrite keeps its own tile, a conditional rewrite reads
//     its base from the earlier one, a pushed var is a tile with no
//     output) is a ring of ss_cdepth(b) computed planes over the plane
//     grown by its writer's in-plane region; a cell outside the plain
//     version's region holds 0 (device_stage's rule).  Sub-stages are
//     parted by barriers;
//   * every output cell is written exactly once: interior cells by the
//     last sub-stage that writes them, pads by a grid-stride pass
//     (flat_pads), so the wrapper takes torch.empty;
//   * K5 (REGION): the walk runs over a shard's box (p.n its extents, the
//     pointers at its cell 0, as run_region moves them for the body), at
//     global coordinates; each sub-stage's plain region is clipped at the
//     global domain, not at the shard's (past an inner face lie the
//     neighbour's cells), and kept to the box grown by its region; a ring
//     copy gets 0 past the shard's allocation, not past the box; only the
//     box's own cells are stored and no pad is written, so the core and
//     the shells of an overlapped group share one set of outputs;
//   * a scratch var is a computed ring with no output, its sub-stage at
//     its lag like any other; its planes past the domain are computed
//     from the pads out to its write halo (plain_region's clip), the
//     first segment's from -clip_lo0 on, the last one's up to n0 +
//     clip_hi0 - 1, and cells past the clip hold 0;
//   * where no plane tile's rings fit shared memory (r = 8: tti, ssg,
//     fsg), they are placed past it (the Spec prints SS_WS_ELEMS and
//     ss_glob, tile_planner._place_rings): the computed rings first, in
//     shared memory while they fit and past it in the block's slice of a
//     device-memory workspace (cring_at, the workspace arm's tile_at
//     rule), written by one sub-stage and read by the next across the
//     barrier that parts them; then the staged inputs' rings by their
//     readers' reads per byte.  A staged input left without a ring is read
//     from its own allocation, which is its ring: nothing is copied.  Every
//     cell a sub-stage computes lies in its plain region, whose reads stay
//     inside the allocation (the pads cover each clip plus its read
//     offsets), so those reads need no guard, as K6's body reads its
//     other inputs.  The wrapper keeps the resident blocks' slices within
//     the card's 50 MB L2.
//
// K4's stream arm is this kernel over a K-level Spec (ops/cuda_emit.py::
// emit_trap_stream's TrapSpec, entries YT_TRAP_STREAM_ENTRIES below): the
// sub-stages of all K levels of a group, level L's reads of earlier
// levels mapped to their computed rings, each level lagged along slot 0
// by what the later levels read of it and grown in-plane alike, each
// output level stored by its level's last writer, one launch a group.
// It replaces the two-phase passes of trapezoid.cuh (their -no-skew
// twin) and is what the reference's skewed-wavefront carry of K levels
// does on the TPU (yask_tpu/ops/pallas_stencil.py:306-441, :1955-2056).
//
// More than three domain dims (a Spec that prints NOUTER, emitted without
// outer copies: ops/cuda_emit.py::emit_trap_stream, for K4's groups and,
// with one level, for K6's and K7's 4-D sub-steps).  The walk stays on
// slot 0; a "plane" is a box over a window of ss_wo(j) indices of every
// outer dim j times the plane tile, and a work item is one window of
// every outer dim times one column times one segment (times one member).
// Each sub-stage is computed once over its region in every slot, the
// outer ones included (sub_olo/sub_ohi(K, j): what the later sub-stages
// read of it at outer offsets), inside its plain region there
// (oclip_lo/oclip_hi); the point function sees the global outer indices
// in g[3 + j].  A staged ring holds the window grown by its readers'
// outer reach (halo_olo/halo_ohi(k, j)) and serves every read of its var
// and ring slot: a read at an outer offset in_dw(A, j) reads the ring
// there (it is neither a ring of its own nor an outer copy), cells past
// the allocation in an outer dim (alloc_olo/alloc_ohi) hold 0; a computed
// ring holds its writer's region in the outer dims as well.  The pad pass
// (flat_pads, over outer_pads) covers the outer slots' pads.  K5 over it
// is not emitted.
//
// The same Spec compiles on the host (no __CUDACC__): host_stages_stream()
// runs K6's host loop (host_stages; with outer dims host_stages_outer,
// each sub-stage once over its plain region in every slot) and zeroes the
// pads, which is how the CPU tests check the entry's arithmetic with g++.
#pragma once

#include "fused_step.cuh"

namespace yt {

template <class S, bool REGION = false>
struct StagesStreamParams {
  // K6's tables (K7's member strides and count; K5's box, REGION)
  ParamsArg<S, REGION> p;
  int seg;                 // planes of slot 0 per segment
  typename S::real_t* ws;  // SS_WS_ELEMS elements per block (SsPlaceOf)
};

// Rings past shared memory (a Spec that prints SS_WS_ELEMS): staged input
// k has no ring where ss_glob(k), and a computed ring at or past SS_ELEMS
// lives in the block's workspace slice.
template <class S, class = void>
struct SsPlaceOf {
  static constexpr bool value = false;
  YT_HD static constexpr bool global(int) { return false; }
};
template <class S>
struct SsPlaceOf<S, std::void_t<decltype(S::SS_WS_ELEMS)>> {
  static constexpr bool value = true;
  YT_HD static constexpr bool global(int k) { return S::ss_glob(k) != 0; }
};

// The elements of a block's workspace slice (0 without one).
template <class S>
YT_HD constexpr int ss_ws_elems() {
  if constexpr (SsPlaceOf<S>::value)
    return S::SS_WS_ELEMS;
  else
    return 0;
}

// A computed ring's storage: shared memory, or past SS_ELEMS the block's
// workspace slice.
template <class S, class T>
YT_HD inline T* cring_at(T* smem, T* ws, int off) {
  if constexpr (SsPlaceOf<S>::value) {
    return off < S::SS_ELEMS ? smem + off : ws + (off - S::SS_ELEMS);
  } else {
    (void)ws;
    return smem + off;
  }
}

// Rows and row length of staged input k's ring planes, and of computed
// tile b's (the in-plane region of its writing sub-stage).
template <class S>
YT_HD constexpr int ring_e1(int k) {
  return S::SS_T1 + S::halo_lo1(k) + S::halo_hi1(k);
}
template <class S>
YT_HD constexpr int ring_e2(int k) {
  return S::SS_T2 + S::halo_lo2(k) + S::halo_hi2(k);
}
// Elements of a row of staged input k's ring: ring_e2, or at element size
// 2 one more rounded up to even, so that the row can start at the 4-byte
// pair holding its first cell (tile_planner.stream_row).
template <class S>
YT_HD constexpr int ring_row(int k) {
  return sizeof(typename S::real_t) == 2 ? (ring_e2<S>(k) + 2) & ~1
                                         : ring_e2<S>(k);
}

// At element size 2: 1 where the first cell of staged ring k's rows (cell
// b2 - halo_lo2(k) of its input, b2 even) is the second of its 4-byte
// pair, else 0.  The input's strides are even, so this holds for every
// row, plane, block and member alike; the fetch starts each row one cell
// early by it and every read of the ring adds it.
template <class S>
YT_HD inline int ring_shift(const ParamsOf<S>& p, int k) {
  if constexpr (sizeof(typename S::real_t) == 2)
    return int(((reinterpret_cast<unsigned long long>(
                     p.in[S::tiled_input(k)]) >> 1)
                + S::halo_lo2(k)) & 1);
  else
    return ((void)p, (void)k, 0);
}

template <class S>
YT_HD constexpr int cring_e1(int b) {
  return S::SS_T1 + S::sub_lo1(S::cmp_sub(b)) + S::sub_hi1(S::cmp_sub(b));
}
template <class S>
YT_HD constexpr int cring_e2(int b) {
  return S::SS_T2 + S::sub_lo2(S::cmp_sub(b)) + S::sub_hi2(S::cmp_sub(b));
}

// The slot of a ring of D planes that holds the plane d planes above its
// lowest at walk step it (the lowest plane's slot is it mod D); 0 <= d <
// D.  D is a compile-time constant at every call (after unrolling), so
// the modulo is a multiply.
YT_HD inline int ring_slot(int D, int it, int d) {
  int s = it % D + d;
  if (s >= D) s -= D;
  return s;
}

// ---- outer dims (NOUTER) --------------------------------------------------
// NO1: an array length for NOUTER values (1 without outer dims).
template <class S>
YT_HD constexpr int no1() {
  return OuterOf<S>::N > 0 ? OuterOf<S>::N : 1;
}

// One work item's window: its first index in every outer dim.
template <class S>
struct OuterWin {
  int w0[no1<S>()];
};

// The extent in outer dim j of staged ring k's box (the window grown by
// its readers' outer reach), and of sub-stage K's region (the window
// grown by its outer region); the cells of each box over the outer dims
// (1 without outer dims).
template <class S>
YT_HD constexpr int ring_oext(int k, int j) {
  return S::ss_wo(j) + S::halo_olo(k, j) + S::halo_ohi(k, j);
}
template <class S>
YT_HD constexpr int sub_oext(int K, int j) {
  return S::ss_wo(j) + S::sub_olo(K, j) + S::sub_ohi(K, j);
}
template <class S>
YT_HD constexpr int ring_o(int k) {
  int c = 1;
  if constexpr (OuterOf<S>::N > 0)
    for (int j = 0; j < OuterOf<S>::N; ++j) c *= ring_oext<S>(k, j);
  (void)k;
  return c;
}
template <class S>
YT_HD constexpr int sub_o(int K) {
  int c = 1;
  if constexpr (OuterOf<S>::N > 0)
    for (int j = 0; j < OuterOf<S>::N; ++j) c *= sub_oext<S>(K, j);
  (void)K;
  return c;
}

// Input a at global outer indices gw (its pointer already at its own
// outer offset), member m, interior cell (c0, c1, c2).
template <class S>
YT_HD inline typename S::real_t global_at_w(const ParamsOf<S>& p, int a,
                                            int m, const int* gw, idx_t c0,
                                            idx_t c1, idx_t c2) {
  idx_t off = idx_t(m) * p.in_ms[a] + c0 * p.in_s[a][0]
              + c1 * p.in_s[a][1] + c2 * p.in_s[a][2];
  for (int j = 0; j < OuterOf<S>::N; ++j)
    off += idx_t(gw[j]) * p.in_s[a][3 + j];
#ifdef __CUDA_ARCH__
  return __ldg(p.in[a] + off);
#else
  return p.in[a][off];
#endif
}

// Output o's element offset at member m, outer indices gw and interior
// cell (g0, g1, g2).
template <class S, class P>
YT_HD inline idx_t out_at_w(const P& p, int o, int m, const int* gw, int g0,
                            int g1, int g2) {
  idx_t off = idx_t(m) * p.out_ms[o] + idx_t(g0) * p.out_s[o][0]
              + idx_t(g1) * p.out_s[o][1] + idx_t(g2) * p.out_s[o][2];
  for (int j = 0; j < OuterOf<S>::N; ++j)
    off += idx_t(gw[j]) * p.out_s[o][3 + j];
  return off;
}

// Sub-stage K's region below and above the block in slot s of any kind
// (the outer ones past the three).
template <class S>
YT_HD constexpr int sub_lo_any(int K, int s) {
  if constexpr (OuterOf<S>::N > 0)
    if (s >= 3) return S::sub_olo(K, s - 3);
  return s == 0 ? S::sub_lo0(K) : s == 1 ? S::sub_lo1(K) : S::sub_lo2(K);
}
template <class S>
YT_HD constexpr int sub_hi_any(int K, int s) {
  if constexpr (OuterOf<S>::N > 0)
    if (s >= 3) return S::sub_ohi(K, s - 3);
  return s == 0 ? S::sub_hi0(K) : s == 1 ? S::sub_hi1(K) : S::sub_hi2(K);
}

// ---- host path: K6's host loop, then the pads ----------------------------
// The host path's reader with outer dims: global inputs at the point's
// outer indices, whole-domain computed buffers over every slot.
template <class S>
struct HostOuterReader {
  const ParamsOf<S>* p;
  typename S::real_t* const* bufs;
  int m;
  int g0, g1, g2;
  const int* gw;
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    return global_at_w<S>(*p, A, m, gw, g0 + o0, g1 + o1, g2 + o2);
  }
  template <int B, class... Os>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2, Os... oo) const {
    constexpr int W = S::cmp_sub(B);
    constexpr int NS = 3 + OuterOf<S>::N;
    const int off[NS] = {o0, o1, o2, int(oo)...};
    const int g[3] = {g0, g1, g2};
    idx_t c = 0;
    for (int s = 0; s < NS; ++s) {
      const int ext = p->n[s] + sub_lo_any<S>(W, s) + sub_hi_any<S>(W, s);
      const int x = (s < 3 ? g[s] : gw[s - 3]) + sub_lo_any<S>(W, s) + off[s];
      c = c * ext + x;
    }
    return bufs[B][c];
  }
};

// Sub-stage K (then the later ones) over its plain region in every slot
// (the domain grown by its clip), reading through HostOuterReader, into
// the interior cells of the outputs it is the last writer of and its
// computed buffers.
template <class S, int K>
void host_stage_outer(const ParamsOf<S>& p, typename S::real_t* const* bufs,
                      int m) {
  typedef typename S::real_t real_t;
  constexpr int NS = 3 + OuterOf<S>::N;
  int lo[NS], hi[NS], g[NS];
  long long cells = 1;
  for (int s = 0; s < NS; ++s) {
    const int cl = s < 3 ? clip_lo_of<S, K>(s) : S::oclip_lo(K, s - 3);
    const int ch = s < 3 ? clip_hi_of<S, K>(s) : S::oclip_hi(K, s - 3);
    lo[s] = -cl;
    hi[s] = p.n[s] + ch;
    cells *= hi[s] - lo[s];
  }
  for (long long i = 0; i < cells; ++i) {
    long long r = i;
    for (int s = NS - 1; s >= 0; --s) {
      const long long w = hi[s] - lo[s];
      g[s] = lo[s] + int(r % w);
      r /= w;
    }
    const HostOuterReader<S> rd{&p, bufs, m, g[0], g[1], g[2], g + 3};
    CalcOf<S> v[S::MAXV];
    S::template stage<K>(rd, g, p.n, p.t, v);
    bool own = true;
    for (int s = 0; s < NS; ++s) own = own && g[s] >= 0 && g[s] < p.n[s];
    for (int j = 0; j < S::stage_nv(K); ++j) {
      const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
      const real_t w = Calc<real_t>::store(v[j]);
      if (o >= 0 && own)
        p.out[o][out_at_w<S>(p, o, m, g + 3, g[0], g[1], g[2])] = w;
      if (b >= 0) {
        idx_t c = 0;
        for (int s = 0; s < NS; ++s)
          c = c * (p.n[s] + sub_lo_any<S>(K, s) + sub_hi_any<S>(K, s))
              + g[s] + sub_lo_any<S>(K, s);
        bufs[b][c] = w;
      }
    }
  }
  if constexpr (K + 1 < S::NSTAGES) host_stage_outer<S, K + 1>(p, bufs, m);
}

template <class S>
void host_stages_outer(const ParamsOf<S>& p) {
  typedef typename S::real_t real_t;
  constexpr int NS = 3 + OuterOf<S>::N;
  std::vector<std::vector<real_t>> store(S::NCMP);
  real_t* bufs[S::NCMP > 0 ? S::NCMP : 1] = {nullptr};
  for (int m = 0; m < p.nm; ++m) {
    for (int b = 0; b < S::NCMP; ++b) {
      size_t c = 1;
      for (int s = 0; s < NS; ++s)
        c *= size_t(p.n[s] + sub_lo_any<S>(S::cmp_sub(b), s)
                    + sub_hi_any<S>(S::cmp_sub(b), s));
      store[b].assign(c, real_t(0.0f));
      bufs[b] = store[b].data();
    }
    host_stage_outer<S, 0>(p, bufs, m);
  }
}

template <class S>
int host_stages_stream(const ParamsArg<S, false>& p) {
  if constexpr (OuterOf<S>::N > 0)
    host_stages_outer<S>(p);
  else
    host_stages<S, false>(p);
  flat_pads<S>(p, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// ---- device path ----------------------------------------------------------
// (the cp.async primitives are fused_step.cuh's)

// Reads of sub-stage K at plane z + ss_lag(K) (walk step it = z minus the
// segment's first walk plane): staged inputs from their rings, others
// (and ring-less staged inputs) from global memory, earlier sub-stages'
// results from their rings.
template <class S, int K>
struct StreamStageReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  const typename S::real_t* ws;  // the block's workspace slice
  int it;
  int m;           // the member (0 in a solo launch)
  int l1, l2;      // point relative to the plane tile (may lie in the
                   // sub-stage's in-plane expansion)
  int g0, g1, g2;  // point in the interior
  // outer dims: the point relative to the window (may lie in the
  // sub-stage's outer expansion) and its global outer indices
  int lw[no1<S>()];
  int gw[no1<S>()];
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0 && !SsPlaceOf<S>::global(k)) {
      constexpr int E1 = ring_e1<S>(k), R2 = ring_row<S>(k);
      const int s = ring_slot(S::ss_depth(k), it,
                              S::ss_rlo(k) + S::ss_lag(K) + o0);
      // the cell in its ring row (past the pair shift at element size 2)
      const int c2 = l2 + S::halo_lo2(k) + o2 + ring_shift<S>(*p, k);
      if constexpr (OuterOf<S>::N > 0) {
        // the ring's box cell at the read's outer offset
        int oc = 0;
        for (int j = 0; j < OuterOf<S>::N; ++j)
          oc = oc * ring_oext<S>(k, j) + lw[j] + S::halo_olo(k, j)
               + S::in_dw(A, j);
        return smem[S::ss_ring(k)
                    + ((s * ring_o<S>(k) + oc) * E1
                       + (l1 + S::halo_lo1(k) + o1)) * R2
                    + c2];
      } else {
        return smem[S::ss_ring(k)
                    + (s * E1 + (l1 + S::halo_lo1(k) + o1)) * R2 + c2];
      }
    } else if constexpr (OuterOf<S>::N > 0) {
      return global_at_w<S>(*p, A, m, gw, g0 + o0, g1 + o1, g2 + o2);
    } else {
      return global_at<S>(*p, A, m, 0, g0 + o0, g1 + o1, g2 + o2);
    }
  }
  // a read of computed ring B; with outer dims its outer offsets follow
  // the three
  template <int B, class... Os>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2, Os... oo) const {
    constexpr int W = S::cmp_sub(B);
    constexpr int C1 = cring_e1<S>(B), C2 = cring_e2<S>(B);
    const int s = ring_slot(S::ss_cdepth(B), it,
                            S::ss_clo(B) + S::ss_lag(K) + o0);
    if constexpr (OuterOf<S>::N > 0) {
      const int od[sizeof...(Os) + 1] = {int(oo)..., 0};
      int oc = 0;
      for (int j = 0; j < OuterOf<S>::N; ++j)
        oc = oc * sub_oext<S>(W, j) + lw[j] + S::sub_olo(W, j) + od[j];
      return cring_at<S>(smem, ws, S::ss_cring(B))[
          ((s * sub_o<S>(W) + oc) * C1 + (l1 + S::sub_lo1(W) + o1)) * C2
          + (l2 + S::sub_lo2(W) + o2)];
    } else {
      return cring_at<S>(smem, ws, S::ss_cring(B))[
          (s * C1 + (l1 + S::sub_lo1(W) + o1)) * C2
          + (l2 + S::sub_lo2(W) + o2)];
    }
  }
};

// Issue the copies of plane c of staged input k (member m) into its ring
// slot `slot`: cells past the input's allocation get 0.  16-byte copies
// where every row lines up with its source (see the notes above), else
// one cell per copy, or at element size 2 one 4-byte pair, each row from
// the pair that holds its first cell (ring_shift).  K5 (REGION) walks the
// box: a box-relative plane, row or cell c lies at c + p.lo of the shard,
// whose allocation (its interior p.sn and the pads) bounds the copies, not
// the box.  With outer dims a plane is the box over the window win grown
// by the ring's outer halo: its rows are (outer cell, slot-1 row) pairs,
// each bounded by the allocation in the outer dims too.
template <class S>
__device__ __forceinline__ bool outer_row(const ParamsOf<S>& p, int k, int a,
                                          const OuterWin<S>& win, int oc,
                                          idx_t& off) {
  bool in = true;
  off = 0;
  for (int j = OuterOf<S>::N - 1; j >= 0; --j) {
    const int e = ring_oext<S>(k, j);
    const int c = win.w0[j] - S::halo_olo(k, j) + oc % e;
    oc /= e;
    in = in && c >= -S::alloc_olo(k, j) && c < p.n[3 + j] + S::alloc_ohi(k, j);
    off += idx_t(c) * p.in_s[a][3 + j];
  }
  return in;
}

template <class S, int k, bool BATCH, bool REGION>
__device__ __forceinline__ void ring_fetch(const ParamsArg<S, REGION>& p,
                                           typename S::real_t* smem, int m,
                                           int c, int slot, int b1, int b2,
                                           int tid, const OuterWin<S>& win) {
  typedef typename S::real_t real_t;
  constexpr int NT = S::SS_NT;
  constexpr int a = S::tiled_input(k);
  constexpr int h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
  constexpr int E1 = ring_e1<S>(k), E2 = ring_e2<S>(k), R2 = ring_row<S>(k);
  constexpr int V = 16 / int(sizeof(real_t));
  constexpr int NO = OuterOf<S>::N;
  constexpr int O = ring_o<S>(k);  // outer cells of a plane (1 in 3-D)
  real_t* dst = smem + S::ss_ring(k) + slot * (O * E1 * R2);
  const int x0 = box_lo<S, REGION>(p, 0), x1 = box_lo<S, REGION>(p, 1),
            x2 = box_lo<S, REGION>(p, 2);
  const bool in0 = c >= -S::alloc_lo0(k) - x0
                   && c < alloc_n<S, REGION>(p, 0) + S::alloc_hi0(k) - x0;
  const int lo1 = -S::alloc_lo1(k) - x1;
  const int lim1 = alloc_n<S, REGION>(p, 1) + S::alloc_hi1(k) - x1;
  const int lo2 = -S::alloc_lo2(k) - x2;
  const int lim2 = alloc_n<S, REGION>(p, 2) + S::alloc_hi2(k) - x2;
  const idx_t* st = p.in_s[a];
  const real_t* src = p.in[a] + cell_base<S>(p.n, m, 0, p.in_ms[a], st)
                      + c * st[0];
  const real_t* zero16 = reinterpret_cast<const real_t*>(
      reinterpret_cast<unsigned long long>(p.in[a]) & ~15ull);
  // the cell a ring row starts at: b2 - h2, at element size 2 the first
  // of the pair that holds it
  const int r2 = b2 - h2 - ring_shift<S>(p, k);
  // element size 2: cells c2 and c2 + 1 of a row (row: the row lies in
  // the allocation) from s to d; a pair whose cells lie both inside the
  // allocation's reach, or both past it, is one copy, one across its edge
  // goes by plain loads and stores
  auto pair = [&](real_t* d, const real_t* s, bool row, int c2) {
    const bool ok0 = row && c2 >= lo2 && c2 < lim2;
    const bool ok1 = row && c2 + 1 >= lo2 && c2 + 1 < lim2;
    if (ok0 == ok1) {
      cp_async<4>(d, ok0 ? s : zero16, ok0);
    } else {
      d[0] = ok0 ? s[0] : real_t(0.0f);
      d[1] = ok1 ? s[1] : real_t(0.0f);
    }
  };
  (void)pair;
  if constexpr (R2 % V == 0) {
    const real_t* src0 = src + (b1 - h1) * st[1] + r2;
    const bool lines_up =
        st[2] == 1 && st[1] % V == 0 && st[0] % V == 0
        && (!BATCH || p.in_ms[a] % V == 0)
        && !((reinterpret_cast<unsigned long long>(dst)
              - reinterpret_cast<unsigned long long>(src0)) & 15);
    bool outer_up = true;
    for (int j = 0; j < NO; ++j) outer_up = outer_up && st[3 + j] % V == 0;
    if (lines_up && outer_up) {
      constexpr int NV = R2 / V;  // a row's 16-byte slots
      for (int j = tid; j < O * E1 * NV; j += NT) {
        const int rr = j / NV;  // the row: outer cell, then slot-1 row
        const int e = (j - rr * NV) * V;
        int r = rr;
        bool rin = in0;
        idx_t ooff = 0;
        if constexpr (NO > 0) {
          r = rr % E1;
          rin = rin && outer_row<S>(p, k, a, win, rr / E1, ooff);
        }
        const int c1 = b1 - h1 + r, c2 = r2 + e;
        real_t* d = dst + rr * R2 + e;
        const bool row = rin && c1 >= lo1 && c1 < lim1;
        const real_t* s = src + ooff + c1 * st[1] + c2;
        if (!row || c2 >= lim2 || c2 + V <= lo2) {
          cp_async<16>(d, zero16, false);
        } else if (c2 >= lo2 && c2 + V <= lim2) {
          cp_async<16>(d, s, true);
        } else if constexpr (sizeof(real_t) == 2) {
          for (int u = 0; u < V; u += 2) pair(d + u, s + u, row, c2 + u);
        } else {
          for (int u = 0; u < V; ++u) {
            const bool ok = c2 + u >= lo2 && c2 + u < lim2;
            cp_async<int(sizeof(real_t))>(d + u, ok ? s + u : p.in[a], ok);
          }
        }
      }
      return;
    }
  }
  if constexpr (sizeof(real_t) == 2) {
    constexpr int NP = R2 / 2;  // a row's pairs
    for (int i = tid; i < O * E1 * NP; i += NT) {
      const int rr = i / NP;
      int r = rr;
      bool rin = in0;
      idx_t ooff = 0;
      if constexpr (NO > 0) {
        r = rr % E1;
        rin = rin && outer_row<S>(p, k, a, win, rr / E1, ooff);
      }
      const int c1 = b1 - h1 + r, c2 = r2 + 2 * (i - rr * NP);
      pair(dst + 2 * i, src + ooff + c1 * st[1] + c2,
           rin && c1 >= lo1 && c1 < lim1, c2);
    }
  } else {
    for (int i = tid; i < O * E1 * E2; i += NT) {
      const int rr = i / E2;
      int r = rr;
      bool rin = in0;
      idx_t ooff = 0;
      if constexpr (NO > 0) {
        r = rr % E1;
        rin = rin && outer_row<S>(p, k, a, win, rr / E1, ooff);
      }
      const int c1 = b1 - h1 + r, c2 = b2 - h2 + (i - rr * E2);
      const bool ok = rin && c1 >= lo1 && c1 < lim1 && c2 >= lo2
                      && c2 < lim2;
      cp_async<int(sizeof(real_t))>(
          dst + i, ok ? src + ooff + c1 * st[1] + c2 * st[2] : p.in[a], ok);
    }
  }
}

// Planes zz - ss_rlo(k) .. zz + ss_rhi(k) of every ring input k (the
// planes walk plane zz reads; first) or plane zz + ss_rhi(k) alone (the
// newest one it reads), into their slots; z0 is the segment's first walk
// plane, whose lowest plane takes slot 0.  A ring-less input copies
// nothing.
template <class S, bool BATCH, bool REGION, int k = 0>
__device__ __forceinline__ void ring_fetch_planes(
    const ParamsArg<S, REGION>& p, typename S::real_t* smem, int m, int z0,
    int zz, bool first, int b1, int b2, int tid, const OuterWin<S>& win) {
  if constexpr (k < S::NTILED) {
    constexpr int D = S::ss_depth(k), lo = S::ss_rlo(k), hi = S::ss_rhi(k);
    if constexpr (!SsPlaceOf<S>::global(k))
      for (int c = first ? zz - lo : zz + hi; c <= zz + hi; ++c)
        ring_fetch<S, k, BATCH, REGION>(p, smem, m, c, (c - (z0 - lo)) % D,
                                        b1, b2, tid, win);
    ring_fetch_planes<S, BATCH, REGION, k + 1>(p, smem, m, z0, zz, first, b1,
                                               b2, tid, win);
  }
}

// Sub-stage K (and, after a barrier, the later ones) at walk plane z:
// plane z + ss_lag(K) over the plane tile grown by its in-plane region,
// from the segment's first plane it must compute (zs - sub_lo0(K)) on.
// Results go to its computed rings and, for the tile's own points of
// the segment [zs, ze), to the outputs it is the last writer of.  K5
// (REGION) computes at global coordinates, its plain region clipped at
// the global domain and kept to the box grown by the sub-stage's region
// (plain_region), and stores the box's own cells.  With outer dims it
// computes the window grown by its outer region (sub_o cells a row of
// the plane), inside its plain region in the outer dims too, and stores
// the window's own cells inside the domain.
template <class S, int K, bool BATCH, bool REGION>
__device__ __forceinline__ void stream_sub(const ParamsArg<S, REGION>& p,
                                           typename S::real_t* smem,
                                           typename S::real_t* ws, int m,
                                           int it, int z, int zs, int ze,
                                           int b1, int b2, int tid,
                                           const OuterWin<S>& win) {
  typedef typename S::real_t real_t;
  constexpr int NO = OuterOf<S>::N;
  constexpr int L = S::ss_lag(K);
  const int g0 = z + L;
  if (g0 >= zs - S::sub_lo0(K)) {
    constexpr int e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
    constexpr int R1 = S::SS_T1 + e1 + S::sub_hi1(K);
    constexpr int R2 = S::SS_T2 + e2 + S::sub_hi2(K);
    constexpr int RO = sub_o<S>(K);  // outer cells of a row (1 in 3-D)
    int plo[3], phi[3];
    for (int s = 0; s < 3; ++s)
      plain_region<S, K, REGION>(p, s, plo[s], phi[s]);
    const bool in0 = g0 >= plo[0] && g0 < phi[0];
    const bool own0 = g0 >= zs && g0 < ze;
    for (int i = tid; i < RO * R1 * R2; i += S::SS_NT) {
      const int rr = i / R2;  // outer cell, then slot-1 row
      int r = rr;
      StreamStageReader<S, K> rd{&p, smem, ws, it, m, 0, 0, g0, 0, 0};
      bool inO = true, ownO = true;
      if constexpr (NO > 0) {
        r = rr % R1;
        int oc = rr / R1;
        for (int j = NO - 1; j >= 0; --j) {
          const int e = sub_oext<S>(K, j);
          rd.lw[j] = oc % e - S::sub_olo(K, j);
          oc /= e;
          rd.gw[j] = win.w0[j] + rd.lw[j];
          inO = inO && rd.gw[j] >= -S::oclip_lo(K, j)
                && rd.gw[j] < p.n[3 + j] + S::oclip_hi(K, j);
          ownO = ownO && rd.lw[j] >= 0 && rd.lw[j] < S::ss_wo(j)
                 && rd.gw[j] < p.n[3 + j];
        }
      }
      const int l1 = r - e1, l2 = i - rr * R2 - e2;
      const int g1 = b1 + l1, g2 = b2 + l2;
      rd.l1 = l1;
      rd.l2 = l2;
      rd.g1 = g1;
      rd.g2 = g2;
      CalcOf<S> v[S::MAXV];
      if (in0 && inO && g1 >= plo[1] && g1 < phi[1] && g2 >= plo[2]
          && g2 < phi[2]) {
        int g[3 + NO];
        for (int j = 0; j < NO; ++j) g[3 + j] = rd.gw[j];
        stage_at<S, K, REGION>(p, rd, g, g0, g1, g2, v);
      } else {
#pragma unroll
        for (int j = 0; j < S::MAXV; ++j) v[j] = CalcOf<S>(0);
      }
      const bool own = own0 && ownO && l1 >= 0 && l1 < S::SS_T1 && l2 >= 0
                       && l2 < S::SS_T2 && g1 < p.n[1] && g2 < p.n[2];
#pragma unroll
      for (int j = 0; j < S::MAXV; ++j) {
        if (j >= S::stage_nv(K)) break;
        const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
        const real_t w = Calc<real_t>::store(v[j]);
        if (o >= 0 && own) {
          if constexpr (NO > 0)
            p.out[o][out_at_w<S>(p, o, m, rd.gw, g0, g1, g2)] = w;
          else
            p.out[o][cell_base<S>(p.n, m, 0, p.out_ms[o], p.out_s[o])
                     + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                     + g2 * p.out_s[o][2]] = w;
        }
        if (b >= 0)
          cring_at<S>(smem, ws, S::ss_cring(b))[
              (ring_slot(S::ss_cdepth(b), it, S::ss_clo(b) + L) * RO
               * cring_e1<S>(b) + rr) * cring_e2<S>(b)
              + (i - rr * R2)] = w;
      }
    }
  }
  if constexpr (K + 1 < S::NSTAGES) {
    __syncthreads();
    stream_sub<S, K + 1, BATCH, REGION>(p, smem, ws, m, it, z, zs, ze, b1,
                                        b2, tid, win);
  }
}

// One work item: member m's column (b1, b2) over the segment [zs, ze) of
// slot 0, walked from plane zs - SS_W (where the sub-stage with the
// widest slot-0 reach starts) on, one barrier before each plane's
// sub-stages.
template <class S, bool BATCH, bool REGION>
__device__ __forceinline__ void stream_item(const ParamsArg<S, REGION>& p,
                                            typename S::real_t* smem,
                                            typename S::real_t* ws, int m,
                                            int zs, int ze, int b1, int b2,
                                            int tid, const OuterWin<S>& win) {
  const int z0 = zs - S::SS_W;
  // the prologue: the planes walk plane z0 reads (one group), then the
  // newest plane of each of the next SS_P - 1 walk planes (a group each;
  // a plane no walk plane of the segment reads is skipped, its group
  // left empty)
  ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z0, true, b1, b2, tid,
                                      win);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < S::SS_P; ++j) {
    if (z0 + j < ze)
      ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z0 + j, false, b1,
                                          b2, tid, win);
    cp_async_commit();
  }
  for (int z = z0; z < ze; ++z) {
    if (z + S::SS_P < ze)
      ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z + S::SS_P, false,
                                          b1, b2, tid, win);
    cp_async_commit();
    cp_async_wait<S::SS_P>();
    __syncthreads();
    stream_sub<S, 0, BATCH, REGION>(p, smem, ws, m, z - z0, z, zs, ze, b1,
                                    b2, tid, win);
  }
  cp_async_wait<0>();
}

// The outer windows of a launch: ceil(n / ss_wo) per outer dim, their
// product (1 without outer dims).
template <class S>
YT_HD inline long long outer_windows(const int* n) {
  long long c = 1;
  if constexpr (OuterOf<S>::N > 0)
    for (int j = 0; j < OuterOf<S>::N; ++j)
      c *= (n[3 + j] + S::ss_wo(j) - 1) / S::ss_wo(j);
  (void)n;
  return c;
}

// K6's stream arm (BATCH = false), K7's over it (BATCH = true) and K5's
// (REGION = true: the walk over a shard's box, BATCH false): a grid of at
// most the card's resident blocks, each walking the work items
// blockIdx.x, + gridDim.x, ... (x columns fastest, then y columns, then
// outer windows (the last outer dim fastest), then segments, then
// members) with its own workspace slice (SsPlaceOf); a barrier parts one
// item's last reads from the next one's prologue.  Then every output's
// pads get 0 (flat_pads, which takes the outer slots' pads too), but in
// K5, whose outputs keep what the wrapper gave them outside the box.
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::SS_NT, S::SS_MIN)
stream_stages_kernel(const __grid_constant__ StagesStreamParams<S, REGION> q) {
  static_assert(!REGION || OuterOf<S>::N == 0,
                "K5 over the stream arm takes three domain dims");
  static_assert(sizeof(typename S::real_t) != 2 || S::SS_T2 % 2 == 0,
                "bfloat16 rings take an even plane tile in slot 2");
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsArg<S, REGION>& p = q.p;
  real_t* ws = q.ws ? q.ws + (long long)blockIdx.x * ss_ws_elems<S>()
                    : nullptr;
  const int tid = threadIdx.x;
  const long long gx = (p.n[2] + S::SS_T2 - 1) / S::SS_T2;
  const long long gy = (p.n[1] + S::SS_T1 - 1) / S::SS_T1;
  const long long gs = (p.n[0] + q.seg - 1) / q.seg;
  const long long gw = outer_windows<S>(p.n);
  const long long items = gx * gy * gw * gs * (BATCH ? p.nm : 1);
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    if (i != (long long)blockIdx.x) __syncthreads();
    const long long yz = i / gx;
    long long sm = yz / gy;
    OuterWin<S> win{};
    if constexpr (OuterOf<S>::N > 0) {
      long long ow = sm % gw;
      sm /= gw;
      for (int j = OuterOf<S>::N - 1; j >= 0; --j) {
        const long long nw = (p.n[3 + j] + S::ss_wo(j) - 1) / S::ss_wo(j);
        win.w0[j] = int(ow % nw) * S::ss_wo(j);
        ow /= nw;
      }
    }
    const int zs = int(sm % gs) * q.seg;
    const int ze = zs + q.seg < p.n[0] ? zs + q.seg : p.n[0];
    stream_item<S, BATCH, REGION>(p, smem, ws, BATCH ? int(sm / gs) : 0, zs,
                                  ze, int(yz % gy) * S::SS_T1,
                                  int(i % gx) * S::SS_T2, tid, win);
  }
  if constexpr (!REGION)
    flat_pads<S>(p, (long long)blockIdx.x * S::SS_NT + tid,
                 (long long)gridDim.x * S::SS_NT);
}

template <class S, bool BATCH, bool REGION>
int stages_stream_resident() {
  return resident_of(stream_stages_kernel<S, BATCH, REGION>, S::SS_NT,
                     int(sizeof(typename S::real_t)) * S::SS_ELEMS);
}

template <class S, bool BATCH, bool REGION>
int launch_stages_stream(StagesStreamParams<S, REGION> p, long long nres,
                         cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SS_ELEMS;
  // a launch with computed rings past shared memory needs its workspace
  if (nres < 1 || p.seg < 1 || (ss_ws_elems<S>() > 0 && !p.ws))
    return int(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      stream_stages_kernel<S, BATCH, REGION>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const long long items = (long long)((p.p.n[2] + S::SS_T2 - 1) / S::SS_T2)
                          * ((p.p.n[1] + S::SS_T1 - 1) / S::SS_T1)
                          * outer_windows<S>(p.p.n)
                          * ((p.p.n[0] + p.seg - 1) / p.seg) * p.p.nm;
  if (items < 1) return 0;
  const dim3 grid(unsigned(items < nres ? items : nres));
  const dim3 block(S::SS_NT, 1, 1);
  stream_stages_kernel<S, BATCH, REGION><<<grid, block, smem, stream>>>(p);
  return int(cudaGetLastError());
}
#endif

// K6's stream arm over nm members (BATCH; K7) or one: K7's arguments
// (member strides null for a solo launch), the segment length, the step,
// the workspace (nres slices of SS_WS_ELEMS elements where rings lie past
// shared memory, else null), the resident blocks (the grid; the host
// path ignores both) and the stream.
template <class S, bool BATCH>
int run_stages_stream(void* in_ptrs, void* in_strides, void* in_mstrides,
                      void* out_ptrs, void* out_strides, void* out_mstrides,
                      void* sizes, int nm, int seg, int t, void* ws,
                      long long nres, void* stream) {
  StagesStreamParams<S> q{};
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  if (BATCH) fill_members<S>(q.p, in_mstrides, out_mstrides, nm);
  q.seg = seg;
  q.ws = static_cast<typename S::real_t*>(ws);
#ifdef __CUDACC__
  return launch_stages_stream<S, BATCH, false>(
      q, nres, static_cast<cudaStream_t>(stream));
#else
  (void)nres;
  (void)stream;
  return host_stages_stream<S>(q.p);
#endif
}

// K5's stream arm: one sub-step of a shard over the box (run_region's
// table, set_region), K6's tables moved to the box's cell 0 and p.n
// holding the box's extents, as run_region does for the body; the
// segment length is the box's (the wrapper's).  The outputs are the
// wrapper's: the kernel stores the box's cells and nothing else.
template <class S>
int run_stages_stream_region(void* in_ptrs, void* in_strides, void* out_ptrs,
                             void* out_strides, void* sizes, void* region,
                             int seg, int t, void* ws, long long nres,
                             void* stream) {
  StagesStreamParams<S, true> q{};
  ParamsArg<S, true>& p = q.p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  if (!set_region<S>(p, region)) return 0;  // an empty box: nothing
  q.seg = seg;
  q.ws = static_cast<typename S::real_t*>(ws);
#ifdef __CUDACC__
  return launch_stages_stream<S, false, true>(
      q, nres, static_cast<cudaStream_t>(stream));
#else
  (void)nres;
  (void)stream;
  return host_stages<S, true>(p);
#endif
}

// The resident blocks of a launch of kind 0 (solo), 1 (member batch) or
// 2 (a shard's box); 1 on the host.
template <class S>
int resident_stages_stream(int kind) {
#ifdef __CUDACC__
  return kind == 1   ? stages_stream_resident<S, true, false>()
         : kind == 2 ? stages_stream_resident<S, false, true>()
                     : stages_stream_resident<S, false, false>();
#else
  (void)kind;
  return 1;
#endif
}

// The resident blocks of a solo (batched 0) or member-batch launch, for a
// Spec without K5's box arm (K4's stream arm); 1 on the host.
template <class S>
int resident_trap_stream(int batched) {
#ifdef __CUDACC__
  return batched ? stages_stream_resident<S, true, false>()
                 : stages_stream_resident<S, false, false>();
#else
  (void)batched;
  return 1;
#endif
}

}  // namespace yt

// The C entry points of K4's stream arm (a TrapSpec of
// ops/cuda_emit.py::emit_trap_stream: one K-step group, its K levels' sub-
// stages lagged along slot 0): solo and member batch with the arguments
// of K6's stream entries below (t is the group's first step: each level's
// point functions add their own offset), and the resident blocks of a
// launch (batched 0 or 1).
#define YT_TRAP_STREAM_ENTRIES(NAME, S)                                      \
  extern "C" int NAME##_trap_stream(void* in_ptrs, void* in_strides,         \
                                    void* out_ptrs, void* out_strides,       \
                                    void* sizes, int seg, int t, void* ws,   \
                                    long long nres, void* stream) {          \
    return yt::run_stages_stream<S, false>(in_ptrs, in_strides, nullptr,     \
                                           out_ptrs, out_strides, nullptr,   \
                                           sizes, 1, seg, t, ws, nres,       \
                                           stream);                          \
  }                                                                          \
  extern "C" int NAME##_trap_stream_batched(                                 \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, int nm, int seg,   \
      int t, void* ws, long long nres, void* stream) {                       \
    return yt::run_stages_stream<S, true>(in_ptrs, in_strides, in_mstrides,  \
                                          out_ptrs, out_strides,             \
                                          out_mstrides, sizes, nm, seg, t,   \
                                          ws, nres, stream);                 \
  }                                                                          \
  extern "C" int NAME##_trap_stream_resident(int batched) {                  \
    return yt::resident_trap_stream<S>(batched);                             \
  }

// The C entry points of K6's stream arm for a Spec with outer dims
// (ops/cuda_emit.py::emit prints it beside K6's body for a 4-D solution):
// solo and member batch with the arguments of YT_STAGES_STREAM_ENTRIES,
// and the resident blocks of a solo (kind 0) or member-batch (kind 1)
// launch.  K5 over it is not emitted.
#define YT_STAGES_STREAM_OUTER_ENTRIES(NAME, S)                              \
  extern "C" int NAME##_stages_stream(void* in_ptrs, void* in_strides,       \
                                      void* out_ptrs, void* out_strides,     \
                                      void* sizes, int seg, int t, void* ws, \
                                      long long nres, void* stream) {        \
    return yt::run_stages_stream<S, false>(in_ptrs, in_strides, nullptr,     \
                                           out_ptrs, out_strides, nullptr,   \
                                           sizes, 1, seg, t, ws, nres,       \
                                           stream);                          \
  }                                                                          \
  extern "C" int NAME##_stages_stream_batched(                               \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, int nm, int seg,   \
      int t, void* ws, long long nres, void* stream) {                       \
    return yt::run_stages_stream<S, true>(in_ptrs, in_strides, in_mstrides,  \
                                          out_ptrs, out_strides,             \
                                          out_mstrides, sizes, nm, seg, t,   \
                                          ws, nres, stream);                 \
  }                                                                          \
  extern "C" int NAME##_stages_stream_resident(int kind) {                   \
    return yt::resident_trap_stream<S>(kind == 1);                           \
  }

// The C entry points of K6's stream arm for a K6 Spec that prints SS_T1:
// solo (K6's arguments), member batch (K7's), a shard's box (K5's: K6's
// arguments and the box table), each with the segment length before the
// step and the workspace and resident blocks before the stream, and the
// resident blocks of a launch kind, which the wrapper asks once.
#define YT_STAGES_STREAM_ENTRIES(NAME, S)                                    \
  extern "C" int NAME##_stages_stream(void* in_ptrs, void* in_strides,       \
                                      void* out_ptrs, void* out_strides,     \
                                      void* sizes, int seg, int t, void* ws, \
                                      long long nres, void* stream) {        \
    return yt::run_stages_stream<S, false>(in_ptrs, in_strides, nullptr,     \
                                           out_ptrs, out_strides, nullptr,   \
                                           sizes, 1, seg, t, ws, nres,       \
                                           stream);                          \
  }                                                                          \
  extern "C" int NAME##_stages_stream_batched(                               \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, int nm, int seg,   \
      int t, void* ws, long long nres, void* stream) {                       \
    return yt::run_stages_stream<S, true>(in_ptrs, in_strides, in_mstrides,  \
                                          out_ptrs, out_strides,             \
                                          out_mstrides, sizes, nm, seg, t,   \
                                          ws, nres, stream);                 \
  }                                                                          \
  extern "C" int NAME##_stages_stream_region(                                \
      void* in_ptrs, void* in_strides, void* out_ptrs, void* out_strides,    \
      void* sizes, void* region, int seg, int t, void* ws, long long nres,   \
      void* stream) {                                                        \
    return yt::run_stages_stream_region<S>(in_ptrs, in_strides, out_ptrs,    \
                                           out_strides, sizes, region, seg,  \
                                           t, ws, nres, stream);             \
  }                                                                          \
  extern "C" int NAME##_stages_stream_resident(int kind) {                   \
    return yt::resident_stages_stream<S>(kind);                              \
  }
