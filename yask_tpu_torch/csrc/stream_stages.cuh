// stream_stages.cuh — the stream arm of K6 (and of K7 over K6's body) for
// NVIDIA Hopper, sm_90a: every sub-stage of one sub-step of a 3-D
// multi-stage solution, each block walking slot 0 through rings of staged
// input planes and computed planes.
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
// The same Spec compiles on the host (no __CUDACC__): host_stages_stream()
// runs K6's host loop (host_stages) and zeroes the pads, which is how the
// CPU tests check the entry's arithmetic with g++.
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

// ---- host path: K6's host loop, then the pads ----------------------------
template <class S>
int host_stages_stream(const ParamsArg<S, false>& p) {
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
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0 && !SsPlaceOf<S>::global(k)) {
      constexpr int E1 = ring_e1<S>(k), E2 = ring_e2<S>(k);
      const int s = ring_slot(S::ss_depth(k), it,
                              S::ss_rlo(k) + S::ss_lag(K) + o0);
      return smem[S::ss_ring(k)
                  + (s * E1 + (l1 + S::halo_lo1(k) + o1)) * E2
                  + (l2 + S::halo_lo2(k) + o2)];
    } else {
      return global_at<S>(*p, A, m, 0, g0 + o0, g1 + o1, g2 + o2);
    }
  }
  template <int B>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2) const {
    constexpr int W = S::cmp_sub(B);
    constexpr int C1 = cring_e1<S>(B), C2 = cring_e2<S>(B);
    const int s = ring_slot(S::ss_cdepth(B), it,
                            S::ss_clo(B) + S::ss_lag(K) + o0);
    return cring_at<S>(smem, ws, S::ss_cring(B))[
        (s * C1 + (l1 + S::sub_lo1(W) + o1)) * C2
        + (l2 + S::sub_lo2(W) + o2)];
  }
};

// Issue the copies of plane c of staged input k (member m) into its ring
// slot `slot`: cells past the input's allocation get 0.  16-byte copies
// where every row lines up with its source (see the notes above), else
// one cell per copy.  K5 (REGION) walks the box: a box-relative plane,
// row or cell c lies at c + p.lo of the shard, whose allocation (its
// interior p.sn and the pads) bounds the copies, not the box.
template <class S, int k, bool BATCH, bool REGION>
__device__ __forceinline__ void ring_fetch(const ParamsArg<S, REGION>& p,
                                           typename S::real_t* smem, int m,
                                           int c, int slot, int b1, int b2,
                                           int tid) {
  typedef typename S::real_t real_t;
  constexpr int NT = S::SS_NT;
  constexpr int a = S::tiled_input(k);
  constexpr int h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
  constexpr int E1 = ring_e1<S>(k), E2 = ring_e2<S>(k);
  constexpr int V = 16 / int(sizeof(real_t));
  real_t* dst = smem + S::ss_ring(k) + slot * (E1 * E2);
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
  if constexpr (E2 % V == 0) {
    const real_t* src0 = src + (b1 - h1) * st[1] + (b2 - h2);
    const bool lines_up =
        st[2] == 1 && st[1] % V == 0 && st[0] % V == 0
        && (!BATCH || p.in_ms[a] % V == 0)
        && !((reinterpret_cast<unsigned long long>(dst)
              - reinterpret_cast<unsigned long long>(src0)) & 15);
    if (lines_up) {
      constexpr int NV = E2 / V;  // a row's 16-byte slots
      const real_t* zero16 = reinterpret_cast<const real_t*>(
          reinterpret_cast<unsigned long long>(p.in[a]) & ~15ull);
      for (int j = tid; j < E1 * NV; j += NT) {
        const int r = j / NV;
        const int e = (j - r * NV) * V;
        const int c1 = b1 - h1 + r, c2 = b2 - h2 + e;
        real_t* d = dst + r * E2 + e;
        const bool row = in0 && c1 >= lo1 && c1 < lim1;
        const real_t* s = src + c1 * st[1] + c2;
        if (!row || c2 >= lim2 || c2 + V <= lo2) {
          cp_async<16>(d, zero16, false);
        } else if (c2 >= lo2 && c2 + V <= lim2) {
          cp_async<16>(d, s, true);
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
  for (int i = tid; i < E1 * E2; i += NT) {
    const int r = i / E2;
    const int c1 = b1 - h1 + r, c2 = b2 - h2 + (i - r * E2);
    const bool ok = in0 && c1 >= lo1 && c1 < lim1 && c2 >= lo2 && c2 < lim2;
    cp_async<int(sizeof(real_t))>(
        dst + i, ok ? src + c1 * st[1] + c2 * st[2] : p.in[a], ok);
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
    int zz, bool first, int b1, int b2, int tid) {
  if constexpr (k < S::NTILED) {
    constexpr int D = S::ss_depth(k), lo = S::ss_rlo(k), hi = S::ss_rhi(k);
    if constexpr (!SsPlaceOf<S>::global(k))
      for (int c = first ? zz - lo : zz + hi; c <= zz + hi; ++c)
        ring_fetch<S, k, BATCH, REGION>(p, smem, m, c, (c - (z0 - lo)) % D,
                                        b1, b2, tid);
    ring_fetch_planes<S, BATCH, REGION, k + 1>(p, smem, m, z0, zz, first, b1,
                                               b2, tid);
  }
}

// Sub-stage K (and, after a barrier, the later ones) at walk plane z:
// plane z + ss_lag(K) over the plane tile grown by its in-plane region,
// from the segment's first plane it must compute (zs - sub_lo0(K)) on.
// Results go to its computed rings and, for the tile's own points of
// the segment [zs, ze), to the outputs it is the last writer of.  K5
// (REGION) computes at global coordinates, its plain region clipped at
// the global domain and kept to the box grown by the sub-stage's region
// (plain_region), and stores the box's own cells.
template <class S, int K, bool BATCH, bool REGION>
__device__ __forceinline__ void stream_sub(const ParamsArg<S, REGION>& p,
                                           typename S::real_t* smem,
                                           typename S::real_t* ws, int m,
                                           int it, int z, int zs, int ze,
                                           int b1, int b2, int tid) {
  typedef typename S::real_t real_t;
  constexpr int L = S::ss_lag(K);
  const int g0 = z + L;
  if (g0 >= zs - S::sub_lo0(K)) {
    constexpr int e1 = S::sub_lo1(K), e2 = S::sub_lo2(K);
    constexpr int R1 = S::SS_T1 + e1 + S::sub_hi1(K);
    constexpr int R2 = S::SS_T2 + e2 + S::sub_hi2(K);
    int plo[3], phi[3];
    for (int s = 0; s < 3; ++s)
      plain_region<S, K, REGION>(p, s, plo[s], phi[s]);
    const bool in0 = g0 >= plo[0] && g0 < phi[0];
    const bool own0 = g0 >= zs && g0 < ze;
    for (int i = tid; i < R1 * R2; i += S::SS_NT) {
      const int r = i / R2;
      const int l1 = r - e1, l2 = i - r * R2 - e2;
      const int g1 = b1 + l1, g2 = b2 + l2;
      CalcOf<S> v[S::MAXV];
      if (in0 && g1 >= plo[1] && g1 < phi[1] && g2 >= plo[2]
          && g2 < phi[2]) {
        const StreamStageReader<S, K> rd{&p, smem, ws, it, m, l1, l2,
                                         g0, g1, g2};
        int g[3];
        stage_at<S, K, REGION>(p, rd, g, g0, g1, g2, v);
      } else {
#pragma unroll
        for (int j = 0; j < S::MAXV; ++j) v[j] = CalcOf<S>(0);
      }
      const bool own = own0 && l1 >= 0 && l1 < S::SS_T1 && l2 >= 0
                       && l2 < S::SS_T2 && g1 < p.n[1] && g2 < p.n[2];
#pragma unroll
      for (int j = 0; j < S::MAXV; ++j) {
        if (j >= S::stage_nv(K)) break;
        const int o = S::stage_out(K, j), b = S::stage_cmp(K, j);
        const real_t w = Calc<real_t>::store(v[j]);
        if (o >= 0 && own)
          p.out[o][cell_base<S>(p.n, m, 0, p.out_ms[o], p.out_s[o])
                   + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                   + g2 * p.out_s[o][2]] = w;
        if (b >= 0)
          cring_at<S>(smem, ws, S::ss_cring(b))[
              (ring_slot(S::ss_cdepth(b), it, S::ss_clo(b) + L)
               * cring_e1<S>(b) + r) * cring_e2<S>(b)
              + (i - r * R2)] = w;
      }
    }
  }
  if constexpr (K + 1 < S::NSTAGES) {
    __syncthreads();
    stream_sub<S, K + 1, BATCH, REGION>(p, smem, ws, m, it, z, zs, ze, b1,
                                        b2, tid);
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
                                            int tid) {
  const int z0 = zs - S::SS_W;
  // the prologue: the planes walk plane z0 reads (one group), then the
  // newest plane of each of the next SS_P - 1 walk planes (a group each;
  // a plane no walk plane of the segment reads is skipped, its group
  // left empty)
  ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z0, true, b1, b2, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < S::SS_P; ++j) {
    if (z0 + j < ze)
      ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z0 + j, false, b1,
                                          b2, tid);
    cp_async_commit();
  }
  for (int z = z0; z < ze; ++z) {
    if (z + S::SS_P < ze)
      ring_fetch_planes<S, BATCH, REGION>(p, smem, m, z0, z + S::SS_P, false,
                                          b1, b2, tid);
    cp_async_commit();
    cp_async_wait<S::SS_P>();
    __syncthreads();
    stream_sub<S, 0, BATCH, REGION>(p, smem, ws, m, z - z0, z, zs, ze, b1,
                                    b2, tid);
  }
  cp_async_wait<0>();
}

// K6's stream arm (BATCH = false), K7's over it (BATCH = true) and K5's
// (REGION = true: the walk over a shard's box, BATCH false): a grid of at
// most the card's resident blocks, each walking the work items
// blockIdx.x, + gridDim.x, ... (x columns fastest, then y columns, then
// segments, then members) with its own workspace slice (SsPlaceOf); a
// barrier parts one item's last reads from the next one's prologue.  Then
// every output's pads get 0 (flat_pads), but in K5, whose outputs keep
// what the wrapper gave them outside the box.
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::SS_NT, S::SS_MIN)
stream_stages_kernel(const __grid_constant__ StagesStreamParams<S, REGION> q) {
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
  const long long items = gx * gy * gs * (BATCH ? p.nm : 1);
  for (long long i = blockIdx.x; i < items; i += gridDim.x) {
    if (i != (long long)blockIdx.x) __syncthreads();
    const long long yz = i / gx, sm = yz / gy;
    const int zs = int(sm % gs) * q.seg;
    const int ze = zs + q.seg < p.n[0] ? zs + q.seg : p.n[0];
    stream_item<S, BATCH, REGION>(p, smem, ws, BATCH ? int(sm / gs) : 0, zs,
                                  ze, int(yz % gy) * S::SS_T1,
                                  int(i % gx) * S::SS_T2, tid);
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
