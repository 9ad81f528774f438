// stream_stages.cuh — the stream arm of K6 (and of K7 over K6's body) for
// NVIDIA Hopper, sm_90a: every sub-stage of one sub-step of a 3-D
// multi-stage solution, each block walking slot 0 through rings of staged
// input planes and computed planes.
//
// It computes what K6 (fused_stages_kernel<S, false>) and K7 over it
// (fused_stages_kernel<S, true>) compute, with the same Spec::stage<K>, so
// with --fmad=false it gives the same bits.  It replaces the stage loop of
// build_pallas_chunk (yask_tpu/ops/pallas_stencil.py:2058-2188, with its
// rewrite arm :2155-2187) under the input prefetch (:1815-1854) and the
// carry of staged planes along the stream dim (:1955-2056), as K1's stream
// arm (stream_step.cuh) does for one stage.
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
//     (flat_pads), so the wrapper takes torch.empty.
//
// The same Spec compiles on the host (no __CUDACC__): host_stages_stream()
// runs K6's host loop (host_stages) and zeroes the pads, which is how the
// CPU tests check the entry's arithmetic with g++.
#pragma once

#include "fused_step.cuh"

namespace yt {

template <class S>
struct StagesStreamParams {
  ParamsOf<S> p;  // K6's tables (K7's member strides and count)
  int seg;        // planes of slot 0 per segment
};

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
int host_stages_stream(const ParamsOf<S>& p) {
  host_stages<S>(p);
  flat_pads<S>(p, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// ---- device path ----------------------------------------------------------
// (the cp.async primitives are fused_step.cuh's)

// Reads of sub-stage K at plane z + ss_lag(K) (walk step it = z minus the
// segment's first walk plane): staged inputs from their rings, others
// from global memory, earlier sub-stages' results from their rings.
template <class S, int K>
struct StreamStageReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int it;
  int m;           // the member (0 in a solo launch)
  int l1, l2;      // point relative to the plane tile (may lie in the
                   // sub-stage's in-plane expansion)
  int g0, g1, g2;  // point in the interior
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    if constexpr (k >= 0) {
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
    return smem[S::ss_cring(B) + (s * C1 + (l1 + S::sub_lo1(W) + o1)) * C2
                + (l2 + S::sub_lo2(W) + o2)];
  }
};

// Issue the copies of plane c of staged input k (member m) into its ring
// slot `slot`: cells past the input's allocation get 0.  16-byte copies
// where every row lines up with its source (see the notes above), else
// one cell per copy.
template <class S, int k, bool BATCH>
__device__ __forceinline__ void ring_fetch(const ParamsOf<S>& p,
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
  const bool in0 = c >= -S::alloc_lo0(k) && c < p.n[0] + S::alloc_hi0(k);
  const int lo1 = -S::alloc_lo1(k), lim1 = p.n[1] + S::alloc_hi1(k);
  const int lo2 = -S::alloc_lo2(k), lim2 = p.n[2] + S::alloc_hi2(k);
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
// plane, whose lowest plane takes slot 0.
template <class S, bool BATCH, int k = 0>
__device__ __forceinline__ void ring_fetch_planes(const ParamsOf<S>& p,
                                                  typename S::real_t* smem,
                                                  int m, int z0, int zz,
                                                  bool first, int b1, int b2,
                                                  int tid) {
  if constexpr (k < S::NTILED) {
    constexpr int D = S::ss_depth(k), lo = S::ss_rlo(k), hi = S::ss_rhi(k);
    for (int c = first ? zz - lo : zz + hi; c <= zz + hi; ++c)
      ring_fetch<S, k, BATCH>(p, smem, m, c, (c - (z0 - lo)) % D, b1, b2,
                              tid);
    ring_fetch_planes<S, BATCH, k + 1>(p, smem, m, z0, zz, first, b1, b2,
                                       tid);
  }
}

// Sub-stage K (and, after a barrier, the later ones) at walk plane z:
// plane z + ss_lag(K) over the plane tile grown by its in-plane region,
// from the segment's first plane it must compute (zs - sub_lo0(K)) on.
// Results go to its computed rings and, for the tile's own points of
// the segment [zs, ze), to the outputs it is the last writer of.
template <class S, int K, bool BATCH>
__device__ __forceinline__ void stream_sub(const ParamsOf<S>& p,
                                           typename S::real_t* smem, int m,
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
      plain_region<S, K, false>(p, s, plo[s], phi[s]);
    const bool in0 = g0 >= plo[0] && g0 < phi[0];
    const bool own0 = g0 >= zs && g0 < ze;
    for (int i = tid; i < R1 * R2; i += S::SS_NT) {
      const int r = i / R2;
      const int l1 = r - e1, l2 = i - r * R2 - e2;
      const int g1 = b1 + l1, g2 = b2 + l2;
      CalcOf<S> v[S::MAXV];
      if (in0 && g1 >= plo[1] && g1 < phi[1] && g2 >= plo[2]
          && g2 < phi[2]) {
        const StreamStageReader<S, K> rd{&p, smem, it, m, l1, l2,
                                         g0, g1, g2};
        int g[3];
        stage_at<S, K, false>(p, rd, g, g0, g1, g2, v);
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
          smem[S::ss_cring(b)
               + (ring_slot(S::ss_cdepth(b), it, S::ss_clo(b) + L)
                  * cring_e1<S>(b) + r) * cring_e2<S>(b)
               + (i - r * R2)] = w;
      }
    }
  }
  if constexpr (K + 1 < S::NSTAGES) {
    __syncthreads();
    stream_sub<S, K + 1, BATCH>(p, smem, m, it, z, zs, ze, b1, b2, tid);
  }
}

// One work item: member m's column (b1, b2) over the segment [zs, ze) of
// slot 0, walked from plane zs - SS_W (where the sub-stage with the
// widest slot-0 reach starts) on, one barrier before each plane's
// sub-stages.
template <class S, bool BATCH>
__device__ __forceinline__ void stream_item(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int zs, int ze, int b1, int b2,
                                            int tid) {
  const int z0 = zs - S::SS_W;
  // the prologue: the planes walk plane z0 reads (one group), then the
  // newest plane of each of the next SS_P - 1 walk planes (a group each;
  // a plane no walk plane of the segment reads is skipped, its group
  // left empty)
  ring_fetch_planes<S, BATCH>(p, smem, m, z0, z0, true, b1, b2, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < S::SS_P; ++j) {
    if (z0 + j < ze)
      ring_fetch_planes<S, BATCH>(p, smem, m, z0, z0 + j, false, b1, b2,
                                  tid);
    cp_async_commit();
  }
  for (int z = z0; z < ze; ++z) {
    if (z + S::SS_P < ze)
      ring_fetch_planes<S, BATCH>(p, smem, m, z0, z + S::SS_P, false, b1,
                                  b2, tid);
    cp_async_commit();
    cp_async_wait<S::SS_P>();
    __syncthreads();
    stream_sub<S, 0, BATCH>(p, smem, m, z - z0, z, zs, ze, b1, b2, tid);
  }
  cp_async_wait<0>();
}

// K6's stream arm (BATCH = false) and K7's over it (BATCH = true): a grid
// of at most the card's resident blocks, each walking the work items
// blockIdx.x, + gridDim.x, ... (x columns fastest, then y columns, then
// segments, then members); a barrier parts one item's last reads from
// the next one's prologue.  Then every output's pads get 0 (flat_pads).
template <class S, bool BATCH>
__global__ void __launch_bounds__(S::SS_NT, S::SS_MIN)
stream_stages_kernel(const __grid_constant__ StagesStreamParams<S> q) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsOf<S>& p = q.p;
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
    stream_item<S, BATCH>(p, smem, BATCH ? int(sm / gs) : 0, zs, ze,
                          int(yz % gy) * S::SS_T1, int(i % gx) * S::SS_T2,
                          tid);
  }
  flat_pads<S>(p, (long long)blockIdx.x * S::SS_NT + tid,
               (long long)gridDim.x * S::SS_NT);
}

template <class S, bool BATCH>
int stages_stream_resident() {
  return resident_of(stream_stages_kernel<S, BATCH>, S::SS_NT,
                     int(sizeof(typename S::real_t)) * S::SS_ELEMS);
}

template <class S, bool BATCH>
int launch_stages_stream(StagesStreamParams<S> p, long long nres,
                         cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::SS_ELEMS;
  if (nres < 1 || p.seg < 1) return int(cudaErrorInvalidConfiguration);
  const cudaError_t e = cudaFuncSetAttribute(
      stream_stages_kernel<S, BATCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  const long long items = (long long)((p.p.n[2] + S::SS_T2 - 1) / S::SS_T2)
                          * ((p.p.n[1] + S::SS_T1 - 1) / S::SS_T1)
                          * ((p.p.n[0] + p.seg - 1) / p.seg) * p.p.nm;
  if (items < 1) return 0;
  const dim3 grid(unsigned(items < nres ? items : nres));
  const dim3 block(S::SS_NT, 1, 1);
  stream_stages_kernel<S, BATCH><<<grid, block, smem, stream>>>(p);
  return int(cudaGetLastError());
}
#endif

// K6's stream arm over nm members (BATCH; K7) or one: K7's arguments
// (member strides null for a solo launch), the segment length, the step,
// the resident blocks (the grid; the host path ignores it) and the stream.
template <class S, bool BATCH>
int run_stages_stream(void* in_ptrs, void* in_strides, void* in_mstrides,
                      void* out_ptrs, void* out_strides, void* out_mstrides,
                      void* sizes, int nm, int seg, int t, long long nres,
                      void* stream) {
  StagesStreamParams<S> q;
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  if (BATCH) fill_members<S>(q.p, in_mstrides, out_mstrides, nm);
  q.seg = seg;
#ifdef __CUDACC__
  return launch_stages_stream<S, BATCH>(q, nres,
                                        static_cast<cudaStream_t>(stream));
#else
  (void)nres;
  (void)stream;
  return host_stages_stream<S>(q.p);
#endif
}

// The resident blocks of a launch of kind 0 (solo) or 1 (member batch);
// 1 on the host.
template <class S>
int resident_stages_stream(int kind) {
#ifdef __CUDACC__
  return kind == 1 ? stages_stream_resident<S, true>()
                   : stages_stream_resident<S, false>();
#else
  (void)kind;
  return 1;
#endif
}

}  // namespace yt

// The C entry points of K6's stream arm for a K6 Spec that prints SS_T1:
// solo (K6's arguments), member batch (K7's), each with the segment length
// before the step and the resident blocks before the stream, and the
// resident blocks of a launch kind, which the wrapper asks once.
#define YT_STAGES_STREAM_ENTRIES(NAME, S)                                    \
  extern "C" int NAME##_stages_stream(void* in_ptrs, void* in_strides,       \
                                      void* out_ptrs, void* out_strides,     \
                                      void* sizes, int seg, int t,           \
                                      long long nres, void* stream) {        \
    return yt::run_stages_stream<S, false>(in_ptrs, in_strides, nullptr,     \
                                           out_ptrs, out_strides, nullptr,   \
                                           sizes, 1, seg, t, nres, stream);  \
  }                                                                          \
  extern "C" int NAME##_stages_stream_batched(                               \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, int nm, int seg,   \
      int t, long long nres, void* stream) {                                 \
    return yt::run_stages_stream<S, true>(in_ptrs, in_strides, in_mstrides,  \
                                          out_ptrs, out_strides,             \
                                          out_mstrides, sizes, nm, seg, t,   \
                                          nres, stream);                     \
  }                                                                          \
  extern "C" int NAME##_stages_stream_resident(int kind) {                   \
    return yt::resident_stages_stream<S>(kind);                              \
  }
