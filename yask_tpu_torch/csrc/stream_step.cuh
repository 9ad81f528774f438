// stream_step.cuh — the stream arm of K1 for NVIDIA Hopper, sm_90a: one
// sub-step of a single-stage 3-D solution, each block walking slot 0
// through a ring of staged planes.
//
// It computes what K1 (fused_step_kernel<S, false>) computes, with the
// same Spec::point, so with --fmad=false it gives the same bits.  It is
// the port's design for the two arms of build_pallas_chunk
// (yask_tpu/ops/pallas_stencil.py) that only schedule the TPU's work:
//   * K2, the input prefetch under the current tile's compute
//     (in_dmas/out_dmas :1668-1813, prefetch/retire :1815-1854, the gate
//     :1445-1502): here cp.async fetches the plane P ahead while the
//     current plane computes;
//   * K3, the walk along a sequential stream dim that carries the
//     trailing halo instead of fetching it again (skew_* :306-441,
//     carry_shape :1337, the carry patch :1955-2056): here the planes
//     already staged stay in the ring for the next output plane.  One
//     level per launch; the stream dim is slot 0 (ROADMAP.md C11).
//
// What bounds it on an H100: bytes.  iso3dfd r=8 must move 16 B per point
// per step (pressure t and t-1 and vel read once, pressure t+1 written
// once): 0.64 ms per step at 512^3 over 3.35 TB/s.  K1 stages a 3-D halo
// tile per block (11.25 staged cells per point at 8x8x64, r=8), alternates
// staging and compute, and zero-fills each fresh output first.  Here:
//   * a block owns a ST1 x ST2 column of the (slot 1, slot 2) plane (one
//     thread per point) and walks a segment of slot 0 in order;
//   * each input K1 stages (a full-dim var read at a spatial offset) has
//     a ring of planes with their in-plane halo, so a point is staged
//     (ST1 + h1) (ST2 + h2) / (ST1 ST2) times (2.5 at 16x64, r=8) plus
//     the h0 planes each segment stages again.  A full-dim input read at
//     the point alone (vel and pressure t-1) goes through a queue of SQ
//     registers per thread, loaded SQ - 1 planes ahead, so its loads are
//     in flight across planes (SQ = 3 where a thread may hold 64
//     registers, else 2); the others (partial-dim vars) are read from
//     global memory as K1 reads them;
//   * the prologue fetches the segment's first h0_lo + h0_hi + 1 planes
//     (one cp.async group) and the next SP - 1 (a group each); then per
//     output plane z: fetch plane z + h0_hi + SP (a group), wait until at
//     most SP groups are in flight, __syncthreads, compute and store
//     plane z.  One barrier per plane suffices because the ring holds one
//     plane more than plane z reads and SP fetch: the slot refilled at
//     plane z was last read by plane z - 2, before the barrier of plane
//     z - 1 (ring_depth(k) = h0_lo + h0_hi + 2 + SP);
//   * a cell past the read reach of the domain (the ragged edge) is
//     filled with zero by the copy's src-size-0 form (K1's lim rule);
//     cp.async copies 4 (fp32) or 8 (fp64) bytes, since the halo plane's
//     minor-dim origin b2 - h2 is not 16-byte aligned;
//   * at element size 2 (bfloat16) cp.async cannot copy one element:
//     each thread copies an aligned pair (4 bytes).  A ring row then
//     starts at the pair that holds the row's first cell b2 - h2, one
//     element early when that cell is the second of its pair
//     (pair_shift), and holds stream_row(E2) elements (E2 + 1 rounded up
//     to even).  The row strides are even (the wrapper checks), so the
//     shift is the same for every row and plane of a block.  A pair with
//     one cell inside the read reach (the shifted first pair, the ragged
//     edge) is copied by plain loads and stores, which the barrier
//     before its plane's compute orders like a copy;
//   * every cell of each padded output is written exactly once: interior
//     cells by the point function, pad cells with 0 by a grid-stride
//     pass over the pad slabs at the end, so the wrapper allocates its
//     outputs with torch.empty and no zero-fill runs.
//
// K7 over the arm (BATCH: a member batch of one single-stage solution,
// the jax.vmap of build_pallas_chunk in yask_tpu/runtime/ensemble.py::
// EnsembleRun._batched_chunk_fn :234-345, built at :253-263): the member
// is a coordinate of the grid beside the segments (z cell = member x
// segments + segment, walked YT_MAX_GRID_Z at a time as any z), and it
// only offsets the block's global reads, ring copies and stores by its
// member stride; the rings, plane tiles and bounds are a solo block's, so
// each member gets the bits of its solo launch.  The pad pass zeroes
// every member's pads.  BATCH is a template parameter: a runtime member
// index in the solo kernel cost K1 up to 14 % on the card.
//
// K5 over the arm (REGION: one sub-step of a shard over a box, the
// region= and distributed=True arms of build_pallas_chunk :736-811 and
// :1948-1953 that yask_tpu/parallel/shard_step.py::_prep_shard_pallas
// :1017, :1093-1160 runs per shard): run_region's tables (set_region
// moves every pointer to the box's cell 0 and sets p.n to the box), so
// the walk, the rings and the register queue run over the box as they
// run over an interior.  The point function sees global coordinates and
// a point outside the global domain is 0 (point_at, K1's body's rule).
// A ring copy's zero bound is the box grown by the read halo, as K1's
// body stages its tile over a box: every read of a box point lies inside
// it, and inside the shard's allocation (check_box), whether the box is
// the interior, grown past an inner face into the exchanged ghosts, or a
// core or shell of an overlapped group.  Only the box's cells are stored
// and no pad is written, so copy_base's outputs and the shared outputs of
// an overlapped group's core and shells keep what lies outside the box.
// At element size 2 the pair shift comes from the moved pointers (a box
// origin at an odd minor index moves the alignment by one element); the
// strides stay even, so it is still the same for every row and plane.
//
// The same Spec compiles on the host (no __CUDACC__): host_stream() runs
// host_step() (over every member, or the box at global coordinates) and
// zeroes the pads, which is how the CPU tests check the entries'
// arithmetic with g++.
#pragma once

#include "fused_step.cuh"

namespace yt {

// Elements of one ring row in shared memory for a plane row of e2 cells
// (tile_planner.stream_row): e2, or at element size 2 one more rounded up
// to even.
template <typename R>
YT_HD constexpr int stream_row(int e2) {
  return sizeof(R) == 2 ? (e2 + 2) & ~1 : e2;
}

// At element size 2: 1 when cell x of input a's minor dim is the second
// element of its 4-byte pair, else 0.
template <class S>
YT_HD inline int pair_shift(const ParamsOf<S>& p, int a, int x) {
  if constexpr (sizeof(typename S::real_t) == 2)
    return int((reinterpret_cast<unsigned long long>(p.in[a] + x) >> 1) & 1);
  else
    return 0;
}

template <class S, bool REGION = false>
struct StreamParams {
  // K1's tables (K7's member strides and count; K5's box, REGION)
  ParamsArg<S, REGION> p;
  int seg;                       // planes of slot 0 per segment (grid z)
  int pad[S::NOUT][3][2];        // each output's pads (lo, hi) per slot
  // the whole grid's y and z extents, and this launch's first y and z
  // block (the launch code walks y and z in chunks of YT_MAX_GRID_Z)
  long long gy, gz, y0, z0;
};

// Pad slab j (0..5) of output o: slot 0 below and above the interior over
// the whole padded plane, then slot 1 below and above over the interior's
// slot 0, then slot 2 below and above over the interior's slots 0 and 1.
// Writes the box [lo, hi) per slot.  (Q: a StreamParams.)
template <class S, class Q>
YT_HD inline void pad_slab(const Q& q, int o, int j, int* lo, int* hi) {
  const int s = j / 2;
  for (int u = 0; u < 3; ++u) {
    if (u < s) {
      lo[u] = 0;
      hi[u] = q.p.n[u];
    } else if (u > s) {
      lo[u] = -q.pad[o][u][0];
      hi[u] = q.p.n[u] + q.pad[o][u][1];
    } else if (j % 2 == 0) {
      lo[u] = -q.pad[o][u][0];
      hi[u] = 0;
    } else {
      lo[u] = q.p.n[u];
      hi[u] = q.p.n[u] + q.pad[o][u][1];
    }
  }
}

// Zero the pad cells numbered first, first + stride, ... of every output
// (of every member: BATCH).
template <class S, bool BATCH = false, class Q>
YT_HD inline void zero_pads(const Q& q, long long first, long long stride) {
  typedef typename S::real_t real_t;
  for (int m = 0; m < (BATCH ? q.p.nm : 1); ++m)
    for (int o = 0; o < S::NOUT; ++o)
      for (int j = 0; j < 6; ++j) {
        int lo[3], hi[3];
        pad_slab<S>(q, o, j, lo, hi);
        const long long w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
        const long long cells = (long long)(hi[0] - lo[0]) * w1 * w2;
        real_t* out = q.p.out[o] + (BATCH ? idx_t(m) * q.p.out_ms[o] : 0);
        for (long long i = first; i < cells; i += stride) {
          const long long r = i / w2;
          const idx_t c0 = lo[0] + r / w1, c1 = lo[1] + r % w1,
                      c2 = lo[2] + i % w2;
          out[c0 * q.p.out_s[o][0] + c1 * q.p.out_s[o][1]
              + c2 * q.p.out_s[o][2]] = real_t(0.0f);
        }
      }
}

// ---- host path: K1's host loop, then the pads ---------------------------
// (every member's: BATCH; K5's box at global coordinates, no pads: REGION)
template <class S, bool BATCH = false, bool REGION = false>
int host_stream(const StreamParams<S, REGION>& q) {
  host_step<S, REGION>(q.p);
  if constexpr (!REGION) zero_pads<S, BATCH>(q, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// (the cp.async primitives are fused_step.cuh's)

// Reads ring inputs from their rings, same-point inputs from the values
// loaded one plane ahead, the rest from global memory.
template <class S>
struct PlaneReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  const int* zb;   // per ring input: the ring slot of plane z - h0_lo
  const int* sh;   // per ring input: its rows' pair shift (element size 2)
  const typename S::real_t* pre;  // per same-point input: its value here
  int m;           // the member (0 in a solo launch)
  int l1, l2;      // point within the block's plane tile
  int g0, g1, g2;  // point in the interior (the box: K5)
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    constexpr int j = S::pre_of(A);
    if constexpr (j >= 0) {
      return pre[j];  // read at offset (0, 0, 0) only
    } else if constexpr (k >= 0) {
      typedef typename S::real_t real_t;
      constexpr int D = S::ring_depth(k);
      constexpr int E1 = S::ST1 + S::halo_lo1(k) + S::halo_hi1(k);
      constexpr int E2 = stream_row<real_t>(S::ST2 + S::halo_lo2(k)
                                            + S::halo_hi2(k));
      int s = zb[k] + S::halo_lo0(k) + o0;  // in [0, 2 D)
      if (s >= D) s -= D;
      int c = S::ring_offset(k) + (s * E1 + (l1 + S::halo_lo1(k) + o1)) * E2
              + (l2 + S::halo_lo2(k) + o2);
      if constexpr (sizeof(real_t) == 2) c += sh[k];
      return smem[c];
    } else {
      return global_at<S>(*p, A, m, 0, g0 + o0, g1 + o1, g2 + o2);
    }
  }
};

// Issue the copies of plane c of ring input k (member m) into its ring
// slot (c - zs + h0_lo) mod depth; cells past the domain's read reach
// (K5: the box's) get 0.
template <class S, int k, bool BATCH>
__device__ __forceinline__ void fetch_plane(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int c, int zs, int b1, int b2,
                                            int tid) {
  typedef typename S::real_t real_t;
  constexpr int NT = S::ST1 * S::ST2;
  constexpr int a = S::tiled_input(k);
  constexpr int h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
  constexpr int E1 = S::ST1 + h1 + S::halo_hi1(k);
  constexpr int E2 = S::ST2 + h2 + S::halo_hi2(k);
  constexpr int R2 = stream_row<real_t>(E2);
  constexpr int D = S::ring_depth(k);
  real_t* dst = smem + S::ring_offset(k)
                + ((c - zs + S::halo_lo0(k)) % D) * (E1 * R2);
  const bool in0 = c < p.n[0] + S::halo_hi0(k);
  const int lim1 = p.n[1] + S::halo_hi1(k);
  const int lim2 = p.n[2] + S::halo_hi2(k);
  const real_t* base = p.in[a] + (BATCH ? idx_t(m) * p.in_ms[a] : 0)
                       + c * p.in_s[a][0];
  if constexpr (sizeof(real_t) != 2) {
    for (int i = tid; i < E1 * E2; i += NT) {
      const int c1 = b1 - h1 + i / E2;
      const int c2 = b2 - h2 + i % E2;
      const bool ok = in0 && c1 < lim1 && c2 < lim2;
      cp_async<int(sizeof(real_t))>(
          dst + i,
          ok ? base + c1 * p.in_s[a][1] + c2 * p.in_s[a][2] : p.in[a], ok);
    }
  } else {
    // aligned pairs from the pair holding cell b2 - h2
    const int x0 = b2 - h2 - pair_shift<S>(p, a, b2 - h2);
    constexpr int NP = R2 / 2;
    for (int i = tid; i < E1 * NP; i += NT) {
      const int c1 = b1 - h1 + i / NP;
      const int c2 = x0 + 2 * (i % NP);
      const bool row = in0 && c1 < lim1;
      const bool ok0 = row && c2 >= b2 - h2 && c2 < lim2;
      const bool ok1 = row && c2 + 1 < lim2;
      real_t* d = dst + (i / NP) * R2 + 2 * (i % NP);
      const real_t* q = base + c1 * p.in_s[a][1] + c2;
      if (ok0 == ok1) {
        cp_async<4>(d, ok0 ? q : p.in[a], ok0);
      } else {
        d[0] = ok0 ? q[0] : real_t(0.0f);
        d[1] = ok1 ? q[1] : real_t(0.0f);
      }
    }
  }
}

// Planes zs - h0_lo(k) .. zs + h0_hi(k) of every ring input k: those
// output plane zs reads (the prologue's first group).
template <class S, bool BATCH, int k = 0>
__device__ __forceinline__ void fetch_first(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int zs, int b1, int b2, int tid) {
  if constexpr (k < S::NTILED) {
    for (int c = zs - S::halo_lo0(k); c <= zs + S::halo_hi0(k); ++c)
      fetch_plane<S, k, BATCH>(p, smem, m, c, zs, b1, b2, tid);
    fetch_first<S, BATCH, k + 1>(p, smem, m, zs, b1, b2, tid);
  }
}

// Plane zs + j + h0_hi(k) of every ring input k: the newest plane that
// output plane zs + j reads.
template <class S, bool BATCH, int k = 0>
__device__ __forceinline__ void fetch_ahead(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int j, int zs, int b1, int b2,
                                            int tid) {
  if constexpr (k < S::NTILED) {
    fetch_plane<S, k, BATCH>(p, smem, m, zs + j + S::halo_hi0(k), zs, b1,
                             b2, tid);
    fetch_ahead<S, BATCH, k + 1>(p, smem, m, j, zs, b1, b2, tid);
  }
}

// Output planes z + U .. z + Q - 1 of the walk: plane z + u reads the
// register queue's slot u and loads plane z + u + Q - 1 into the slot
// plane z + u - 1 read; with TAIL, planes from ze on are skipped.
template <int U, bool TAIL, int Q, class F, class T>
__device__ __forceinline__ void queue_planes(F& plane, T (&qv)[Q], int z,
                                             int ze) {
  if constexpr (U < Q) {
    if (!TAIL || z + U < ze) {
      plane(z + U, qv[U], qv[(U + Q - 1) % Q]);
      queue_planes<U + 1, TAIL>(plane, qv, z, ze);
    }
  }
}

// SMIN blocks fit an SM by threads and shared memory: the registers are
// capped so that they fit too.  K1's arm (BATCH and REGION false), K7's
// over it (BATCH: the z cell is member x segments + segment) and K5's
// (REGION: the walk over a shard's box, no pad pass).
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(S::ST1 * S::ST2, S::SMIN)
stream_step_kernel(const __grid_constant__ StreamParams<S, REGION> q) {
  static_assert(!(BATCH && REGION), "K5 walks one shard's box");
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsArg<S, REGION>& p = q.p;
  constexpr int NT = S::ST1 * S::ST2;
  constexpr int NK = S::NTILED > 0 ? S::NTILED : 1;
  constexpr int NJ = S::NPRE > 0 ? S::NPRE : 1;
  const int tid = threadIdx.y * S::ST2 + threadIdx.x;
  const int by = int(q.y0) + int(blockIdx.y);
  const int bz = int(q.z0) + int(blockIdx.z);
  // the member and the segment of the z cell
  int m = 0, sg = bz;
  if constexpr (BATCH) {
    const int segs = (p.n[0] + q.seg - 1) / q.seg;
    m = bz / segs;
    sg = bz - m * segs;
  }
  const int b1 = by * S::ST1, b2 = blockIdx.x * S::ST2;
  const int l1 = threadIdx.y, l2 = threadIdx.x;
  const int g1 = b1 + l1, g2 = b2 + l2;
  const bool active = g1 < p.n[1] && g2 < p.n[2];
  const int zs = sg * q.seg;
  const int ze = zs + q.seg < p.n[0] ? zs + q.seg : p.n[0];

  if (zs < ze) {
    // 1) prologue: the planes output plane zs reads (one group), then the
    //    newest plane of each of the next SP - 1 output planes (a group
    //    each); a plane no output plane of the segment reads is skipped,
    //    its group left empty
    fetch_first<S, BATCH>(p, smem, m, zs, b1, b2, tid);
    cp_async_commit();
#pragma unroll
    for (int j = 1; j < S::SP; ++j) {
      if (zs + j < ze) fetch_ahead<S, BATCH>(p, smem, m, j, zs, b1, b2, tid);
      cp_async_commit();
    }
    // 2) the walk, one barrier per output plane z: fetch plane z + h0_hi +
    //    SP of each ring input into the slot of plane z - h0_lo - 2 (last
    //    read by plane z - 2, before the previous barrier) and load each
    //    same-point input at plane z + SQ - 1 into the register queue;
    //    wait until at most SP groups are in flight, __syncthreads, then
    //    compute and store plane z.
    int zb[NK];  // per ring input: the ring slot of plane z - h0_lo
    int sh[NK];  // per ring input: its rows' pair shift (element size 2)
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      zb[k] = 0;
      sh[k] = pair_shift<S>(p, S::tiled_input(k), b2 - S::halo_lo2(k));
    }
    real_t qv[S::SQ][NJ];  // same-point values of planes z .. z + SQ - 1
#pragma unroll
    for (int i = 0; i + 1 < S::SQ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        qv[i][j] = S::NPRE && active && (i == 0 || zs + i < ze)
                       ? global_at<S>(p, S::pre_input(j), m, 0, zs + i, g1,
                                      g2)
                       : real_t(0.0f);
    auto plane = [&](int z, real_t (&cur)[NJ], real_t (&ahead)[NJ]) {
      if (z + S::SP < ze)
        fetch_ahead<S, BATCH>(p, smem, m, z - zs + S::SP, zs, b1, b2, tid);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ahead[j] = S::NPRE && active && z + S::SQ - 1 < ze
                       ? global_at<S>(p, S::pre_input(j), m, 0,
                                      z + S::SQ - 1, g1, g2)
                       : real_t(0.0f);
      cp_async_wait<S::SP>();
      __syncthreads();
      if (active) {
        const PlaneReader<S> rd{&p, smem, zb, sh, cur, m, l1, l2, z, g1, g2};
        CalcOf<S> out[S::NOUT];
        point_at<S, REGION>(p, rd, 0, z, g1, g2, out);
        store<S, REGION>(p, m, 0, z, g1, g2, out);
      }
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (++zb[k] == S::ring_depth(k)) zb[k] = 0;
    };
    // unrolled by SQ at compile time, so that the queue's slots are
    // registers; then the segment's last planes
    int z = zs;
    for (; z + S::SQ <= ze; z += S::SQ)
      queue_planes<0, false>(plane, qv, z, ze);
    queue_planes<0, true>(plane, qv, z, ze);
  }

  // 3) the pads: 0 into every output cell outside the interior (of every
  //    member), shared out over every thread of the whole grid (all its
  //    launches); K5's outputs keep what lies outside the box
  if constexpr (!REGION) {
    const long long nb = (long long)gridDim.x * q.gy * q.gz;
    const long long bid = blockIdx.x
                          + (long long)gridDim.x * (by + q.gy * bz);
    zero_pads<S, BATCH>(q, bid * NT + tid, nb * NT);
  }
}

template <class S, bool BATCH, bool REGION>
int launch_stream(StreamParams<S, REGION> p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::STREAM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      stream_step_kernel<S, BATCH, REGION>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  if (p.seg < 1) return int(cudaErrorInvalidConfiguration);
  // z cells: the segments (of every member)
  p.gz = (long long)((p.p.n[0] + p.seg - 1) / p.seg) * (BATCH ? p.p.nm : 1);
  p.gy = (p.p.n[1] + S::ST1 - 1) / S::ST1;
  const dim3 block(S::ST2, S::ST1, 1);
  // y in chunks of YT_MAX_GRID_Z, and z in each (launch_z)
  for (p.y0 = 0; p.y0 < p.gy; p.y0 += YT_MAX_GRID_Z) {
    const long long ny = p.gy - p.y0;
    const int rc = launch_z(
        p.z0, p.gz,
        dim3((p.p.n[2] + S::ST2 - 1) / S::ST2,
             unsigned(ny < YT_MAX_GRID_Z ? ny : YT_MAX_GRID_Z)),
        [&](dim3 grid) {
      stream_step_kernel<S, BATCH, REGION><<<grid, block, smem, stream>>>(p);
    });
    if (rc != 0) return rc;
  }
  return 0;
}
#endif

// The segment length and each output's pads (lo, hi) per slot from `geom`
// = int[1 + 6 NOUT].  (Q: a StreamParams.)
template <class S, class Q>
void fill_geom(Q& q, const void* geom) {
  const int* gm = static_cast<const int*>(geom);
  q.seg = gm[0];
  for (int o = 0; o < S::NOUT; ++o)
    for (int s = 0; s < 3; ++s)
      for (int e = 0; e < 2; ++e) q.pad[o][s][e] = gm[1 + 6 * o + 2 * s + e];
}

// The stream arm: K1's arguments, then `geom` (fill_geom).
template <class S>
int run_stream(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, void* geom, int t,
               void* stream) {
  StreamParams<S> q;
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_geom<S>(q, geom);
#ifdef __CUDACC__
  return launch_stream<S, false, false>(q, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_stream<S>(q);
#endif
}

// K7 over the stream arm: K7's arguments (member strides and count), then
// `geom` as run_stream takes it.
template <class S>
int run_stream_batched(void* in_ptrs, void* in_strides, void* in_mstrides,
                       void* out_ptrs, void* out_strides, void* out_mstrides,
                       void* sizes, void* geom, int nm, int t, void* stream) {
  StreamParams<S> q;
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_members<S>(q.p, in_mstrides, out_mstrides, nm);
  fill_geom<S>(q, geom);
#ifdef __CUDACC__
  return launch_stream<S, true, false>(q, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_stream<S, true>(q);
#endif
}

// K5 over the stream arm: K1's arguments, K5's box table (set_region),
// then `geom` as run_stream takes it, its segment length the box's.  The
// outputs are the wrapper's: the kernel stores the box's cells and
// nothing else (the pads in `geom` are the single-domain arm's, which
// the box's walk leaves alone).
template <class S>
int run_stream_region(void* in_ptrs, void* in_strides, void* out_ptrs,
                      void* out_strides, void* sizes, void* region,
                      void* geom, int t, void* stream) {
  StreamParams<S, true> q{};
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  if (!set_region<S>(q.p, region)) return 0;  // an empty box: nothing
  fill_geom<S>(q, geom);
#ifdef __CUDACC__
  return launch_stream<S, false, true>(q, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_stream<S, false, true>(q);
#endif
}

}  // namespace yt

// The C entry points of the stream arm for a K1 Spec: solo (K1's
// arguments, then the segment and pad table before the step index), K7
// over it (K7's arguments with the segment and pad table before the
// member count) and K5 over it (K5's arguments with the segment and pad
// table, the box's segment length, before the step index).
#define YT_FUSED_STREAM_ENTRY(NAME, S)                                       \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, void* geom, int t,     \
                      void* stream) {                                        \
    return yt::run_stream<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, geom, t, stream);                        \
  }                                                                          \
  extern "C" int NAME##_batched(                                             \
      void* in_ptrs, void* in_strides, void* in_mstrides, void* out_ptrs,    \
      void* out_strides, void* out_mstrides, void* sizes, void* geom,        \
      int nm, int t, void* stream) {                                         \
    return yt::run_stream_batched<S>(in_ptrs, in_strides, in_mstrides,       \
                                     out_ptrs, out_strides, out_mstrides,    \
                                     sizes, geom, nm, t, stream);            \
  }                                                                          \
  extern "C" int NAME##_region(void* in_ptrs, void* in_strides,              \
                               void* out_ptrs, void* out_strides,            \
                               void* sizes, void* region, void* geom, int t, \
                               void* stream) {                               \
    return yt::run_stream_region<S>(in_ptrs, in_strides, out_ptrs,           \
                                    out_strides, sizes, region, geom, t,     \
                                    stream);                                 \
  }
