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
// The same Spec compiles on the host (no __CUDACC__): host_stream() runs
// host_step() and zeroes the pads, which is how the CPU tests check the
// entry's arithmetic with g++.
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

template <class S>
struct StreamParams {
  ParamsOf<S> p;                 // K1's tables
  int seg;                       // planes of slot 0 per segment (grid z)
  int pad[S::NOUT][3][2];        // each output's pads (lo, hi) per slot
  // the whole grid's y and z extents, and this launch's first y and z
  // block (the launch code walks y and z in chunks of YT_MAX_GRID_Z)
  long long gy, gz, y0, z0;
};

// Pad slab j (0..5) of output o: slot 0 below and above the interior over
// the whole padded plane, then slot 1 below and above over the interior's
// slot 0, then slot 2 below and above over the interior's slots 0 and 1.
// Writes the box [lo, hi) per slot.
template <class S>
YT_HD inline void pad_slab(const StreamParams<S>& q, int o, int j, int* lo,
                           int* hi) {
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

// Zero the pad cells numbered first, first + stride, ... of every output.
template <class S>
YT_HD inline void zero_pads(const StreamParams<S>& q, long long first,
                            long long stride) {
  typedef typename S::real_t real_t;
  for (int o = 0; o < S::NOUT; ++o)
    for (int j = 0; j < 6; ++j) {
      int lo[3], hi[3];
      pad_slab<S>(q, o, j, lo, hi);
      const long long w1 = hi[1] - lo[1], w2 = hi[2] - lo[2];
      const long long cells = (long long)(hi[0] - lo[0]) * w1 * w2;
      for (long long i = first; i < cells; i += stride) {
        const long long r = i / w2;
        const idx_t c0 = lo[0] + r / w1, c1 = lo[1] + r % w1,
                    c2 = lo[2] + i % w2;
        q.p.out[o][c0 * q.p.out_s[o][0] + c1 * q.p.out_s[o][1]
                   + c2 * q.p.out_s[o][2]] = real_t(0.0f);
      }
    }
}

// ---- host path: K1's host loop, then the pads ---------------------------
template <class S>
int host_stream(const StreamParams<S>& q) {
  host_step<S>(q.p);
  zero_pads<S>(q, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// The cp.async primitives.  A CUDA runtime header that defines
// YT_CP_ASYNC_HOOKS supplies them instead (the CPU emulation of this
// kernel does, to defer each copy to its wait).
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

// Reads ring inputs from their rings, same-point inputs from the values
// loaded one plane ahead, the rest from global memory.
template <class S>
struct PlaneReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  const int* zb;   // per ring input: the ring slot of plane z - h0_lo
  const int* sh;   // per ring input: its rows' pair shift (element size 2)
  const typename S::real_t* pre;  // per same-point input: its value here
  int l1, l2;      // point within the block's plane tile
  int g0, g1, g2;  // point in the interior
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
      return global_at<S>(*p, A, 0, 0, g0 + o0, g1 + o1, g2 + o2);
    }
  }
};

// Issue the copies of plane c of ring input k into its ring slot
// (c - zs + h0_lo) mod depth; cells past the domain's read reach get 0.
template <class S, int k>
__device__ __forceinline__ void fetch_plane(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int c,
                                            int zs, int b1, int b2,
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
  const real_t* base = p.in[a] + c * p.in_s[a][0];
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
template <class S, int k = 0>
__device__ __forceinline__ void fetch_first(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int zs,
                                            int b1, int b2, int tid) {
  if constexpr (k < S::NTILED) {
    for (int c = zs - S::halo_lo0(k); c <= zs + S::halo_hi0(k); ++c)
      fetch_plane<S, k>(p, smem, c, zs, b1, b2, tid);
    fetch_first<S, k + 1>(p, smem, zs, b1, b2, tid);
  }
}

// Plane zs + j + h0_hi(k) of every ring input k: the newest plane that
// output plane zs + j reads.
template <class S, int k = 0>
__device__ __forceinline__ void fetch_ahead(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int j,
                                            int zs, int b1, int b2, int tid) {
  if constexpr (k < S::NTILED) {
    fetch_plane<S, k>(p, smem, zs + j + S::halo_hi0(k), zs, b1, b2, tid);
    fetch_ahead<S, k + 1>(p, smem, j, zs, b1, b2, tid);
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
// capped so that they fit too.
template <class S>
__global__ void __launch_bounds__(S::ST1 * S::ST2, S::SMIN)
stream_step_kernel(const __grid_constant__ StreamParams<S> q) {
  typedef typename S::real_t real_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsOf<S>& p = q.p;
  constexpr int NT = S::ST1 * S::ST2;
  constexpr int NK = S::NTILED > 0 ? S::NTILED : 1;
  constexpr int NJ = S::NPRE > 0 ? S::NPRE : 1;
  const int tid = threadIdx.y * S::ST2 + threadIdx.x;
  const int by = int(q.y0) + int(blockIdx.y);
  const int bz = int(q.z0) + int(blockIdx.z);
  const int b1 = by * S::ST1, b2 = blockIdx.x * S::ST2;
  const int l1 = threadIdx.y, l2 = threadIdx.x;
  const int g1 = b1 + l1, g2 = b2 + l2;
  const bool active = g1 < p.n[1] && g2 < p.n[2];
  const int zs = bz * q.seg;
  const int ze = zs + q.seg < p.n[0] ? zs + q.seg : p.n[0];

  if (zs < ze) {
    // 1) prologue: the planes output plane zs reads (one group), then the
    //    newest plane of each of the next SP - 1 output planes (a group
    //    each); a plane no output plane of the segment reads is skipped,
    //    its group left empty
    fetch_first<S>(p, smem, zs, b1, b2, tid);
    cp_async_commit();
#pragma unroll
    for (int j = 1; j < S::SP; ++j) {
      if (zs + j < ze) fetch_ahead<S>(p, smem, j, zs, b1, b2, tid);
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
                       ? global_at<S>(p, S::pre_input(j), 0, 0, zs + i, g1, g2)
                       : real_t(0.0f);
    auto plane = [&](int z, real_t (&cur)[NJ], real_t (&ahead)[NJ]) {
      if (z + S::SP < ze)
        fetch_ahead<S>(p, smem, z - zs + S::SP, zs, b1, b2, tid);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ahead[j] = S::NPRE && active && z + S::SQ - 1 < ze
                       ? global_at<S>(p, S::pre_input(j), 0, 0, z + S::SQ - 1,
                                      g1, g2)
                       : real_t(0.0f);
      cp_async_wait<S::SP>();
      __syncthreads();
      if (active) {
        const PlaneReader<S> rd{&p, smem, zb, sh, cur, l1, l2, z, g1, g2};
        const int g[3] = {z, g1, g2};
        CalcOf<S> out[S::NOUT];
        S::point(rd, g, p.n, p.t, out);
        store<S>(p, 0, 0, z, g1, g2, out);
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

  // 3) the pads: 0 into every output cell outside the interior, shared
  //    out over every thread of the whole grid (all its launches)
  const long long nb = (long long)gridDim.x * q.gy * q.gz;
  const long long bid = blockIdx.x + (long long)gridDim.x * (by + q.gy * bz);
  zero_pads<S>(q, bid * NT + tid, nb * NT);
}

template <class S>
int launch_stream(StreamParams<S> p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::STREAM_ELEMS;
  cudaError_t e = cudaFuncSetAttribute(
      stream_step_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return int(e);
  if (p.seg < 1) return int(cudaErrorInvalidConfiguration);
  p.gz = (p.p.n[0] + p.seg - 1) / p.seg;
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
      stream_step_kernel<S><<<grid, block, smem, stream>>>(p);
    });
    if (rc != 0) return rc;
  }
  return 0;
}
#endif

// The stream arm: K1's arguments, then `geom` = int[1 + 6 NOUT]: the
// segment length, then each output's pads (lo, hi) per slot.
template <class S>
int run_stream(void* in_ptrs, void* in_strides, void* out_ptrs,
               void* out_strides, void* sizes, void* geom, int t,
               void* stream) {
  StreamParams<S> q;
  fill_params<S>(q.p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  const int* gm = static_cast<const int*>(geom);
  q.seg = gm[0];
  for (int o = 0; o < S::NOUT; ++o)
    for (int s = 0; s < 3; ++s)
      for (int e = 0; e < 2; ++e) q.pad[o][s][e] = gm[1 + 6 * o + 2 * s + e];
#ifdef __CUDACC__
  return launch_stream<S>(q, static_cast<cudaStream_t>(stream));
#else
  (void)stream;
  return host_stream<S>(q);
#endif
}

}  // namespace yt

// The C entry point of the stream arm for a K1 Spec (K1's arguments, then
// the segment and pad table before the step index).
#define YT_FUSED_STREAM_ENTRY(NAME, S)                                       \
  extern "C" int NAME(void* in_ptrs, void* in_strides, void* out_ptrs,       \
                      void* out_strides, void* sizes, void* geom, int t,     \
                      void* stream) {                                        \
    return yt::run_stream<S>(in_ptrs, in_strides, out_ptrs, out_strides,     \
                             sizes, geom, t, stream);                        \
  }
