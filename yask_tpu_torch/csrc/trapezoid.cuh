// trapezoid.cuh — K4, the trapezoid/diamond two-phase temporal tiling of
// one K-step group, for NVIDIA Hopper, sm_90a.
//
// Replaces the trapezoid arm of build_pallas_chunk
// (yask_tpu/ops/pallas_stencil.py: resolution :812-930, phase-1 write
// windows :1740-1752, diamond sub-builds :1514-1553, band windows
// :1725-1739, host stitch :2372-2416; the geometry is
// yask_tpu/ops/tile_planner.py::TilePlan).  It is the port's first kernel
// that advances K time levels inside one launch: every other kernel does
// one step per launch.
//
// What bounds it on an H100: bytes, if the recompute stays cheap.  For
// iso3dfd r=2 at K=4 a group reads p(t), p(t-1) and vel once and writes
// the two newest levels: 20 B per point per 4 steps (5 B/pt/step) against
// K1's 16 B/pt/step.  What the design does about it: the levels between
// live only in shared memory.  The price is recompute, and in this first
// cut it dominates: phase 1 recomputes the z margins (uniform, K·r per
// side) and the diamonds recompute every band from level 0 with K·r
// margins, 4.1x the useful cells at 512^3, so K4 runs at the rate its
// cells are computed, not at its bound (PERF.md; ROADMAP.md A5 streams z).
//
// Design (a first cut that is simple and right), one template for both
// phases, instantiated per pass P (compile-time tables of the emitted
// Spec, ops/cuda_emit.py::emit_trapezoid):
//   * pass 0, trapezoid_kernel<S>: one block per output tile.  In a
//     trapezoid dim (x and y of a 3-D solution) the tile stages one step
//     radius r per side and level L is computed over the block shrunk by
//     (L-1)·r per side; in a uniform dim (z, which the card must block too)
//     it stages K·r per side and level L covers the block grown by
//     (K-L)·r;
//   * pass D >= 1, diamond_kernel<S, D>: the K-step kernel from the
//     level-0 inputs whose grid walks every phase-1 tile boundary
//     j·block[D], domain edges included, with band-wide tiles (2·cl(K))
//     and K·r margins in D; level L writes [j·block - cl(L), j·block +
//     cl(L)), clipped to the domain, straight into phase 1's output arrays
//     on the same stream (the TPU's band arrays and host stitch have no
//     counterpart).  A trapezoid dim after D keeps phase 1's geometry (its
//     own pass fills those gaps, corners included); the other dims are
//     uniform.  It reads level 0 only, never phase 1's outputs; where two
//     passes write the same cell they write the same value;
//   * 1) stage: every input a level reads at a spatial offset (all ring
//     slots of the written vars that the levels reach back to, and the
//     read-only full-dim vars read at an offset) is copied into its
//     shared-memory buffer over the tile's window.  Cells outside the
//     domain are zero: in a trapezoid dim every window lies within
//     trapezoid_pad_need of the domain (the block divides the span), whose
//     pads the plan requires and which hold zero, so no bounds test there;
//     in the other dims the cells outside the domain are set to 0;
//   * 2) levels 1..K in order, each a loop of the block's threads over its
//     region: a cell outside the domain is not computed and holds zero
//     (the ghost-cell rule of K6), a cell inside runs Spec::point with
//     reads mapped to level buffers (Spec::lvl_src); the result goes to
//     the level's buffer and, inside the level's write window, to the
//     output array of that level; __syncthreads between levels.  The
//     levels of a written var live in a ring of its ring depth S buffers
//     (level L replaces level L-S in place, each cell by the thread that
//     reads it) when the oldest slot is read only at its own point, else
//     S+1.
//
// The same code runs on the host (no __CUDACC__) with one thread per
// block, blocks in order and NaN-filled buffers: run_trapezoid's host path,
// which the CPU tests build with g++.
#pragma once

#include "fused_step.cuh"

namespace yt {

// A block barrier in the device pass of the shared code, nothing on the
// host (one thread per block there).
#ifdef __CUDA_ARCH__
#define YT_SYNC() __syncthreads()
#else
#define YT_SYNC() ((void)0)
#endif

// Window extent (tile + margins) per slot, and elements per buffer.
template <class S, int P>
YT_HD constexpr int win(int s) {
  return S::tile(P, s) + 2 * S::marg(P, s);
}
template <class S, int P>
YT_HD constexpr int buf_elems() {
  return win<S, P>(0) * win<S, P>(1) * win<S, P>(2);
}

// Reads of a point of level L: written vars and staged inputs from their
// level buffers, the rest from global memory.
template <class S, int P, int L>
struct LevelReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  int w0, w1, w2;  // the point in window coordinates
  int g0, g1, g2;  // the point in the interior
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int b = S::lvl_src(L, A);
    if constexpr (b >= 0) {
      return smem[b * buf_elems<S, P>()
                  + ((w0 + o0) * win<S, P>(1) + (w1 + o1)) * win<S, P>(2)
                  + (w2 + o2)];
    } else {
      return global_at<S>(*p, A, 0, 0, g0 + o0, g1 + o1, g2 + o2);
    }
  }
};

// 1) stage the inputs over the window of the tile at origin b.
template <class S, int P>
YT_HD void stage_inputs(const ParamsOf<S>& p, typename S::real_t* smem,
                        const int* b, int tid, int nt) {
  typedef typename S::real_t real_t;
  constexpr int W1 = win<S, P>(1), W2 = win<S, P>(2);
  constexpr int E = buf_elems<S, P>();
  // U independent loads in flight per thread before any store (K1's
  // staging lesson: one dependent load per cell is latency-bound)
  constexpr int U = 8;
#pragma unroll
  for (int k = 0; k < S::NSTAGED; ++k) {
    const int a = S::staged_in(k);
    real_t* dst = smem + S::staged_buf(k) * E;
    for (int base = tid; base < E; base += nt * U) {
      real_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * nt;
        const int c2 = b[2] - S::marg(P, 2) + i % W2;
        const int r = i / W2;
        const int c1 = b[1] - S::marg(P, 1) + r % W1;
        const int c0 = b[0] - S::marg(P, 0) + r / W1;
        const bool in = i < E
            && (S::trap_slot(0) || (c0 >= 0 && c0 < p.n[0]))
            && (S::trap_slot(1) || (c1 >= 0 && c1 < p.n[1]))
            && (S::trap_slot(2) || (c2 >= 0 && c2 < p.n[2]));
        v[u] = in ? global_at<S>(p, a, 0, 0, c0, c1, c2) : real_t(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * nt < E) dst[base + u * nt] = v[u];
    }
  }
}

// 2) level L over its region, then the levels after it.
template <class S, int P, int L>
YT_HD void compute_level(const ParamsOf<S>& p, typename S::real_t* smem,
                         const int* b, int tid, int nt) {
  typedef typename S::real_t real_t;
  constexpr int W1 = win<S, P>(1), W2 = win<S, P>(2);
  constexpr int E = buf_elems<S, P>();
  constexpr int lo0 = S::reg_lo(P, 0, L), lo1 = S::reg_lo(P, 1, L);
  constexpr int lo2 = S::reg_lo(P, 2, L);
  constexpr int R1 = S::reg_hi(P, 1, L) - lo1;
  constexpr int R2 = S::reg_hi(P, 2, L) - lo2;
  constexpr int cells = (S::reg_hi(P, 0, L) - lo0) * R1 * R2;
  const int t = p.t + (L - 1) * S::STEP_DIR;
  for (int i = tid; i < cells; i += nt) {
    const int l2 = lo2 + i % R2;
    const int r = i / R2;
    const int l1 = lo1 + r % R1;
    const int l0 = lo0 + r / R1;
    const int g0 = b[0] + l0, g1 = b[1] + l1, g2 = b[2] + l2;
    const bool inside = g0 >= 0 && g0 < p.n[0] && g1 >= 0 && g1 < p.n[1]
                        && g2 >= 0 && g2 < p.n[2];
    const int w0 = l0 + S::marg(P, 0), w1 = l1 + S::marg(P, 1);
    const int w2 = l2 + S::marg(P, 2);
    real_t v[S::NV];
    if (inside) {
      const LevelReader<S, P, L> rd{&p, smem, w0, w1, w2, g0, g1, g2};
      const int g[3] = {g0, g1, g2};
      S::point(rd, g, p.n, t, v);
    } else {
#pragma unroll
      for (int j = 0; j < S::NV; ++j) v[j] = real_t(0);
    }
    const int c = (w0 * W1 + w1) * W2 + w2;
    const bool wr = inside && l0 >= S::wr_lo(P, 0, L)
                    && l0 < S::wr_hi(P, 0, L) && l1 >= S::wr_lo(P, 1, L)
                    && l1 < S::wr_hi(P, 1, L) && l2 >= S::wr_lo(P, 2, L)
                    && l2 < S::wr_hi(P, 2, L);
#pragma unroll
    for (int j = 0; j < S::NV; ++j) {
      const int ob = S::out_buf(j, L), o = S::out_of(j, L);
      if (ob >= 0) smem[ob * E + c] = v[j];
      if (wr && o >= 0)
        p.out[o][g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                 + g2 * p.out_s[o][2]] = v[j];
    }
  }
  if constexpr (L < S::K) {
    YT_SYNC();
    compute_level<S, P, L + 1>(p, smem, b, tid, nt);
  }
}

// One tile of pass P: its origin from the block index, stage, levels.
template <class S, int P>
YT_HD void tile_pass(const ParamsOf<S>& p, typename S::real_t* smem,
                     int bi0, int bi1, int bi2, int tid, int nt) {
  const int b[3] = {bi0 * S::stride(P, 0) + S::orig(P, 0),
                    bi1 * S::stride(P, 1) + S::orig(P, 1),
                    bi2 * S::stride(P, 2) + S::orig(P, 2)};
  stage_inputs<S, P>(p, smem, b, tid, nt);
  YT_SYNC();
  compute_level<S, P, 1>(p, smem, b, tid, nt);
}

// Host path: the blocks of pass P in order, one thread each, buffers
// filled with NaN before every block.
template <class S, int P>
int host_pass(const ParamsOf<S>& p) {
  typedef typename S::real_t real_t;
  std::vector<real_t> smem(size_t(S::NBUF) * buf_elems<S, P>() + 1);
  for (int b0 = 0; b0 < S::grid(P, 0); ++b0)
    for (int b1 = 0; b1 < S::grid(P, 1); ++b1)
      for (int b2 = 0; b2 < S::grid(P, 2); ++b2) {
        for (auto& x : smem) x = real_t(NAN);
        tile_pass<S, P>(p, smem.data(), b0, b1, b2, 0, 1);
      }
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
template <class S>
__global__ void __launch_bounds__(S::NT)
trapezoid_kernel(const __grid_constant__ ParamsOf<S> p) {
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  tile_pass<S, 0>(p, reinterpret_cast<typename S::real_t*>(yt_smem_raw),
                  blockIdx.z, blockIdx.y, blockIdx.x, threadIdx.x, S::NT);
}

template <class S, int D>
__global__ void __launch_bounds__(S::NT)
diamond_kernel(const __grid_constant__ ParamsOf<S> p) {
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  tile_pass<S, D>(p, reinterpret_cast<typename S::real_t*>(yt_smem_raw),
                  blockIdx.z, blockIdx.y, blockIdx.x, threadIdx.x, S::NT);
}

template <class S, int P>
int launch_pass(const ParamsOf<S>& p, cudaStream_t stream) {
  const int smem = int(sizeof(typename S::real_t)) * S::NBUF
                   * buf_elems<S, P>();
  const dim3 grid(S::grid(P, 2), S::grid(P, 1), S::grid(P, 0));
  const dim3 block(S::NT, 1, 1);
  if constexpr (P == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        trapezoid_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return int(e);
    trapezoid_kernel<S><<<grid, block, smem, stream>>>(p);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        diamond_kernel<S, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return int(e);
    diamond_kernel<S, P><<<grid, block, smem, stream>>>(p);
  }
  return int(cudaGetLastError());
}
#endif

template <class S, int P>
int run_pass(const ParamsOf<S>& p, int pass, void* stream) {
  if (pass == P) {
#ifdef __CUDACC__
    return launch_pass<S, P>(p, static_cast<cudaStream_t>(stream));
#else
    (void)stream;
    return host_pass<S, P>(p);
#endif
  }
  if constexpr (P + 1 < S::NPASS) return run_pass<S, P + 1>(p, pass, stream);
  return int(-1);
}

// K4: pass 0 (phase 1) or pass D (the diamonds of the D-th trapezoid dim)
// of one K-step group; t is the step index of the newest inputs.
template <class S>
int run_trapezoid(int pass, void* in_ptrs, void* in_strides, void* out_ptrs,
                  void* out_strides, void* sizes, int t, void* stream) {
  ParamsOf<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  return run_pass<S, 0>(p, pass, stream);
}

}  // namespace yt

// The C entry point of one emitted K4 kernel: K1's arguments after the
// pass index; returns cudaGetLastError() (0 on the host, -1 for a pass
// the Spec does not have).
#define YT_TRAPEZOID_ENTRY(NAME, S)                                          \
  extern "C" int NAME(int pass, void* in_ptrs, void* in_strides,             \
                      void* out_ptrs, void* out_strides, void* sizes, int t, \
                      void* stream) {                                        \
    return yt::run_trapezoid<S>(pass, in_ptrs, in_strides, out_ptrs,         \
                                out_strides, sizes, t, stream);              \
  }
