// trapezoid.cuh — K4, the trapezoid/diamond two-phase temporal tiling of
// one K-step group, for NVIDIA Hopper, sm_90a.
//
// Replaces the trapezoid arm of build_pallas_chunk
// (yask_tpu/ops/pallas_stencil.py: resolution :812-930, phase-1 write
// windows :1740-1752, diamond sub-builds :1514-1553, band windows
// :1725-1739, the stage loop inside each level :2058-2188, host stitch
// :2372-2416; the geometry is yask_tpu/ops/tile_planner.py::TilePlan,
// its per-stage windows TilePlan.stage_flow), and the member batch the
// reference vmaps over it (yask_tpu/runtime/ensemble.py:253-263).  It is
// the port's one kernel that advances K time levels inside one launch:
// every other kernel does one step per launch.
//
// What bounds it on an H100: bytes, if the recompute stays cheap.  For
// iso3dfd r=2 at K=4 a group reads p(t), p(t-1) and vel once and writes
// the two newest levels: 20 B per point per 4 steps (5 B/pt/step) against
// K1's 16 B/pt/step.  What the design does about it: the levels between
// live only in the block's buffers.  The price is recompute, and in this
// first cut it dominates: phase 1 recomputes the z margins (uniform, K·r
// per side) and the diamonds recompute every band from level 0 with K·r
// margins, 4.1x the useful cells at 512^3, so K4 runs at the rate its
// cells are computed, not at its bound (PERF.md; ROADMAP.md A5 streams z).
// A multi-stage or scratch solution (TTI, SSG, AWP, the RTM chain) needs
// more buffers than shared memory holds at any tile the band floor
// allows; the rest live in a workspace in device memory (below).
//
// Under -skew (the default) the 3-D solutions K6's stream arm takes run
// K4's stream arm instead: one launch per group, stream_stages.cuh over
// the K levels' sub-stages lagged along slot 0 (ops/cuda_emit.py::
// emit_trap_stream, entries YT_TRAP_STREAM_ENTRIES).  These two-phase
// passes are its -no-skew twin and the kernel of the solutions it does
// not take (element size 2, more than three domain dims, 1-D and 2-D,
// misc and partial-dim outputs).
//
// Design (a first cut that is simple and right), one template for both
// phases, instantiated per pass P (compile-time tables of the emitted
// Spec, ops/cuda_emit.py::emit_trapezoid):
//   * pass 0, trapezoid_kernel<S, BATCH>: one output tile per block
//     iteration.  In a trapezoid dim (x and y of a 3-D solution) the tile
//     stages one fused step radius r per side and level L is computed over
//     the block shrunk by (L-1)·r per side; in a uniform dim (z, which the
//     card must block too) it stages K·r per side and level L covers the
//     block grown by (K-L)·r;
//   * pass D >= 1, diamond_kernel<S, D, BATCH>: the K-step kernel from the
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
//     buffer over the tile's window.  Cells outside the domain are zero:
//     in a trapezoid dim every window lies within trapezoid_pad_need of
//     the domain (the block divides the span), whose pads the plan
//     requires and which hold zero, so no bounds test there; in the other
//     dims the cells outside the domain are set to 0;
//   * 2) levels 1..K in order; inside each, the sub-stages of K6
//     (Spec::stage<Q>: a stage's scratch parts, one per write halo, then
//     its other parts) in order, each a loop of the block's threads over
//     its region: the level's region grown by what the later sub-stages
//     read of it (sub_lo/sub_hi, K6's expansions, inside the level's
//     TilePlan.stage_flow window), __syncthreads between sub-stages and
//     between levels.  A cell outside the sub-stage's plain region (the
//     domain, grown by a scratch var's write halo: clip_lo/clip_hi, K6's)
//     is not computed and holds zero, the ghost-cell rule of K6; a cell
//     inside runs the sub-stage's point function with reads mapped to
//     level buffers (lvl_src: a ring slot of a written var at this level;
//     cmp_buf: this level's value from an earlier sub-stage) or to global
//     memory (lvl_in: an input, for a misc slice no equation writes the
//     slot the level sees).  Each value, rounded once to real_t, goes to
//     its buffer (st_buf) and, from the last sub-stage writing its slice
//     and inside the level's write window, to the output of that level
//     (st_out);
//   * buffers: the levels of a written slice live in a ring of its ring
//     depth S buffers (level L replaces level L-S in place, each cell by
//     the thread that reads it) when the oldest slot is read only at its
//     own point and only by the sub-stage that writes the slice, else
//     S+1; a scratch var, and a slice a later sub-stage rewrites (AWP),
//     get a buffer per writing sub-stage that a later one reads, as K6's
//     tiles (a rewrite never writes what its neighbours still read);
//   * where the buffers live: the first nsmem(P) in shared memory (as many
//     as fit, the rings first), the rest in a workspace in device memory,
//     nws(P) buffers per block.  A pass with a workspace runs a grid of at most
//     the blocks the card holds at once (the wrapper's `nres`, from
//     resident_blocks()), each walking tiles blockIdx.x, + gridDim.x, ...
//     with its own slice of the workspace, so the workspace is bounded by
//     the resident blocks, not by the grid; the walk is block-uniform, so
//     every thread reaches every barrier.  A pass without one keeps one
//     block per tile, its z cells (members x slot-0 tiles) walked in
//     launches of at most YT_MAX_GRID_Z (launch_z);
//   * BATCH = true (K7 over K4, a member batch): a tile belongs to one
//     member, whose stride offsets its global reads and its stores only;
//     its buffers and geometry are a solo tile's, so each member gets the
//     bits of a solo group.  BATCH is a template parameter: the solo
//     kernels compute no member offset.
//
// More than three domain dims (NOUTER): the outer dims (slots 3, ...) are
// window dims of the geometry, uniform with K·r margins as the reference
// blocks w in test_4d: a buffer spans every slot (the outer ones
// outermost), the tile walk and the z cells take the outer tiles, each
// sub-stage is computed once over its region in every slot (no outer
// copies, which K6 needs), cells outside its plain region in an outer
// dim hold 0, and a read at an outer offset reads the level buffer there
// (in_dw: an input's outer offset; a computed read prints its own).
// Inputs are staged as 0 past the domain in an outer dim, as in z.
//
// Element size 2: real_t (the buffers, as the reference's VMEM tiles) is
// bf16_t; the point functions compute in float, one rounding per op, and
// a stored value is rounded once (Calc), as K6 does.
//
// The same code runs on the host (no __CUDACC__) with one thread per
// block, tiles in order and NaN-filled buffers (the workspace ones too):
// run_trapezoid's host path, which the CPU tests build with g++.
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

// K4's launch parameters: K1's, and the workspace (nws(P) buffers per
// resident block of a pass whose buffers do not all fit shared memory).
template <class S>
struct TrapParams : ParamsOf<S> {
  typename S::real_t* ws;
};

// The slots of a window: the three of the tile, then the outer dims
// (NOUTER, more than three domain dims), each uniform with K·r margins.
template <class S>
constexpr int NSLOT = 3 + OuterOf<S>::N;

// Window extent (tile + margins) per slot, and elements per buffer.
template <class S, int P>
YT_HD constexpr int win(int s) {
  return S::tile(P, s) + 2 * S::marg(P, s);
}
template <class S, int P>
YT_HD constexpr int buf_elems() {
  int e = 1;
  for (int s = 0; s < NSLOT<S>; ++s) e *= win<S, P>(s);
  return e;
}
// Elements of the three slots of a window, and the stride of outer slot
// 3 + j in units of them (outer slots outermost, the last fastest).
template <class S, int P>
YT_HD constexpr int inner_elems() {
  return win<S, P>(0) * win<S, P>(1) * win<S, P>(2);
}
template <class S, int P>
YT_HD constexpr int ostride(int j) {
  int e = 1;
  for (int i = j + 1; i < OuterOf<S>::N; ++i) e *= win<S, P>(3 + i);
  return e;
}

// Buffer b of pass P: the first nsmem(P) buffers live in shared memory,
// the rest in the block's workspace.
template <class S, int P>
YT_HD inline typename S::real_t* buf_at(typename S::real_t* smem,
                                        typename S::real_t* ws, int b) {
  return b < S::nsmem(P) ? smem + b * buf_elems<S, P>()
                         : ws + (b - S::nsmem(P)) * buf_elems<S, P>();
}

// A global read at interior (c0, c1, c2) of outer coordinates gq (input
// a's pointer carries its outer offset) of member m.
template <class S>
YT_HD inline typename S::real_t global_at_q(const ParamsOf<S>& p, int a,
                                            int m, const int* gq, idx_t c0,
                                            idx_t c1, idx_t c2) {
  idx_t off = idx_t(m) * p.in_ms[a];
  for (int j = 0; j < OuterOf<S>::N; ++j)
    off += idx_t(gq[j]) * p.in_s[a][3 + j];
  (void)gq;
  const typename S::real_t* r =
      p.in[a] + (off + c0 * p.in_s[a][0] + c1 * p.in_s[a][1]
                 + c2 * p.in_s[a][2]);
#ifdef __CUDA_ARCH__
  return __ldg(r);
#else
  return *r;
#endif
}

// The window offset, in three-slot units, of input A's outer offset
// (in_dw, printed for outer dims) and of a computed read's (ow).
template <class S, int P, int A>
YT_HD constexpr int in_outer_off() {
  if constexpr (OuterOf<S>::N > 0) {
    int o = 0;
    for (int j = 0; j < OuterOf<S>::N; ++j)
      o += S::in_dw(A, j) * ostride<S, P>(j);
    return o;
  } else {
    return 0;
  }
}
template <class S, int P, class... O>
YT_HD inline int cmp_outer_off(O... ow) {
  const int d[] = {0, int(ow)...};
  int o = 0;
  for (int j = 0; j < int(sizeof...(O)); ++j) o += d[1 + j] * ostride<S, P>(j);
  return o;
}

// Reads of a sub-stage point of level L: written vars and staged inputs
// from their level buffers, this level's earlier values from the
// buffers of their sub-stages, the rest from global memory (of member m
// in a batch, BATCH; a solo tile's member is 0 at compile time).  wq is
// the point's outer window index (flat), gq its outer coordinates.
template <class S, int P, int L, bool BATCH>
struct LevelReader {
  const ParamsOf<S>* p;
  typename S::real_t* smem;
  typename S::real_t* ws;
  int m;           // the member
  int w0, w1, w2;  // the point in window coordinates
  int g0, g1, g2;  // the point in the interior (may lie past the domain)
  int wq;          // its outer window index (0 without outer dims)
  const int* gq;   // its outer coordinates
  YT_HD int cell(int o0, int o1, int o2) const {
    return wq * inner_elems<S, P>()
           + ((w0 + o0) * win<S, P>(1) + (w1 + o1)) * win<S, P>(2)
           + (w2 + o2);
  }
  template <int A>
  YT_HD typename S::real_t at(int o0, int o1, int o2) const {
    constexpr int b = S::lvl_src(L, A);
    if constexpr (b >= 0) {
      return buf_at<S, P>(smem, ws, b)[
          cell(o0, o1, o2) + in_outer_off<S, P, A>() * inner_elems<S, P>()];
    } else {
      constexpr int a = S::lvl_in(L, A) >= 0 ? S::lvl_in(L, A) : A;
      return global_at_q<S>(*p, a, BATCH ? m : 0, gq, g0 + o0, g1 + o1,
                            g2 + o2);
    }
  }
  template <int B, class... O>
  YT_HD typename S::real_t cmp(int o0, int o1, int o2, O... ow) const {
    return buf_at<S, P>(smem, ws, S::cmp_buf(L, B))[
        cell(o0, o1, o2) + cmp_outer_off<S, P>(ow...) * inner_elems<S, P>()];
  }
};

// 1) stage the inputs over the window of the tile at origin b (per slot).
template <class S, int P, bool BATCH>
YT_HD void stage_inputs(const ParamsOf<S>& p, typename S::real_t* smem,
                        typename S::real_t* ws, const int* b, int m,
                        int tid, int nt) {
  typedef typename S::real_t real_t;
  constexpr int NO = OuterOf<S>::N;
  constexpr int W0 = win<S, P>(0), W1 = win<S, P>(1), W2 = win<S, P>(2);
  constexpr int E = buf_elems<S, P>();
  // U independent loads in flight per thread before any store (K1's
  // staging lesson: one dependent load per cell is latency-bound)
  constexpr int U = 8;
#pragma unroll
  for (int k = 0; k < S::NSTAGED; ++k) {
    const int a = S::staged_in(k);
    real_t* dst = buf_at<S, P>(smem, ws, S::staged_buf(k));
    for (int base = tid; base < E; base += nt * U) {
      real_t v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * nt;
        const int c2 = b[2] - S::marg(P, 2) + i % W2;
        int r = i / W2;
        const int c1 = b[1] - S::marg(P, 1) + r % W1;
        int c0;
        int gq[NO > 0 ? NO : 1];
        bool in_o = true;
        if constexpr (NO == 0) {
          c0 = b[0] - S::marg(P, 0) + r / W1;
        } else {
          r /= W1;
          c0 = b[0] - S::marg(P, 0) + r % W0;
          r /= W0;
          for (int j = NO - 1; j >= 0; --j) {
            const int W = win<S, P>(3 + j);
            gq[j] = b[3 + j] - S::marg(P, 3 + j) + r % W;
            r /= W;
            in_o = in_o && gq[j] >= 0 && gq[j] < p.n[3 + j];
          }
        }
        const bool in = i < E && in_o
            && (S::trap_slot(0) || (c0 >= 0 && c0 < p.n[0]))
            && (S::trap_slot(1) || (c1 >= 0 && c1 < p.n[1]))
            && (S::trap_slot(2) || (c2 >= 0 && c2 < p.n[2]));
        v[u] = in ? global_at_q<S>(p, a, BATCH ? m : 0, gq, c0, c1, c2)
                  : real_t(0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * nt < E) dst[base + u * nt] = v[u];
    }
  }
}

// Value J.. of sub-stage Q's point at window cell c, rounded once: to its
// buffer, and (wr: inside the level's write window and the domain) to its
// output of level L (outer coordinates gq).
template <class S, int P, int L, int Q, int J, bool BATCH>
YT_HD inline void store_vals(const ParamsOf<S>& p, typename S::real_t* smem,
                             typename S::real_t* ws, const CalcOf<S>* v,
                             int c, bool wr, int m, int g0, int g1, int g2,
                             const int* gq) {
  if constexpr (J < S::stage_nv(Q)) {
    typedef typename S::real_t real_t;
    constexpr int bb = S::st_buf(Q, J, L), o = S::st_out(Q, J, L);
    const real_t x = Calc<real_t>::store(v[J]);
    if constexpr (bb >= 0) buf_at<S, P>(smem, ws, bb)[c] = x;
    if constexpr (o >= 0) {
      if (wr) {
        idx_t off = cell_base<S>(p.n, BATCH ? m : 0, 0, p.out_ms[o],
                                 p.out_s[o]);
        if constexpr (OuterOf<S>::N > 0) {
          off = idx_t(BATCH ? m : 0) * p.out_ms[o];
          for (int j = 0; j < OuterOf<S>::N; ++j)
            off += idx_t(gq[j]) * p.out_s[o][3 + j];
        }
        p.out[o][off + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                 + g2 * p.out_s[o][2]] = x;
      }
    }
    store_vals<S, P, L, Q, J + 1, BATCH>(p, smem, ws, v, c, wr, m, g0, g1,
                                         g2, gq);
  } else {
    (void)p; (void)smem; (void)ws; (void)v; (void)c; (void)wr; (void)m;
    (void)g0; (void)g1; (void)g2; (void)gq;
  }
}

// Sub-stage Q's region of level L in pass P, slot s: its lower end and
// its extent (in tile coordinates), and its cells in the outer slots.
template <class S, int P, int L, int Q>
YT_HD constexpr int sub_reg_lo(int s) {
  return S::reg_lo(P, s, L) - S::sub_lo(Q, s);
}
template <class S, int P, int L, int Q>
YT_HD constexpr int sub_reg_n(int s) {
  return S::reg_hi(P, s, L) + S::sub_hi(Q, s) - sub_reg_lo<S, P, L, Q>(s);
}
template <class S, int P, int L, int Q>
YT_HD constexpr int sub_reg_outer() {
  int c = 1;
  for (int s = 3; s < NSLOT<S>; ++s) c *= sub_reg_n<S, P, L, Q>(s);
  return c;
}

// 2) sub-stage Q of level L over its region, then the sub-stages and
//    levels after it.
template <class S, int P, int L, int Q, bool BATCH>
YT_HD void compute_sub(const ParamsOf<S>& p, typename S::real_t* smem,
                       typename S::real_t* ws, const int* b, int m, int tid,
                       int nt) {
  constexpr int NO = OuterOf<S>::N;
  constexpr int W1 = win<S, P>(1), W2 = win<S, P>(2);
  constexpr int lo0 = S::reg_lo(P, 0, L) - S::sub_lo(Q, 0);
  constexpr int lo1 = S::reg_lo(P, 1, L) - S::sub_lo(Q, 1);
  constexpr int lo2 = S::reg_lo(P, 2, L) - S::sub_lo(Q, 2);
  constexpr int R0 = S::reg_hi(P, 0, L) + S::sub_hi(Q, 0) - lo0;
  constexpr int R1 = S::reg_hi(P, 1, L) + S::sub_hi(Q, 1) - lo1;
  constexpr int R2 = S::reg_hi(P, 2, L) + S::sub_hi(Q, 2) - lo2;
  constexpr int cells = R0 * R1 * R2 * sub_reg_outer<S, P, L, Q>();
  constexpr int cl0 = S::clip_lo(Q, 0), cl1 = S::clip_lo(Q, 1);
  constexpr int cl2 = S::clip_lo(Q, 2), ch0 = S::clip_hi(Q, 0);
  constexpr int ch1 = S::clip_hi(Q, 1), ch2 = S::clip_hi(Q, 2);
  constexpr int m0 = S::marg(P, 0), m1 = S::marg(P, 1), m2 = S::marg(P, 2);
  constexpr int wl0 = S::wr_lo(P, 0, L), wh0 = S::wr_hi(P, 0, L);
  constexpr int wl1 = S::wr_lo(P, 1, L), wh1 = S::wr_hi(P, 1, L);
  constexpr int wl2 = S::wr_lo(P, 2, L), wh2 = S::wr_hi(P, 2, L);
  const int t = p.t + (L - 1) * S::STEP_DIR;
  for (int i = tid; i < cells; i += nt) {
    const int l2 = lo2 + i % R2;
    int r = i / R2;
    const int l1 = lo1 + r % R1;
    int l0;
    // outer slots: coordinates, window index, plain region and write
    // window
    int g[3 + NO];
    int wq = 0;
    bool in_o = true, wr_o = true;
    if constexpr (NO == 0) {
      l0 = lo0 + r / R1;
      (void)R0;
    } else {
      r /= R1;
      l0 = lo0 + r % R0;
      r /= R0;
      for (int j = NO - 1; j >= 0; --j) {
        const int s = 3 + j;
        const int R = sub_reg_n<S, P, L, Q>(s);
        const int l = sub_reg_lo<S, P, L, Q>(s) + r % R;
        r /= R;
        g[s] = b[s] + l;
        wq += (l + S::marg(P, s)) * ostride<S, P>(j);
        in_o = in_o && g[s] >= -S::clip_lo(Q, s)
               && g[s] < p.n[s] + S::clip_hi(Q, s);
        wr_o = wr_o && g[s] >= 0 && g[s] < p.n[s]
               && l >= S::wr_lo(P, s, L) && l < S::wr_hi(P, s, L);
      }
    }
    const int g0 = b[0] + l0, g1 = b[1] + l1, g2 = b[2] + l2;
    // the plain version's region of the sub-stage: the domain, grown by a
    // scratch var's write halo
    const bool inside = in_o && g0 >= -cl0 && g0 < p.n[0] + ch0
                        && g1 >= -cl1 && g1 < p.n[1] + ch1 && g2 >= -cl2
                        && g2 < p.n[2] + ch2;
    const int w0 = l0 + m0, w1 = l1 + m1, w2 = l2 + m2;
    CalcOf<S> v[S::MAXV];
    if (inside) {
      const LevelReader<S, P, L, BATCH> rd{&p, smem, ws, m, w0, w1, w2,
                                           g0, g1, g2, wq, g + 3};
      g[0] = g0;
      g[1] = g1;
      g[2] = g2;
      S::template stage<Q>(rd, g, p.n, t, v);
    } else {
#pragma unroll
      for (int j = 0; j < S::MAXV; ++j) v[j] = CalcOf<S>(0);
    }
    const int c = wq * inner_elems<S, P>() + (w0 * W1 + w1) * W2 + w2;
    const bool wr = wr_o && g0 >= 0 && g0 < p.n[0] && g1 >= 0 && g1 < p.n[1]
                    && g2 >= 0 && g2 < p.n[2] && l0 >= wl0 && l0 < wh0
                    && l1 >= wl1 && l1 < wh1 && l2 >= wl2 && l2 < wh2;
    store_vals<S, P, L, Q, 0, BATCH>(p, smem, ws, v, c, wr, m, g0, g1, g2,
                                     g + 3);
  }
  if constexpr (Q + 1 < S::NSTAGES) {
    YT_SYNC();
    compute_sub<S, P, L, Q + 1, BATCH>(p, smem, ws, b, m, tid, nt);
  } else if constexpr (L < S::K) {
    YT_SYNC();
    compute_sub<S, P, L + 1, 0, BATCH>(p, smem, ws, b, m, tid, nt);
  }
}

// The tiles of pass P of one member, and tile i's index per slot (the
// minor slot fastest, then slots 1 and 0, then the outer slots, the last
// fastest).
template <class S, int P>
YT_HD constexpr long long tiles_per_member() {
  long long c = 1;
  for (int s = 0; s < NSLOT<S>; ++s) c *= S::grid(P, s);
  return c;
}
template <class S, int P>
YT_HD inline void tile_index(long long i, int* bi) {
  bi[2] = int(i % S::grid(P, 2));
  i /= S::grid(P, 2);
  bi[1] = int(i % S::grid(P, 1));
  i /= S::grid(P, 1);
  bi[0] = int(i % S::grid(P, 0));
  i /= S::grid(P, 0);
  for (int j = OuterOf<S>::N - 1; j >= 0; --j) {
    bi[3 + j] = int(i % S::grid(P, 3 + j));
    i /= S::grid(P, 3 + j);
  }
}

// One tile of pass P (member m, tile indices bi per slot): its origin,
// stage, levels.
template <class S, int P, bool BATCH>
YT_HD void tile_pass(const ParamsOf<S>& p, typename S::real_t* smem,
                     typename S::real_t* ws, int m, const int* bi, int tid,
                     int nt) {
  int b[NSLOT<S>];
  for (int s = 0; s < NSLOT<S>; ++s)
    b[s] = bi[s] * S::stride(P, s) + S::orig(P, s);
  stage_inputs<S, P, BATCH>(p, smem, ws, b, m, tid, nt);
  YT_SYNC();
  compute_sub<S, P, 1, 0, BATCH>(p, smem, ws, b, m, tid, nt);
}

// Host path: the tiles of pass P of every member in order, one thread
// each, every buffer (the workspace ones too) filled with NaN before
// every tile.
template <class S, int P, bool BATCH>
int host_pass(const TrapParams<S>& p) {
  typedef typename S::real_t real_t;
  std::vector<real_t> sm(size_t(S::nsmem(P)) * buf_elems<S, P>() + 1);
  std::vector<real_t> ws(size_t(S::nws(P)) * buf_elems<S, P>() + 1);
  for (int m = 0; m < p.nm; ++m)
    for (long long i = 0; i < tiles_per_member<S, P>(); ++i) {
      int bi[NSLOT<S>];
      tile_index<S, P>(i, bi);
      for (auto& x : sm) x = real_t(NAN);
      for (auto& x : ws) x = real_t(NAN);
      tile_pass<S, P, BATCH>(p, sm.data(), ws.data(), m, bi, 0, 1);
    }
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// The tiles of one block: its own (z cell = member x slot-0 tiles, y and
// x the other tiles) where the pass has no workspace, else tiles
// blockIdx.x, + gridDim.x, ... of every member with the block's slice of
// the workspace.
template <class S, int P, bool BATCH>
__device__ __forceinline__ void run_tiles(const TrapParams<S>& p,
                                          typename S::real_t* smem) {
  const int tid = threadIdx.x;
  int bi[NSLOT<S>];
  if constexpr (S::nws(P) == 0) {
    int z = int(p.z0) + int(blockIdx.z);
    int m = 0;
    bi[2] = blockIdx.x;
    bi[1] = blockIdx.y;
    if constexpr (BATCH || OuterOf<S>::N > 0) {
      bi[0] = z % S::grid(P, 0);
      z /= S::grid(P, 0);
      for (int j = OuterOf<S>::N - 1; j >= 0; --j) {
        bi[3 + j] = z % S::grid(P, 3 + j);
        z /= S::grid(P, 3 + j);
      }
      if constexpr (BATCH) m = z;
    } else {
      bi[0] = z;
    }
    tile_pass<S, P, BATCH>(p, smem, nullptr, m, bi, tid, S::NT);
  } else {
    typename S::real_t* ws =
        p.ws + size_t(blockIdx.x) * S::nws(P) * buf_elems<S, P>();
    constexpr long long per = tiles_per_member<S, P>();
    walk_tiles(per * (BATCH ? p.nm : 1), [&](long long i) {
      const int m = BATCH ? int(i / per) : 0;
      tile_index<S, P>(i - m * per, bi);
      tile_pass<S, P, BATCH>(p, smem, ws, m, bi, tid, S::NT);
    });
  }
}

template <class S, bool BATCH>
__global__ void __launch_bounds__(S::NT)
trapezoid_kernel(const __grid_constant__ TrapParams<S> p) {
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  run_tiles<S, 0, BATCH>(p,
                         reinterpret_cast<typename S::real_t*>(yt_smem_raw));
}

template <class S, int D, bool BATCH>
__global__ void __launch_bounds__(S::NT)
diamond_kernel(const __grid_constant__ TrapParams<S> p) {
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  run_tiles<S, D, BATCH>(p,
                         reinterpret_cast<typename S::real_t*>(yt_smem_raw));
}

template <class S, int P>
constexpr int smem_bytes() {
  return int(sizeof(typename S::real_t)) * S::nsmem(P) * buf_elems<S, P>();
}

// The blocks of pass P the card holds at once.
template <class S, int P, bool BATCH>
int resident_blocks() {
  if constexpr (P == 0)
    return resident_of(trapezoid_kernel<S, BATCH>, S::NT, smem_bytes<S, P>());
  else
    return resident_of(diamond_kernel<S, P, BATCH>, S::NT,
                       smem_bytes<S, P>());
}

template <class S, int P, bool BATCH>
int launch_pass(TrapParams<S> p, long long nres, cudaStream_t stream) {
  constexpr int smem = smem_bytes<S, P>();
  constexpr bool walk = S::nws(P) > 0;
  const long long tiles = tiles_per_member<S, P>() * p.nm;
  if (walk && (p.ws == nullptr || nres < 1))
    return int(cudaErrorInvalidConfiguration);
  const dim3 block(S::NT, 1, 1);
  const dim3 cols = walk ? dim3(unsigned(tiles < nres ? tiles : nres))
                         : dim3(S::grid(P, 2), S::grid(P, 1));
  // the z cells: members x outer tiles x slot-0 tiles
  const long long gz = walk ? 1 : tiles / (S::grid(P, 2) * S::grid(P, 1));
  if constexpr (P == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        trapezoid_kernel<S, BATCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    return launch_z(p.z0, gz, cols, [&](dim3 grid) {
      trapezoid_kernel<S, BATCH><<<grid, block, smem, stream>>>(p);
    });
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        diamond_kernel<S, P, BATCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    return launch_z(p.z0, gz, cols, [&](dim3 grid) {
      diamond_kernel<S, P, BATCH><<<grid, block, smem, stream>>>(p);
    });
  }
}
#endif

template <class S, bool BATCH, int P = 0>
int run_pass(const TrapParams<S>& p, int pass, long long nres,
             void* stream) {
  if (pass == P) {
#ifdef __CUDACC__
    return launch_pass<S, P, BATCH>(p, nres,
                                    static_cast<cudaStream_t>(stream));
#else
    (void)nres;
    (void)stream;
    return host_pass<S, P, BATCH>(p);
#endif
  }
  if constexpr (P + 1 < S::NPASS)
    return run_pass<S, BATCH, P + 1>(p, pass, nres, stream);
  return int(-1);
}

template <class S, bool BATCH, int P = 0>
int resident(int pass) {
  if (pass == P) {
#ifdef __CUDACC__
    return resident_blocks<S, P, BATCH>();
#else
    return 1;
#endif
  }
  if constexpr (P + 1 < S::NPASS) return resident<S, BATCH, P + 1>(pass);
  return int(-1);
}

// K4: pass 0 (phase 1) or pass D (the diamonds of the D-th trapezoid dim)
// of one K-step group; t is the step index of the newest inputs, ws the
// workspace of nres resident blocks (unused by a pass without one).
template <class S>
int run_trapezoid(int pass, void* in_ptrs, void* in_strides, void* out_ptrs,
                  void* out_strides, void* sizes, int t, void* ws,
                  long long nres, void* stream) {
  TrapParams<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  p.ws = static_cast<typename S::real_t*>(ws);
  return run_pass<S, false>(p, pass, nres, stream);
}

// K7 over K4: the same pass for nm members whose arrays sit
// in_mstrides[a] / out_mstrides[o] elements apart (arrays of idx_t).
template <class S>
int run_trapezoid_batched(int pass, void* in_ptrs, void* in_strides,
                          void* in_mstrides, void* out_ptrs,
                          void* out_strides, void* out_mstrides, void* sizes,
                          int nm, int t, void* ws, long long nres,
                          void* stream) {
  TrapParams<S> p;
  fill_params<S>(p, in_ptrs, in_strides, out_ptrs, out_strides, sizes, t);
  fill_members<S>(p, in_mstrides, out_mstrides, nm);
  p.ws = static_cast<typename S::real_t*>(ws);
  return run_pass<S, true>(p, pass, nres, stream);
}

}  // namespace yt

// The C entry points of one emitted K4 kernel: the solo group (K1's
// arguments after the pass index, then the workspace and its resident
// blocks), the member batch (K7's arguments, likewise) and the resident
// blocks of a pass (solo or batched); each returns cudaGetLastError() (0
// on the host, -1 for a pass the Spec does not have).
#define YT_TRAPEZOID_ENTRY(NAME, S)                                          \
  extern "C" int NAME(int pass, void* in_ptrs, void* in_strides,             \
                      void* out_ptrs, void* out_strides, void* sizes, int t, \
                      void* ws, long long nres, void* stream) {              \
    return yt::run_trapezoid<S>(pass, in_ptrs, in_strides, out_ptrs,         \
                                out_strides, sizes, t, ws, nres, stream);    \
  }                                                                          \
  extern "C" int NAME##_trap_batched(                                        \
      int pass, void* in_ptrs, void* in_strides, void* in_mstrides,          \
      void* out_ptrs, void* out_strides, void* out_mstrides, void* sizes,    \
      int nm, int t, void* ws, long long nres, void* stream) {               \
    return yt::run_trapezoid_batched<S>(pass, in_ptrs, in_strides,           \
                                        in_mstrides, out_ptrs, out_strides,  \
                                        out_mstrides, sizes, nm, t, ws,      \
                                        nres, stream);                       \
  }                                                                          \
  extern "C" int NAME##_trap_resident(int pass, int batched) {               \
    return batched ? yt::resident<S, true>(pass)                             \
                   : yt::resident<S, false>(pass);                           \
  }
