// stream_step.cuh — the stream arm of K1 for NVIDIA Hopper, sm_90a: one
// sub-step of a single-stage solution of three domain dims or more, each
// block walking slot 0 through a ring of staged planes.
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
// At element size 2 the row shift comes from the moved pointers (a box
// origin at minor index x moves it by x mod 8 cells); the strides stay
// multiples of 8, so it is still the same for every row and plane.  The
// lane pairs start at the box's even minor indices.
//
// Past three domain dims (a Spec that prints NOUTER: the grid over every
// lead dim, pallas_stencil.py:1442, under K2's prefetch and K3's carry;
// K7's batches of such solutions too): the outer cells are a coordinate
// of the work items beside the segments and the member, as K1's body
// folds them into its grid (split_z): z cell = (member x outer cells +
// outer cell) x segments + segment.  The body's rule for reads at outer
// offsets holds: each is an input of its own whose pointer the wrapper
// moves by its offset, staged into a ring of its own (KernelSpec.in_outer)
// or, read at the point alone, loaded into the register queue; a block
// adds its outer cell's offset to every read and store, and the point
// function sees the outer indices in g[3 + j].  test_4d stages 2 inputs
// at 8 planes a ring and 16x32 tiles: about 1.5 cells per input and point
// at 128^4 against K1's body's 5.1 in all (8x8x64 tiles), where K6's
// outer-window box (StreamSpec) would stage 17.2.  The plan keeps 40
// registers a thread (tile_planner.STREAM_OUTER_MIN_REGS): at 32 these
// builds spill.  The pad pass zeroes every slot's pads, the outer slots'
// included (outer_pads).  K5's box walk stays 3-D (REGION asserts it).
//
// Element size 2 (bfloat16): two adjacent minor-dim points a thread in
// packed bfloat16x2 arithmetic, over ring rows of whole 16-byte units.
// What held the one-point-a-thread body back (3.5 ms per launch of
// iso3dfd r=8 at 512^3 against 2.1 at fp32, PERF.md): each op on
// bfloat16 values computed in float and rounded once costs a cvt and a
// widening beside it, and each read a widening; its rings were filled
// with 4-byte pair copies (1,312 a plane of the 16x64 tile at r=8); and
// at 1024 threads a block its builds spilled at 32 registers.  Here:
//   * a thread owns the lanes g2 and g2 + 1 (g2 even in the interior, the
//     box: K5) of its tile, so a 16x64 tile takes 512 threads, and the
//     plan keeps 64 registers a thread (tile_planner.STREAM_PAIR_MIN_REGS;
//     past three dims with a register queue of 2);
//   * the point function's pair flavour (Spec::point2, printed by
//     cuda_emit from the same walk as Spec::point) runs +, - and x of
//     bfloat16 values packed (add.rn/sub.rn/mul.rn.bf16x2: each rounds
//     the exact result once, which for bfloat16 operands is what an op
//     computed in float and rounded once gives, ROADMAP.md C13; an
//     explicit rounding mode is never contracted into an FMA) and
//     everything else per lane in float, rounded per lane (yt::pack);
//   * a ring row starts at the 16-byte unit that holds its first cell
//     b2 - h2, unit_shift (0-7) cells early, and holds pair_row(E2)
//     elements (E2 + 7 rounded up to 8).  The strides are multiples of 8
//     (the wrapper checks), so the shift is the same for every row,
//     plane, outer cell and member of a launch.  Rows are filled by
//     cp.async 16; a unit across the read reach's edge goes by plain
//     loads and stores, which the barrier before its plane's compute
//     orders like a copy;
//   * a lane pair at ring position c comes from the two 32-bit words
//     holding c and c + 1 and a funnel shift by 0 or 16 bits: the
//     position's parity is the row shift's plus the offset's, so each
//     thread keeps per ring input the word and the shift of an even minor
//     offset (an odd one's follow from them; PairReader), and every read
//     is two LDS at constant offsets and one SHF (the shift is known at
//     run time only, hence PAIR_TAIL: the rings' last read may touch one
//     word past them);
//   * same-point and global reads load a pair as one 32-bit word where it
//     is aligned and lane 1 lies inside, else lane by lane; an output
//     pair is one 32-bit store where it is aligned and both lanes store,
//     else lane by lane, so a lane past the interior or the box, and a
//     box at an odd minor origin, are masked.
// A lane is computed as the one-point function computes it, so the bits
// are the -no-skew twin's (K1's body).
//
// The same Spec compiles on the host (no __CUDACC__): host_stream() runs
// host_step() (over every member, or the box at global coordinates; at
// element size 2 host_pairs(), the pair flavour over the lane pairs, each
// lane's op in float rounded once, which is the rule itself) and zeroes
// the pads, which is how the CPU tests check the entries' arithmetic with
// g++.
#pragma once

#include "fused_step.cuh"

namespace yt {

// Elements of one ring row in shared memory for a plane row of e2 cells
// at element size 2 (tile_planner.pair_row): a whole number of 16-byte
// units from the unit holding the row's first cell (e2 + 7 rounded up to
// 8).  At 4 and 8 bytes a row holds its e2 cells.
YT_HD constexpr int pair_row(int e2) { return (e2 + 14) & ~7; }

// At element size 2: the cells by which cell x of input a's minor dim
// lies past the start of its 16-byte unit (0-7).
template <class S>
YT_HD inline int unit_shift(const ParamsOf<S>& p, int a, int x) {
  return int((reinterpret_cast<unsigned long long>(p.in[a] + x) >> 1) & 7);
}

// ---- bfloat16 pairs: two adjacent minor-dim lanes (element size 2) ------
// Lane 0 is the low half of the 32-bit word, as in memory.  On the card
// the packed ops are Hopper's bf16x2 instructions with an explicit
// rounding mode (each rounds the exact result once; never contracted
// into an FMA); elsewhere (the host build, the CPU emulation) each lane
// is computed in float and rounded once, which is ROADMAP.md C13's rule.
#if defined(__CUDA_ARCH__) && !defined(YT_HOST_BF16)
#define YT_BF16X2_PTX 1
#endif
struct alignas(4) bf2 {
  bf16_t x, y;
};
YT_HD inline uint32_t bits2(bf2 v) {
  uint32_t w;
  memcpy(&w, &v, 4);
  return w;
}
YT_HD inline bf2 from_bits2(uint32_t w) {
  bf2 v;
  memcpy(&v, &w, 4);
  return v;
}
// the float of bfloat16 bits b, and the pair of it in both lanes
YT_HD inline float bf_float(uint32_t b) {
  const uint32_t u = b << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
YT_HD inline bf2 bf2_bits(uint32_t b) { return from_bits2(b | (b << 16)); }
YT_HD inline float lane0(bf2 v) { return to_f(v.x); }
YT_HD inline float lane1(bf2 v) { return to_f(v.y); }
// two floats, each rounded once to bfloat16
YT_HD inline bf2 pack(float a, float b) {
#ifdef YT_BF16X2_PTX
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(b), "f"(a));
  return from_bits2(w);
#else
  return bf2{to_bf16(a), to_bf16(b)};
#endif
}
#ifdef YT_BF16X2_PTX
#define YT_BF16X2_OP(NAME, PTX)                                         \
  YT_HD inline bf2 NAME(bf2 a, bf2 b) {                                 \
    uint32_t w;                                                         \
    asm(PTX " %0, %1, %2;" : "=r"(w) : "r"(bits2(a)), "r"(bits2(b)));   \
    return from_bits2(w);                                               \
  }
#else
#define YT_BF16X2_OP(NAME, OP)                                          \
  YT_HD inline bf2 NAME(bf2 a, bf2 b) {                                 \
    return pack(lane0(a) OP lane0(b), lane1(a) OP lane1(b));            \
  }
#endif
#ifdef YT_BF16X2_PTX
YT_BF16X2_OP(add2, "add.rn.bf16x2")
YT_BF16X2_OP(sub2, "sub.rn.bf16x2")
YT_BF16X2_OP(mul2, "mul.rn.bf16x2")
#else
YT_BF16X2_OP(add2, +)
YT_BF16X2_OP(sub2, -)
YT_BF16X2_OP(mul2, *)
#endif
#undef YT_BF16X2_OP
// negation flips the sign bits (exact, as -x in float is)
YT_HD inline bf2 neg2(bf2 a) { return from_bits2(bits2(a) ^ 0x80008000u); }
// lane by lane: v where c, else base (a conditional write)
YT_HD inline bf2 select2(bool c0, bool c1, bf2 v, bf2 base) {
  return bf2{c0 ? v.x : base.x, c1 ? v.y : base.y};
}
// the low 32 bits of (hi:lo) >> f (f: 0 or 16)
YT_HD inline uint32_t fshr(uint32_t lo, uint32_t hi, int f) {
#ifdef YT_BF16X2_PTX
  return __funnelshift_r(lo, hi, f);
#else
  return uint32_t(((uint64_t(hi) << 32) | lo) >> f);
#endif
}

// Input a's cells (c2, c2 + 1) at (c0, c1) of member m, outer cell q: one
// 32-bit load where it is aligned and lane 1 lies inside (ok1), else lane
// by lane (lane 1 only where ok1; both lanes the one cell where the var
// lacks the minor dim).
template <class S>
YT_HD inline bf2 global_pair(const ParamsOf<S>& p, int a, int m, int q,
                             idx_t c0, idx_t c1, idx_t c2, bool ok1) {
  const bf16_t* r =
      p.in[a] + (cell_base<S>(p.n, m, q, p.in_ms[a], p.in_s[a])
                 + c0 * p.in_s[a][0] + c1 * p.in_s[a][1] + c2 * p.in_s[a][2]);
  const idx_t s2 = p.in_s[a][2];
#ifdef __CUDA_ARCH__
  if (s2 == 1 && ok1 && !(reinterpret_cast<unsigned long long>(r) & 3))
    return from_bits2(__ldg(reinterpret_cast<const uint32_t*>(r)));
  const bf16_t v0 = __ldg(r);
  return bf2{v0, s2 == 0 ? v0 : ok1 ? __ldg(r + s2) : bf16_t(0.0f)};
#else
  return bf2{r[0], s2 == 0 ? r[0] : ok1 ? r[s2] : bf16_t(0.0f)};
#endif
}

// Reads every input pair from global memory (the host path).
template <class S>
struct GlobalPairReader {
  const ParamsOf<S>* p;
  int m, q;        // member, outer cell
  int g0, g1, g2;
  bool ok1;        // lane 1 lies inside the interior (the box: K5)
  template <int A>
  YT_HD bf2 at(int o0, int o1, int o2) const {
    return global_pair<S>(*p, A, m, q, g0 + o0, g1 + o1, g2 + o2, ok1);
  }
};

// K1's body's point_at for the lanes (g2, g2 + 1): K5 (REGION) computes
// them at global coordinates, a lane outside the global domain 0.
template <class S, bool REGION, class RD>
YT_HD inline void point_at2(const ParamsArg<S, REGION>& p, const RD& rd,
                            int q, int g0, int g1, int g2, bf2* out) {
  int g[3 + OuterOf<S>::N] = {g0, g1, g2};
  fill_outer<S>(g, p.n, q);
  if constexpr (REGION) {
    int h[3 + OuterOf<S>::N];
    for (int s = 0; s < 3 + OuterOf<S>::N; ++s) h[s] = g[s];
    h[2] += 1;
    const bool in0 = to_global<S, REGION>(p, g);
    const bool in1 = to_global<S, REGION>(p, h);
    const bf2 zero = bf2_bits(0);
    if (in0 || in1) S::point2(rd, g, dom_of<S, REGION>(p), p.t, out);
    for (int o = 0; o < S::NOUT; ++o)
      out[o] = select2(in0, in1, in0 || in1 ? out[o] : zero, zero);
  } else {
    S::point2(rd, g, dom_of<S, REGION>(p), p.t, out);
  }
}

// K1's body's store for the lanes (g2, g2 + 1): one 32-bit store where
// the pair is aligned and both lanes store (lane 1: ok1), else lane by
// lane.
template <class S, bool REGION = false>
YT_HD inline void store2(const ParamsArg<S, REGION>& p, int m, int q, int g0,
                         int g1, int g2, bool ok1, const bf2* out) {
  const int* lo = nullptr;
  if constexpr (REGION) lo = p.lo;
  for (int o = 0; o < S::NOUT; ++o) {
    const bool s0 = stores<S, REGION>(o, g0, g1, g2, q, p.n, lo);
    const bool s1 = ok1 && stores<S, REGION>(o, g0, g1, g2 + 1, q, p.n, lo);
    const idx_t s2 = p.out_s[o][2];
    bf16_t* d = p.out[o] + (cell_base<S>(p.n, m, q, p.out_ms[o], p.out_s[o])
                            + g0 * p.out_s[o][0] + g1 * p.out_s[o][1]
                            + g2 * s2);
    if (s0 && s1 && s2 == 1
        && !(reinterpret_cast<unsigned long long>(d) & 3)) {
      *reinterpret_cast<uint32_t*>(d) = bits2(out[o]);
    } else {
      if (s0) d[0] = out[o].x;
      if (s1) d[s2] = out[o].y;
    }
  }
}

// The host path at element size 2: the pair flavour over the lane pairs
// of every member's interior (each outer cell's; K5: the box's).
template <class S, bool REGION = false>
int host_pairs(const ParamsArg<S, REGION>& p) {
  for (int m = 0; m < p.nm; ++m)
    for (int q = 0; q < outer_cells<S>(p.n); ++q)
      for (int g0 = 0; g0 < p.n[0]; ++g0)
        for (int g1 = 0; g1 < p.n[1]; ++g1)
          for (int g2 = 0; g2 < p.n[2]; g2 += 2) {
            const bool ok1 = g2 + 1 < p.n[2];
            const GlobalPairReader<S> rd{&p, m, q, g0, g1, g2, ok1};
            bf2 out[S::NOUT];
            point_at2<S, REGION>(p, rd, q, g0, g1, g2, out);
            store2<S, REGION>(p, m, q, g0, g1, g2, ok1, out);
          }
  return 0;
}

template <class S, bool REGION = false>
struct StreamParams {
  // K1's tables (K7's member strides and count; K5's box, REGION)
  ParamsArg<S, REGION> p;
  int seg;                       // planes of slot 0 per segment (grid z)
  // each output's pads (lo, hi) per slot, the outer slots after the three
  int pad[S::NOUT][3 + OuterOf<S>::N][2];
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
// (of every member: BATCH; past three domain dims every slot's pads, the
// outer ones included, of every outer cell: outer_pads).
template <class S, bool BATCH = false, class Q>
YT_HD inline void zero_pads(const Q& q, long long first, long long stride) {
  typedef typename S::real_t real_t;
  if constexpr (OuterOf<S>::N > 0) {
    outer_pads<S>(q.p, [&](int o, int k) { return q.pad[o][k / 2][k % 2]; },
                  first, stride);
    return;
  }
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
  if constexpr (sizeof(typename S::real_t) == 2)
    host_pairs<S, REGION>(q.p);
  else
    host_step<S, REGION>(q.p);
  if constexpr (!REGION) zero_pads<S, BATCH>(q, 0, 1);
  return 0;
}

#ifdef __CUDACC__
// ---- device path -------------------------------------------------------
// (the cp.async primitives are fused_step.cuh's)

// Threads of a block: one a point of the ST1 x ST2 plane tile, at element
// size 2 one a lane pair.
template <class S>
YT_HD constexpr int stream_nt() {
  return S::ST1 * S::ST2 / (sizeof(typename S::real_t) == 2 ? 2 : 1);
}

// Reads ring inputs from their rings, same-point inputs from the values
// loaded one plane ahead, the rest from global memory.
template <class S>
struct PlaneReader {
  const ParamsOf<S>* p;
  const typename S::real_t* smem;
  const int* zb;   // per ring input: the ring slot of plane z - h0_lo
  const typename S::real_t* pre;  // per same-point input: its value here
  int m;           // the member (0 in a solo launch)
  int oc;          // the outer cell (0 without outer dims)
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
      constexpr int E2 = S::ST2 + S::halo_lo2(k) + S::halo_hi2(k);
      int s = zb[k] + S::halo_lo0(k) + o0;  // in [0, 2 D)
      if (s >= D) s -= D;
      return smem[S::ring_offset(k)
                  + (s * E1 + (l1 + S::halo_lo1(k) + o1)) * E2
                  + (l2 + S::halo_lo2(k) + o2)];
    } else {
      return global_at<S>(*p, A, m, oc, g0 + o0, g1 + o1, g2 + o2);
    }
  }
};

// Element size 2: reads lane pairs (g2, g2 + 1), ring inputs from their
// rings as two 32-bit words and a funnel shift, same-point inputs from the
// pairs loaded one plane ahead, the rest from global memory.  Ring input
// k's pair at minor offset o2 starts at row position b + o2, b = l2 +
// halo_lo2(k) + its row shift: at word we + (o2 >> 1) shifted by fe bits
// for an even o2 (we = b >> 1, fe = 16 (b & 1)), at word we + fe / 16 +
// (o2 >> 1) shifted by 16 - fe bits for an odd one.
template <class S>
struct PairReader {
  const ParamsOf<S>* p;
  const uint32_t* words;  // shared memory as 32-bit words
  const int* zb;   // per ring input: the ring slot of plane z - h0_lo
  const int* we;   // per ring input: the word and the shift of an even
  const int* fe;   //   minor offset's pair
  const bf2* pre;  // per same-point input: its pair here
  int m;           // the member (0 in a solo launch)
  int oc;          // the outer cell (0 without outer dims)
  int l1;          // row within the block's plane tile
  int g0, g1, g2;  // lane 0 in the interior (the box: K5)
  bool ok1;        // lane 1 lies inside it
  template <int A>
  YT_HD bf2 at(int o0, int o1, int o2) const {
    constexpr int k = S::tile_of(A);
    constexpr int j = S::pre_of(A);
    if constexpr (j >= 0) {
      return pre[j];  // read at offset (0, 0, 0) only
    } else if constexpr (k >= 0) {
      constexpr int D = S::ring_depth(k);
      constexpr int E1 = S::ST1 + S::halo_lo1(k) + S::halo_hi1(k);
      constexpr int W2 =
          pair_row(S::ST2 + S::halo_lo2(k) + S::halo_hi2(k)) / 2;
      int s = zb[k] + S::halo_lo0(k) + o0;  // in [0, 2 D)
      if (s >= D) s -= D;
      const bool odd = o2 & 1;
      const uint32_t* w = words + S::ring_offset(k) / 2
                          + (s * E1 + (l1 + S::halo_lo1(k) + o1)) * W2
                          + we[k] + (odd ? fe[k] >> 4 : 0) + (o2 >> 1);
      return from_bits2(fshr(w[0], w[1], odd ? 16 - fe[k] : fe[k]));
    } else {
      return global_pair<S>(*p, A, m, oc, g0 + o0, g1 + o1, g2 + o2, ok1);
    }
  }
};

// Issue the copies of plane c of ring input k (member m, outer cell oc)
// into its ring slot (c - zs + h0_lo) mod depth; cells past the domain's
// read reach (K5: the box's) get 0.
template <class S, int k, bool BATCH>
__device__ __forceinline__ void fetch_plane(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int oc, int c, int zs, int b1,
                                            int b2, int tid) {
  typedef typename S::real_t real_t;
  constexpr int NT = stream_nt<S>();
  constexpr int a = S::tiled_input(k);
  constexpr int h1 = S::halo_lo1(k), h2 = S::halo_lo2(k);
  constexpr int E1 = S::ST1 + h1 + S::halo_hi1(k);
  constexpr int E2 = S::ST2 + h2 + S::halo_hi2(k);
  constexpr int R2 = sizeof(real_t) == 2 ? pair_row(E2) : E2;
  constexpr int D = S::ring_depth(k);
  real_t* dst = smem + S::ring_offset(k)
                + ((c - zs + S::halo_lo0(k)) % D) * (E1 * R2);
  const bool in0 = c < p.n[0] + S::halo_hi0(k);
  const int lim1 = p.n[1] + S::halo_hi1(k);
  const int lim2 = p.n[2] + S::halo_hi2(k);
  const real_t* base = p.in[a] + (BATCH ? idx_t(m) * p.in_ms[a] : 0)
                       + cell_base<S>(p.n, 0, oc, 0, p.in_s[a])
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
    // 16-byte units from the unit holding cell b2 - h2; a unit across the
    // read reach's edge by plain loads, its cells outside it 0
    constexpr int V = 8;
    const int lo2 = b2 - h2;
    const int x0 = lo2 - unit_shift<S>(p, a, lo2);
    const real_t* zero16 = reinterpret_cast<const real_t*>(
        reinterpret_cast<unsigned long long>(p.in[a]) & ~15ull);
    constexpr int NU = R2 / V;
    for (int i = tid; i < E1 * NU; i += NT) {
      const int r = i / NU;
      const int c1 = b1 - h1 + r;
      const int c2 = x0 + V * (i - r * NU);
      real_t* d = dst + r * R2 + (c2 - x0);
      const real_t* q = base + c1 * p.in_s[a][1] + c2;
      if (!(in0 && c1 < lim1) || c2 >= lim2) {
        cp_async<16>(d, zero16, false);
      } else if (c2 >= lo2 && c2 + V <= lim2) {
        cp_async<16>(d, q, true);
      } else {
        for (int u = 0; u < V; ++u)
          d[u] = c2 + u >= lo2 && c2 + u < lim2 ? __ldg(q + u)
                                                : real_t(0.0f);
      }
    }
  }
}

// Planes zs - h0_lo(k) .. zs + h0_hi(k) of every ring input k: those
// output plane zs reads (the prologue's first group).
template <class S, bool BATCH, int k = 0>
__device__ __forceinline__ void fetch_first(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int oc, int zs, int b1, int b2,
                                            int tid) {
  if constexpr (k < S::NTILED) {
    for (int c = zs - S::halo_lo0(k); c <= zs + S::halo_hi0(k); ++c)
      fetch_plane<S, k, BATCH>(p, smem, m, oc, c, zs, b1, b2, tid);
    fetch_first<S, BATCH, k + 1>(p, smem, m, oc, zs, b1, b2, tid);
  }
}

// Plane zs + j + h0_hi(k) of every ring input k: the newest plane that
// output plane zs + j reads.
template <class S, bool BATCH, int k = 0>
__device__ __forceinline__ void fetch_ahead(const ParamsOf<S>& p,
                                            typename S::real_t* smem, int m,
                                            int oc, int j, int zs, int b1,
                                            int b2, int tid) {
  if constexpr (k < S::NTILED) {
    fetch_plane<S, k, BATCH>(p, smem, m, oc, zs + j + S::halo_hi0(k), zs,
                             b1, b2, tid);
    fetch_ahead<S, BATCH, k + 1>(p, smem, m, oc, j, zs, b1, b2, tid);
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
// over it (BATCH: the z cell is (member x outer cells + outer cell) x
// segments + segment) and K5's (REGION: the walk over a shard's 3-D box,
// no pad pass).
template <class S, bool BATCH, bool REGION>
__global__ void __launch_bounds__(
    S::ST1 * S::ST2 / (sizeof(typename S::real_t) == 2 ? 2 : 1), S::SMIN)
stream_step_kernel(const __grid_constant__ StreamParams<S, REGION> q) {
  static_assert(!(BATCH && REGION), "K5 walks one shard's box");
  static_assert(!(REGION && OuterOf<S>::N > 0), "K5 walks a 3-D box");
  typedef typename S::real_t real_t;
  // element size 2: a thread computes the lane pair (g2, g2 + 1)
  constexpr bool PAIR = sizeof(real_t) == 2;
  typedef typename std::conditional<PAIR, bf2, real_t>::type val_t;
  extern __shared__ __align__(16) unsigned char yt_smem_raw[];
  real_t* smem = reinterpret_cast<real_t*>(yt_smem_raw);
  const ParamsArg<S, REGION>& p = q.p;
  constexpr int NT = stream_nt<S>();
  constexpr int NK = S::NTILED > 0 ? S::NTILED : 1;
  constexpr int NJ = S::NPRE > 0 ? S::NPRE : 1;
  const int tid = threadIdx.y * (S::ST2 / (PAIR ? 2 : 1)) + threadIdx.x;
  const int by = int(q.y0) + int(blockIdx.y);
  const int bz = int(q.z0) + int(blockIdx.z);
  // the member, the outer cell and the segment of the z cell
  int m = 0, oc = 0, sg = bz;
  if constexpr (BATCH || OuterOf<S>::N > 0) {
    const int segs = (p.n[0] + q.seg - 1) / q.seg;
    const int r = bz / segs;
    sg = bz - r * segs;
    if constexpr (BATCH) {
      const int nq = outer_cells<S>(p.n);
      m = r / nq;
      oc = r - m * nq;
    } else {
      oc = r;
    }
  }
  const int b1 = by * S::ST1, b2 = blockIdx.x * S::ST2;
  const int l1 = threadIdx.y, l2 = threadIdx.x * (PAIR ? 2 : 1);
  const int g1 = b1 + l1, g2 = b2 + l2;
  const bool active = g1 < p.n[1] && g2 < p.n[2];
  const bool ok1 = PAIR && active && g2 + 1 < p.n[2];  // lane 1 inside
  const int zs = sg * q.seg;
  const int ze = zs + q.seg < p.n[0] ? zs + q.seg : p.n[0];

  if (zs < ze) {
    // 1) prologue: the planes output plane zs reads (one group), then the
    //    newest plane of each of the next SP - 1 output planes (a group
    //    each); a plane no output plane of the segment reads is skipped,
    //    its group left empty
    fetch_first<S, BATCH>(p, smem, m, oc, zs, b1, b2, tid);
    cp_async_commit();
#pragma unroll
    for (int j = 1; j < S::SP; ++j) {
      if (zs + j < ze)
        fetch_ahead<S, BATCH>(p, smem, m, oc, j, zs, b1, b2, tid);
      cp_async_commit();
    }
    // 2) the walk, one barrier per output plane z: fetch plane z + h0_hi +
    //    SP of each ring input into the slot of plane z - h0_lo - 2 (last
    //    read by plane z - 2, before the previous barrier) and load each
    //    same-point input at plane z + SQ - 1 into the register queue;
    //    wait until at most SP groups are in flight, __syncthreads, then
    //    compute and store plane z.
    int zb[NK];  // per ring input: the ring slot of plane z - h0_lo
    // element size 2, per ring input: the word and the funnel shift of
    // the thread's pair at an even minor offset (PairReader)
    int we[NK], fe[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      zb[k] = 0;
      if constexpr (PAIR) {
        const int lo2 = b2 - S::halo_lo2(k);
        const int b = l2 + S::halo_lo2(k)
                      + unit_shift<S>(p, S::tiled_input(k), lo2);
        we[k] = b >> 1;
        fe[k] = 16 * (b & 1);
      }
    }
    val_t qv[S::SQ][NJ];  // same-point values of planes z .. z + SQ - 1
    auto same = [&](int j, int z) -> val_t {
      if constexpr (PAIR)
        return global_pair<S>(p, S::pre_input(j), m, oc, z, g1, g2, ok1);
      else
        return global_at<S>(p, S::pre_input(j), m, oc, z, g1, g2);
    };
    val_t zero;
    if constexpr (PAIR)
      zero = bf2_bits(0);
    else
      zero = real_t(0.0f);
#pragma unroll
    for (int i = 0; i + 1 < S::SQ; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        qv[i][j] = S::NPRE && active && (i == 0 || zs + i < ze)
                       ? same(j, zs + i) : zero;
    auto plane = [&](int z, val_t (&cur)[NJ], val_t (&ahead)[NJ]) {
      if (z + S::SP < ze)
        fetch_ahead<S, BATCH>(p, smem, m, oc, z - zs + S::SP, zs, b1, b2,
                              tid);
      cp_async_commit();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ahead[j] = S::NPRE && active && z + S::SQ - 1 < ze
                       ? same(j, z + S::SQ - 1) : zero;
      cp_async_wait<S::SP>();
      __syncthreads();
      if (active) {
        if constexpr (PAIR) {
          const PairReader<S> rd{
              &p, reinterpret_cast<const uint32_t*>(smem), zb, we, fe, cur,
              m, oc, l1, z, g1, g2, ok1};
          bf2 out[S::NOUT];
          point_at2<S, REGION>(p, rd, oc, z, g1, g2, out);
          store2<S, REGION>(p, m, oc, z, g1, g2, ok1, out);
        } else {
          const PlaneReader<S> rd{&p, smem, zb, cur, m, oc,
                                  l1, l2, z, g1, g2};
          CalcOf<S> out[S::NOUT];
          point_at<S, REGION>(p, rd, oc, z, g1, g2, out);
          store<S, REGION>(p, m, oc, z, g1, g2, out);
        }
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
  //    member; every slot's, the outer ones included), shared out over
  //    every thread of the whole grid (all its launches); K5's outputs
  //    keep what lies outside the box
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
  // z cells: the segments (of every outer cell, of every member)
  p.gz = (long long)((p.p.n[0] + p.seg - 1) / p.seg)
         * outer_cells<S>(p.p.n) * (BATCH ? p.p.nm : 1);
  p.gy = (p.p.n[1] + S::ST1 - 1) / S::ST1;
  const dim3 block(stream_nt<S>() / S::ST1, S::ST1, 1);
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
// = int[1 + 2 NS NOUT], NS the slots (3 + the outer dims).  (Q: a
// StreamParams.)
template <class S, class Q>
void fill_geom(Q& q, const void* geom) {
  constexpr int NS = 3 + OuterOf<S>::N;
  const int* gm = static_cast<const int*>(geom);
  q.seg = gm[0];
  for (int o = 0; o < S::NOUT; ++o)
    for (int s = 0; s < NS; ++s)
      for (int e = 0; e < 2; ++e)
        q.pad[o][s][e] = gm[1 + 2 * NS * o + 2 * s + e];
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
// table, the box's segment length, before the step index).  A Spec past
// three domain dims has the first two alone (YT_FUSED_STREAM_OUTER_ENTRY).
#define YT_FUSED_STREAM_OUTER_ENTRY(NAME, S)                                 \
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
  }
#define YT_FUSED_STREAM_ENTRY(NAME, S)                                       \
  YT_FUSED_STREAM_OUTER_ENTRY(NAME, S)                                       \
  extern "C" int NAME##_region(void* in_ptrs, void* in_strides,              \
                               void* out_ptrs, void* out_strides,            \
                               void* sizes, void* region, void* geom, int t, \
                               void* stream) {                               \
    return yt::run_stream_region<S>(in_ptrs, in_strides, out_ptrs,           \
                                    out_strides, sizes, region, geom, t,     \
                                    stream);                                 \
  }
