// Recombination trips of the SMC' particle filter: a group of lanes per
// particle, the particle's tree in shared memory.
//
// Replaces the Pallas TPU kernel smcsmc_tpu/kernels/pallas_trip.py
// (_trip_kernel, entered through fused_trip).  Two entry points share one
// __device__ trip:
//
//   trip          up to T trips per particle on pre-drawn uniforms
//                 [T, P, 4], state updated in place, inactive particles
//                 untouched.  Held against kernels/trip.py::trip_plain.
//   segment_pass  a segment's whole tree pass in one launch: tree summaries
//                 (tl, tl_e, B) from the trees alone, all trips, the final
//                 extension to the segment end and the push of the
//                 segment's statistics into FIFO slot 0.  The per-particle
//                 `upd` and `pending` never reach device memory.  Held
//                 against kernels/trip.py::segment_pass_plain.
//
// What bounds it on Hopper: launch and latency, neither bytes nor FLOPs.
// At the sweep's shape (10,000 particles, 4 leaves, 9 epochs, about one
// particle in ten recombining in a mean segment) `trip` has to move about
// 0.8 MB and `segment_pass` about 2 MB (every tree read once, and of the
// FIFO row only the statistics that are not zero: one gated row of
// recombination opportunity for a particle that does not recombine), i.e.
// 0.25 us and 0.6 us at 3.35 TB/s, with under 0.1 us of float32
// arithmetic; an empty launch alone takes longer.  What the kernel spends
// is the dependent chain of one particle's trip.
//
// What the design does about it:
//
// * A group of GROUP = 8 lanes owns one particle (8 was fastest at the
//   sweep's shape, against 16 and 32); consecutive groups own consecutive
//   particles, so a block's loads of the [P, N] rows are contiguous.  What
//   is indexed by a value (node times, parent and child pointers for the
//   SPR), the per-epoch tree length and, for segment_pass, the pending
//   statistics live in the group's slice of shared memory, padded to an
//   odd stride so that groups of one warp hit different banks.
// * Every lane keeps the particle's node and parent times in registers,
//   padded to 7 or 15 nodes (a template argument) so that every loop over
//   nodes is unrolled and nothing is indexed dynamically: no stack frame.
//   They are reloaded from shared memory after each SPR.
// * The (epoch x node) sums are split over the lanes by epoch; O(N) steps
//   are computed redundantly by every lane, which keeps the scalars
//   (next_rec, upd, log_w, tl, B) identical in all lanes without
//   broadcasts; "first true in node order" is an unrolled scan; the SPR
//   pointer surgery is done by lane 0 on shared memory, which no other lane
//   reads during a trip, followed by one group sync.
// * The hazard is inverted over sorted breakpoints instead of evaluating
//   lam(v) on the whole grid for every candidate v: epoch starts are sorted
//   already, so one pass gives each epoch's full hazard mass
//   full_e = sum_j |branch_j ∩ epoch_e ∩ [h_r, inf)|, a running sum finds
//   the epoch e* in which lam crosses x_exp, and only the node times inside
//   e* are evaluated: O(E*N/GROUP + E + N*N/GROUP) per trip instead of
//   O((N+E)*E*N).  The same full_e serve as the coalescence opportunity of
//   every epoch that ends below t_c.  This sums in another order than the
//   plain version, so t_c can differ in its last bits.
// * All particles fit on the card at once (GROUP * P threads), so a launch
//   lasts as long as its longest chain of trips; the next trip's uniforms
//   are loaded while the current trip runs.
//
// Semantics kept from the plain version: INF = 3e38 arithmetic, the uniform
// clip to [1e-7, 1 - 1e-7], first-true selection in node order, the d_eff
// remap, the 0.99*INF clamp, B for mixed data as data_branch_length, the
// gap from the refreshed tree length.  Built with -fmad=false so that each
// product and sum rounds as the plain version's separate operations do.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LEAVES 8
#define MAX_NODES (2 * MAX_LEAVES - 1)
#define MAX_EPOCHS 64
#define BLOCK 128
#define GROUP 8  // lanes that share one particle; divides 32
#define BIG 3e38f

namespace {

struct Args {
  // both entry points
  const float* uniforms;  // [trips, P, 4]
  int trips, P, n, E, leaf_status;
  float* time;  // [P, N]
  int* parent;
  int* child0;
  int* child1;
  float* next_rec;  // [P]
  float* log_w;     // [P]
  float L, mu, rho;
  const float* epoch_start;  // [E]
  const float* inv2ne;       // [E]
  const unsigned char* has_data;  // [n]
  // trip
  float* upd;      // [P]
  float* tl;       // [P]
  float* B;        // [P], may alias tl (complete data)
  float* tl_e;     // [P, E]
  float* pending;  // [P, 6E]
  // segment_pass
  float* fifo;  // [P, F, 6E]; slot 0 of each particle is updated
  long long fifo_stride;    // F * 6E
  const float* fifo_mask;   // [6E]
  float* tl_out;            // [P] post-trip tree length
};

// per-block tables in shared memory, and the launch's scalars
struct Tables {
  const float* est;
  const float* eend;
  const float* i2n;
  const int* hd;
  const float* gate;  // [6E] FIFO gate (segment_pass)
  int n, N, E, total_data, leaf_status;
  float L, mu, rho;
};

// one particle's slice of shared memory: what is indexed by a value
struct Work {
  float* t;     // [N] node times
  int* par;     // [N]
  int* c0;      // [N]
  int* c1;      // [N]
  int* below;   // [N] bit l set: data leaf l hangs below the node
  float* tle;   // [E] tree length per epoch
  float* full;  // [E] hazard mass of each epoch above h_r
};

// one particle's node and parent times in registers, padded to NP nodes
// (7 for up to 4 leaves, 15 for up to 8); every loop over them is unrolled.
// The root has pt == BIG; a padded node has t == pt == BIG, so that it has
// no branch length, overlaps nothing and crosses no time.
template <int NP>
struct Heights {
  float t[NP];
  float pt[NP];
};

__host__ __device__ inline int tables_words(int E, bool with_gate) {
  return 3 * E + MAX_LEAVES + (with_gate ? 6 * E : 0);
}

__host__ __device__ inline int work_words(int N, int E, bool with_pending) {
  return (5 * N + 2 * E + (with_pending ? 6 * E : 0)) | 1;  // odd stride
}

__device__ __forceinline__ float clip_u(float u) {
  return fminf(fmaxf(u, 1e-7f), (float)(1.0 - 1e-7));
}

__device__ __forceinline__ unsigned group_mask() {
  return ((1u << GROUP) - 1u) << ((threadIdx.x & 31) & ~(GROUP - 1));
}

__device__ __forceinline__ float group_max(float v, unsigned gm) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(gm, v, off));
  return v;
}

// every lane ends with the same bits: each step adds the same two values
__device__ __forceinline__ float group_sum(float v, unsigned gm) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(gm, v, off);
  return v;
}

// Block-wide: the epoch tables (and, for segment_pass, the FIFO gate) on
// their way into shared memory.  No barrier here: the caller starts its own
// loads too, so that all of them are in flight together, and then calls
// __syncthreads().
__device__ void stage_tables(const Args& a, float* smem, bool with_gate) {
  const int E = a.E;
  float* s_est = smem;
  float* s_eend = smem + E;
  float* s_i2n = smem + 2 * E;
  int* s_hd = reinterpret_cast<int*>(smem + 3 * E);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    s_est[e] = a.epoch_start[e];
    s_eend[e] = (e + 1 < E) ? a.epoch_start[e + 1] : BIG;
    s_i2n[e] = a.inv2ne[e];
  }
  for (int l = threadIdx.x; l < MAX_LEAVES; l += blockDim.x)
    s_hd[l] = (l < a.n && a.has_data[l] != 0) ? 1 : 0;
  if (with_gate) {
    float* s_gate = smem + 3 * E + MAX_LEAVES;
    for (int k = threadIdx.x; k < 6 * E; k += blockDim.x)
      s_gate[k] = a.fifo_mask[k];
  }
}

// After the barrier that follows stage_tables.
__device__ void bind_tables(const Args& a, float* smem, Tables& tb) {
  const int E = a.E;
  tb.est = smem;
  tb.eend = smem + E;
  tb.i2n = smem + 2 * E;
  tb.hd = reinterpret_cast<const int*>(smem + 3 * E);
  tb.gate = smem + 3 * E + MAX_LEAVES;
  tb.n = a.n;
  tb.N = 2 * a.n - 1;
  tb.E = E;
  tb.total_data = 0;
  for (int l = 0; l < a.n; ++l) tb.total_data += tb.hd[l];
  tb.leaf_status = a.leaf_status;
  tb.L = a.L;
  tb.mu = a.mu;
  tb.rho = a.rho;
}

// Carve this group's slice of shared memory (`pend` is only there for
// segment_pass).  Returns the particle index of the calling thread's group.
__device__ int carve(const Args& a, float* smem, bool segment, Work& w,
                     float*& pend) {
  const int E = a.E, N = 2 * a.n - 1;
  const int group = threadIdx.x / GROUP;
  float* base = smem + tables_words(E, segment)
      + (size_t)group * work_words(N, E, segment);
  w.t = base;
  w.par = reinterpret_cast<int*>(base + N);
  w.c0 = reinterpret_cast<int*>(base + 2 * N);
  w.c1 = reinterpret_cast<int*>(base + 3 * N);
  w.below = reinterpret_cast<int*>(base + 4 * N);
  w.tle = base + 5 * N;
  w.full = base + 5 * N + E;
  pend = base + 5 * N + 2 * E;
  return blockIdx.x * (blockDim.x / GROUP) + group;
}

__device__ void load_tree(const Args& a, const Work& w, int i, int N,
                          int lane) {
  for (int j = lane; j < N; j += GROUP) {
    w.t[j] = a.time[(size_t)i * N + j];
    w.par[j] = a.parent[(size_t)i * N + j];
    w.c0[j] = a.child0[(size_t)i * N + j];
    w.c1[j] = a.child1[(size_t)i * N + j];
  }
}

__device__ void store_tree(const Args& a, const Work& w, int i, int N,
                           int lane) {
  for (int j = lane; j < N; j += GROUP) {
    a.time[(size_t)i * N + j] = w.t[j];
    a.parent[(size_t)i * N + j] = w.par[j];
    a.child0[(size_t)i * N + j] = w.c0[j];
    a.child1[(size_t)i * N + j] = w.c1[j];
  }
}

// Node and parent times of the tree in shared memory into registers.  The
// group must be synchronised after the last write to w.t / w.par.
template <int NP>
__device__ __forceinline__ void load_heights(const Work& w, int N,
                                             Heights<NP>& h) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j < N) {
      const int p = w.par[j];
      h.t[j] = w.t[j];
      h.pt[j] = p < 0 ? BIG : w.t[p];
    } else {
      h.t[j] = BIG;
      h.pt[j] = BIG;
    }
  }
}

// Tree summaries from the heights in registers: tree length per epoch
// (w.tle, each lane its own epochs), tree length, data branch length.
// Every lane returns the same tl and B.  For mixed data the group must be
// synchronised on entry (w.par is read across lanes).
template <int NP>
__device__ void summaries(const Tables& tb, const Work& w,
                          const Heights<NP>& h, int lane, unsigned gm,
                          float& tl, float& B) {
  const int E = tb.E;
  if (tb.leaf_status == 0) {
    for (int j = lane; j < tb.N; j += GROUP) w.below[j] = 0;
    __syncwarp(gm);
    // each data leaf marks itself on its ancestor chain
    for (int l = lane; l < tb.n; l += GROUP) {
      if (!tb.hd[l]) continue;
      int cur = l;
      for (int s = 0; s < tb.n && cur >= 0; ++s) {
        atomicOr(&w.below[cur], 1 << l);
        cur = w.par[cur];
      }
    }
    __syncwarp(gm);
  }
  float mine = 0.0f;
  for (int e = lane; e < E; e += GROUP) {
    const float lo_e = tb.est[e], hi_e = tb.eend[e];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (h.pt[j] < BIG)  // not the root's lineage, not padding
        s += fmaxf(fminf(h.pt[j], hi_e) - fmaxf(h.t[j], lo_e), 0.0f);
    w.tle[e] = s;
    mine += s;
  }
  tl = group_sum(mine, gm);
  if (tb.leaf_status == 1) {
    B = tl;
  } else if (tb.leaf_status == -1) {
    B = 0.0f;
  } else {
    // informative branches: at least one and not all data leaves below
    float b = 0.0f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j < tb.N && h.pt[j] < BIG) {
        const int cnt = __popc(w.below[j]);
        if (cnt >= 1 && cnt < tb.total_data) b += h.pt[j] - h.t[j];
      }
    }
    B = b;
  }
}

// sum_j |branch_j ∩ [lo, hi_e) ∩ (-inf, v]|
template <int NP>
__device__ __forceinline__ float overlap_below(const Heights<NP>& h, float lo,
                                               float hi_e, float v) {
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    s += fmaxf(fminf(fminf(h.pt[j], hi_e), v) - fmaxf(h.t[j], lo), 0.0f);
  return s;
}

// One trip of the particle in `w` / `h`.  Called by all lanes of a
// synchronised group with identical scalars and heights, w.tle up to date;
// returns the same way.  `pend` ([6E], shared or global) takes the trip's
// statistics.
template <int NP>
__device__ void one_trip(const Tables& tb, const Work& w, Heights<NP>& h,
                         int lane, unsigned gm, const float4 u, float* pend,
                         float& nr, float& up, float& lw, float& tl,
                         float& B) {
  const int N = tb.N, E = tb.E;
  const float u_pt = clip_u(u.x), u_exp = clip_u(u.y);
  const float u_tgt = clip_u(u.z), u_gap = clip_u(u.w);

  // ---- extension: no-mutation likelihood + recombination opportunity ----
  const float delta = nr - up;
  lw = lw - tb.mu * B * delta;

  // ---- recombination point: first node whose prefix sum >= u*total ------
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    total += h.pt[j] < BIG ? h.pt[j] - h.t[j] : 0.0f;
  const float x_pt = u_pt * total;
  int c = -1;
  float prev = 0.0f, cum = 0.0f, t_cut = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const float bl = h.pt[j] < BIG ? h.pt[j] - h.t[j] : 0.0f;
    cum += bl;
    if (j < N && c < 0 && cum >= x_pt) {
      c = j;
      prev = cum - bl;
      t_cut = h.t[j];
    }
  }
  const float h_r = t_cut + (x_pt - prev);

  // ---- SMC' hazard inversion -------------------------------------------
  // lam(v) = sum_{e,j} inv2ne_e * |branch_j ∩ epoch_e ∩ [h_r, v]| is
  // piecewise linear and non-decreasing in v.  full_e is epoch e's whole
  // contribution; the running sum over epochs is lam at each epoch start.
  const float x_exp = -log1pf(-u_exp);
  for (int e = lane; e < E; e += GROUP)
    w.full[e] = overlap_below<NP>(h, fmaxf(tb.est[e], h_r), tb.eend[e], BIG);
  __syncwarp(gm);
  int es = 0;        // last epoch whose start has lam <= x_exp
  float base = 0.0f; // lam at that epoch's start
  {
    float run = 0.0f;
    for (int e = 0; e < E; ++e) {
      if (!(run <= x_exp)) break;
      es = e;
      base = run;
      run += w.full[e] * tb.i2n[e];
    }
  }
  const float lo_s = fmaxf(tb.est[es], h_r), hi_s = tb.eend[es];
  const float i2n_s = tb.i2n[es];
  // node times inside epoch e* are the remaining candidates; lane l takes
  // nodes l, l + GROUP, ...
  float best = -BIG;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    if (i % GROUP == lane) {
      const float v = h.t[i];
      if (v >= lo_s && v < hi_s) {
        const float lam = base + overlap_below<NP>(h, lo_s, hi_s, v) * i2n_s;
        if (lam <= x_exp) best = fmaxf(best, v);
      }
    }
  }
  const float t_lo = fmaxf(group_max(best, gm), lo_s);
  const float lam_lo = base + overlap_below<NP>(h, lo_s, hi_s, t_lo) * i2n_s;
  float k_lo = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    k_lo += (h.t[j] <= t_lo && t_lo < h.pt[j]) ? 1.0f : 0.0f;
  const float rate_lo = k_lo * i2n_s;
  float t_c = t_lo + (rate_lo > 0.0f
                          ? (x_exp - lam_lo) / fmaxf(rate_lo, 1e-30f) : BIG);
  t_c = fminf(t_c, (float)(0.99 * 3e38));

  // ---- coalescence target: the r-th branch crossing t_c -----------------
  float kc = 0.0f;
#pragma unroll
  for (int j = 0; j < NP; ++j)
    kc += (h.t[j] <= t_c && t_c < h.pt[j]) ? 1.0f : 0.0f;
  const int r = (int)floorf(u_tgt * fmaxf(kc, 1.0f));
  int d = -1, seen = -1;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (h.t[j] <= t_c && t_c < h.pt[j]) {
      ++seen;
      if (d < 0 && seen == r) d = j;
    }
  }

  // ---- opportunity / count records --------------------------------------
  // layout: [coal_opp | coal_cnt | mig_opp | mig_cnt | recomb_opp |
  //          recomb_cnt], E columns each
  for (int e = lane; e < E; e += GROUP) {
    const float st_e = tb.est[e], hi_e = tb.eend[e];
    const float lo_e = fmaxf(st_e, h_r);
    float coal_opp;
    if (hi_e <= t_c)
      coal_opp = w.full[e];  // no branch of the epoch is cut at t_c
    else if (lo_e >= t_c)
      coal_opp = 0.0f;
    else
      coal_opp = overlap_below<NP>(h, lo_e, hi_e, t_c);
    const float span = fmaxf(fminf(hi_e, t_c) - lo_e, 0.0f);
    const bool in_c = t_c >= st_e && t_c < hi_e;
    const bool in_r = h_r >= st_e && h_r < hi_e;
    pend[e] += coal_opp;
    pend[E + e] += in_c ? 1.0f : 0.0f;
    pend[2 * E + e] += span;
    pend[4 * E + e] += delta * w.tle[e];
    pend[5 * E + e] += in_r ? 1.0f : 0.0f;
  }

  // ---- SPR: cut the branch above c, regraft onto d at t_c ---------------
  // pick(x, idx) reads 0 for idx < 0, and writes to idx < 0 are dropped,
  // as in the reference's one-hot index algebra.  Nothing else reads the
  // tree in shared memory during a trip, so lane 0 edits it alone.
  if (lane == 0) {
#define PICK(arr, idx) ((idx) >= 0 ? (arr)[(idx)] : 0)
    const int p = PICK(w.par, c);
    const int sib0 = PICK(w.c0, p), sib1 = PICK(w.c1, p);
    const int o = sib0 == c ? sib1 : sib0;
    const int g = PICK(w.par, p);
    const bool noop = d == c;
    const int d_eff = d == p ? o : d;
    const int gp = d_eff == o ? g : PICK(w.par, d_eff);
#undef PICK
    if (!noop) {
      if (o >= 0) w.par[o] = g;
      if (d_eff >= 0) w.par[d_eff] = p;
      if (p >= 0) w.par[p] = gp;
      if (g >= 0) {
        if (w.c0[g] == p) w.c0[g] = o;
        if (w.c1[g] == p) w.c1[g] = o;
      }
      if (p >= 0) {
        w.c0[p] = c;
        w.c1[p] = d_eff;
      }
      if (gp >= 0) {
        if (w.c0[gp] == d_eff) w.c0[gp] = p;
        if (w.c1[gp] == d_eff) w.c1[gp] = p;
      }
      if (p >= 0) w.t[p] = t_c;
    }
  }
  __syncwarp(gm);

  // ---- refreshed tree summaries, then the next gap ----------------------
  load_heights<NP>(w, N, h);
  summaries<NP>(tb, w, h, lane, gm, tl, B);
  const float gap = -log1pf(-u_gap) / fmaxf(tb.rho * tl, 1e-30f);
  up = nr;
  nr = nr + gap;
}

__device__ __forceinline__ float4 load_uniforms(const Args& a, int k, int i) {
  return *reinterpret_cast<const float4*>(a.uniforms
                                          + ((size_t)k * a.P + i) * 4);
}

template <int NP>
__global__ void __launch_bounds__(BLOCK) trip_kernel(const Args a) {
  extern __shared__ float smem[];
  Work w;
  float* unused;
  const int i = carve(a, smem, false, w, unused);
  const int lane = threadIdx.x % GROUP;
  const unsigned gm = group_mask();
  const int N = 2 * a.n - 1, E = a.E;

  // the tables, next_rec and then the rows of an active particle are all
  // under way before the one barrier
  float nr = i < a.P ? a.next_rec[i] : BIG;
  stage_tables(a, smem, false);
  const bool active = nr < a.L;  // else every output stays as it is
  float up = 0.0f, lw = 0.0f, tl = 0.0f, B = 0.0f;
  if (active) {
    load_tree(a, w, i, N, lane);
    for (int e = lane; e < E; e += GROUP)
      w.tle[e] = a.tl_e[(size_t)i * E + e];
    up = a.upd[i], lw = a.log_w[i], tl = a.tl[i], B = a.B[i];
  }
  __syncthreads();
  if (!active) return;
  Tables tb;
  bind_tables(a, smem, tb);
  float* pend = a.pending + (size_t)i * 6 * E;
  Heights<NP> h;
  load_heights<NP>(w, N, h);

  float4 u = load_uniforms(a, 0, i);
  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    // the next trip's uniforms are under way while this trip runs
    const float4 u_next = k + 1 < a.trips ? load_uniforms(a, k + 1, i) : u;
    one_trip<NP>(tb, w, h, lane, gm, u, pend, nr, up, lw, tl, B);
    u = u_next;
  }

  store_tree(a, w, i, N, lane);
  for (int e = lane; e < E; e += GROUP)
    a.tl_e[(size_t)i * E + e] = w.tle[e];
  if (lane == 0) {
    a.next_rec[i] = nr;
    a.upd[i] = up;
    a.log_w[i] = lw;
    a.tl[i] = tl;
    a.B[i] = B;
  }
}

template <int NP>
__global__ void __launch_bounds__(BLOCK) segment_pass_kernel(const Args a) {
  extern __shared__ float smem[];
  Work w;
  float* pend;
  const int i = carve(a, smem, true, w, pend);
  const int lane = threadIdx.x % GROUP;
  const unsigned gm = group_mask();
  const int N = 2 * a.n - 1, E = a.E, K = 6 * a.E;

  // the tables, the gate and the particle's rows are all under way before
  // the one barrier, which also publishes the tree and the zeroed pend
  const bool live = i < a.P;
  float nr = 0.0f, lw = 0.0f, up = 0.0f;
  stage_tables(a, smem, true);
  if (live) {
    load_tree(a, w, i, N, lane);
    for (int k = lane; k < K; k += GROUP) pend[k] = 0.0f;
    nr = a.next_rec[i], lw = a.log_w[i];
  }
  __syncthreads();
  if (!live) return;
  Tables tb;
  bind_tables(a, smem, tb);
  Heights<NP> h;
  load_heights<NP>(w, N, h);
  float tl, B;
  summaries<NP>(tb, w, h, lane, gm, tl, B);  // at segment entry

  bool moved = false;
  float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.trips > 0 && nr < a.L) u = load_uniforms(a, 0, i);
  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    // the next trip's uniforms are under way while this trip runs
    const float4 u_next = k + 1 < a.trips ? load_uniforms(a, k + 1, i) : u;
    one_trip<NP>(tb, w, h, lane, gm, u, pend, nr, up, lw, tl, B);
    u = u_next;
    moved = true;
  }

  // ---- final extension to the segment end -------------------------------
  const float delta = a.L - up;
  lw = lw - a.mu * B * delta;
  for (int e = lane; e < E; e += GROUP) pend[4 * E + e] += delta * w.tle[e];
  nr = nr - a.L;
  __syncwarp(gm);

  // ---- push the segment's statistics into FIFO slot 0 -------------------
  float* slot = a.fifo + (size_t)i * a.fifo_stride;
  for (int k = lane; k < K; k += GROUP) {
    const float v = pend[k] * tb.gate[k];
    if (v != 0.0f) slot[k] += v;
  }

  if (moved) store_tree(a, w, i, N, lane);  // only rows that changed
  if (lane == 0) {
    a.next_rec[i] = nr;
    a.log_w[i] = lw;
    a.tl_out[i] = tl;
  }
}

__global__ void noop_kernel() {}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Args& a, dim3 grid, size_t bytes,
                  cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, BLOCK, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NP>
int launch(const Args& a, bool segment, cudaStream_t stream) {
  const int N = 2 * a.n - 1;
  const int per_block = BLOCK / GROUP;
  const size_t bytes = sizeof(float)
      * ((size_t)tables_words(a.E, segment)
         + (size_t)per_block * work_words(N, a.E, segment));
  const dim3 grid((unsigned)((a.P + per_block - 1) / per_block));
  if (segment)
    return launch_kernel(segment_pass_kernel<NP>, a, grid, bytes, stream);
  return launch_kernel(trip_kernel<NP>, a, grid, bytes, stream);
}

int dispatch(const Args& a, bool segment, void* stream) {
  if (a.n < 2 || a.n > MAX_LEAVES || a.E < 1 || a.E > MAX_EPOCHS
      || a.trips < 0)
    return (int)cudaErrorInvalidValue;
  if (a.P <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return a.n <= 4 ? launch<7>(a, segment, s)
                  : launch<MAX_NODES>(a, segment, s);
}

}  // namespace

extern "C" int smc_trip_launch(
    const float* uniforms, int trips, int P, int n, int E, int leaf_status,
    float* time, int* parent, int* child0, int* child1, float* next_rec,
    float* upd, float* log_w, float* tl, float* B, float* tl_e,
    float* pending, float L, float mu, float rho, const float* epoch_start,
    const float* inv2ne, const unsigned char* has_data, void* stream) {
  if (trips < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.uniforms = uniforms;
  a.trips = trips;
  a.P = P;
  a.n = n;
  a.E = E;
  a.leaf_status = leaf_status;
  a.time = time;
  a.parent = parent;
  a.child0 = child0;
  a.child1 = child1;
  a.next_rec = next_rec;
  a.log_w = log_w;
  a.L = L;
  a.mu = mu;
  a.rho = rho;
  a.epoch_start = epoch_start;
  a.inv2ne = inv2ne;
  a.has_data = has_data;
  a.upd = upd;
  a.tl = tl;
  a.B = B;
  a.tl_e = tl_e;
  a.pending = pending;
  return dispatch(a, false, stream);
}

extern "C" int smc_segment_pass_launch(
    const float* uniforms, int trips, int P, int n, int E, int F,
    int leaf_status, float* time, int* parent, int* child0, int* child1,
    float* next_rec, float* log_w, float* fifo, const float* fifo_mask,
    float* tl_out, float L, float mu, float rho, const float* epoch_start,
    const float* inv2ne, const unsigned char* has_data, void* stream) {
  if (F < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.uniforms = uniforms;
  a.trips = trips;
  a.P = P;
  a.n = n;
  a.E = E;
  a.leaf_status = leaf_status;
  a.time = time;
  a.parent = parent;
  a.child0 = child0;
  a.child1 = child1;
  a.next_rec = next_rec;
  a.log_w = log_w;
  a.L = L;
  a.mu = mu;
  a.rho = rho;
  a.epoch_start = epoch_start;
  a.inv2ne = inv2ne;
  a.has_data = has_data;
  a.fifo = fifo;
  a.fifo_stride = (long long)F * 6 * E;
  a.fifo_mask = fifo_mask;
  a.tl_out = tl_out;
  return dispatch(a, true, stream);
}

// An empty launch, for timing what any launch costs on the card.
extern "C" int smc_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* smc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
