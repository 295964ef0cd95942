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
//                 A compile-time variant (BIAS) is the biased pass: the
//                 point is drawn height-biased over the [N, S] weighted
//                 segments (transition.py:160 of the JAX package), the
//                 posterior weight takes log_iw, the pilot weight tracks the
//                 extension and the immediate part, the delayed part goes
//                 into the particle's ring of delayed factors (smc.py:488,
//                 :968-1020), and after the final extension the factors due
//                 at front + L are applied to the pilot (smc.py:540).  The
//                 ring (32 slots of 4 words) lives in the group's slice of
//                 shared memory, slot k handled by lane k % GROUP alone (so
//                 no lane reads another's slots): every particle reads the
//                 slots' positions (what is due, what is free), a slot's
//                 other words are read only where the drain applies it, and
//                 only slots pushed or applied are written back.  The point
//                 is weighed by lanes (each its nodes' segments) into the
//                 slice, summed in node-major order as one chain, and
//                 searched by lanes; the delay's epoch comes from the
//                 trip's per-epoch records.  The section table and the
//                 delays sit beside the epoch tables.  On an H100 at the
//                 genome path's shape: 96 registers, 5 resident blocks per
//                 SM (BIAS_MIN_BLOCKS holds them at n <= 4 too), so 10,000
//                 particles run in one wave.
//                 Two more compile-time variants ride on these.  GUIDE (the
//                 biased pass only: a guide without height bias is one
//                 section of strength 1) follows a recombination guide
//                 (smc.py:783-812, transition.py:124-221 of the JAX
//                 package): each extension takes the guide's survival
//                 weight in both weights, the point's segments are weighed
//                 by each branch's guide rate (the leaves' rates at the
//                 event's window, merged bottom up by lane 0 over the tree
//                 in shared memory), and the gap is drawn in guide mass
//                 through a binary search of the chunk's mass table.  What
//                 bounds the guide is the latency of its dependent loads
//                 (a few hundred cycles each from device memory on an
//                 H100), so each block stages in shared memory the pivots
//                 of the search's first nine steps (kernels/guide.py's
//                 search_pivots, a copy by node of its decision tree: the
//                 search's own path and values); each position's mass is
//                 looked up once, and the leaves' rates are under way
//                 with it.
//                 LOCAL (plain or biased) pushes each trip's local
//                 recombination event (position, due position, height, the
//                 cut branch's leaves from a ballot over the tree before
//                 the SPR) into the particle's ring in device memory, the
//                 first free slot of a mask read once per segment, a full
//                 ring counted by one integer atomic per particle; and it
//                 writes the segment's ungated recombination opportunity.
//                 What it adds is latency on each trip's serial chain and
//                 at entry, so each leaf's lane walks its path to the root
//                 at the trip's start (a mask, as ARG does below) and the
//                 leaves below c are bit tests and one ballot; the plain
//                 pass reads its ring after the block's barrier, under way
//                 with the first trip's uniforms, and sums the opportunity
//                 in the final extension's loop (same order).  The guided
//                 local pass and the biased one above 4 leaves keep the
//                 walk to c, and the biased ones the read before the
//                 barrier: those were slower there, timed in turns (a path
//                 or the ring's positions held in registers at the
//                 96-register cap).
//                 Without GUIDE and LOCAL each pass is the code it was.
//                 ARG (the plain and biased passes, the migration pass and
//                 the wide plain pass) records the genealogy for -arg
//                 (smc.py:1021-1052 of the JAX package, which runs it
//                 through XLA): each trip pushes an R row (position, h_r,
//                 the leaves below c) and a C row (t_c, the coalescence's
//                 population, the leaves below c or d), the migration pass
//                 an M row for each of the walk's first ARG_MIG_ROWS hops,
//                 into slot arg_n % A of the particle's ring in device
//                 memory.  A row is 19 bytes, so what the ARG costs is its
//                 place on each trip's serial chain before the SPR.  In
//                 the narrow and migration passes each leaf's lane walks
//                 its path to the root at the trip's start (a mask of
//                 nodes, the walk unrolled and under way with the point
//                 and the hazard; the tree changes only in the SPR), so
//                 the leaves below c and d are bit tests and one ballot
//                 (two at 5-8 leaves in the narrow passes: one lane per
//                 leaf and node tested); lane r writes row r, so that a
//                 warp issues one store per field and adjacent slots share
//                 a sector, before the SPR in the narrow passes and at the
//                 trip's end in the migration pass (whose SPR has many
//                 warp syncs); the slot is kept beside arg_n in a register
//                 and advanced by compare and subtract (A any size; a row
//                 whose slot a later row of the trip takes is not
//                 written), the first one a mask of arg_n (a division
//                 unless A is a power of two); arg_n is written back once
//                 per segment.  The wide plain pass walks each stripe of
//                 leaves after the target and lane 0 writes the rows.
//                 Without ARG each pass is the code it was.
//                 A third variant is the migration pass (several
//                 populations; the Pallas kernel refuses migration, and the
//                 JAX package runs it through XLA, transition.py:1348):
//                 each trip's re-coalescence is the lock-step loop walk with
//                 migration (transition.py:339) on a Philox stream, and the
//                 SPR routes the branches' migration-event buffers
//                 (transition.py:1170); a warp per particle, see the
//                 section "The migration pass" below.  Held against
//                 kernels/migration.py through segment_pass_plain.
//                 Above MAX_LEAVES leaves (up to WIDE_MAX_LEAVES) trip,
//                 the plain and biased passes, the plain pass with local
//                 recording and the biased pass guided, with local
//                 recording or both (each pass with and without VB), and
//                 the plain pass's ARG variant run as the wide kernels:
//                 each lane a chunk of the nodes, every sum of a trip
//                 lane-parallel and in double; see "The wide passes".
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
#define MAX_SECTIONS 8      // bias sections
#define MAX_DELAY_SLOTS 32  // delayed factors per particle
#define MAX_LOCAL_SLOTS 32  // pending local events per particle (LOCAL)
#define MAX_POPS 4          // populations of the migration pass
#define MAX_MIG 96          // events per branch buffer (migration pass)
#define BLOCK 128
#define GROUP 8  // lanes that share one particle; divides 32
#define MIG_PPB 2  // particles (warps) per migration block
#define MIG_MIN_BLOCKS 10  // resident migration blocks per SM: <= 96 registers
#define BIAS_MIN_BLOCKS 5  // resident biased blocks per SM: 80 particles
#define GUIDE_TOP 512  // the guide's search's first 9 steps: pivots by node
#define BIG 3e38f

// VB on or off: each pass has a compile-time variant with VB and one
// without, so that the pass without VB is the code it was before VB.

// The library is built from this file as five units compiled side by
// side (kernels/_build.py) and linked: SMC_PART 1 instantiates the wide
// kernels and defines smc_wide_dispatch, SMC_PART 4 the wide guided and
// local kernels and smc_wide_proposal_dispatch, SMC_PART 2 and 3 the
// migration pass's kernels without and with VB and smc_mig_dispatch /
// smc_mig_vb_dispatch, SMC_PART 0 everything else.  Without SMC_PART one
// unit holds all (the host rehearsal).
#if !defined(SMC_PART) || SMC_PART == 0
#define SMC_NARROW 1
#else
#define SMC_NARROW 0
#endif
#if !defined(SMC_PART) || SMC_PART == 1
#define SMC_WIDE 1
#else
#define SMC_WIDE 0
#endif
#if !defined(SMC_PART) || SMC_PART == 2
#define SMC_MIG 1
#else
#define SMC_MIG 0
#endif
#if !defined(SMC_PART) || SMC_PART == 3
#define SMC_MIG_VB 1
#else
#define SMC_MIG_VB 0
#endif
#if !defined(SMC_PART) || SMC_PART == 4
#define SMC_WIDE_PROP 1
#else
#define SMC_WIDE_PROP 0
#endif

// a wide kernel for the run-time flags (args: an Args), launched on
// `stream` (res == nullptr) or asked for its resources
extern "C" int smc_wide_dispatch(const void* args, int segment, int biased,
                                 int vb, int arg, void* stream, int* res);
// a wide guided or local kernel (the segment pass: biased with guide
// and/or local recording, or plain with local recording), launched on
// `stream` (res == nullptr) or asked for its resources
extern "C" int smc_wide_proposal_dispatch(const void* args, int biased,
                                          int vb, int guide, int local,
                                          void* stream, int* res);
// a kernel of the migration pass for the run-time flags (args: an Args;
// arg: the ARG variant; bias, guide, local: a proposal variant), launched
// with `blocks` blocks of `ppb` particles and `bytes` of shared memory on
// `stream` (res == nullptr) or asked for its resources; the VB variants by
// smc_mig_vb_dispatch
extern "C" int smc_mig_dispatch(const void* args, int vb, int arg, int bias,
                                int guide, int local, unsigned blocks,
                                size_t bytes, int ppb, void* stream,
                                int* res);
extern "C" int smc_mig_vb_dispatch(const void* args, int arg, int bias,
                                   int guide, int local, unsigned blocks,
                                   size_t bytes, int ppb, void* stream,
                                   int* res);

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
  // the biased segment_pass (log_pilot == nullptr: the plain one)
  float* log_pilot;              // [P]
  float* df_pos;                 // [P, K] ring: next application (BIG: free)
  float* df_logf;                // [P, K] log factor per application
  float* df_delta;               // [P, K] spacing
  int* df_k;                     // [P, K] applications left
  const float* bias_heights;     // [S + 1]: 0, h_1, ..., BIG
  const float* bias_strengths;   // [S]
  const float* delays;           // [E] application delay by epoch
  int K, S, delay_type, delay_k;  // delay_type 0: keyed off h_r, 1: t_c
  float front;                   // the segment's start
  // the migration segment_pass (pop == nullptr: another pass)
  int* pop;               // [P, N] population at each node's time
  float* mig_time;        // [P, N, Mw] branch events, ascending, BIG-padded
  int* mig_dest;          // [P, N, Mw] their destinations, 0-padded
  double* diag;           // [2] walks capped, events dropped
  const int* key;         // [2] the segment's Philox key
  const float* ne;        // [E, Pp]
  const float* mig;       // [E, Pp, Pp]
  const float* tot_mig;   // [E, Pp]
  const int* pop_map;     // [E, Pp]
  int Pp, Mw, max_events;
  // VB (nullptr: off): each trip adds to log_w (and to the biased pass's
  // pilot) the table entry of every coalescence and migration it records,
  // psi(C) - log(C) of the previous iteration's counts, 0 in -xc epochs
  const float* vb_coal;  // [E, Pp]
  const float* vb_mig;   // [E, Pp, Pp] (the migration pass)
  // the recombination guide (g_rel == nullptr: off), the biased pass only
  const float* g_rel;     // [Wg] rate relative to rho by window
  const float* cum_mass;  // [Wg + 1] guide mass (bp) at window boundaries
  const float* g_leaf;    // [Wg, n] relative rate of each leaf
  const float* g_top;     // [GUIDE_TOP] the search's first pivots by node
  int Wg;
  float ws;               // window size (bp)
  // local recording (lr_pos == nullptr: off); the ring [P, R]
  float* lr_pos;          // event position (BIG: free slot)
  float* lr_due;          // commit position
  float* lr_time;         // recombination height
  long long* lr_desc;     // leaves below the cut branch
  int* lr_dropped;        // [] events dropped on a full ring
  const float* lags;      // [E] lag (bp) by epoch
  float* ropp;            // [P] out: the segment's ungated opportunity
  int R;
  // ARG recording (arg_pos == nullptr: off); the ring [P, A], slot
  // arg_n % A taken by each push
  float* arg_pos;          // event position
  signed char* arg_code;   // 0 R, 1 C, 2 M
  float* arg_time;         // event height
  signed char* arg_from;   // population (R: -1)
  signed char* arg_to;     // destination (M), else -1
  long long* arg_desc;     // leaves below
  int* arg_n;              // [P] rows pushed so far
  int A;
};

// per-block tables in shared memory, and the launch's scalars
struct Tables {
  const float* est;
  const float* eend;
  const float* i2n;
  const int* hd;
  const float* gate;  // [6E] FIFO gate (segment_pass)
  const float* bh;    // [S + 1] section boundaries (biased)
  const float* bs;    // [S] section strengths (biased)
  const float* dl;    // [E] delays (biased)
  const float* vb;    // [E] VB term of a coalescence by epoch (VB)
  const float* lag;   // [E] lags (LOCAL)
  const float* g_rel;     // the guide's tables, in device memory (GUIDE)
  const float* cum_mass;
  const float* g_leaf;
  // GUIDE, in shared memory: the pivots of the mass table's search by
  // node (heap order) of its first steps' decision tree [GUIDE_TOP]
  const float* g_top;
  int n, N, E, total_data, leaf_status, S, delay_type, Wg;
  float L, mu, rho, front, ws;
};

// what a trip hands back to the biased pass; key_epoch is the calling
// lane's epoch of the delay's height if that epoch is one of its own (E
// otherwise), so that the group's minimum is the epoch
struct TripEvent {
  float h_r, t_c, log_iw, strength;
  int key_epoch;
  float vb;  // the VB table entry of t_c's epoch (VB), else 0
  float liw;          // the extension's survival weight (GUIDE), else 0
  float log_iw_bias;  // the height-bias part of log_iw (GUIDE), else log_iw
};

// LOCAL: the particle's free slots (bit s: slot s), identical in all lanes,
// and its events dropped on a full ring
struct LocalRing {
  unsigned free;
  int dropped;
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
  // the biased pass's ring of delayed factors, [MAX_DELAY_SLOTS] each
  float* rpos;
  float* rlogf;
  float* rdelta;
  int* rk;
  // the biased point's scratch, [N S] each in node-major order: each
  // (node, section) segment's length and weighted length, the running sum
  float* seg;
  float* wseg;
  float* cum;
  // GUIDE: the branches' guide rates [N], the internal nodes in time order
  // [MAX_LEAVES]
  float* rate;
  int* order;
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

// guide: the guided pass's staged pivots
__host__ __device__ inline int tables_words(int E, bool with_gate,
                                            bool biased, bool vb = false,
                                            bool local = false,
                                            bool guide = false) {
  return 3 * E + MAX_LEAVES + (with_gate ? 6 * E : 0)
      + (biased ? 2 * MAX_SECTIONS + 1 + E : 0) + (vb ? E : 0)
      + (local ? E : 0) + (guide ? GUIDE_TOP : 0);
}

// S: the biased pass's sections (its point's scratch is 3 N S words; the
// guided one's rates N and order MAX_LEAVES more)
__host__ __device__ inline int work_words(int N, int E, bool with_pending,
                                          bool biased, int S,
                                          bool guide = false) {
  return (5 * N + 2 * E + (with_pending ? 6 * E : 0)
          + (biased ? 4 * MAX_DELAY_SLOTS + 3 * N * S : 0)
          + (guide ? N + MAX_LEAVES : 0)) | 1;  // odd
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

__device__ __forceinline__ int group_min(int v, unsigned gm) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(gm, v, off));
  return v;
}

__device__ __forceinline__ unsigned group_or(unsigned v, unsigned gm) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    v = v | __shfl_xor_sync(gm, v, off);
  return v;
}

// ARG: one row into `slot` of particle i's ring (the calling lane alone;
// smc.py:513 of the JAX package)
__device__ __forceinline__ void arg_put(const Args& a, int i, unsigned slot,
                                       int code, float pos, float time,
                                       int from, int to, long long desc) {
  const size_t at = (size_t)i * a.A + slot;
  a.arg_pos[at] = pos;
  a.arg_code[at] = (signed char)code;
  a.arg_time[at] = time;
  a.arg_from[at] = (signed char)from;
  a.arg_to[at] = (signed char)to;
  a.arg_desc[at] = desc;
}

// ARG: row n into slot n % A (the wide pass)
__device__ __forceinline__ void arg_push(const Args& a, int i, int n,
                                         int code, float pos, float time,
                                         int from, int to, long long desc) {
  arg_put(a, i, (unsigned)n % (unsigned)a.A, code, pos, time, from, to,
          desc);
}

// ARG (the narrow and migration passes): where the particle's next row
// goes, its rows pushed so far and their count's slot n % A, kept in step
// without a division
struct ArgCursor {
  int n;
  int slot;
};

// ARG: the slot of row n in a ring of A slots (any A > 0; a mask for a
// power of two, as the ring's 512)
__device__ __forceinline__ int arg_slot_of(int n, int A) {
  return (int)((A & (A - 1)) == 0 ? (unsigned)n & (unsigned)(A - 1)
                                  : (unsigned)n % (unsigned)A);
}

// ARG: the slot `ahead` rows after `slot` in a ring of A slots (any A > 0)
__device__ __forceinline__ int arg_slot_after(int slot, int ahead, int A) {
  int s = slot + ahead;
  while (s >= A) s -= A;
  return s;
}

// ARG: the nodes on the path from leaf `leaf` up to the root of the tree
// `par` as a mask (bit j: node j, the leaf's own bit included), 0 for
// leaf >= n.  A leaf's path holds at most n <= (NP + 1) / 2 nodes, so the
// walk is unrolled, its loads with no loop test between them.
template <int NP>
__device__ __forceinline__ unsigned leaf_path(const int* par, int leaf,
                                              int n) {
  int cur = leaf < n ? leaf : -1;
  unsigned path = 0u;
#pragma unroll
  for (int s = 0; s < (NP + 1) / 2; ++s) {
    if (cur >= 0) {
      path |= 1u << cur;
      cur = s + 1 < (NP + 1) / 2 ? par[cur] : -1;
    }
  }
  return path;
}

// A 4-byte copy from device memory into shared memory, under way until
// the calling thread's wait_copies(); nothing may touch dst meanwhile.
__device__ __forceinline__ void copy_word_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Block-wide: the epoch tables (and, for segment_pass, the FIFO gate; for
// the biased pass the sections and delays; for the guided pass the
// search's first pivots) on their way into shared memory.  No barrier
// here: the caller starts its own loads too, so that all of them are in
// flight together, and then calls __syncthreads().
__device__ void stage_tables(const Args& a, float* smem, bool with_gate,
                             bool biased, bool vb = false,
                             bool local = false, bool guide = false) {
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
  if (biased) {
    float* s_bh = smem + 3 * E + MAX_LEAVES + 6 * E;
    float* s_bs = s_bh + MAX_SECTIONS + 1;
    float* s_dl = s_bs + MAX_SECTIONS;
    for (int k = threadIdx.x; k <= a.S; k += blockDim.x)
      s_bh[k] = a.bias_heights[k];
    for (int k = threadIdx.x; k < a.S; k += blockDim.x)
      s_bs[k] = a.bias_strengths[k];
    for (int e = threadIdx.x; e < E; e += blockDim.x) s_dl[e] = a.delays[e];
  }
  if (vb) {
    float* s_vb = smem + tables_words(E, with_gate, biased);
    for (int e = threadIdx.x; e < E; e += blockDim.x) s_vb[e] = a.vb_coal[e];
  }
  if (local) {
    float* s_lag = smem + tables_words(E, with_gate, biased, vb);
    for (int e = threadIdx.x; e < E; e += blockDim.x) s_lag[e] = a.lags[e];
  }
  if (guide) {
    // under way at once (the caller waits for them before its barrier)
    float* s_top = smem + tables_words(E, with_gate, biased, vb, local);
    for (int h = threadIdx.x; h < GUIDE_TOP; h += blockDim.x)
      copy_word_async(&s_top[h], &a.g_top[h]);
  }
}

// After the barrier that follows stage_tables (vb: the VB table was
// staged behind the segment pass's tables).
__device__ void bind_tables(const Args& a, float* smem, Tables& tb,
                            bool biased = false, bool vb = false,
                            bool local = false, bool guide = false) {
  const int E = a.E;
  tb.est = smem;
  tb.eend = smem + E;
  tb.i2n = smem + 2 * E;
  tb.hd = reinterpret_cast<const int*>(smem + 3 * E);
  tb.gate = smem + 3 * E + MAX_LEAVES;
  tb.bh = tb.gate + 6 * E;
  tb.bs = tb.bh + MAX_SECTIONS + 1;
  tb.dl = tb.bs + MAX_SECTIONS;
  tb.vb = vb ? smem + tables_words(E, true, biased) : nullptr;
  tb.lag = local ? smem + tables_words(E, true, biased, vb) : nullptr;
  if (guide) {
    tb.g_rel = a.g_rel;
    tb.cum_mass = a.cum_mass;
    tb.g_leaf = a.g_leaf;
    tb.Wg = a.Wg;
    tb.ws = a.ws;
    tb.g_top = smem + tables_words(E, true, biased, vb, local);
  }
  tb.front = a.front;
  tb.S = a.S;
  tb.delay_type = a.delay_type;
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
__device__ int carve(const Args& a, float* smem, bool segment, bool biased,
                     bool vb, Work& w, float*& pend, bool local = false,
                     bool guide = false) {
  const int E = a.E, N = 2 * a.n - 1;
  const int group = threadIdx.x / GROUP;
  float* base = smem + tables_words(E, segment, biased, vb, local, guide)
      + (size_t)group * work_words(N, E, segment, biased, a.S, guide);
  w.t = base;
  w.par = reinterpret_cast<int*>(base + N);
  w.c0 = reinterpret_cast<int*>(base + 2 * N);
  w.c1 = reinterpret_cast<int*>(base + 3 * N);
  w.below = reinterpret_cast<int*>(base + 4 * N);
  w.tle = base + 5 * N;
  w.full = base + 5 * N + E;
  pend = base + 5 * N + 2 * E;
  float* ring = pend + 6 * E;
  w.rpos = ring;
  w.rlogf = ring + MAX_DELAY_SLOTS;
  w.rdelta = ring + 2 * MAX_DELAY_SLOTS;
  w.rk = reinterpret_cast<int*>(ring + 3 * MAX_DELAY_SLOTS);
  w.seg = ring + 4 * MAX_DELAY_SLOTS;
  w.wseg = w.seg + N * a.S;
  w.cum = w.wseg + N * a.S;
  w.rate = w.cum + N * a.S;
  w.order = reinterpret_cast<int*>(w.rate + N);
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

// GUIDE: the window of position x, the first or last beyond the table's
// ends (the window of mass() of smc.py:792, and of the leaves' rates)
__device__ __forceinline__ int guide_window(const Tables& tb, float x) {
  return (int)fminf(fmaxf(floorf(x / tb.ws), 0.0f), (float)(tb.Wg - 1));
}

// GUIDE: the guide mass (bp) at position x in its window i, from the
// window's boundary mass and rate (mass() of smc.py:792)
__device__ __forceinline__ float guide_mass(const Tables& tb, int i,
                                            float x) {
  return tb.cum_mass[i] + (x - (float)i * tb.ws) * tb.g_rel[i];
}

__device__ __forceinline__ float guide_mass(const Tables& tb, float x) {
  return guide_mass(tb, guide_window(tb, x), x);
}

// GUIDE: the position of guide mass m (inv_mass() of smc.py:796): the last
// window boundary at or below m, by binary search of the table (every lane
// the same addresses), plus the rest at its rate.  The first steps' pivots
// come from the block's copy of them by node of the search's decision tree
// (g_top, heap order: the search's own path and values), the later ones
// from device memory.
__device__ __forceinline__ float guide_inv_mass(const Tables& tb, float m) {
  int lo = 0, hi = tb.Wg + 1;  // the first boundary above m is in [lo, hi]
  for (int h = 1; h < GUIDE_TOP && lo < hi;) {
    const int mid = (lo + hi) >> 1;
    const int right = tb.g_top[h] <= m ? 1 : 0;
    if (right)
      lo = mid + 1;
    else
      hi = mid;
    h = 2 * h + right;
  }
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tb.cum_mass[mid] <= m)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int j = min(max(lo - 1, 0), tb.Wg - 1);
  return (float)j * tb.ws
      + (m - tb.cum_mass[j]) / fmaxf(tb.g_rel[j], 1e-30f);
}

// GUIDE: the survival weight over [x0, x1) from the guide masses m0, m1 at
// its ends, rho tl (m1 - m0 - (x1 - x0)) (span_log_iw() of smc.py:809)
__device__ __forceinline__ float guide_span(const Tables& tb, float tl,
                                            float x0, float x1, float m0,
                                            float m1) {
  return tb.rho * tl * ((m1 - m0) - (x1 - x0));
}

// One trip of the particle in `w` / `h`.  Called by all lanes of a
// synchronised group with identical scalars and heights, w.tle up to date;
// returns the same way.  `pend` ([6E], shared or global) takes the trip's
// statistics.  BIAS draws the point height-biased and returns its
// importance weight (otherwise log_iw 0 and strength 1); VB returns the VB
// table entry of the coalescence's epoch (the one lane whose epoch holds
// t_c reads it, the group sums it with zeros: exact).  GUIDE (with BIAS)
// adds the extension's survival weight to lw and returns it, weighs the
// point by the branches' guide rates and draws the gap in guide mass,
// *m_up the guide mass at front + up (kept from one trip to the next);
// LOCAL pushes the trip's event into particle i's ring of `a`; ARG its R
// and C rows into the particle's ARG ring at the cursor *ac.
template <int NP, bool BIAS, bool VB = false, bool GUIDE = false,
          bool LOCAL = false, bool ARG = false>
__device__ TripEvent one_trip(const Tables& tb, const Work& w, Heights<NP>& h,
                              int lane, unsigned gm, const float4 u,
                              float* pend, float& nr, float& up, float& lw,
                              float& tl, float& B,
                              const Args* a = nullptr, int i = 0,
                              LocalRing* ring = nullptr,
                              ArgCursor* ac = nullptr,
                              float* m_up = nullptr) {
  const int N = tb.N, E = tb.E;
  const float u_pt = clip_u(u.x), u_exp = clip_u(u.y);
  const float u_tgt = clip_u(u.z), u_gap = clip_u(u.w);
  // ARG, LOCAL_PATHS: leaf `lane`'s path to the root in the tree before
  // the SPR (the tree changes only there), under way with the point and
  // the hazard; for ARG up to 4 leaves (NP 7) lane 4 + l holds leaf l's
  // too, for one ballot.  Local recording takes the paths in the plain pass
  // and in the biased one up to 4 leaves; the guided pass and the biased
  // one above walk each leaf up to c instead: a path held through their
  // trip at the 96-register cap cost them more than the walk (timed in
  // turns)
  constexpr bool LOCAL_PATHS = LOCAL && !GUIDE && (!BIAS || NP == 7);
  unsigned path = 0u;
  if constexpr (ARG)
    path = leaf_path<NP>(w.par, NP == 7 ? lane & 3 : lane, tb.n);
  if constexpr (LOCAL_PATHS) path = leaf_path<NP>(w.par, lane, tb.n);

  // ---- extension: no-mutation likelihood + recombination opportunity ----
  const float delta = nr - up;
  lw = lw - tb.mu * B * delta;
  float liw = 0.0f;
  float m_nr = 0.0f, leaf_rate = 0.0f;  // GUIDE: at the event's position
  if constexpr (GUIDE) {
    // the guide's survival weight over the extension (smc.py:903-914);
    // the mass at its start is the last trip's (*m_up), the window of its
    // end gives the mass there and lane l leaf l's rate, all under way
    // together
    const float x0 = tb.front + up, x1 = tb.front + nr;
    const int win = guide_window(tb, x1);
    if (lane < tb.n) leaf_rate = tb.g_leaf[(size_t)win * tb.n + lane];
    m_nr = guide_mass(tb, win, x1);
    liw = guide_span(tb, tl, x0, x1, *m_up, m_nr);
    lw = lw + liw;
  }

  int c = -1;
  float h_r, log_iw = 0.0f, strength = 1.0f, log_iw_bias = 0.0f;
  if constexpr (!BIAS) {
    // ---- recombination point: first node whose prefix sum >= u*total ---
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      total += h.pt[j] < BIG ? h.pt[j] - h.t[j] : 0.0f;
    const float x_pt = u_pt * total;
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
    h_r = t_cut + (x_pt - prev);
  } else {
    // ---- height-biased point: over the segments |branch_j ∩ section_s|
    // weighted by strength_s, node-major, the first whose running sum
    // reaches u * their total (the last one if rounding leaves none).
    // Each lane weighs its nodes' segments (nodes lane, lane + GROUP,
    // read from shared memory, so that the lanes run one instruction
    // stream); the running sums then take them in node-major order, as
    // one chain; each lane searches its own pairs (q = j S + s, q % GROUP
    // its lane) and the group's least hit is the first ----
    const int S = tb.S, Q = N * S;
    if constexpr (GUIDE) {
      // the branches' guide rates (transition.py:124): the leaves' rates
      // at the event's window (under way since the extension); each lane
      // ranks one internal node in the stable order of the times; lane 0
      // merges them in that order (the mean of the children's rates) and
      // gives both children of the last the larger of their two rates
      const int n = tb.n;
      for (int j = lane; j < N; j += GROUP)
        w.rate[j] = j < n ? leaf_rate : 0.0f;
      if (lane < n - 1) {
        const int v = n + lane;
        const float tv = w.t[v];
        int rank = 0;
        for (int k = n; k < N; ++k) {
          const float tk = w.t[k];
          rank += (tk < tv || (tk == tv && k < v)) ? 1 : 0;
        }
        w.order[rank] = v;
      }
      __syncwarp(gm);
      if (lane == 0) {
        for (int k = 0; k < n - 1; ++k) {
          const int v = w.order[k];
          w.rate[v] = 0.5f * (w.rate[w.c0[v]] + w.rate[w.c1[v]]);
        }
        const int root = w.order[n - 2];
        const int rc0 = w.c0[root], rc1 = w.c1[root];
        const float mx = fmaxf(w.rate[rc0], w.rate[rc1]);
        w.rate[rc0] = mx;
        w.rate[rc1] = mx;
      }
      __syncwarp(gm);
    }
    for (int j = lane; j < N; j += GROUP) {
      const int p = w.par[j];
      const float t_j = w.t[j], pt_j = p < 0 ? BIG : w.t[p];
      const float r_j = GUIDE ? w.rate[j] : 1.0f;
#pragma unroll
      for (int s = 0; s < MAX_SECTIONS; ++s) {
        if (s < S) {
          const float seg = pt_j < BIG
              ? fmaxf(fminf(pt_j, tb.bh[s + 1]) - fmaxf(t_j, tb.bh[s]), 0.0f)
              : 0.0f;
          w.seg[j * S + s] = seg;
          if constexpr (GUIDE) {
            w.wseg[j * S + s] = seg * tb.bs[s] * r_j;
          } else {
            w.wseg[j * S + s] = seg * tb.bs[s];
          }
        }
      }
    }
    __syncwarp(gm);
    // GUIDE: btot sums the segments weighted by the strengths alone, each
    // product as the weighing took it (s_q: q's section)
    float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;
    int s_q = 0;
#pragma unroll 4
    for (int q = 0; q < Q; ++q) {
      wtot += w.wseg[q];
      ptot += w.seg[q];
      if constexpr (GUIDE) {
        btot += w.seg[q] * tb.bs[s_q];
        s_q = s_q + 1 == S ? 0 : s_q + 1;
      }
      if (q % GROUP == lane) w.cum[q] = wtot;
    }
    __syncwarp(gm);
    const float x = u_pt * wtot;
    int mine = Q;
    for (int q = lane; q < Q; q += GROUP)
      if (w.cum[q] >= x) {
        mine = q;
        break;
      }
    const int hit = group_min(mine, gm);
    // the hit pair, or the last one; `prev` is the running sum before it
    const int q_hit = hit < Q ? hit : Q - 1;
    c = hit < Q ? q_hit / S : N - 1;
    const int s_hit = q_hit - (q_hit / S) * S;
    const float prev = q_hit > 0 ? w.cum[q_hit - 1] : 0.0f;
    const float lo_hit = fmaxf(w.t[q_hit / S], tb.bh[s_hit]);
    strength = tb.bs[s_hit];
    // the point's weight per unit length: its strength (times its
    // branch's guide rate)
    const float local_w = GUIDE ? strength * w.rate[q_hit / S] : strength;
    h_r = lo_hit + (x - prev) / fmaxf(local_w, 1e-30f);
    log_iw = logf(wtot) - logf(fmaxf(ptot, 1e-30f))
        - logf(fmaxf(local_w, 1e-30f));
    if constexpr (GUIDE)
      log_iw_bias = logf(btot) - logf(fmaxf(ptot, 1e-30f))
          - logf(fmaxf(strength, 1e-30f));
    else
      log_iw_bias = log_iw;
  }

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
  // nodes l, l + GROUP, ... (the biased pass reads them from shared memory,
  // so that the lanes' candidates run side by side)
  float best = -BIG;
  if constexpr (BIAS) {
    for (int i = lane; i < N; i += GROUP) {
      const float v = w.t[i];
      if (v >= lo_s && v < hi_s) {
        const float lam = base + overlap_below<NP>(h, lo_s, hi_s, v) * i2n_s;
        if (lam <= x_exp) best = fmaxf(best, v);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i % GROUP == lane) {
        const float v = h.t[i];
        if (v >= lo_s && v < hi_s) {
          const float lam = base
              + overlap_below<NP>(h, lo_s, hi_s, v) * i2n_s;
          if (lam <= x_exp) best = fmaxf(best, v);
        }
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
  int key_epoch = E, lag_epoch = E;
  float vbv = 0.0f;
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
    if constexpr (BIAS) {
      if (tb.delay_type == 0 ? in_r : in_c) key_epoch = e;
    }
    if (VB && in_c) vbv = tb.vb[e];
    if (LOCAL && in_r) lag_epoch = e;
    pend[e] += coal_opp;
    pend[E + e] += in_c ? 1.0f : 0.0f;
    pend[2 * E + e] += span;
    pend[4 * E + e] += delta * w.tle[e];
    pend[5 * E + e] += in_r ? 1.0f : 0.0f;
  }
  const float vb = VB ? group_sum(vbv, gm) : 0.0f;

  if constexpr (LOCAL) {
    // ---- the trip's local event (smc.py:1054-1069): due a lag of h_r's
    // epoch after its position; the leaves below c in the tree before the
    // SPR (a leaf is below c if c is on its path, or where the leaf walks
    // up to c), one ballot; into the first free slot ----
    int e = group_min(lag_epoch, gm);
    if (e >= E) e = h_r >= tb.est[0] ? E - 1 : 0;
    bool below = false;
    if constexpr (!LOCAL_PATHS) {
      if (lane < tb.n) {
        int cur = lane;
        for (int s = 0; s < N && cur >= 0; ++s) {
          if (cur == c) {
            below = true;
            break;
          }
          cur = w.par[cur];
        }
      }
    } else {
      below = lane < tb.n && c >= 0 && (path >> c & 1u) != 0u;
    }
    const unsigned desc = (__ballot_sync(gm, below)
                           >> ((threadIdx.x & 31) & ~(GROUP - 1)))
        & ((1u << GROUP) - 1u);
    if (ring->free != 0u) {
      const int slot = __ffs(ring->free) - 1;
      ring->free &= ring->free - 1u;
      if (lane == 0) {
        const size_t at = (size_t)i * a->R + slot;
        const float pos = tb.front + nr;
        a->lr_pos[at] = pos;
        a->lr_due[at] = pos + tb.lag[e];
        a->lr_time[at] = h_r;
        a->lr_desc[at] = (long long)desc;
      }
    } else {
      ring->dropped += 1;
    }
  }

  if constexpr (ARG) {
    // ---- the trip's ARG rows (smc.py:1021-1037): R at h_r with the
    // leaves below c, C at t_c with the leaves below c or d, in the tree
    // before the SPR (a leaf is below a node on its path: up to 4 leaves
    // lanes 0-3 test c and lanes 4-7 d in one ballot); lane 0 writes the R
    // row and lane 1 the C row, at the cursor's slots.  With one slot the
    // C row, the later push, is the one kept ----
    const int shift = (threadIdx.x & 31) & ~(GROUP - 1);
    unsigned dc, dd;
    if constexpr (NP == 7) {
      const int x = lane < 4 ? c : d;
      const unsigned m =
          (__ballot_sync(gm, x >= 0 && (path >> x & 1u) != 0u) >> shift)
          & ((1u << GROUP) - 1u);
      dc = m & 15u;
      dd = m >> 4;
    } else {
      const bool bc = c >= 0 && (path >> c & 1u) != 0u;
      const bool bd = d >= 0 && (path >> d & 1u) != 0u;
      dc = (__ballot_sync(gm, bc) >> shift) & ((1u << GROUP) - 1u);
      dd = (__ballot_sync(gm, bd) >> shift) & ((1u << GROUP) - 1u);
    }
    if (lane < 2 && (lane == 1 || a->A > 1)) {
      const bool C = lane == 1;
      arg_put(*a, i, C ? arg_slot_after(ac->slot, 1, a->A) : ac->slot,
              C ? 1 : 0, tb.front + nr, C ? t_c : h_r, C ? 0 : -1, -1,
              (long long)(C ? dc | dd : dc));
    }
    ac->n += 2;
    ac->slot = arg_slot_after(ac->slot, 2, a->A);
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
  if constexpr (GUIDE) {
    // the gap in guide mass from the event's position (smc.py:802-808),
    // whose mass the extension read; it is the next extension's start
    const float gap_m = -log1pf(-u_gap) / fmaxf(tb.rho * tl, 1e-30f);
    const float at = tb.front + nr;
    const float nxt = guide_inv_mass(tb, m_nr + gap_m);
    *m_up = m_nr;
    up = nr;
    nr = nr + fmaxf(nxt - at, 1e-3f);
  } else {
    const float gap = -log1pf(-u_gap) / fmaxf(tb.rho * tl, 1e-30f);
    up = nr;
    nr = nr + gap;
  }
  return TripEvent{h_r, t_c, log_iw, strength, key_epoch, vb, liw,
                   log_iw_bias};
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
  const int i = carve(a, smem, false, false, false, w, unused);
  const int lane = threadIdx.x % GROUP;
  const unsigned gm = group_mask();
  const int N = 2 * a.n - 1, E = a.E;

  // the tables, next_rec and then the rows of an active particle are all
  // under way before the one barrier
  float nr = i < a.P ? a.next_rec[i] : BIG;
  stage_tables(a, smem, false, false);
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
    one_trip<NP, false>(tb, w, h, lane, gm, u, pend, nr, up, lw, tl, B);
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

// The biased pass's delayed factors: after a trip whose importance weight
// is not applied at once, insert it into the first free slot of the ring
// (k applications of log_iw / k, the first at abs_pos + delay / (2^k - 1));
// a full ring gives it to the pilot at once.  Slot s is lane s % GROUP's,
// bit s / GROUP of its mask `changed` (to be written back).  The delay's
// epoch is the group's least `key_epoch` (the epoch whose [start, end)
// holds d_h; none below the first start or from the last end on, where
// counting the starts at or below d_h gives the first and the last epoch).
__device__ __forceinline__ void push_delayed(
    const Tables& tb, const Work& w, int D, int kk, int lane, unsigned gm,
    float d_h, int key_epoch, float abs_pos, float late, float& lp,
    unsigned& changed) {
  int mine = MAX_DELAY_SLOTS;
  for (int s = lane; s < D; s += GROUP)
    if (w.rpos[s] >= 0.5f * BIG) {
      mine = s;
      break;
    }
  const int first = group_min(mine, gm);
  if (first >= D) {  // no free slot
    lp = lp + late;
    return;
  }
  int e = group_min(key_epoch, gm);
  if (first % GROUP != lane) return;
  if (e >= tb.E) e = d_h >= tb.est[0] ? tb.E - 1 : 0;
  const float dd = tb.dl[e] / (float)((1 << kk) - 1);
  w.rpos[first] = abs_pos + dd;
  w.rlogf[first] = late / (float)kk;
  w.rdelta[first] = dd;
  w.rk[first] = kk;
  changed |= 1u << (first / GROUP);
}

// The segment pass; a kernel of its own for each variant below.
template <int NP, bool BIAS, bool VB, bool GUIDE = false, bool LOCAL = false,
          bool ARG = false>
__device__ __forceinline__ void segment_pass_body(const Args& a) {
  extern __shared__ float smem[];
  Work w;
  float* pend;
  const bool vb = VB;
  const int i = carve(a, smem, true, BIAS, vb, w, pend, LOCAL, GUIDE);
  const int lane = threadIdx.x % GROUP;
  const unsigned gm = group_mask();
  const int N = 2 * a.n - 1, E = a.E, K = 6 * a.E;
  const int D = a.K;  // ring slots (BIAS)
  // LOCAL: the plain pass reads its ring's positions after the barrier and
  // sums the opportunity in the final extension's loop; the biased passes
  // (more registers held at entry) read before it and sum after the loop
  // (each faster so, timed in turns)
  constexpr bool PLAIN_LOCAL = LOCAL && !BIAS;

  // the tables, the gate and the particle's rows are all under way before
  // the one barrier, which also publishes the tree and the zeroed pend
  const bool live = i < a.P;
  float nr = 0.0f, lw = 0.0f, up = 0.0f, lp = 0.0f;
  // this lane's ring slots (bit k: slot lane + k GROUP) to write back
  unsigned changed = 0u;
  LocalRing ring{0u, 0};  // LOCAL: this lane's free slots, until combined
  ArgCursor ac{0, 0};     // ARG: the ring's rows pushed so far, next slot
  stage_tables(a, smem, true, BIAS, vb, LOCAL, GUIDE);
  if (live) {
    load_tree(a, w, i, N, lane);
    for (int k = lane; k < K; k += GROUP) pend[k] = 0.0f;
    nr = a.next_rec[i], lw = a.log_w[i];
    if constexpr (ARG) ac.n = a.arg_n[i];
    if constexpr (BIAS) {
      // what is due and what is free: the positions alone
      lp = a.log_pilot[i];
      for (int s = lane; s < D; s += GROUP)
        w.rpos[s] = a.df_pos[(size_t)i * D + s];
    }
    if constexpr (LOCAL && !PLAIN_LOCAL) {
      // the local ring's free slots, read only by a particle that
      // recombines in this segment
      if (nr < a.L)
        for (int s = lane; s < a.R; s += GROUP)
          if (a.lr_pos[(size_t)i * a.R + s] >= 0.5f * BIG) ring.free |= 1u << s;
    }
  }
  if constexpr (GUIDE) wait_copies();  // the guide's staged tables
  __syncthreads();
  if (!live) return;
  if constexpr (LOCAL && !PLAIN_LOCAL) ring.free = group_or(ring.free, gm);
  // PLAIN_LOCAL: the ring's positions (slot lane + k GROUP), read only by a
  // particle that recombines in this segment, so that no particle of the
  // block waits at the barrier for a read behind its next_rec; under way
  // with the summaries and the first trip's uniforms
  float lpos[MAX_LOCAL_SLOTS / GROUP];
  if constexpr (PLAIN_LOCAL) {
#pragma unroll
    for (int k = 0; k < MAX_LOCAL_SLOTS / GROUP; ++k) {
      const int s = lane + k * GROUP;
      lpos[k] = nr < a.L && s < a.R ? a.lr_pos[(size_t)i * a.R + s] : 0.0f;
    }
  }
  if constexpr (BIAS) {
    // the other words of the slots due at the segment end, under way
    // while the trips run (a push takes only free slots, so these stay
    // due and nothing else writes them)
    const float end = a.front + a.L;
#pragma unroll
    for (int k = 0; k < MAX_DELAY_SLOTS / GROUP; ++k) {
      const int s = lane + k * GROUP;
      if (s < D && w.rpos[s] <= end) {
        const size_t at = (size_t)i * D + s;
        copy_word_async(&w.rlogf[s], &a.df_logf[at]);
        copy_word_async(&w.rdelta[s], &a.df_delta[at]);
        copy_word_async(&w.rk[s], &a.df_k[at]);
      }
    }
  }
  Tables tb;
  bind_tables(a, smem, tb, BIAS, vb, LOCAL, GUIDE);
  Heights<NP> h;
  load_heights<NP>(w, N, h);
  float tl, B;
  summaries<NP>(tb, w, h, lane, gm, tl, B);  // at segment entry
  float m_up = 0.0f;  // GUIDE: the guide mass at front + up
  if constexpr (GUIDE) m_up = guide_mass(tb, tb.front + up);

  bool moved = false;
  float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.trips > 0 && nr < a.L) {
    u = load_uniforms(a, 0, i);
    // ARG: the first row's slot (arg_slot_of), once a segment
    if constexpr (ARG) ac.slot = arg_slot_of(ac.n, a.A);
    if constexpr (PLAIN_LOCAL) {
      // the ring's free slots (bit s: slot s)
#pragma unroll
      for (int k = 0; k < MAX_LOCAL_SLOTS / GROUP; ++k)
        if (lpos[k] >= 0.5f * BIG) ring.free |= 1u << (lane + k * GROUP);
      ring.free = group_or(ring.free, gm);
    }
  }
  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    // the next trip's uniforms are under way while this trip runs
    const float4 u_next = k + 1 < a.trips ? load_uniforms(a, k + 1, i) : u;
    const float delta = nr - up, B_pre = B;
    const TripEvent ev = one_trip<NP, BIAS, VB, GUIDE, LOCAL, ARG>(
        tb, w, h, lane, gm, u, pend, nr, up, lw, tl, B, &a, i, &ring, &ac,
        &m_up);
    // the VB term follows the extension and comes before the importance
    // weight, in both weights (smc.py:951-967)
    if (vb) lw = lw + ev.vb;
    if constexpr (BIAS) {
      // the posterior takes the whole importance weight; the pilot the
      // extension and, where the delay height's section is unbiased, the
      // weight at once; the rest is delayed (smc.py:968-1020)
      lp = lp - a.mu * B_pre * delta;
      if constexpr (GUIDE) lp = lp + ev.liw;
      if (vb) lp = lp + ev.vb;
      lw = lw + ev.log_iw;
      const float d_h = a.delay_type == 0 ? ev.h_r : ev.t_c;
      float strength_h = ev.strength;
      if (a.delay_type != 0) {
        int cnt = 0;  // section of d_h
        for (int s = 0; s <= tb.S; ++s) cnt += tb.bh[s] <= d_h ? 1 : 0;
        strength_h = tb.bs[min(max(cnt - 1, 0), tb.S - 1)];
      }
      // the immediate part is the height-bias part (all of log_iw unguided)
      const float imm =
          fabsf(strength_h - 1.0f) < 1e-6f ? ev.log_iw_bias : 0.0f;
      const float late = ev.log_iw - imm;
      lp = lp + imm;
      if (fabsf(late) > 1e-9f)
        push_delayed(tb, w, D, a.delay_k, lane, gm, d_h, ev.key_epoch,
                     a.front + up, late, lp, changed);
    }
    u = u_next;
    moved = true;
  }

  // ---- final extension to the segment end -------------------------------
  const float delta = a.L - up;
  lw = lw - a.mu * B * delta;
  float liwf = 0.0f;
  if constexpr (GUIDE) {
    // the guide's survival weight of the final extension (smc.py:1123-1131)
    if (delta > 0.0f) {
      const float x1 = tb.front + a.L;
      liwf = guide_span(tb, tl, tb.front + up, x1, m_up, guide_mass(tb, x1));
    }
    lw = lw + liwf;
  }
  float mine = 0.0f;  // LOCAL: this lane's epochs of the opportunity
  if constexpr (PLAIN_LOCAL) {
    for (int e = lane; e < E; e += GROUP) {
      const float v = pend[4 * E + e] + delta * w.tle[e];
      pend[4 * E + e] = v;
      mine += v;
    }
  } else {
    for (int e = lane; e < E; e += GROUP) pend[4 * E + e] += delta * w.tle[e];
  }
  nr = nr - a.L;
  if constexpr (LOCAL) {
    // the segment's ungated recombination opportunity (each lane's epochs
    // in order); the dropped events
    if constexpr (!PLAIN_LOCAL)
      for (int e = lane; e < E; e += GROUP) mine += pend[4 * E + e];
    const float ropp = group_sum(mine, gm);
    if (lane == 0) {
      a.ropp[i] = ropp;
      if (ring.dropped > 0) atomicAdd(a.lr_dropped, ring.dropped);
    }
  }
  if constexpr (BIAS) {
    // ---- the pilot's extension; the delayed factors due at front + L ----
    lp = lp - a.mu * B * delta;
    if constexpr (GUIDE) lp = lp + liwf;
    const float end = a.front + a.L;
    unsigned due = 0u;
#pragma unroll
    for (int k = 0; k < MAX_DELAY_SLOTS / GROUP; ++k) {
      const int s = lane + k * GROUP;
      if (s < D && w.rpos[s] <= end) due |= 1u << k;
    }
    // a due slot was due at entry (its words copied since) or pushed here
    wait_copies();
    float add = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_DELAY_SLOTS / GROUP; ++k) {
      if (due >> k & 1u) {
        const int s = lane + k * GROUP;
        add += w.rlogf[s];
        if (w.rk[s] > 1) {
          w.rpos[s] = w.rpos[s] + 2.0f * w.rdelta[s];
          w.rdelta[s] = 2.0f * w.rdelta[s];
          w.rk[s] = w.rk[s] - 1;
        } else {
          w.rpos[s] = BIG;
          w.rlogf[s] = 0.0f;
          w.rk[s] = 0;
        }
      }
    }
    changed |= due;
    // a group with nothing due adds the +0 that the sum of its zeros is
    lp = lp + (__any_sync(gm, due != 0u) ? group_sum(add, gm) : 0.0f);
  }
  __syncwarp(gm);

  // ---- push the segment's statistics into FIFO slot 0 -------------------
  float* slot = a.fifo + (size_t)i * a.fifo_stride;
  for (int k = lane; k < K; k += GROUP) {
    const float v = pend[k] * tb.gate[k];
    if (v != 0.0f) slot[k] += v;
  }

  if (moved) store_tree(a, w, i, N, lane);  // only rows that changed
  if constexpr (BIAS) {
    // only the slots that were pushed or applied
#pragma unroll
    for (int k = 0; k < MAX_DELAY_SLOTS / GROUP; ++k) {
      if (changed >> k & 1u) {
        const int s = lane + k * GROUP;
        const size_t at = (size_t)i * D + s;
        a.df_pos[at] = w.rpos[s];
        a.df_logf[at] = w.rlogf[s];
        a.df_delta[at] = w.rdelta[s];
        a.df_k[at] = w.rk[s];
      }
    }
    if (lane == 0) a.log_pilot[i] = lp;
  }
  if (lane == 0) {
    a.next_rec[i] = nr;
    a.log_w[i] = lw;
    a.tl_out[i] = tl;
    if constexpr (ARG) {
      if (moved) a.arg_n[i] = ac.n;
    }
  }
}

template <int NP, bool VB, bool LOCAL, bool ARG = false>
__global__ void __launch_bounds__(BLOCK) segment_pass_kernel(const Args a) {
  segment_pass_body<NP, false, VB, false, LOCAL, ARG>(a);
}

// the biased pass, held at BIAS_MIN_BLOCKS resident blocks per SM
template <int NP, bool VB, bool GUIDE, bool LOCAL, bool ARG = false>
__global__ void __launch_bounds__(BLOCK, BIAS_MIN_BLOCKS)
    segment_pass_biased_kernel(const Args a) {
  segment_pass_body<NP, true, VB, GUIDE, LOCAL, ARG>(a);
}

// ===========================================================================
// The wide passes: trees of 9 to WIDE_MAX_LEAVES leaves.
//
// Replaces the same Pallas kernel as the passes above (the JAX package runs
// it at n <= 8 and its XLA twin above: transition.py:108/:160 for the
// point, :231 for the re-coalescence, :1170 for the SPR, smc.py:417 for the
// summaries).  The plain and the biased segment pass (each with and without
// VB), the plain pass's ARG variant and trip; the plain pass with local
// recording and the biased pass guided, with local recording or both (each
// with and without VB: segment_pass_wide_local_kernel,
// segment_pass_biased_wide_proposal_kernel); the migration pass and its
// variants and the biased pass's ARG variant have no wide form.
//
// What bounds it on Hopper: neither bytes nor operations but the dependent
// chain of a particle's trips (a launch lasts as long as the longest chain
// among the particles of its waves), and the FP64 issue rate: the trip is
// computed in double (below), and an SM issues 64 FP64 operations a clock
// against 128 in float32, fewer conversions from float, and a min or max
// of doubles takes several instructions.  So a clip against float bounds
// is taken in float (exact) before the conversion, and an overlap's clip
// at 0 is a select.
//
// What the design does about it.  A group of G lanes owns a particle: G = 8
// up to 16 leaves (31 nodes, 4 a lane), so that a block of 128 threads holds
// 16 particles, and 16 above (127 nodes at the cap, 8 a lane; 8 particles a
// block).  WIDE_MIN_BLOCKS = 5 resident blocks an SM (at most 96 registers a
// thread) hold 80 particles an SM up to 16 leaves, so that 10,000 particles
// run in one wave on 132 SMs, and 40 above, two waves.  The leaf cap ML is a
// template argument of these kernels alone (it sizes the has-data table and
// the stripes), so MAX_LEAVES and the narrow kernels stay as they were.
//
// * Lane l owns the contiguous chunk of nodes l cr .. l cr + cr - 1 (cr =
//   ceil(N / G)); node order is lane order, then chunk order.  Each lane
//   keeps its chunk's node and parent times in registers (WideChunk, padded
//   to C = ceil((2 ML - 1) / G) with BIG, which has no branch length,
//   overlaps nothing and crosses no time), reloaded from shared memory after
//   each SPR.  The tree itself (times, pointers) stays in the group's slice
//   of shared memory, where lane 0 does the SPR.
// * Every sum over nodes is lane-parallel and in double: each lane adds its
//   chunk in node order, a fixed xor-shuffle tree (wide_sum) combines the
//   lanes so that every lane ends with the same bits, and a value stored is
//   rounded to float once.  So are the per-epoch sums (tree length per
//   epoch, each epoch's hazard mass), one epoch after the other over all the
//   nodes, not one epoch per lane.
// * "First node in node order whose running sum reaches u total" (the
//   point; the biased point over the (node, section) pairs, node-major):
//   each lane's chunk total, every lane's prefix as one left fold of those
//   totals in lane order (wide_prefix), a ballot for the first lane whose
//   running sum at its chunk's end reaches the target, then that lane
//   alone walks its chunk again.  The running sum at a node is its lane's
//   prefix plus the chunk's running sum; a lane's sum at its chunk's end
//   is the next lane's prefix bit for bit, so the running sums rise in node
//   order and the total is that of the last node: some node always reaches
//   u total < total.  No running sums are staged in shared memory.
// * The hazard in the epoch e* of t_c: its candidate node times are a
//   ballot per lane's chunk, visited in node order; the hazard at each is a
//   lane-parallel sum, skipped where it cannot move t_lo (the hazard is
//   monotone: a time at or below the best one accepted, or at or above one
//   refused).  Which branches cross a time, their count and the r-th of
//   them in node order: each lane's chunk bits, a scan of their counts.
// * The trip computes in double from the float tree: every sum, the
//   point's height, the hazard and the re-coalescence time t_c, and every
//   decision on them (the point, the candidates, the branches crossing
//   t_c, the epochs of h_r and t_c).  A float chain over 127 nodes loses up
//   to 127 roundings, and t_c comes from a difference of two such sums:
//   along 64 trips at 64 leaves float sums drifted up to 6.5 node units
//   (1e-5 of the tallest node) from a float64 run, the plain version in
//   float32 2.4 and a kernel in double 0.09 (a host rehearsal).  So the
//   plain version in float64 is what the wide kernels are held to.
// * Per-epoch records and the ring of delayed factors are each lane's own
//   epochs and slots (e % G, s % G), so no lane reads another's words; the
//   data leaves below each node are counted by each data leaf's lane
//   walking up its ancestors with an atomic add in shared memory.
// * The guided and local passes (GUIDE, LOCAL; one_trip's steps) hold
//   nothing of theirs in registers across a trip beyond the guide mass at
//   the extension's start: the pass runs at the same 96 registers, where
//   the biased pass already spills.  The branches' guide rates and the
//   internal nodes' stable time order are in the group's slice (w.rate,
//   w.order): each lane ranks its internal nodes by an exact count over
//   the tree's times, and lane 0 merges the rates in that order, as the
//   narrow pass does (a node's rate reads a child later in the order at
//   0, so the order, ties by index, decides the bits); the guided point's
//   weights, the guide's search pivots (staged per block by cp.async) and
//   the gap in guide mass are the narrow pass's, the point's running sum
//   in node order as the biased point's.  The local ring's free slots and
//   drops are lane 0's words in the slice (w.lst), read from the ring's
//   positions by one ballot per slot stripe at entry; each trip's leaves
//   below the cut are a walk per leaf stripe and one ballot per stripe
//   into a 64-bit word (leaf 63 its sign bit), the lag's epoch a minimum
//   over lanes, and lane 0 writes the event.  The segment's ungated
//   opportunity sums the lanes' epochs in double.
// ===========================================================================

#define WIDE_MAX_LEAVES 64  // the reference's u64 Descendants_t
#define WIDE_MIN_BLOCKS 5   // resident wide blocks per SM: <= 96 registers

// nodes a lane holds at most: the chunk of 2 ML - 1 nodes over G lanes
#define WIDE_CHUNK(G, ML) ((2 * (ML) - 1 + (G) - 1) / (G))

template <int G>
__device__ __forceinline__ unsigned wide_mask() {
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// the group's ballot, bit k for the group's lane k
template <int G>
__device__ __forceinline__ unsigned wide_ballot(unsigned gm, bool p) {
  const unsigned b = __ballot_sync(gm, p);
  if constexpr (G == 32)
    return b;
  else
    return (b >> ((threadIdx.x & 31) & ~(G - 1))) & ((1u << G) - 1u);
}

// every lane ends with the same bits: each step adds the same two values
template <int G, typename T>
__device__ __forceinline__ T wide_sum(T v, unsigned gm) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(gm, v, off);
  return v;
}

// two wide_sums at once, their shuffles interleaved
template <int G>
__device__ __forceinline__ void wide_sum2(double& a, double& b,
                                          unsigned gm) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const double x = __shfl_xor_sync(gm, a, off);
    const double y = __shfl_xor_sync(gm, b, off);
    a = a + x;
    b = b + y;
  }
}

template <int G>
__device__ __forceinline__ int wide_min(int v, unsigned gm) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(gm, v, off));
  return v;
}

// lane `src`'s value (src the same in every lane)
template <int G, typename T>
__device__ __forceinline__ T wide_from(T v, int src, unsigned gm) {
  return __shfl_sync(gm, v, ((threadIdx.x & 31) & ~(G - 1)) + src);
}

// the sum of the lanes before the calling one, each lane's value added in
// lane order (a left fold), and in `total` the fold of all G: lane l's
// prefix plus its own value is lane l + 1's prefix, bit for bit
template <int G>
__device__ __forceinline__ double wide_prefix(double v, int lane,
                                              unsigned gm, double& total) {
  double ex = 0.0, all = 0.0;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const double y = wide_from<G>(v, k, gm);
    if (k == lane) ex = all;
    all += y;
  }
  total = all;
  return ex;
}

// inclusive scan of counts over the group's lanes in lane order
template <int G>
__device__ __forceinline__ int wide_scan(int v, int lane, unsigned gm) {
  const int wl = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const int y = __shfl_sync(gm, v, lane >= off ? wl - off : wl);
    if (lane >= off) v = v + y;
  }
  return v;
}

// est, eend, i2n [E]; has-data [ML]; with segment the FIFO gate [6E]; with
// biased the sections' heights and strengths and the delays [E]; with vb
// the VB table [E]; with local the lags [E]; with guide the search's first
// pivots [GUIDE_TOP]
template <int ML>
__host__ __device__ inline int wide_tables_words(int E, bool segment,
                                                 bool biased, bool vb,
                                                 bool local = false,
                                                 bool guide = false) {
  return 3 * E + ML + (segment ? 6 * E : 0)
      + (biased ? 2 * MAX_SECTIONS + 1 + E : 0) + (vb ? E : 0)
      + (local ? E : 0) + (guide ? GUIDE_TOP : 0);
}

// one particle's slice: node times, parent, children, data leaves below
// [N]; tree length and hazard mass per epoch [E]; the segment pass's
// statistics [6E]; the biased pass's ring; with guide the branches' guide
// rates and the internal nodes in time order [N] each; with local the
// local ring's free slots and drops [2]
__host__ __device__ inline int wide_work_words(int N, int E, bool segment,
                                               bool biased,
                                               bool guide = false,
                                               bool local = false) {
  return (5 * N + 2 * E + (segment ? 6 * E : 0)
          + (biased ? 4 * MAX_DELAY_SLOTS : 0) + (guide ? 2 * N : 0)
          + (local ? 2 : 0)) | 1;  // odd
}

template <int ML>
__host__ __device__ inline int wide_block_words(int G, int N, int E,
                                                bool segment, bool biased,
                                                bool vb, bool local = false,
                                                bool guide = false) {
  return wide_tables_words<ML>(E, segment, biased, vb, local, guide)
      + (BLOCK / G) * wide_work_words(N, E, segment, biased, guide, local);
}

struct WideWork {
  float* t;     // [N] node times
  int* par;     // [N]
  int* c0;      // [N]
  int* c1;      // [N]
  int* cnt;     // [N] data leaves below the node (mixed data)
  float* tle;   // [E] tree length per epoch (lane e % G's)
  float* full;  // [E] hazard mass of each epoch above h_r (lane e % G's)
  float* rpos;  // the biased pass's ring, [MAX_DELAY_SLOTS] each
  float* rlogf;
  float* rdelta;
  int* rk;
  float* rate;    // GUIDE: [N] the branches' guide rates
  int* order;     // GUIDE: [N] the internal nodes in stable time order
  unsigned* lst;  // LOCAL: the ring's free slots (bit s: slot s), drops
};

// the calling lane's chunk: nodes j0 .. j0 + cr - 1 of the tree, their
// node and parent times (BIG past the last node; pt BIG at the root)
template <int C>
struct WideChunk {
  float t[C];
  float pt[C];
  int j0, cr;
};

template <int ML, bool LOCAL = false, bool GUIDE = false>
__device__ void wide_stage_tables(const Args& a, float* smem, bool segment,
                                  bool biased, bool vb) {
  const int E = a.E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    smem[e] = a.epoch_start[e];
    smem[E + e] = (e + 1 < E) ? a.epoch_start[e + 1] : BIG;
    smem[2 * E + e] = a.inv2ne[e];
  }
  int* s_hd = reinterpret_cast<int*>(smem + 3 * E);
  for (int l = threadIdx.x; l < ML; l += blockDim.x)
    s_hd[l] = (l < a.n && a.has_data[l] != 0) ? 1 : 0;
  float* p = smem + 3 * E + ML;
  if (segment) {
    for (int k = threadIdx.x; k < 6 * E; k += blockDim.x)
      p[k] = a.fifo_mask[k];
    p += 6 * E;
  }
  if (biased) {
    for (int k = threadIdx.x; k <= a.S; k += blockDim.x)
      p[k] = a.bias_heights[k];
    for (int k = threadIdx.x; k < a.S; k += blockDim.x)
      p[MAX_SECTIONS + 1 + k] = a.bias_strengths[k];
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      p[2 * MAX_SECTIONS + 1 + e] = a.delays[e];
    p += 2 * MAX_SECTIONS + 1 + E;
  }
  if (vb)
    for (int e = threadIdx.x; e < E; e += blockDim.x) p[e] = a.vb_coal[e];
  if constexpr (LOCAL || GUIDE) {
    if (vb) p += E;
    if constexpr (LOCAL) {
      for (int e = threadIdx.x; e < E; e += blockDim.x) p[e] = a.lags[e];
      p += E;
    }
    if constexpr (GUIDE) {
      // under way at once (the caller waits for them before its barrier)
      for (int h = threadIdx.x; h < GUIDE_TOP; h += blockDim.x)
        copy_word_async(&p[h], &a.g_top[h]);
    }
  }
}

template <int ML, bool LOCAL = false, bool GUIDE = false>
__device__ void wide_bind_tables(const Args& a, float* smem, Tables& tb,
                                 bool segment, bool biased, bool vb) {
  const int E = a.E;
  tb.est = smem;
  tb.eend = smem + E;
  tb.i2n = smem + 2 * E;
  tb.hd = reinterpret_cast<const int*>(smem + 3 * E);
  const float* p = smem + 3 * E + ML;
  tb.gate = p;
  if (segment) p += 6 * E;
  tb.bh = p;
  tb.bs = p + MAX_SECTIONS + 1;
  tb.dl = tb.bs + MAX_SECTIONS;
  if (biased) p += 2 * MAX_SECTIONS + 1 + E;
  tb.vb = vb ? p : nullptr;
  tb.lag = nullptr;
  if constexpr (LOCAL || GUIDE) {
    if (vb) p += E;
    if constexpr (LOCAL) {
      tb.lag = p;
      p += E;
    }
    if constexpr (GUIDE) {
      tb.g_rel = a.g_rel;
      tb.cum_mass = a.cum_mass;
      tb.g_leaf = a.g_leaf;
      tb.Wg = a.Wg;
      tb.ws = a.ws;
      tb.g_top = p;
    }
  }
  tb.front = a.front;
  tb.S = a.S;
  tb.delay_type = a.delay_type;
  tb.n = a.n;
  tb.N = 2 * a.n - 1;
  tb.E = E;
  tb.total_data = 0;  // the data leaves, for mixed data's B alone
  if (a.leaf_status == 0)
    for (int l = 0; l < a.n; ++l) tb.total_data += tb.hd[l];
  tb.leaf_status = a.leaf_status;
  tb.L = a.L;
  tb.mu = a.mu;
  tb.rho = a.rho;
}

// Carve this group's slice (`pend` is only there for segment_pass).
// Returns the particle index of the calling thread's group.
template <int G, int ML, bool LOCAL = false, bool GUIDE = false>
__device__ int wide_carve(const Args& a, float* smem, bool segment,
                          bool biased, bool vb, WideWork& w, float*& pend) {
  const int E = a.E, N = 2 * a.n - 1;
  const int group = threadIdx.x / G;
  float* base = smem
      + wide_tables_words<ML>(E, segment, biased, vb, LOCAL, GUIDE)
      + (size_t)group
          * wide_work_words(N, E, segment, biased, GUIDE, LOCAL);
  w.t = base;
  w.par = reinterpret_cast<int*>(base + N);
  w.c0 = reinterpret_cast<int*>(base + 2 * N);
  w.c1 = reinterpret_cast<int*>(base + 3 * N);
  w.cnt = reinterpret_cast<int*>(base + 4 * N);
  w.tle = base + 5 * N;
  w.full = base + 5 * N + E;
  pend = base + 5 * N + 2 * E;
  float* ring = pend + 6 * E;
  w.rpos = ring;
  w.rlogf = ring + MAX_DELAY_SLOTS;
  w.rdelta = ring + 2 * MAX_DELAY_SLOTS;
  w.rk = reinterpret_cast<int*>(ring + 3 * MAX_DELAY_SLOTS);
  if constexpr (LOCAL || GUIDE) {
    float* x = ring + (biased ? 4 * MAX_DELAY_SLOTS : 0);
    w.rate = x;
    w.order = reinterpret_cast<int*>(x + N);
    w.lst = reinterpret_cast<unsigned*>(x + (GUIDE ? 2 * N : 0));
  }
  return blockIdx.x * (blockDim.x / G) + group;
}

// every load of the tree under way at once (node j is lane j % G's here)
template <int G, int ML>
__device__ void wide_load_tree(const Args& a, const WideWork& w, int i,
                               int N, int lane) {
#pragma unroll
  for (int q = 0; q < WIDE_CHUNK(G, ML); ++q) {
    const int j = lane + q * G;
    if (j < N) {
      w.t[j] = a.time[(size_t)i * N + j];
      w.par[j] = a.parent[(size_t)i * N + j];
      w.c0[j] = a.child0[(size_t)i * N + j];
      w.c1[j] = a.child1[(size_t)i * N + j];
    }
  }
}

template <int G>
__device__ void wide_store_tree(const Args& a, const WideWork& w, int i,
                                int N, int lane) {
  for (int j = lane; j < N; j += G) {
    a.time[(size_t)i * N + j] = w.t[j];
    a.parent[(size_t)i * N + j] = w.par[j];
    a.child0[(size_t)i * N + j] = w.c0[j];
    a.child1[(size_t)i * N + j] = w.c1[j];
  }
}

// The lane's chunk from the tree in shared memory; the group must be
// synchronised after the last write to w.t / w.par.
template <int G, int C>
__device__ __forceinline__ void wide_chunk_load(const WideWork& w, int N,
                                                int lane, WideChunk<C>& h) {
  h.cr = (N + G - 1) / G;
  h.j0 = lane * h.cr;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int j = h.j0 + k;
    const bool in = k < h.cr && j < N;
    const int p = in ? w.par[j] : -1;
    h.t[k] = in ? w.t[j] : BIG;
    h.pt[k] = p >= 0 ? w.t[p] : BIG;
  }
}

// the chunk's part of sum_j |branch_j ∩ [lo, hi) ∩ (-inf, v]|, in double.
// A min or max of doubles takes several instructions on this card, so the
// overlap's clip at 0 is a select: max(a - b, 0) is a - b where a > b.
template <int C>
__device__ __forceinline__ double chunk_overlap(const WideChunk<C>& h,
                                                double lo, double hi,
                                                double v) {
  const double top = fmin(hi, v);
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const double a = fmin((double)h.pt[k], top), b = fmax((double)h.t[k], lo);
    s += a > b ? a - b : 0.0;
  }
  return s;
}

// chunk_overlap with v = BIG for two intervals at once, each node's times
// converted once
template <int C>
__device__ __forceinline__ void chunk_overlap2(const WideChunk<C>& h,
                                               double lo0, double hi0,
                                               double lo1, double hi1,
                                               double& f0, double& f1) {
  f0 = 0.0;
  f1 = 0.0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const double t = h.t[k], pt = h.pt[k];
    const double a0 = fmin(pt, hi0), b0 = fmax(t, lo0);
    const double a1 = fmin(pt, hi1), b1 = fmax(t, lo1);
    f0 += a0 > b0 ? a0 - b0 : 0.0;
    f1 += a1 > b1 ? a1 - b1 : 0.0;
  }
}

// the chunk's branches crossing x (t <= x < pt), bit k for its node k
template <int C>
__device__ __forceinline__ unsigned chunk_crossing(const WideChunk<C>& h,
                                                   double x) {
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if ((double)h.t[k] <= x && x < (double)h.pt[k]) m |= 1u << k;
  return m;
}

// Tree summaries from the chunks (h up to date, w.par too): tree length
// per epoch (w.tle, lane e % G storing epoch e), tree length, data branch
// length; every lane returns the same tl and B.
template <int G, int C>
__device__ void wide_summaries(const Tables& tb, const WideWork& w,
                               const WideChunk<C>& h, int lane, unsigned gm,
                               float& tl, float& B) {
  const int E = tb.E, N = tb.N;
  if (tb.leaf_status == 0) {
    for (int j = lane; j < N; j += G) w.cnt[j] = 0;
    __syncwarp(gm);
    // each data leaf counts itself on its ancestor chain
    for (int l = lane; l < tb.n; l += G) {
      if (!tb.hd[l]) continue;
      int cur = l;
      for (int s = 0; s < tb.n && cur >= 0; ++s) {
        atomicAdd(&w.cnt[cur], 1);
        cur = w.par[cur];
      }
    }
    __syncwarp(gm);
  }
  // the root's time: no branch but the root's lineage reaches an epoch
  // that starts at or above it, so such epochs have no length
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (h.pt[k] >= BIG && h.t[k] < BIG) mine = h.t[k];
  const unsigned at = wide_ballot<G>(gm, mine > 0.0f);
  const float root = at ? wide_from<G>(mine, __ffs((int)at) - 1, gm) : BIG;
  double tl_d = 0.0;
  for (int e = 0; e < E; e += 2) {  // two epochs at a time
    double s[2] = {0.0, 0.0};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (e + q < E && tb.est[e + q] < root) {
        const float lo_e = tb.est[e + q], hi_e = tb.eend[e + q];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          // the clip in float (exact), the length in double where positive
          const float a = fminf(h.pt[k], hi_e), b = fmaxf(h.t[k], lo_e);
          if (h.pt[k] < BIG && a > b)  // not the root's lineage
            s[q] += (double)a - (double)b;
        }
      }
    }
    if (tb.est[e] < root) wide_sum2<G>(s[0], s[1], gm);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (e + q < E) {
        if (((e + q) & (G - 1)) == lane) w.tle[e + q] = (float)s[q];
        tl_d += s[q];
      }
    }
  }
  tl = (float)tl_d;
  if (tb.leaf_status == 1) {
    B = tl;
  } else if (tb.leaf_status == -1) {
    B = 0.0f;
  } else {
    // informative branches: at least one and not all data leaves below
    double b = 0.0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (h.pt[k] < BIG) {
        const int c = w.cnt[h.j0 + k];
        if (c >= 1 && c < tb.total_data)
          b += (double)h.pt[k] - (double)h.t[k];
      }
    }
    B = (float)wide_sum<G>(b, gm);
  }
}

// One trip of the particle in `w`: one_trip's steps for a tree in shared
// memory.  Called by all lanes of a synchronised group with identical
// scalars, w.tle and the chunks up to date; returns the same way.  ARG
// pushes the trip's R and C rows into particle i's ARG ring, from row *an
// on.  GUIDE (with BIAS) and LOCAL are one_trip's: the guide's survival
// weight, the point weighed by the branches' guide rates (w.rate, merged
// by lane 0 in the stable order of the times), the gap in guide mass from
// *m_up; the trip's local event into the first free slot of w.lst[0].
template <int G, int ML, bool BIAS, bool VB, bool ARG = false,
          bool GUIDE = false, bool LOCAL = false>
__device__ TripEvent wide_trip(const Tables& tb, const WideWork& w,
                               WideChunk<WIDE_CHUNK(G, ML)>& h, int lane,
                               unsigned gm, const float4 u, float* pend,
                               float& nr, float& up, float& lw, float& tl,
                               float& B, const Args* a = nullptr, int i = 0,
                               int* an = nullptr, float* m_up = nullptr) {
  constexpr int C = WIDE_CHUNK(G, ML);
  const int N = tb.N, E = tb.E;
  const float u_pt = clip_u(u.x), u_exp = clip_u(u.y);
  const float u_tgt = clip_u(u.z), u_gap = clip_u(u.w);
  // the lane that holds node N - 1; the lanes after it hold none
  const int last = (N - 1) / h.cr;

  // ---- extension: no-mutation likelihood + recombination opportunity ----
  const float delta = nr - up;
  lw = lw - tb.mu * B * delta;
  float liw = 0.0f, m_nr = 0.0f;  // GUIDE: the mass at the event
  if constexpr (GUIDE) {
    // the guide's survival weight over the extension (smc.py:903-914): the
    // mass at its start is the last trip's (*m_up); the window of its end
    // gives the mass there and the leaves' rates (leaf l lane l % G's),
    // the internal nodes' rates 0 until merged
    const float x0 = tb.front + up, x1 = tb.front + nr;
    const int win = guide_window(tb, x1);
    for (int j = lane; j < N; j += G)
      w.rate[j] = j < tb.n ? tb.g_leaf[(size_t)win * tb.n + j] : 0.0f;
    m_nr = guide_mass(tb, win, x1);
    liw = guide_span(tb, tl, x0, x1, *m_up, m_nr);
    lw = lw + liw;
  }

  int c = -1;
  double h_r;  // the point's height; the trip's decisions take it in double
  float log_iw = 0.0f, strength = 1.0f, log_iw_bias = 0.0f;
  if constexpr (!BIAS) {
    // ---- recombination point: first node whose running sum of branch
    // lengths reaches u * total ----
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < C; ++k)
      s += h.pt[k] < BIG ? (double)h.pt[k] - (double)h.t[k] : 0.0;
    double total;
    const double ex = wide_prefix<G>(s, lane, gm, total);  // lanes before
    const double end = ex + s;  // the running sum at my chunk's end
    const double x_pt = (double)u_pt * total;
    const unsigned hits = wide_ballot<G>(gm, lane <= last && end >= x_pt);
    const int src = hits ? __ffs((int)hits) - 1 : -1;
    int c_l = -1;
    double hr_l = 0.0;
    if (lane == src) {
      double r = 0.0;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (c_l < 0 && k < h.cr && h.j0 + k < N) {
          const double bl =
              h.pt[k] < BIG ? (double)h.pt[k] - (double)h.t[k] : 0.0;
          r += bl;
          const double g = ex + r;
          if (g >= x_pt) {
            c_l = h.j0 + k;
            hr_l = (double)h.t[k] + (x_pt - (g - bl));
          }
        }
      }
    }
    if (src >= 0) {
      c = wide_from<G>(c_l, src, gm);
      h_r = wide_from<G>(hr_l, src, gm);
    } else {
      h_r = x_pt;
    }
  } else {
    // ---- height-biased point: the running sum over the (node, section)
    // segments weighted by strength, node-major, found as the plain point
    // is; the pairs of the hit lane's chunk are weighed again by that lane
    const int S = tb.S;
    if constexpr (GUIDE) {
      // the branches' guide rates (transition.py:124): each lane ranks its
      // internal nodes (n + lane, n + lane + G, ...) in the stable order of
      // the times, an exact count; lane 0 merges them in that order (the
      // mean of the children's rates, a child later in the order read at
      // 0) and gives both children of the last the larger of their two
      // rates
      const int n = tb.n;
      for (int v = n + lane; v < N; v += G) {
        const float tv = w.t[v];
        int rank = 0;
        for (int k = n; k < N; ++k) {
          const float tk = w.t[k];
          rank += (tk < tv || (tk == tv && k < v)) ? 1 : 0;
        }
        w.order[rank] = v;
      }
      __syncwarp(gm);
      if (lane == 0) {
        for (int k = 0; k < n - 1; ++k) {
          const int v = w.order[k];
          w.rate[v] = 0.5f * (w.rate[w.c0[v]] + w.rate[w.c1[v]]);
        }
        const int root = w.order[n - 2];
        const int rc0 = w.c0[root], rc1 = w.c1[root];
        const float mx = fmaxf(w.rate[rc0], w.rate[rc1]);
        w.rate[rc0] = mx;
        w.rate[rc1] = mx;
      }
      __syncwarp(gm);
    }
    // GUIDE: bs sums the segments weighted by the strengths alone
    double s = 0.0, ps = 0.0, bs = 0.0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (h.pt[k] < BIG) {  // the root's lineage and padding weigh nothing
        const double t_k = h.t[k], pt_k = h.pt[k];
        double r_k = 1.0;
        if constexpr (GUIDE) r_k = w.rate[h.j0 + k];
        for (int q = 0; q < S; ++q) {
          const double seg = fmax(fmin(pt_k, (double)tb.bh[q + 1])
                                  - fmax(t_k, (double)tb.bh[q]), 0.0);
          if constexpr (GUIDE) {
            const double wq = seg * (double)tb.bs[q];
            s += wq * r_k;
            bs += wq;
          } else {
            s += seg * (double)tb.bs[q];
          }
          ps += seg;
        }
      }
    }
    double wtot;
    const double ex = wide_prefix<G>(s, lane, gm, wtot);
    const double end = ex + s;
    const double ptot = wide_sum<G>(ps, gm);
    const double x = (double)u_pt * wtot;
    const unsigned hits = wide_ballot<G>(gm, lane <= last && end >= x);
    // no hit only where a sum is not a number: the last pair, as before
    const int src = hits ? __ffs((int)hits) - 1 : last;
    int c_l = -1, q_l = 0;
    double hr_l = 0.0;
    if (lane == src) {
      double r = 0.0, prev = 0.0, lo = 0.0;
      bool found = false;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (!found && k < h.cr && h.j0 + k < N) {
          const double t_k = h.t[k], pt_k = h.pt[k];
          double r_k = 1.0;
          if constexpr (GUIDE) r_k = w.rate[h.j0 + k];
          for (int q = 0; q < S && !found; ++q) {
            const double seg = pt_k < BIG
                ? fmax(fmin(pt_k, (double)tb.bh[q + 1])
                           - fmax(t_k, (double)tb.bh[q]), 0.0)
                : 0.0;
            prev = ex + r;
            if constexpr (GUIDE)
              r += seg * (double)tb.bs[q] * r_k;
            else
              r += seg * (double)tb.bs[q];
            found = ex + r >= x;
            c_l = h.j0 + k;
            q_l = q;
            lo = fmax(t_k, (double)tb.bh[q]);
          }
        }
      }
      // the point's weight per unit length: its strength (times its
      // branch's guide rate)
      double lw_l = tb.bs[q_l];
      if constexpr (GUIDE) lw_l = lw_l * (double)w.rate[c_l];
      hr_l = lo + (x - prev) / fmax(lw_l, 1e-30);
    }
    c = wide_from<G>(c_l, src, gm);
    const int s_hit = wide_from<G>(q_l, src, gm);
    h_r = wide_from<G>(hr_l, src, gm);
    strength = tb.bs[s_hit];
    if constexpr (GUIDE) {
      // log(wtot) - log(ptot) - log(strength rate_c), and against the
      // segments weighted by the strengths alone its height-bias part
      const double local_w = (double)strength * (double)w.rate[c];
      log_iw = (float)log(wtot / (fmax(ptot, 1e-30) * fmax(local_w, 1e-30)));
      log_iw_bias = (float)log(wide_sum<G>(bs, gm)
                               / (fmax(ptot, 1e-30)
                                  * fmax((double)strength, 1e-30)));
    } else {
      // log(wtot) - log(ptot) - log(strength), one logarithm
      log_iw = (float)log(wtot / (fmax(ptot, 1e-30)
                                  * fmax((double)strength, 1e-30)));
      log_iw_bias = log_iw;
    }
  }

  // ---- SMC' hazard inversion (one_trip's, in double) --------------------
  // each epoch's hazard mass above h_r over every node, two epochs at a
  // time, until the running hazard crosses x_exp in the epoch e*; an epoch
  // that ends at or below h_r has none
  const double x_exp = -log1p(-(double)u_exp);
  int es = 0;         // last epoch whose start has lam <= x_exp
  double base = 0.0;  // lam at that epoch's start
  int done = 0;       // epochs whose mass is in w.full
  {
    double run = 0.0;
    for (; done < E && (double)tb.eend[done] <= h_r; ++done) {
      if ((done & (G - 1)) == lane) w.full[done] = 0.0f;
      es = done;
    }
    while (done < E && run <= x_exp) {
      const int e = done;
      const bool two = e + 1 < E;
      double f0, f1;  // (f1 is 0 past the last epoch: an empty interval)
      chunk_overlap2(h, fmax((double)tb.est[e], h_r), tb.eend[e],
                     two ? fmax((double)tb.est[e + 1], h_r) : 0.0,
                     two ? (double)tb.eend[e + 1] : 0.0, f0, f1);
      wide_sum2<G>(f0, f1, gm);
      if ((e & (G - 1)) == lane) w.full[e] = (float)f0;
      if (two && ((e + 1) & (G - 1)) == lane) w.full[e + 1] = (float)f1;
      done = e + 1 + two;
      es = e;
      base = run;
      run += f0 * (double)tb.i2n[e];
      if (two && run <= x_exp) {
        es = e + 1;
        base = run;
        run += f1 * (double)tb.i2n[e + 1];
      }
    }
  }
  const double lo_s = fmax((double)tb.est[es], h_r), hi_s = tb.eend[es];
  const double i2n_s = tb.i2n[es];
  // the node times inside e* are the candidates for t_lo, the greatest
  // with lam <= x_exp; visited in node order, each lane its chunk's
  unsigned cand = 0u;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if ((double)h.t[k] >= lo_s && (double)h.t[k] < hi_s) cand |= 1u << k;
  float ok_v = -BIG, no_v = BIG;  // the best accepted, the least refused
  double lam_lo = base;           // lam at lo_s: nothing overlaps below it
  for (;;) {
    const unsigned has = wide_ballot<G>(gm, cand != 0u);
    if (!has) break;
    const int src = __ffs((int)has) - 1;
    const int j = wide_from<G>(h.j0 + __ffs((int)cand) - 1, src, gm);
    if (lane == src) cand &= cand - 1u;
    const float v = w.t[j];
    if (v <= ok_v || v >= no_v) continue;  // cannot move t_lo
    const double lam =
        base + wide_sum<G>(chunk_overlap(h, lo_s, hi_s, v), gm) * i2n_s;
    if (lam <= x_exp) {
      ok_v = v;
      lam_lo = lam;
    } else {
      no_v = v;
    }
  }
  const double t_lo = fmax((double)ok_v, lo_s);
  const int k_lo = wide_sum<G>(__popc(chunk_crossing(h, t_lo)), gm);
  const double rate_lo = (double)k_lo * i2n_s;
  const double t_c = rate_lo > 0.0
      ? fmin(t_lo + (x_exp - lam_lo) / rate_lo, 0.99 * 3e38)
      : 0.99 * 3e38;

  // ---- coalescence target: the r-th branch crossing t_c -----------------
  const unsigned cm = chunk_crossing(h, t_c);
  const int mine = __popc(cm);
  const int upto = wide_scan<G>(mine, lane, gm);  // crossings to my end
  const float kc = (float)wide_from<G>(upto, G - 1, gm);
  const int r = (int)floorf(u_tgt * fmaxf(kc, 1.0f));
  int d_l = -1;
  if (r >= upto - mine && r < upto) {
    unsigned b = cm;
    for (int skip = r - (upto - mine); skip > 0; --skip) b &= b - 1u;
    d_l = h.j0 + __ffs((int)b) - 1;
  }
  const unsigned dh = wide_ballot<G>(gm, d_l >= 0);
  const int d = dh ? wide_from<G>(d_l, __ffs((int)dh) - 1, gm) : -1;

  // ---- opportunity / count records (one_trip's layout) ------------------
  // at most one epoch is cut at t_c (lo_e < t_c < hi_e): its opportunity
  // below t_c over every node; below it each epoch's whole mass, above 0
  for (int e = done; e < E && (double)tb.eend[e] <= t_c; ++e) {
    // past e* only where t_c is clamped above every epoch's start
    const double f = wide_sum<G>(
        chunk_overlap(h, fmax((double)tb.est[e], h_r), tb.eend[e], BIG), gm);
    if ((e & (G - 1)) == lane) w.full[e] = (float)f;
  }
  int ecut = -1;
  for (int e = 0; e < E; ++e)
    if (!((double)tb.eend[e] <= t_c)
        && !(fmax((double)tb.est[e], h_r) >= t_c))
      ecut = e;
  const double cut_opp = ecut >= 0
      ? wide_sum<G>(chunk_overlap(h, fmax((double)tb.est[ecut], h_r),
                                  tb.eend[ecut], t_c), gm)
      : 0.0;
  int key_epoch = E, lag_epoch = E;
  float vbv = 0.0f;
  for (int e = lane; e < E; e += G) {
    const double st_e = tb.est[e], hi_e = tb.eend[e];
    const double lo_e = fmax(st_e, h_r);
    const double coal_opp = hi_e <= t_c ? (double)w.full[e]
        : e == ecut ? cut_opp : 0.0;
    const double span = fmax(fmin(hi_e, t_c) - lo_e, 0.0);
    const bool in_c = t_c >= st_e && t_c < hi_e;
    const bool in_r = h_r >= st_e && h_r < hi_e;
    if constexpr (BIAS) {
      if (tb.delay_type == 0 ? in_r : in_c) key_epoch = e;
    }
    if (VB && in_c) vbv = tb.vb[e];
    if (LOCAL && in_r) lag_epoch = e;
    pend[e] += (float)coal_opp;
    pend[E + e] += in_c ? 1.0f : 0.0f;
    pend[2 * E + e] += (float)span;
    pend[4 * E + e] += delta * w.tle[e];
    pend[5 * E + e] += in_r ? 1.0f : 0.0f;
  }
  const float vb = VB ? wide_sum<G>(vbv, gm) : 0.0f;

  if constexpr (LOCAL) {
    // ---- the trip's local event (one_trip's): due a lag of h_r's epoch
    // after its position; the leaves below c in the tree before the SPR,
    // leaf l lane l % G's walking up to c, its stripe's ballot the word's
    // bits l - l % G on (leaf 63 the sign bit); lane 0 takes the first
    // free slot and writes the event ----
    int e = wide_min<G>(lag_epoch, gm);
    if (e >= E) e = h_r >= (double)tb.est[0] ? E - 1 : 0;
    constexpr int LSTRIPES = (ML + G - 1) / G;
    unsigned long long desc = 0ull;
#pragma unroll
    for (int k = 0; k < LSTRIPES; ++k) {
      const int l = k * G + lane;
      bool below = false;
      if (l < tb.n) {
        int cur = l;
        for (int s = 0; s < N && cur >= 0; ++s) {
          if (cur == c) {
            below = true;
            break;
          }
          cur = w.par[cur];
        }
      }
      desc |= (unsigned long long)wide_ballot<G>(gm, below) << (k * G);
    }
    if (lane == 0) {
      const unsigned fr = w.lst[0];
      if (fr != 0u) {
        const int slot = __ffs((int)fr) - 1;
        w.lst[0] = fr & (fr - 1u);
        const size_t at = (size_t)i * a->R + slot;
        const float pos = tb.front + nr;
        a->lr_pos[at] = pos;
        a->lr_due[at] = pos + tb.lag[e];
        a->lr_time[at] = (float)h_r;
        a->lr_desc[at] = (long long)desc;
      } else {
        w.lst[1] += 1u;
      }
    }
  }

  if constexpr (ARG) {
    // ---- the trip's ARG rows (one_trip's): leaf l is lane l % G's, its
    // stripe's ballot the word's bits l - l % G on ----
    constexpr int LSTRIPES = (ML + G - 1) / G;
    unsigned long long dc = 0ull, dd = 0ull;
#pragma unroll
    for (int k = 0; k < LSTRIPES; ++k) {
      const int l = k * G + lane;
      bool bc = false, bd = false;
      if (l < tb.n) {
        int cur = l;
        for (int s = 0; s < N && cur >= 0; ++s) {
          bc = bc || cur == c;
          bd = bd || cur == d;
          cur = w.par[cur];
        }
      }
      dc |= (unsigned long long)wide_ballot<G>(gm, bc) << (k * G);
      dd |= (unsigned long long)wide_ballot<G>(gm, bd) << (k * G);
    }
    if (lane == 0) {
      const float pos = tb.front + nr;
      arg_push(*a, i, *an, 0, pos, (float)h_r, -1, -1, (long long)dc);
      arg_push(*a, i, *an + 1, 1, pos, (float)t_c, 0, -1,
               (long long)(dc | dd));
    }
    *an += 2;
  }

  // ---- SPR: cut the branch above c, regraft onto d at t_c (lane 0, once
  // every lane is done reading the tree) -----------------------------------
  __syncwarp(gm);
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
      if (p >= 0) w.t[p] = (float)t_c;
    }
  }
  __syncwarp(gm);

  // ---- refreshed tree summaries, then the next gap ----------------------
  wide_chunk_load<G>(w, N, lane, h);
  wide_summaries<G>(tb, w, h, lane, gm, tl, B);
  if constexpr (GUIDE) {
    // the gap in guide mass from the event's position (smc.py:802-808),
    // whose mass the extension read; it is the next extension's start
    const float gap_m = -log1pf(-u_gap) / fmaxf(tb.rho * tl, 1e-30f);
    const float at = tb.front + nr;
    const float nxt = guide_inv_mass(tb, m_nr + gap_m);
    *m_up = m_nr;
    up = nr;
    nr = nr + fmaxf(nxt - at, 1e-3f);
  } else {
    const float gap = -log1pf(-u_gap) / fmaxf(tb.rho * tl, 1e-30f);
    up = nr;
    nr = nr + gap;
  }
  return TripEvent{(float)h_r, (float)t_c, log_iw, strength, key_epoch, vb,
                   liw, BIAS ? log_iw_bias : log_iw};
}

template <int G, int ML>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS)
    trip_wide_kernel(const Args a) {
  extern __shared__ float smem[];
  WideWork w;
  float* unused;
  const int i = wide_carve<G, ML>(a, smem, false, false, false, w, unused);
  const int lane = threadIdx.x % G;
  const unsigned gm = wide_mask<G>();
  const int N = 2 * a.n - 1, E = a.E;

  float nr = i < a.P ? a.next_rec[i] : BIG;
  wide_stage_tables<ML>(a, smem, false, false, false);
  const bool active = nr < a.L;  // else every output stays as it is
  float up = 0.0f, lw = 0.0f, tl = 0.0f, B = 0.0f;
  if (active) {
    wide_load_tree<G, ML>(a, w, i, N, lane);
#pragma unroll
    for (int q = 0; q < MAX_EPOCHS / G; ++q) {
      const int e = lane + q * G;
      if (e < E) w.tle[e] = a.tl_e[(size_t)i * E + e];
    }
    up = a.upd[i], lw = a.log_w[i], tl = a.tl[i], B = a.B[i];
  }
  __syncthreads();
  if (!active) return;
  Tables tb;
  wide_bind_tables<ML>(a, smem, tb, false, false, false);
  float* pend = a.pending + (size_t)i * 6 * E;
  WideChunk<WIDE_CHUNK(G, ML)> h;
  wide_chunk_load<G>(w, N, lane, h);

  float4 u = load_uniforms(a, 0, i);
  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    const float4 u_next = k + 1 < a.trips ? load_uniforms(a, k + 1, i) : u;
    wide_trip<G, ML, false, false>(tb, w, h, lane, gm, u, pend, nr, up, lw,
                                   tl, B);
    u = u_next;
  }

  __syncwarp(gm);
  wide_store_tree<G>(a, w, i, N, lane);
  for (int e = lane; e < E; e += G) a.tl_e[(size_t)i * E + e] = w.tle[e];
  if (lane == 0) {
    a.next_rec[i] = nr;
    a.upd[i] = up;
    a.log_w[i] = lw;
    a.tl[i] = tl;
    a.B[i] = B;
  }
}

// push_delayed for a group of G lanes: slot s is lane s % G's, bit s / G
// of its mask `changed`
template <int G>
__device__ __forceinline__ void wide_push_delayed(
    const Tables& tb, const WideWork& w, int D, int kk, int lane,
    unsigned gm, float d_h, int key_epoch, float abs_pos, float late,
    float& lp, unsigned& changed) {
  int mine = MAX_DELAY_SLOTS;
  for (int s = lane; s < D; s += G)
    if (w.rpos[s] >= 0.5f * BIG) {
      mine = s;
      break;
    }
  const int first = wide_min<G>(mine, gm);
  if (first >= D) {  // no free slot
    lp = lp + late;
    return;
  }
  int e = wide_min<G>(key_epoch, gm);
  if (first % G != lane) return;
  if (e >= tb.E) e = d_h >= tb.est[0] ? tb.E - 1 : 0;
  const float dd = tb.dl[e] / (float)((1 << kk) - 1);
  w.rpos[first] = abs_pos + dd;
  w.rlogf[first] = late / (float)kk;
  w.rdelta[first] = dd;
  w.rk[first] = kk;
  changed |= 1u << (first / G);
}

// segment_pass_body for the wide tree (ARG without BIAS, GUIDE or LOCAL;
// GUIDE with BIAS).  LOCAL keeps the ring's free slots and drops in the
// group's slice (w.lst, lane 0's), GUIDE the branches' rates (w.rate).
template <int G, int ML, bool BIAS, bool VB, bool ARG = false,
          bool GUIDE = false, bool LOCAL = false>
__device__ __forceinline__ void wide_segment_body(const Args& a) {
  constexpr int SLOTS = MAX_DELAY_SLOTS / G;  // ring slots per lane
  extern __shared__ float smem[];
  WideWork w;
  float* pend;
  const int i = wide_carve<G, ML, LOCAL, GUIDE>(a, smem, true, BIAS, VB, w,
                                                pend);
  const int lane = threadIdx.x % G;
  const unsigned gm = wide_mask<G>();
  const int N = 2 * a.n - 1, E = a.E, K = 6 * a.E;
  const int D = a.K;  // ring slots (BIAS)

  const bool live = i < a.P;
  float nr = 0.0f, lw = 0.0f, up = 0.0f, lp = 0.0f;
  // this lane's ring slots (bit k: slot lane + k G) to write back
  unsigned changed = 0u;
  int an = 0;  // ARG: the ring's rows pushed so far
  wide_stage_tables<ML, LOCAL, GUIDE>(a, smem, true, BIAS, VB);
  if (live) {
    wide_load_tree<G, ML>(a, w, i, N, lane);
    for (int k = lane; k < K; k += G) pend[k] = 0.0f;
    nr = a.next_rec[i], lw = a.log_w[i];
    if constexpr (ARG) an = a.arg_n[i];
    if constexpr (BIAS) {
      lp = a.log_pilot[i];
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int s = lane + k * G;
        if (s < D) w.rpos[s] = a.df_pos[(size_t)i * D + s];
      }
    }
    if constexpr (LOCAL) {
      // the local ring's free slots (slot lane + k G a ballot's bit), read
      // only by a particle that recombines in this segment
      unsigned fr = 0u;
      if (nr < a.L) {
#pragma unroll
        for (int k = 0; k < MAX_LOCAL_SLOTS / G; ++k) {
          const int s = lane + k * G;
          const bool f =
              s < a.R && a.lr_pos[(size_t)i * a.R + s] >= 0.5f * BIG;
          fr |= wide_ballot<G>(gm, f) << (k * G);
        }
      }
      if (lane == 0) {
        w.lst[0] = fr;
        w.lst[1] = 0u;
      }
    }
  }
  if constexpr (GUIDE) wait_copies();  // the guide's staged pivots
  __syncthreads();
  if (!live) return;
  if constexpr (BIAS) {
    // the other words of the slots due at the segment end, under way
    // while the trips run
    const float end = a.front + a.L;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int s = lane + k * G;
      if (s < D && w.rpos[s] <= end) {
        const size_t at = (size_t)i * D + s;
        copy_word_async(&w.rlogf[s], &a.df_logf[at]);
        copy_word_async(&w.rdelta[s], &a.df_delta[at]);
        copy_word_async(&w.rk[s], &a.df_k[at]);
      }
    }
  }
  Tables tb;
  wide_bind_tables<ML, LOCAL, GUIDE>(a, smem, tb, true, BIAS, VB);
  WideChunk<WIDE_CHUNK(G, ML)> h;
  wide_chunk_load<G>(w, N, lane, h);
  float tl, B;
  wide_summaries<G>(tb, w, h, lane, gm, tl, B);  // at segment entry
  float m_up = 0.0f;  // GUIDE: the guide mass at front + up
  if constexpr (GUIDE) m_up = guide_mass(tb, tb.front + up);

  bool moved = false;
  float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.trips > 0 && nr < a.L) u = load_uniforms(a, 0, i);
  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    const float4 u_next = k + 1 < a.trips ? load_uniforms(a, k + 1, i) : u;
    const float delta = nr - up, B_pre = B;
    const TripEvent ev = wide_trip<G, ML, BIAS, VB, ARG, GUIDE, LOCAL>(
        tb, w, h, lane, gm, u, pend, nr, up, lw, tl, B, &a, i, &an, &m_up);
    if (VB) lw = lw + ev.vb;
    if constexpr (BIAS) {
      // segment_pass_body's weights (smc.py:968-1020)
      lp = lp - a.mu * B_pre * delta;
      if constexpr (GUIDE) lp = lp + ev.liw;
      if (VB) lp = lp + ev.vb;
      lw = lw + ev.log_iw;
      const float d_h = a.delay_type == 0 ? ev.h_r : ev.t_c;
      float strength_h = ev.strength;
      if (a.delay_type != 0) {
        int cnt = 0;  // section of d_h
        for (int s = 0; s <= tb.S; ++s) cnt += tb.bh[s] <= d_h ? 1 : 0;
        strength_h = tb.bs[min(max(cnt - 1, 0), tb.S - 1)];
      }
      // the immediate part is the height-bias part (all of log_iw unguided)
      const float imm =
          fabsf(strength_h - 1.0f) < 1e-6f ? ev.log_iw_bias : 0.0f;
      const float late = ev.log_iw - imm;
      lp = lp + imm;
      if (fabsf(late) > 1e-9f)
        wide_push_delayed<G>(tb, w, D, a.delay_k, lane, gm, d_h,
                             ev.key_epoch, a.front + up, late, lp, changed);
    }
    u = u_next;
    moved = true;
  }

  // ---- final extension to the segment end -------------------------------
  const float delta = a.L - up;
  lw = lw - a.mu * B * delta;
  float liwf = 0.0f;
  if constexpr (GUIDE) {
    // the guide's survival weight of the final extension (smc.py:1123-1131)
    if (delta > 0.0f) {
      const float x1 = tb.front + a.L;
      liwf = guide_span(tb, tl, tb.front + up, x1, m_up, guide_mass(tb, x1));
    }
    lw = lw + liwf;
  }
  for (int e = lane; e < E; e += G) pend[4 * E + e] += delta * w.tle[e];
  nr = nr - a.L;
  if constexpr (LOCAL) {
    // the segment's ungated recombination opportunity (each lane's epochs,
    // the lanes' sums in double); the dropped events
    double mine = 0.0;
    for (int e = lane; e < E; e += G) mine += (double)pend[4 * E + e];
    const float ropp = (float)wide_sum<G>(mine, gm);
    if (lane == 0) {
      a.ropp[i] = ropp;
      const int dropped = (int)w.lst[1];
      if (dropped > 0) atomicAdd(a.lr_dropped, dropped);
    }
  }
  if constexpr (BIAS) {
    // ---- the pilot's extension; the delayed factors due at front + L ----
    lp = lp - a.mu * B * delta;
    if constexpr (GUIDE) lp = lp + liwf;
    const float end = a.front + a.L;
    unsigned due = 0u;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int s = lane + k * G;
      if (s < D && w.rpos[s] <= end) due |= 1u << k;
    }
    wait_copies();
    float add = 0.0f;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (due >> k & 1u) {
        const int s = lane + k * G;
        add += w.rlogf[s];
        if (w.rk[s] > 1) {
          w.rpos[s] = w.rpos[s] + 2.0f * w.rdelta[s];
          w.rdelta[s] = 2.0f * w.rdelta[s];
          w.rk[s] = w.rk[s] - 1;
        } else {
          w.rpos[s] = BIG;
          w.rlogf[s] = 0.0f;
          w.rk[s] = 0;
        }
      }
    }
    changed |= due;
    lp = lp + (__any_sync(gm, due != 0u) ? wide_sum<G>(add, gm) : 0.0f);
  }
  __syncwarp(gm);

  // ---- push the segment's statistics into FIFO slot 0 -------------------
  // four of the lane's entries at a time, their reads under way together
  float* slot = a.fifo + (size_t)i * a.fifo_stride;
  for (int k0 = lane; k0 < K; k0 += 4 * G) {
    float v[4], old[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + q * G;
      v[q] = k < K ? pend[k] * tb.gate[k] : 0.0f;
      old[q] = v[q] != 0.0f ? slot[k] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v[q] != 0.0f) slot[k0 + q * G] = old[q] + v[q];
  }

  if (moved) wide_store_tree<G>(a, w, i, N, lane);
  if constexpr (BIAS) {
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (changed >> k & 1u) {
        const int s = lane + k * G;
        const size_t at = (size_t)i * D + s;
        a.df_pos[at] = w.rpos[s];
        a.df_logf[at] = w.rlogf[s];
        a.df_delta[at] = w.rdelta[s];
        a.df_k[at] = w.rk[s];
      }
    }
    if (lane == 0) a.log_pilot[i] = lp;
  }
  if (lane == 0) {
    a.next_rec[i] = nr;
    a.log_w[i] = lw;
    a.tl_out[i] = tl;
    if constexpr (ARG) {
      if (moved) a.arg_n[i] = an;
    }
  }
}

template <int G, int ML, bool VB, bool ARG = false>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS)
    segment_pass_wide_kernel(const Args a) {
  wide_segment_body<G, ML, false, VB, ARG>(a);
}

template <int G, int ML, bool VB>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS)
    segment_pass_biased_wide_kernel(const Args a) {
  wide_segment_body<G, ML, true, VB>(a);
}

// the wide plain pass with local recording (-alpha's iteration 0)
template <int G, int ML, bool VB>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS)
    segment_pass_wide_local_kernel(const Args a) {
  wide_segment_body<G, ML, false, VB, false, false, true>(a);
}

// the wide biased pass guided, with local recording or both (-guide, and
// -alpha's iterations)
template <int G, int ML, bool VB, bool GUIDE, bool LOCAL>
__global__ void __launch_bounds__(BLOCK, WIDE_MIN_BLOCKS)
    segment_pass_biased_wide_proposal_kernel(const Args a) {
  wide_segment_body<G, ML, true, VB, false, GUIDE, LOCAL>(a);
}

// ===========================================================================
// The migration pass: a warp per particle, the particle's tree, buffers,
// walk lists, routing rows and statistics row in shared memory.
//
// What bounds it: latency, neither bytes nor operations.  At the
// two-population path's shape (10,000 particles, 4 leaves, 8 epochs, 56
// events per buffer) a launch has to move a few MB (trees, the buffer
// events the walks read, the rows they change) and compute a few million
// operations, a few us of either.  What it spends is chains of dependent
// steps: each walk event depends on the last, and every particle, walking
// or not, has its round trips to device memory (tree, statistics push).  A
// launch lasts as long as the longest chains among the particles an SM
// holds at once, times the waves in which the SMs take the particles; the
// SM's issue slots are mostly idle, waiting on those chains.
//
// What the design does about it:
//
// * A warp owns a particle and lane l its branch l (N is 7 at 4 leaves, 15
//   at 8), so that particles never share a warp: their walks diverge
//   freely, and every loop over a particle's rows is split 32 ways, which
//   keeps its chain of memory round trips short.
// * A walk event is a short chain.  A lane keeps its branch's node and
//   parent time, its cursor into the branch's buffer, the next buffer event
//   and the population the branch is in (all in registers, advanced only
//   when the walk passes an event); the warp combines the branches with
//   one ballot (k_same is its popcount, the coalescence target the r-th set
//   bit in node order) and one min-reduction of the breakpoints (their
//   bits: all are positive floats, so the integer order is the float
//   order).  The epoch is advanced, not searched.  The next event's Philox
//   draw is computed a step ahead, in the shadow of the current event.  The
//   event's scalar logic runs in every lane on identical values, so
//   nothing is broadcast; lane 0 alone adds into the statistics row and
//   appends to the walk's lists, in event order.
// * Everything indexed by a value lives in the particle's slice of shared
//   memory: the tree with each branch's parent time and length (so that
//   the node-order sums load independently), the buffers of a particle that
//   recombines in this segment (N x Mw times and destinations, staged with
//   vector loads at entry and written back only for the rows the routing
//   changed; a particle that does not recombine never reads them), the
//   walk's two lists, three routing rows and a merge's whole list (used on
//   overflow only), and the statistics row, pushed into FIFO slot 0 once at
//   the end with its reads in flight together.  Destinations are bytes
//   there (a population is below MAX_POPS), which takes a particle's slice
//   from 8.2 KB to 5.3 KB at the twopop shape and lets an SM hold more
//   particles at once.  Nothing is indexed in local memory.
// * Routing by lanes: a filter compacts with one ballot per 32 events; a
//   merge writes each event to its own index plus its rank in the other
//   list (a binary search, ties to the first list); on overflow each lane
//   ranks the holds of its own events.
// * A block is MIG_PPB warps (fewer only if they would not fit in shared
//   memory), so that an SM is refilled a few particles at a time as walks
//   end.
// * The proposal variants (BIAS, GUIDE, LOCAL: segment_pass_mig_proposal_
//   kernel) run the same walk and SPR at the same 96 registers, so what
//   they add must not stay in registers across them (held there, it
//   spilled 56-136 B into the walk's loop).  Their state lives in the
//   particle's scratch (MigExtra): the ring of delayed factors, the pilot
//   weight and the ring's free and pushed slots (lane 0's alone), the
//   point's importance weights and strength, the guide masses and the
//   local ring's free slots and drops.  The entry of every migration
//   kernel, the proposal's or not, puts every table, the tree, the ring
//   and the buffers' times into shared memory by cp.async, all under way
//   at once (a load and its store one after the other would wait a round
//   trip each, and the tables are many); the proposal's tables sit at
//   constant addresses.  The biased point's chain loads
//   MIG_CHAIN addends ahead of its adds, which stay one at a time in
//   node-major order; the delay height's section and epoch are counted by
//   ballots; the guide's masses at the segment's two ends come from their
//   windows' entries staged once a block; the branches' guide rates are
//   merged by lanes in n - 1 rounds of shuffles; the local event takes the
//   leaves below the point from the leaves' path masks by one ballot and
//   is stored by lane 0 before the walk.
//
// Bit for bit: every float operation that feeds a tree or a buffer is the
// plain version's, in its order.  The tree length sums each epoch's
// branches in node order and the epochs in epoch order (so that the next
// gap is the plain version's), the point and the data branch length sum in
// node order, each statistic takes its addends in event order; only exact
// operations (min, max, counts) are spread over lanes.  Uniforms of the
// walk: Philox-4x32-10 under the segment's key, counter (particle, trip,
// event, 0), 24 bits each; kernels/migration.py computes the same numbers.
// ===========================================================================

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0,
                                               unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float u24(unsigned x) {
  return (float)(x >> 8) * 0x1.0p-24f;
}

__device__ __forceinline__ int epoch_of(const float* est, int E, float t) {
  int cnt = 0;
  for (int e = 0; e < E; ++e) cnt += t >= est[e] ? 1 : 0;
  return min(max(cnt - 1, 0), E - 1);
}

#define WARP_ALL 0xffffffffu

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// a population index, held as a byte in shared memory
typedef unsigned char pop_t;

// one particle's slice of shared memory
struct MigWork {
  float* tm;  // [N] node times
  float* pt;  // [N] parent times (BIG at the root)
  float* bl;  // [N] branch lengths (0 at the root)
  int* par;   // [N]
  int* c0;    // [N]
  int* c1;    // [N]
  int* pp;    // [N] population at each node's time
  float* tle;   // [E] tree length per epoch
  float* pend;  // [K] the segment's statistics
  float* mt;    // [N * Mw] the buffers: event times
  float* ev_t;  // [2 Mw] the floating lineage's events
  float* rev_t;  // [2 Mw] the root lineage's events
  float* r1_t;  // [Mw] routing rows
  float* r2_t;
  float* r3_t;
  float* tt_t;  // [3 Mw] a merge's whole list
  pop_t* md;    // destinations of the lists above, in the same order
  pop_t* ev_d;
  pop_t* rev_d;
  pop_t* r1_d;
  pop_t* r2_d;
  pop_t* r3_d;
  pop_t* tt_d;
};

__host__ __device__ inline int mig_stats_width(int E, int Pp) {
  return 3 * E * Pp + E * Pp * Pp + 2 * E;
}

// the proposal variants' tables, first in shared memory at offsets that
// depend on the variant alone: with bias the section table [MAX_SECTIONS
// + 1], its strengths [MAX_SECTIONS] and the delays [MAX_EPOCHS], with
// local recording the lags [MAX_EPOCHS], with the guide the search's first
// pivots [GUIDE_TOP] and the mass table's entries (mass, rate) of the
// windows of the segment's two ends [4]
__host__ __device__ constexpr int mig_proposal_words(bool bias, bool guide,
                                                     bool local) {
  return (bias ? 2 * MAX_SECTIONS + 1 + MAX_EPOCHS : 0)
      + (local ? MAX_EPOCHS : 0) + (guide ? GUIDE_TOP + 4 : 0);
}

// the proposal variants' tables (mig_proposal_words); est [E]; ne,
// tot_mig, pop_map [E Pp]; mig [E Pp Pp]; has_data; the FIFO gate [K];
// with vb the VB tables [E Pp] and [E Pp Pp]
__host__ __device__ inline int mig_table_words(int E, int Pp,
                                               bool vb = false,
                                               bool bias = false,
                                               bool guide = false,
                                               bool local = false) {
  return mig_proposal_words(bias, guide, local) + E + 3 * E * Pp
      + E * Pp * Pp + MAX_LEAVES + mig_stats_width(E, Pp)
      + (vb ? E * Pp + E * Pp * Pp : 0);
}

// the words of MigWork: its floats and ints, then its destination bytes
__host__ __device__ inline int mig_work_words(int N, int E, int Pp, int Mw) {
  const int events = N * Mw + 10 * Mw;
  return 7 * N + E + mig_stats_width(E, Pp) + events + (events + 3) / 4;
}

// the proposal variants' scratch beyond MigWork, at the end of the
// particle's slice, first what has a fixed size (so that each word is at a
// constant offset from the scratch's start): the scalars that cross the
// loop walk [MIG_KEEP]; with bias the ring of delayed factors (positions,
// log factors, spacings, applications left) [MAX_DELAY_SLOTS] each; with
// the guide the branches' rates [MAX_NODES]; then with bias the biased
// point's (node, section) segments, their weighted lengths and running
// sums [N S] each, node-major
#define MIG_KEEP 10
#define MIG_CHAIN 4  // addends of the biased point's chain loaded at once
__host__ __device__ inline int mig_extra_words(int N, int S, bool bias,
                                               bool guide,
                                               bool local = false) {
  return (bias || guide || local ? MIG_KEEP : 0)
      + (bias ? 4 * MAX_DELAY_SLOTS + 3 * N * S : 0)
      + (guide ? MAX_NODES : 0);
}

// the words of MigExtra::keep: the pilot weight, the point's importance
// weights and strength, the ring's free slots and the slots pushed (bits);
// the guide masses at front + up and at front + nr; the local ring's free
// slots (bits) and the events it dropped
enum { K_LP, K_IW, K_IW_BIAS, K_STRENGTH, K_DFREE, K_PUSHED, K_M_UP, K_M_NR,
       K_LFREE, K_LDROP };

struct MigExtra {
  float* keep;
  float* rpos;
  float* rlogf;
  float* rdelta;
  int* rk;
  float* rate;
  float* seg;
  float* wseg;
  float* cum;
};

// The scratch of the proposal variants (mig_extra_words) from its start f.
__device__ __forceinline__ MigExtra carve_extra(float* f, int Q, bool bias,
                                                bool guide) {
  MigExtra x;
  x.keep = f;
  x.rpos = f + MIG_KEEP;
  x.rlogf = x.rpos + MAX_DELAY_SLOTS;
  x.rdelta = x.rlogf + MAX_DELAY_SLOTS;
  x.rk = reinterpret_cast<int*>(x.rdelta + MAX_DELAY_SLOTS);
  x.rate = f + MIG_KEEP + (bias ? 4 * MAX_DELAY_SLOTS : 0);
  x.seg = x.rate + (guide ? MAX_NODES : 0);
  x.wseg = x.seg + Q;
  x.cum = x.wseg + Q;
  return x;
}

__device__ MigWork carve_mig(float* f, int N, int E, int K, int Mw) {
  MigWork w;
  w.tm = f;
  w.pt = (f += N);
  w.bl = (f += N);
  w.par = reinterpret_cast<int*>(f += N);
  w.c0 = reinterpret_cast<int*>(f += N);
  w.c1 = reinterpret_cast<int*>(f += N);
  w.pp = reinterpret_cast<int*>(f += N);
  w.tle = (f += N);
  w.pend = (f += E);
  w.mt = (f += K);
  w.ev_t = (f += N * Mw);
  w.rev_t = (f += 2 * Mw);
  w.r1_t = (f += 2 * Mw);
  w.r2_t = (f += Mw);
  w.r3_t = (f += Mw);
  w.tt_t = (f += Mw);
  pop_t* b = reinterpret_cast<pop_t*>(f + 3 * Mw);
  w.md = b;
  w.ev_d = (b += N * Mw);
  w.rev_d = (b += 2 * Mw);
  w.r1_d = (b += 2 * Mw);
  w.r2_d = (b += Mw);
  w.r3_d = (b += Mw);
  w.tt_d = (b += Mw);
  return w;
}

// Global rows (gt, gd)[0, len) into shared memory by the warp's lanes: the
// times by cp.async, under way until the caller's wait_copies(); the
// destinations' loads four at a time ahead of their stores
__device__ void stage_events(const float* gt, const int* gd, float* st,
                             pop_t* sd, int len, int lane) {
  for (int k = lane; k < len; k += 32) copy_word_async(&st[k], &gt[k]);
#pragma unroll 4
  for (int k = lane; k < len; k += 32) sd[k] = (pop_t)gd[k];
}

// (ot, od)[0, len) = (t, d)[0, len); lane l moves entries l, l + 32, ...
template <typename D, typename OD>
__device__ __forceinline__ void g_copy(const float* t, const D* d, int len,
                                       float* ot, OD* od, int lane) {
  for (int k = lane; k < len; k += 32) {
    ot[k] = t[k];
    od[k] = (OD)d[k];
  }
}

// The first index of t[0, len) that is not below BIG (len if none).
__device__ int g_nvalid(const float* t, int len, int lane) {
  for (int base = 0; base < len; base += 32) {
    const int k = base + lane;
    const unsigned bad = __ballot_sync(WARP_ALL, k < len && !(t[k] < BIG));
    if (bad != 0u) return base + __ffs(bad) - 1;
  }
  return len;
}

// The events of (t, d)[0, len) with lo <= t < hi, in order, into
// (ot, od)[0, len), BIG/0-padded (transition.py:1107): one ballot per 32
// events gives each kept event its place.
__device__ void g_filter(const float* t, const pop_t* d, int len, float lo,
                         float hi, float* ot, pop_t* od, int lane) {
  int kept = 0;
  for (int base = 0; base < len; base += 32) {
    const int j = base + lane;
    float v = BIG;
    pop_t dv = 0;
    if (j < len) {
      v = t[j];
      dv = d[j];
    }
    const bool keep = j < len && v >= lo && v < hi && v < BIG;
    const unsigned bits = __ballot_sync(WARP_ALL, keep);
    if (keep) {
      const int at = kept + __popc(bits & lanes_below(lane));
      ot[at] = v;
      od[at] = dv;
    }
    kept += __popc(bits);
  }
  for (int k = kept + lane; k < len; k += 32) {
    ot[k] = BIG;
    od[k] = 0;
  }
}

// How many of a[0, n) (ascending) come before v in a merge: those below v,
// or not above it when a is the first list (ties go to the first list).
__device__ __forceinline__ int merge_rank(const float* a, int n, float v,
                                          bool a_first) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before = a_first ? a[mid] <= v : a[mid] < v;
    if (before)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Merge two ascending BIG-padded lists into (ot, od)[0, M): by time, ties
// to the first list; if more than M are valid, keep the M with the longest
// hold (time to the next merged event, BIG for the last), of equal holds
// the earlier (transition.py:1125).  Each event goes to its own index plus
// its rank in the other list: into the output directly, or on overflow
// into (tt, td), whose holds each lane then ranks for its own events.  No
// output may alias an input; the inputs must be visible to the whole
// warp.  Returns the number dropped.
__device__ int g_merge_hold(const float* at, const pop_t* ad, int la,
                            const float* bt, const pop_t* bd, int lb, int M,
                            float* ot, pop_t* od, float* tt, pop_t* td,
                            int lane) {
  const int na = g_nvalid(at, la, lane), nb = g_nvalid(bt, lb, lane);
  const int nv = na + nb;
  float* mt = nv <= M ? ot : tt;
  pop_t* md = nv <= M ? od : td;
  for (int k = lane; k < na; k += 32) {
    const float v = at[k];
    const int to = k + merge_rank(bt, nb, v, false);
    mt[to] = v;
    md[to] = ad[k];
  }
  for (int k = lane; k < nb; k += 32) {
    const float v = bt[k];
    const int to = k + merge_rank(at, na, v, true);
    mt[to] = v;
    md[to] = bd[k];
  }
  if (nv <= M) {
    for (int k = nv + lane; k < M; k += 32) {
      ot[k] = BIG;
      od[k] = 0;
    }
    return 0;
  }
  __syncwarp();
  int kept = 0;  // ends at M: the ranks are a permutation of 0..nv-1
  for (int base = 0; base < nv; base += 32) {
    const int k = base + lane;
    bool keep = false;
    float v = 0.0f;
    pop_t dv = 0;
    if (k < nv) {
      v = tt[k];
      dv = td[k];
      const float h_k = (k + 1 < nv ? tt[k + 1] : BIG) - v;
      int before = 0;
      for (int j = 0; j < nv && before < M; ++j) {
        const float h_j = (j + 1 < nv ? tt[j + 1] : BIG) - tt[j];
        if (h_j > h_k || (h_j == h_k && j < k)) ++before;
      }
      keep = before < M;
    }
    const unsigned bits = __ballot_sync(WARP_ALL, keep);
    if (keep) {
      const int to = kept + __popc(bits & lanes_below(lane));
      ot[to] = v;
      od[to] = dv;
    }
    kept += __popc(bits);
  }
  return nv - M;
}

// Each branch's parent time and length from the tree (lane j, branch j).
// The tree must be visible to the whole warp; the caller syncs after.
__device__ __forceinline__ void mig_branches(const MigWork& w, int N,
                                             int lane) {
  if (lane < N) {
    const int p = w.par[lane];
    const float t = w.tm[lane];
    const float pt = p >= 0 ? w.tm[p] : BIG;
    w.pt[lane] = pt;
    w.bl[lane] = p >= 0 ? pt - t : 0.0f;
  }
}

// tl, tle[E] (in w.tle) and B of the tree in w for the segment's leaf
// status: each epoch's branches summed in node order (lanes over epochs),
// the epochs in epoch order, the informative branches in node order.  Every
// lane returns the same tl and B.  The tree and its branches (mig_branches)
// must be visible to the whole warp on entry.
__device__ void mig_summaries(const float* est, const int* hd,
                              const MigWork& w, int n, int E,
                              int leaf_status, int lane, float& tl,
                              float& B) {
  const int N = 2 * n - 1;
  for (int e = lane; e < E; e += 32) {
    const float lo = est[e];
    const float hi = e + 1 < E ? est[e + 1] : BIG;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_NODES; ++j)
      if (j < N && w.par[j] >= 0)
        s += fmaxf(fminf(w.pt[j], hi) - fmaxf(w.tm[j], lo), 0.0f);
    w.tle[e] = s;
  }
  __syncwarp();
  tl = 0.0f;
  for (int e = 0; e < E; ++e) tl += w.tle[e];
  if (leaf_status == 1) {
    B = tl;
    return;
  }
  if (leaf_status == -1) {
    B = 0.0f;
    return;
  }
  // the data leaves below the lane's branch, from the leaves' ancestor
  // chains
  unsigned below = 0u;
  int total = 0;
  for (int l = 0; l < n; ++l) {
    if (!hd[l]) continue;
    ++total;
    int cur = l;
    for (int step = 0; step < n && cur >= 0; ++step) {
      if (cur == lane) below |= 1u << l;
      cur = w.par[cur];
    }
  }
  // informative branches (at least one and not all data leaves below)
  float b = 0.0f;
  for (int j = 0; j < N; ++j) {
    const int cnt = __popc(__shfl_sync(WARP_ALL, below, j));
    if (w.par[j] >= 0 && cnt >= 1 && cnt < total) b += w.bl[j];
  }
  B = b;
}

// ARG pushes each trip's R, C and M rows (smc.py:1021-1052) into the
// particle's ARG ring: the leaves below c and below d by one ballot of the
// leaves' lanes (lanes 0-7 and 8-15), each holding its path to the root in
// the tree before the SPR (walked at the trip's start, under way with the
// point and the loop walk), the coalescence's population, and the walk's
// first ARG_MIG_ROWS hops from its lists in shared memory; lane r holds
// row r and writes it at the trip's end, after the SPR's warp syncs.
#define ARG_MIG_ROWS 4
template <bool VB, bool ARG, bool BIAS, bool GUIDE, bool LOCAL>
__device__ __forceinline__ void mig_pass_body(const Args& a) {
  extern __shared__ float smem[];
  const bool vb = VB;
  const int n = a.n, N = 2 * n - 1, E = a.E, Pp = a.Pp, Mw = a.Mw;
  const int EP = E * Pp, K = mig_stats_width(E, Pp);
  const int o_coal_cnt = EP, o_mig_opp = 2 * EP, o_mig_cnt = 3 * EP;
  const int o_ropp = 3 * EP + EP * Pp, o_rcnt = o_ropp + E;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const bool live = i < a.P;

  // ---- the block's tables -----------------------------------------------
  // the proposal variants' tables, at constant addresses
  float* const bh = smem;
  float* const bs = bh + MAX_SECTIONS + 1;
  float* const dl = bs + MAX_SECTIONS;
  float* const lag = smem + mig_proposal_words(BIAS, false, false);
  float* const top = smem + mig_proposal_words(BIAS, false, LOCAL);
  float* est = smem + mig_proposal_words(BIAS, GUIDE, LOCAL);
  float* ne = est + E;
  float* tot = ne + EP;
  float* mig = tot + EP;
  int* pmap = reinterpret_cast<int*>(mig + EP * Pp);
  int* hd = pmap + EP;
  float* gate = reinterpret_cast<float*>(hd + MAX_LEAVES);
  float* vbc = gate + K;  // the VB tables, if vb
  float* vbm = vbc + EP;
  // GUIDE: the guide's functions' view of its tables, built where it is
  // used (so that no register holds it across the walk)
  auto gtab = [&]() {
    Tables t;
    t.g_rel = a.g_rel;
    t.cum_mass = a.cum_mass;
    t.g_top = top;
    t.Wg = a.Wg;
    t.ws = a.ws;
    t.rho = a.rho;
    return t;
  };
  // GUIDE: the guide mass at front (end 0) and at front + L (end 1), from
  // their windows' entries in the block's tables (guide_mass's sums)
  auto gmass_end = [&](int end) {
    const float x = a.front + (end ? a.L : 0.0f);
    const int win = guide_window(gtab(), x);
    return top[GUIDE_TOP + 2 * end]
        + (x - (float)win * a.ws) * top[GUIDE_TOP + 2 * end + 1];
  };
  // every table's copy under way at once, each thread's copies one after
  // another with no wait between them (the leaves' data flags, computed,
  // follow the particle's loads)
  for (int k = threadIdx.x; k < E; k += blockDim.x)
    copy_word_async(&est[k], &a.epoch_start[k]);
  for (int k = threadIdx.x; k < EP; k += blockDim.x) {
    copy_word_async(&ne[k], &a.ne[k]);
    copy_word_async(&tot[k], &a.tot_mig[k]);
    copy_word_async(&pmap[k], &a.pop_map[k]);
  }
  for (int k = threadIdx.x; k < EP * Pp; k += blockDim.x)
    copy_word_async(&mig[k], &a.mig[k]);
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    copy_word_async(&gate[k], &a.fifo_mask[k]);
  if (vb) {
    for (int k = threadIdx.x; k < EP; k += blockDim.x)
      copy_word_async(&vbc[k], &a.vb_coal[k]);
    for (int k = threadIdx.x; k < EP * Pp; k += blockDim.x)
      copy_word_async(&vbm[k], &a.vb_mig[k]);
  }
  if constexpr (BIAS) {
    for (int k = threadIdx.x; k <= a.S; k += blockDim.x)
      copy_word_async(&bh[k], &a.bias_heights[k]);
    for (int k = threadIdx.x; k < a.S; k += blockDim.x)
      copy_word_async(&bs[k], &a.bias_strengths[k]);
    for (int k = threadIdx.x; k < E; k += blockDim.x)
      copy_word_async(&dl[k], &a.delays[k]);
  }
  if constexpr (LOCAL) {
    for (int k = threadIdx.x; k < E; k += blockDim.x)
      copy_word_async(&lag[k], &a.lags[k]);
  }
  if constexpr (GUIDE) {
    for (int k = threadIdx.x; k < GUIDE_TOP; k += blockDim.x)
      copy_word_async(&top[k], &a.g_top[k]);
    // every particle's extension starts at the front (up = 0) and the
    // final one ends at front + L: their windows' entries once a block
    if (threadIdx.x < 2) {
      const int win = guide_window(
          gtab(), a.front + (threadIdx.x ? a.L : 0.0f));
      copy_word_async(&top[GUIDE_TOP + 2 * threadIdx.x],
                      &a.cum_mass[win]);
      copy_word_async(&top[GUIDE_TOP + 2 * threadIdx.x + 1],
                      &a.g_rel[win]);
    }
  }
  const int S = BIAS ? a.S : 0, Q = N * S, D = BIAS ? a.K : 0;
  const int words = mig_work_words(N, E, Pp, Mw)
      + ((BIAS || GUIDE || LOCAL) ? mig_extra_words(N, S, BIAS, GUIDE, LOCAL)
                                  : 0);
  const MigWork w = carve_mig(
      smem + mig_table_words(E, Pp, vb, BIAS, GUIDE, LOCAL)
          + (size_t)(threadIdx.x / 32) * words,
      N, E, K, Mw);
  MigExtra xw{};
  if constexpr (BIAS || GUIDE || LOCAL)
    xw = carve_extra(smem + mig_table_words(E, Pp, vb, BIAS, GUIDE, LOCAL)
                         + (size_t)(threadIdx.x / 32) * words
                         + mig_work_words(N, E, Pp, Mw),
                     Q, BIAS, GUIDE);

  // ---- the particle's tree, a zeroed statistics row and, if it
  // recombines in this segment, its buffers: all under way before the one
  // barrier
  float nr = 0.0f, lw = 0.0f;
  ArgCursor ac{0, 0};  // ARG: the ring's rows pushed so far, next slot
  bool lfree = false;  // LOCAL: slot `lane` of the local ring is free
  // the proposal's state lives in the particle's scratch (xw), not in
  // registers, so that the loop walk and the SPR run with the plain pass's
  // live set: BIAS the pilot weight (lane 0's alone) and slot `lane` of the
  // ring of delayed factors (slot s: lane s's words, under way with the
  // tree)
  unsigned* const ku = reinterpret_cast<unsigned*>(xw.keep);
  if (live) {
    nr = a.next_rec[i];
    lw = a.log_w[i];
    if constexpr (ARG) ac.n = a.arg_n[i];
    if constexpr (BIAS) {
      if (lane == 0) copy_word_async(&xw.keep[K_LP], &a.log_pilot[i]);
      if (lane < D) {
        const size_t at = (size_t)i * D + lane;
        copy_word_async(&xw.rpos[lane], &a.df_pos[at]);
        copy_word_async(&xw.rlogf[lane], &a.df_logf[at]);
        copy_word_async(&xw.rdelta[lane], &a.df_delta[at]);
        copy_word_async(&xw.rk[lane], &a.df_k[at]);
      }
    }
    if (lane < N) {
      const size_t at = (size_t)i * N + lane;
      copy_word_async(&w.tm[lane], &a.time[at]);
      copy_word_async(&w.par[lane], &a.parent[at]);
      copy_word_async(&w.c0[lane], &a.child0[at]);
      copy_word_async(&w.c1[lane], &a.child1[at]);
      copy_word_async(&w.pp[lane], &a.pop[at]);
    }
    for (int k = lane; k < K; k += 32) w.pend[k] = 0.0f;
    // what only a particle that recombines in this segment reads, after
    // the loads that wait for no next_rec
    if (a.trips > 0 && nr < a.L) {
      if constexpr (LOCAL) {
        if (lane < a.R)
          lfree = a.lr_pos[(size_t)i * a.R + lane] >= 0.5f * BIG;
      }
      const float* gt = a.mig_time + (size_t)i * N * Mw;
      const int* gd = a.mig_dest + (size_t)i * N * Mw;
      stage_events(gt, gd, w.mt, w.md, N * Mw, lane);
    }
  }
  for (int l = threadIdx.x; l < MAX_LEAVES; l += blockDim.x)
    hd[l] = (l < n && a.has_data[l] != 0) ? 1 : 0;
  wait_copies();
  __syncthreads();
  if (!live) return;
  if constexpr (BIAS) {
    // the ring's free slots (bit s: slot s), lane 0's from here on
    const unsigned frees =
        __ballot_sync(WARP_ALL, lane < D && xw.rpos[lane] >= 0.5f * BIG);
    if (lane == 0) {
      ku[K_DFREE] = frees;
      ku[K_PUSHED] = 0u;
    }
  }

  mig_branches(w, N, lane);
  __syncwarp();
  float tl, B;
  mig_summaries(est, hd, w, n, E, a.leaf_status, lane, tl, B);
  const unsigned k0 = (unsigned)a.key[0], k1 = (unsigned)a.key[1];
  float up = 0.0f, capped = 0.0f, dropped = 0.0f;
  if constexpr (LOCAL) {
    // the ring's free slots (bit s: slot s) and the events dropped, lane
    // 0's alone
    const unsigned frees = __ballot_sync(WARP_ALL, lfree);
    if (lane == 0) {
      ku[K_LFREE] = frees;
      ku[K_LDROP] = 0u;
    }
  }
  // GUIDE: the guide mass at front + up, lane 0's
  if constexpr (GUIDE) {
    if (lane == 0) xw.keep[K_M_UP] = gmass_end(0);
  }
  bool moved = false;
  unsigned dirty = 0u;  // buffer rows to write back
  // ARG: the first row's slot (arg_slot_of), once a segment
  if constexpr (ARG) {
    if (a.trips > 0 && nr < a.L) ac.slot = arg_slot_of(ac.n, a.A);
  }

  for (int k = 0; k < a.trips; ++k) {
    if (!(nr < a.L)) break;
    const float4 u = load_uniforms(a, k, i);
    const float u_pt = clip_u(u.x), u_gap = clip_u(u.w);
    // ARG, LOCAL: leaf `lane`'s path to the root in the tree before the
    // SPR, and lane 8 + l leaf l's too, for one ballot
    unsigned path = 0u;
    if constexpr (ARG || LOCAL)
      path = leaf_path<MAX_NODES>(w.par, lane & 7, lane < 16 ? n : 0);
    // ARG: this lane's row of the trip (lane 0 R, lane 1 C, lane 2 + j the
    // M row of hop j), whether it is written, the trip's rows
    float row_t = 0.0f;
    int row_from = 0, row_to = 0, rows = 0;
    unsigned row_desc = 0u;
    bool row_put = false;
    // the walk's first draw is under way while the point is found; the
    // biased point without local recording holds too many registers for
    // it, and takes it after
    constexpr bool DRAW_LATE = BIAS && !LOCAL;
    uint4 r4_next = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (!DRAW_LATE)
      r4_next = philox4x32_10(
          make_uint4((unsigned)i, (unsigned)k, 0u, 0u), k0, k1);

    // ---- extension ------------------------------------------------------
    const float delta = nr - up;
    lw = lw - a.mu * B * delta;
    float leaf_rate = 0.0f;  // GUIDE: leaf `lane`'s rate at the event
    if constexpr (GUIDE) {
      // the guide's survival weight over the extension (smc.py:903-914);
      // the pilot weight takes it after the walk.  Lane l reads leaf l's
      // rate at the event's window.  The warp sync orders lane 0's writes
      // of the masses (at the last gap, and below) after every lane's
      // reads
      __syncwarp();
      const Tables gt = gtab();
      const float x1 = a.front + nr;
      const int win = guide_window(gt, x1);
      if (lane < n) leaf_rate = a.g_leaf[(size_t)win * n + lane];
      const float m_nr = guide_mass(gt, win, x1);
      lw = lw + guide_span(gt, tl, a.front + up, x1, xw.keep[K_M_UP], m_nr);
      if (lane == 0) xw.keep[K_M_NR] = m_nr;
    }
    for (int e = lane; e < E; e += 32) w.pend[o_ropp + e] += delta * w.tle[e];

    int c = -1;
    float h_r;
    if constexpr (!BIAS) {
      // ---- uniform point: running sum of branch lengths in node order ---
      float total = 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_NODES; ++j)
        if (j < N) total += w.bl[j];
      const float x_pt = u_pt * total;
      float cum = 0.0f, prev = 0.0f;
#pragma unroll
      for (int j = 0; j < MAX_NODES; ++j) {
        if (j < N) {
          const float before = cum;
          cum += w.bl[j];
          if (c < 0 && cum >= x_pt) {
            c = j;
            prev = before;
          }
        }
      }
      if (c < 0) {
        c = N - 1;
        prev = cum - w.bl[N - 1];
      }
      h_r = w.tm[c] + (x_pt - prev);
    } else {
      // ---- height-biased point (transition.py:160): the segments
      // |branch_j ∩ section_s| weighted by strength_s (times branch j's
      // guide rate), node-major; the first whose running sum reaches u
      // times their total, the last if rounding leaves none.  Lane j
      // weighs node j's segments; every lane then adds them in node-major
      // order as one chain (the plain version's order), lane q % 32
      // keeping running sum q; each lane searches its own pairs ----
      if constexpr (GUIDE) {
        // the branches' guide rates (transition.py:124): the leaves' rates
        // at the event's window, merged bottom up in the stable order of
        // the internal nodes' times, each the mean of its children's rates
        // as the merge has them at its turn (a child merged later reads 0,
        // a missing child, -1 in an internal node a forest leaves unused,
        // the last node's rate, as the plain version does); then both
        // children of the last take the larger of their two rates.  Lane
        // v holds node v's rate and ranks internal node v; n - 1 rounds
        // of the same sums, each from the last round's rates, end at the
        // merge's, since a node's turn comes after those it reads
        float rv = lane < n ? leaf_rate : 0.0f;
        int rank = -1, x0 = 0, x1 = 0;
        if (lane >= n && lane < N) {
          const float tv = w.tm[lane];
          rank = 0;
          for (int q = n; q < N; ++q) {
            const float tq = w.tm[q];
            rank += (tq < tv || (tq == tv && q < lane)) ? 1 : 0;
          }
          x0 = w.c0[lane] < 0 ? N - 1 : w.c0[lane];
          x1 = w.c1[lane] < 0 ? N - 1 : w.c1[lane];
        }
        const bool own = lane >= n && lane < N;
        const bool read0 = __shfl_sync(WARP_ALL, rank, x0) < rank;
        const bool read1 = __shfl_sync(WARP_ALL, rank, x1) < rank;
        for (int r = 0; r < n - 1; ++r) {
          const float a0 = __shfl_sync(WARP_ALL, rv, x0);
          const float a1 = __shfl_sync(WARP_ALL, rv, x1);
          if (own) rv = 0.5f * ((read0 ? a0 : 0.0f) + (read1 ? a1 : 0.0f));
        }
        const int root = __ffs((int)__ballot_sync(WARP_ALL, rank == n - 2)) - 1;
        const int rc0 = __shfl_sync(WARP_ALL, x0, root);
        const int rc1 = __shfl_sync(WARP_ALL, x1, root);
        const float mx = fmaxf(__shfl_sync(WARP_ALL, rv, rc0),
                               __shfl_sync(WARP_ALL, rv, rc1));
        if (lane == rc0 || lane == rc1) rv = mx;
        if (lane < N) xw.rate[lane] = rv;
        __syncwarp();
      }
      if (lane < N) {
        const float t_j = w.tm[lane], pt_j = w.pt[lane];
        const float r_j = GUIDE ? xw.rate[lane] : 1.0f;
        for (int q = 0; q < S; ++q) {
          const float seg = pt_j < BIG
              ? fmaxf(fminf(pt_j, bh[q + 1]) - fmaxf(t_j, bh[q]), 0.0f)
              : 0.0f;
          xw.seg[lane * S + q] = seg;
          if constexpr (GUIDE) {
            xw.wseg[lane * S + q] = seg * bs[q] * r_j;
          } else {
            xw.wseg[lane * S + q] = seg * bs[q];
          }
        }
      }
      __syncwarp();
      // the chain, MIG_CHAIN addends at a time: their loads (and under the
      // guide the products btot takes) issued ahead of the adds, the adds
      // one at a time in node-major order; past Q each addend is +0, which
      // leaves the non-negative sums' bits as they are
      float wtot = 0.0f, ptot = 0.0f, btot = 0.0f;
      int s_q = 0;
      for (int q0 = 0; q0 < Q; q0 += MIG_CHAIN) {
        float wv[MIG_CHAIN], pv[MIG_CHAIN], bv[MIG_CHAIN];
#pragma unroll
        for (int j = 0; j < MIG_CHAIN; ++j) {
          const bool in = q0 + j < Q;
          wv[j] = in ? xw.wseg[q0 + j] : 0.0f;
          pv[j] = in ? xw.seg[q0 + j] : 0.0f;
          if constexpr (GUIDE) {
            bv[j] = pv[j] * bs[s_q];
            s_q = s_q + 1 == S ? 0 : s_q + 1;
          }
        }
#pragma unroll
        for (int j = 0; j < MIG_CHAIN; ++j) {
          wtot += wv[j];
          ptot += pv[j];
          if constexpr (GUIDE) btot += bv[j];
          if (q0 + j < Q && ((q0 + j) & 31) == lane) xw.cum[q0 + j] = wtot;
        }
      }
      __syncwarp();
      const float xb = u_pt * wtot;
      unsigned mine = (unsigned)Q;
      for (int q = lane; q < Q; q += 32)
        if (xw.cum[q] >= xb) {
          mine = (unsigned)q;
          break;
        }
      const int hit = (int)__reduce_min_sync(WARP_ALL, mine);
      const int q_hit = hit < Q ? hit : Q - 1;
      c = q_hit / S;
      const int s_hit = q_hit - c * S;
      const float prev = q_hit > 0 ? xw.cum[q_hit - 1] : 0.0f;
      const float strength = bs[s_hit];
      const float local_w = GUIDE ? strength * xw.rate[c] : strength;
      h_r = fmaxf(w.tm[c], bh[s_hit]) + (xb - prev) / fmaxf(local_w, 1e-30f);
      // the importance weights and the strength, for after the walk
      if (lane == 0) {
        const float log_iw = logf(wtot) - logf(fmaxf(ptot, 1e-30f))
            - logf(fmaxf(local_w, 1e-30f));
        xw.keep[K_IW] = log_iw;
        if constexpr (GUIDE)
          xw.keep[K_IW_BIAS] = logf(btot) - logf(fmaxf(ptot, 1e-30f))
              - logf(fmaxf(strength, 1e-30f));
        else
          xw.keep[K_IW_BIAS] = log_iw;
        xw.keep[K_STRENGTH] = strength;
      }
    }
    // ---- the loop walk from (c, h_r) --------------------------------------
    if constexpr (DRAW_LATE)
      r4_next = philox4x32_10(
          make_uint4((unsigned)i, (unsigned)k, 0u, 0u), k0, k1);
    const unsigned roots = __ballot_sync(WARP_ALL,
                                         lane < N && w.par[lane] < 0);
    const int root = roots != 0u ? __ffs(roots) - 1 : 0;
    const float root_h = w.tm[root];
    // the lane's branch: node and parent time, and a cursor past its
    // buffer events so far (the walk only moves up, so it only advances)
    // with the next event's time and the population the branch is in
    const bool mine = lane < N;
    const float* row = w.mt + (mine ? lane : 0) * Mw;
    const pop_t* drow = w.md + (mine ? lane : 0) * Mw;
    const float bt = mine ? w.tm[lane] : BIG;
    const float bpt = mine ? w.pt[lane] : BIG;
    int bq = 0, bpop = mine ? w.pp[lane] : 0;
    float bnext = mine ? row[0] : BIG;
    if (mine) {
      while (bq < Mw && bnext <= h_r) {
        bpop = drow[bq];
        ++bq;
        bnext = bq < Mw ? row[bq] : BIG;
      }
    }
    // the floating lineage starts in c's population after c's own events
    // below h_r
    int p_raw = __shfl_sync(WARP_ALL, bpop, c);
    const int p_start = p_raw;  // the first M row's source (ARG)
    int r_raw = w.pp[root];
    int e = epoch_of(est, E, h_r);
    float tt = h_r, t_c = 0.0f;
    if constexpr (LOCAL) {
      // ---- the trip's local event (smc.py:1054-1069): at front + nr, due
      // a lag of h_r's epoch later, the leaves below c in the tree before
      // the SPR (one ballot of the leaves' paths); into the first free
      // slot, a full ring counts it dropped.  The walk changes none of it,
      // so lane 0 stores it now, with h_r's epoch as the walk starts it ----
      const unsigned desc =
          __ballot_sync(WARP_ALL, lane < n && (path >> c & 1u) != 0u);
      if (lane == 0) {
        const unsigned frees = ku[K_LFREE];
        if (frees != 0u) {
          ku[K_LFREE] = frees & (frees - 1u);
          const size_t at = (size_t)i * a.R + (__ffs((int)frees) - 1);
          const float pos = a.front + nr;
          a.lr_pos[at] = pos;
          a.lr_due[at] = pos + lag[e];
          a.lr_time[at] = h_r;
          a.lr_desc[at] = (long long)desc;
        } else {
          ku[K_LDROP] += 1u;
        }
      }
    }
    int d = -1, fpop = 0, n_ev = 0, n_rev = 0;
    bool done = false;
    // the trip's VB term: its coalescence's entry, its migrations' in
    // event order (every lane holds the same)
    float vb_c = 0.0f, vb_m = 0.0f;
    for (int ev = 0; ev < a.max_events && !done; ++ev) {
      const uint4 r4 = r4_next;
      r4_next = philox4x32_10(
          make_uint4((unsigned)i, (unsigned)k, (unsigned)(ev + 1), 0u), k0,
          k1);
      // the epoch of tt (epoch starts ascend) and the next epoch start
      while (e + 1 < E && tt >= est[e + 1]) ++e;
      const float next_epoch = e + 1 < E ? est[e + 1] : BIG;
      const int* pm = pmap + e * Pp;
      const int p_cur = pm[p_raw], r_cur = pm[r_raw];
      const bool above = tt >= root_h;
      // the lane's branch: cursor, population, membership, breakpoints
      float tbk = BIG;
      bool member = false;
      if (mine) {
        while (bq < Mw && bnext <= tt) {
          bpop = drow[bq];
          ++bq;
          bnext = bq < Mw ? row[bq] : BIG;
        }
        const int bp = lane == root ? r_cur : pm[bpop];
        member = bt <= tt && tt < bpt && bp == p_cur;
        if (bt > tt) tbk = bt;
        tbk = fminf(tbk, bnext);
      }
      const unsigned members = __ballot_sync(WARP_ALL, member);
      const int kc = __popc(members);
      // every candidate is above tt >= 0 (or BIG): positive floats order
      // as their bits do
      const float t_bk = fminf(
          __uint_as_float(__reduce_min_sync(WARP_ALL, __float_as_uint(tbk))),
          next_epoch);

      // ---- the event: the same scalars in every lane ----------------------
      const float k_same = (float)kc;
      const float coal_rate = k_same / (2.0f * ne[e * Pp + p_cur]);
      const float mig_rate = tot[e * Pp + p_cur];
      const float root_rate = above ? tot[e * Pp + r_cur] : 0.0f;
      const float rate = coal_rate + mig_rate + root_rate;
      const float u_dt = clip_u(u24(r4.x));
      const float dt = rate > 0.0f ? -log1pf(-u_dt) / fmaxf(rate, 1e-30f)
                                   : BIG;
      const bool hit_bk = tt + dt >= t_bk;
      const float t_next = fminf(tt + dt, t_bk);
      float span = fmaxf(t_next - tt, 0.0f);
      if (!isfinite(span)) span = 0.0f;
      if (lane == 0) {
        w.pend[e * Pp + p_cur] += k_same * span;
        w.pend[o_mig_opp + e * Pp + p_cur] += span;
        if (above) w.pend[o_mig_opp + e * Pp + r_cur] += span;
      }

      const float x = u24(r4.y) * rate;
      const bool is_coal = !hit_bk && x < coal_rate;
      const bool is_fm = !hit_bk && !is_coal && x < coal_rate + mig_rate;
      const bool is_rm = !hit_bk && !is_coal && !is_fm;
      if (is_coal) {
        // the r-th member in node order (none: node 0)
        const int r = (int)floorf(u24(r4.z) * (float)max(kc, 1));
        unsigned m = members;
        for (int s = 0; s < r && m != 0u; ++s) m &= m - 1u;
        if (lane == 0) w.pend[o_coal_cnt + e * Pp + p_cur] += 1.0f;
        if (vb) vb_c = vbc[e * Pp + p_cur];
        done = true;
        t_c = t_next;
        d = m != 0u ? __ffs(m) - 1 : 0;
        fpop = p_cur;
      } else if (is_fm || is_rm) {
        const int mover = is_rm ? r_cur : p_cur;
        const float* wr = mig + (e * Pp + mover) * Pp;
        float wtot = 0.0f;
        for (int q = 0; q < Pp; ++q) wtot += wr[q];
        const float xd = u24(r4.w) * wtot;
        float cw = 0.0f;
        int dest = -1, last = 0;
        for (int q = 0; q < Pp; ++q) {
          cw += wr[q];
          if (wr[q] > 0.0f) last = q;
          if (dest < 0 && cw > xd) dest = q;
        }
        if (dest < 0) dest = last;
        if (vb) vb_m = vb_m + vbm[(e * Pp + mover) * Pp + dest];
        if (lane == 0) {
          w.pend[o_mig_cnt + (e * Pp + mover) * Pp + dest] += 1.0f;
          const int slot = min(is_fm ? n_ev : n_rev, 2 * Mw - 1);
          (is_fm ? w.ev_t : w.rev_t)[slot] = t_next;
          (is_fm ? w.ev_d : w.rev_d)[slot] = (pop_t)dest;
        }
        if (is_fm) {
          ++n_ev;
          p_raw = dest;
        } else {
          ++n_rev;
          r_raw = dest;
        }
      }
      tt = t_next;
    }
    if (!done) {  // capped: coalesce onto the root lineage
      float hmax = w.tm[0];
      for (int j = 1; j < N; ++j) hmax = fmaxf(hmax, w.tm[j]);
      d = root;
      t_c = fmaxf(tt, hmax);
      fpop = r_raw;
      capped += 1.0f;
    }
    // the whole term after the walk, after the extension (smc.py:951-967)
    if (vb) lw = lw + (vb_c + vb_m);
    // the lists end at their first BIG: a merge reads no further
    if (lane == 0) {
      if (n_ev < 2 * Mw) {
        w.ev_t[n_ev] = BIG;
        w.ev_d[n_ev] = 0;
      }
      if (n_rev < 2 * Mw) {
        w.rev_t[n_rev] = BIG;
        w.rev_d[n_rev] = 0;
      }
      w.pend[o_rcnt + epoch_of(est, E, h_r)] += 1.0f;
    }
    __syncwarp();
    if constexpr (BIAS) {
      // ---- the importance weight (smc.py:968-1020): the posterior takes
      // all of it, the pilot the height-bias part where the delay
      // height's section is unbiased, and the rest goes into the first
      // free slot of the ring, k applications of late / k from front + nr
      // + delay / (2^k - 1) on; a full ring gives it to the pilot at once.
      // The delay height: h_r, t_c, or under -delay_migr the lower of t_c
      // and the walk's first migration (the head of its list, BIG if
      // none).  The pilot weight, the ring's free slots and its push are
      // lane 0's ----
      lw = lw + xw.keep[K_IW];
      // the delay height's section and epoch (epoch_of), counted by
      // ballots: lane q tests section boundary q, lane e epoch start e
      const float d_h = a.delay_type == 0 ? h_r
          : a.delay_type == 1 ? t_c : fminf(t_c, w.ev_t[0]);
      const int cnt =
          __popc(__ballot_sync(WARP_ALL, lane <= S && bh[lane] <= d_h));
      int ecnt = 0;
      for (int base = 0; base < E; base += 32)
        ecnt += __popc(__ballot_sync(
            WARP_ALL, base + lane < E && est[base + lane] <= d_h));
      if (lane == 0) {
        const float log_iw = xw.keep[K_IW];
        float strength_h = xw.keep[K_STRENGTH];
        if (a.delay_type != 0) strength_h = bs[min(max(cnt - 1, 0), S - 1)];
        const float imm =
            fabsf(strength_h - 1.0f) < 1e-6f ? xw.keep[K_IW_BIAS] : 0.0f;
        const float late = log_iw - imm;
        // the trip's extension, then its weights, in the plain order
        float lp = xw.keep[K_LP] - a.mu * B * (nr - up);
        if constexpr (GUIDE)
          lp = lp + guide_span(gtab(), tl, a.front + up, a.front + nr,
                               xw.keep[K_M_UP], xw.keep[K_M_NR]);
        if (vb) lp = lp + (vb_c + vb_m);
        lp = lp + imm;
        if (fabsf(late) > 1e-9f) {
          const unsigned frees = ku[K_DFREE];
          if (frees == 0u) {
            lp = lp + late;
          } else {
            const int slot = __ffs((int)frees) - 1;
            ku[K_DFREE] = frees & (frees - 1u);
            ku[K_PUSHED] |= 1u << slot;
            const int kk = a.delay_k;
            const float dd =
                dl[min(max(ecnt - 1, 0), E - 1)] / (float)((1 << kk) - 1);
            xw.rpos[slot] = (a.front + nr) + dd;
            xw.rlogf[slot] = late / (float)kk;
            xw.rdelta[slot] = dd;
            xw.rk[slot] = kk;
          }
        }
        xw.keep[K_LP] = lp;
      }
    }
    if constexpr (ARG) {
      // ---- the trip's ARG rows, in the tree before the SPR, each lane's
      // own: the leaves below c (lanes 0-7) and below d (lanes 8-15) by
      // one ballot of the leaves' paths; a row whose slot a later row of
      // the trip takes (a ring of fewer slots than rows) is not written ----
      const int x = lane < 8 ? c : d;
      const unsigned m =
          __ballot_sync(WARP_ALL, x >= 0 && (path >> x & 1u) != 0u);
      const unsigned dc = m & 0xffu, dd = m >> 8 & 0xffu;
      rows = 2 + min(min(n_ev, 2 * Mw), ARG_MIG_ROWS);
      row_put = lane < rows && lane + a.A >= rows;
      if (row_put) {
        const int j = lane - 2;  // an M row's hop
        row_t = lane == 0 ? h_r : lane == 1 ? t_c : w.ev_t[j];
        row_from = lane == 0 ? -1 : lane == 1 ? fpop
            : j == 0 ? p_start : (int)w.ev_d[j - 1];
        row_to = lane < 2 ? -1 : (int)w.ev_d[j];
        row_desc = lane == 1 ? dc | dd : dc;
      }
    }

    // ---- the SPR with buffer routing --------------------------------------
    // rows of a negative node read as row 0 and are not written, as in the
    // plain version's one-hot algebra
#define PICK(arr, idx) ((idx) >= 0 ? (arr)[(idx)] : 0)
    const int p = PICK(w.par, c);
    const int sib0 = PICK(w.c0, p), sib1 = PICK(w.c1, p);
    const int o = sib0 == c ? sib1 : sib0;
    const int g = PICK(w.par, p);
    const int d_eff = d == p ? o : d;
    const int gp = d_eff == o ? g : PICK(w.par, d_eff);
#undef PICK
#define ROW_T(x) (w.mt + max((x), 0) * Mw)
#define ROW_D(x) (w.md + max((x), 0) * Mw)
    // c's events below h_r, then the walk's
    g_filter(ROW_T(c), ROW_D(c), Mw, -BIG, h_r, w.r2_t, w.r2_d, lane);
    __syncwarp();
    int drop = g_merge_hold(w.r2_t, w.r2_d, Mw, w.ev_t, w.ev_d, 2 * Mw, Mw,
                            w.r1_t, w.r1_d, w.tt_t, w.tt_d, lane);
    __syncwarp();
    if (d == c) {
      // self-coalescence: c's events in [h_r, t_c) become the walk's
      g_filter(ROW_T(c), ROW_D(c), Mw, t_c, BIG, w.r2_t, w.r2_d, lane);
      __syncwarp();
      drop += g_merge_hold(w.r1_t, w.r1_d, Mw, w.r2_t, w.r2_d, Mw, Mw,
                           w.r3_t, w.r3_d, w.tt_t, w.tt_d, lane);
      __syncwarp();
      if (c >= 0) {
        g_copy(w.r3_t, w.r3_d, Mw, ROW_T(c), ROW_D(c), lane);
        dirty |= 1u << c;
      }
    } else {
      // o's merged branch: o's events and p's
      drop += g_merge_hold(ROW_T(o), ROW_D(o), Mw, ROW_T(p), ROW_D(p), Mw, Mw,
                           w.r2_t, w.r2_d, w.tt_t, w.tt_d, lane);
      __syncwarp();
      // the target's branch (the merged one if d_eff == o), with the root
      // lineage's events when the target is the old root; split at t_c
      const float* src_t = d_eff == o ? w.r2_t : ROW_T(d_eff);
      const pop_t* src_d = d_eff == o ? w.r2_d : ROW_D(d_eff);
      if (d == root || d_eff == root)
        drop += g_merge_hold(src_t, src_d, Mw, w.rev_t, w.rev_d, 2 * Mw, Mw,
                             w.r3_t, w.r3_d, w.tt_t, w.tt_d, lane);
      else
        g_copy(src_t, src_d, Mw, w.r3_t, w.r3_d, lane);
      __syncwarp();
      // the new rows, each from the routing rows alone
      if (o != d_eff && o >= 0) {
        g_copy(w.r2_t, w.r2_d, Mw, ROW_T(o), ROW_D(o), lane);
        dirty |= 1u << o;
      }
      if (d_eff >= 0) {
        g_filter(w.r3_t, w.r3_d, Mw, -BIG, t_c, ROW_T(d_eff), ROW_D(d_eff),
                 lane);
        dirty |= 1u << d_eff;
      }
      if (p >= 0) {
        g_filter(w.r3_t, w.r3_d, Mw, t_c, BIG, ROW_T(p), ROW_D(p), lane);
        dirty |= 1u << p;
      }
      if (c >= 0) {
        g_copy(w.r1_t, w.r1_d, Mw, ROW_T(c), ROW_D(c), lane);
        dirty |= 1u << c;
      }
      __syncwarp();
      // the topology, as the plain pass edits it; no other lane reads the
      // tree until the next warp sync
      if (lane == 0) {
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
        if (p >= 0) {
          w.tm[p] = t_c;
          w.pp[p] = fpop;
        }
      }
      __syncwarp();
    }
#undef ROW_T
#undef ROW_D
    dropped += (float)drop;
    // the new root's row holds nothing: the path above it is drawn afresh
    const unsigned roots_f = __ballot_sync(WARP_ALL,
                                           lane < N && w.par[lane] < 0);
    const int root_f = roots_f != 0u ? __ffs(roots_f) - 1 : 0;
    for (int q = lane; q < Mw; q += 32) {
      w.mt[root_f * Mw + q] = BIG;
      w.md[root_f * Mw + q] = 0;
    }
    dirty |= 1u << root_f;

    // ---- refreshed summaries, then the next gap ---------------------------
    mig_branches(w, N, lane);
    __syncwarp();
    mig_summaries(est, hd, w, n, E, a.leaf_status, lane, tl, B);
    if constexpr (GUIDE) {
      // the gap in guide mass from the event's position (smc.py:802-808),
      // whose mass the extension read; it is the next extension's start.
      // The next trip's window goes under way at once
      const Tables gt = gtab();
      const float m_nr = xw.keep[K_M_NR];
      const float gap_m = -log1pf(-u_gap) / fmaxf(a.rho * tl, 1e-30f);
      const float at = a.front + nr;
      const float nxt = guide_inv_mass(gt, m_nr + gap_m);
      if (lane == 0) xw.keep[K_M_UP] = m_nr;
      up = nr;
      nr = nr + fmaxf(nxt - at, 1e-3f);
    } else {
      const float gap = -log1pf(-u_gap) / fmaxf(a.rho * tl, 1e-30f);
      up = nr;
      nr = nr + gap;
    }
    moved = true;
    if constexpr (ARG) {
      // ---- the trip's rows at its position (now up), written last, so
      // that no warp sync of this trip waits on them ----
      if (row_put)
        arg_put(a, i, arg_slot_after(ac.slot, lane, a.A), min(lane, 2),
                a.front + up, row_t, row_from, row_to, (long long)row_desc);
      ac.n += rows;
      ac.slot = arg_slot_after(ac.slot, rows, a.A);
    }
  }

  // ---- final extension to the segment end, push into FIFO slot 0 --------
  const float delta = a.L - up;
  lw = lw - a.mu * B * delta;
  float liwf = 0.0f;
  if constexpr (GUIDE) {
    // the guide's survival weight of the final extension (smc.py:1123-1131)
    // to front + L, whose mass the block holds
    __syncwarp();
    if (delta > 0.0f) {
      const float x1 = a.front + a.L;
      liwf = guide_span(gtab(), tl, a.front + up, x1, xw.keep[K_M_UP],
                        gmass_end(1));
    }
    lw = lw + liwf;
  }
  for (int e = lane; e < E; e += 32) w.pend[o_ropp + e] += delta * w.tle[e];
  nr = nr - a.L;
  __syncwarp();
  if constexpr (LOCAL) {
    // the segment's ungated recombination opportunity, in epoch order; the
    // events dropped
    if (lane == 0) {
      float ropp = 0.0f;
      for (int e = 0; e < E; ++e) ropp += w.pend[o_ropp + e];
      a.ropp[i] = ropp;
      if (ku[K_LDROP] > 0u) atomicAdd(a.lr_dropped, (int)ku[K_LDROP]);
    }
  }
  unsigned applied = 0u;  // BIAS: the ring slots applied
  if constexpr (BIAS) {
    // ---- the pilot's extension; the delayed factors due at front + L,
    // each lane its slot ----
    const bool due = lane < D && xw.rpos[lane] <= a.front + a.L;
    float add = 0.0f;
    if (due) {
      add = xw.rlogf[lane];
      const int rk = xw.rk[lane];
      const float rdelta = xw.rdelta[lane];
      if (rk > 1) {
        xw.rpos[lane] = xw.rpos[lane] + 2.0f * rdelta;
        xw.rdelta[lane] = 2.0f * rdelta;
        xw.rk[lane] = rk - 1;
      } else {
        xw.rpos[lane] = BIG;
        xw.rlogf[lane] = 0.0f;
        xw.rk[lane] = 0;
      }
    }
    applied = __ballot_sync(WARP_ALL, due);
    if (applied != 0u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        add += __shfl_xor_sync(WARP_ALL, add, off);
    }
    if (lane == 0) {
      float lp = xw.keep[K_LP] - a.mu * B * delta;
      if constexpr (GUIDE) lp = lp + liwf;
      if (applied != 0u) lp = lp + add;
      a.log_pilot[i] = lp;
    }
  }
  float* slot = a.fifo + (size_t)i * a.fifo_stride;
  for (int k = lane; k < K; k += 4 * 32) {
    float v[4], cur[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int at = k + q * 32;
      v[q] = at < K ? w.pend[at] * gate[at] : 0.0f;
      cur[q] = v[q] != 0.0f ? slot[at] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (v[q] != 0.0f) slot[k + q * 32] = cur[q] + v[q];
  }
  if (moved) {
    if (lane < N) {
      const size_t at = (size_t)i * N + lane;
      a.time[at] = w.tm[lane];
      a.parent[at] = w.par[lane];
      a.child0[at] = w.c0[lane];
      a.child1[at] = w.c1[lane];
      a.pop[at] = w.pp[lane];
    }
    for (int j = 0; j < N; ++j) {
      if (!((dirty >> j) & 1u)) continue;
      const size_t row = ((size_t)i * N + j) * Mw;
      g_copy(w.mt + j * Mw, w.md + j * Mw, Mw, a.mig_time + row,
             a.mig_dest + row, lane);
    }
  }
  if constexpr (BIAS) {
    // only the slots that were pushed or applied
    if ((applied | ku[K_PUSHED]) >> lane & 1u) {
      const size_t at = (size_t)i * D + lane;
      a.df_pos[at] = xw.rpos[lane];
      a.df_logf[at] = xw.rlogf[lane];
      a.df_delta[at] = xw.rdelta[lane];
      a.df_k[at] = xw.rk[lane];
    }
  }
  if (lane == 0) {
    if (capped > 0.0f) atomicAdd(&a.diag[0], (double)capped);
    if (dropped > 0.0f) atomicAdd(&a.diag[1], (double)dropped);
    a.next_rec[i] = nr;
    a.log_w[i] = lw;
    a.tl_out[i] = tl;
    if constexpr (ARG) {
      if (moved) a.arg_n[i] = ac.n;
    }
  }
}

template <bool VB, bool ARG = false>
__global__ void __launch_bounds__(MIG_PPB * 32, MIG_MIN_BLOCKS)
segment_pass_mig_kernel(const Args a) {
  mig_pass_body<VB, ARG, false, false, false>(a);
}

// The migration pass with the production proposal and local recording
// (BIAS, GUIDE: the guided biased pass, LOCAL); see the proposal variants
// in "The migration pass" above.
template <bool VB, bool BIAS, bool GUIDE, bool LOCAL>
__global__ void __launch_bounds__(MIG_PPB * 32, MIG_MIN_BLOCKS)
segment_pass_mig_proposal_kernel(const Args a) {
  mig_pass_body<VB, false, BIAS, GUIDE, LOCAL>(a);
}

#if SMC_NARROW
__global__ void noop_kernel() {}
#endif

template <typename Kernel>
int launch_kernel(Kernel kernel, const Args& a, dim3 grid, size_t bytes,
                  cudaStream_t stream, int threads = BLOCK) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

#if SMC_NARROW
// Particles per block of the migration pass and its dynamic shared bytes:
// MIG_PPB, halved until the block fits in what the card grants one block.
// bias, guide, local (S sections): a proposal variant's tables and scratch.
int mig_shape(int n, int E, int Pp, int Mw, bool vb, int& ppb,
              size_t& bytes, bool bias = false, bool guide = false,
              bool local = false, int S = 0) {
  int dev = 0, most = 48 * 1024;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int N = 2 * n - 1;
  for (ppb = MIG_PPB; ppb >= 1; ppb /= 2) {
    bytes = sizeof(float)
        * ((size_t)mig_table_words(E, Pp, vb, bias, guide, local)
           + (size_t)ppb * (mig_work_words(N, E, Pp, Mw)
                            + mig_extra_words(N, S, bias, guide, local)));
    if (bytes <= (size_t)most) return 0;
  }
  return (int)cudaErrorInvalidValue;
}

#endif

// What a kernel takes on the card, as the card reports it: out[0]
// registers per thread, out[1] local (stack) bytes per thread, out[2]
// static shared bytes, out[3] dynamic shared bytes per block as launched,
// out[4] particles per block, out[5] blocks an SM holds at once, out[6]
// the card's SMs.
template <typename Kernel>
int resources_of(Kernel kernel, int threads, size_t bytes, int ppb,
                 int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = (int)bytes;
  out[4] = ppb;
  out[5] = blocks;
  out[6] = sms;
  return 0;
}

#if SMC_WIDE
// dynamic shared bytes of a block of a wide pass or trip
template <int G, int ML>
size_t wide_bytes(int n, int E, bool segment, bool biased, bool vb) {
  return sizeof(float)
      * (size_t)wide_block_words<ML>(G, 2 * n - 1, E, segment, biased, vb);
}

// A wide kernel for the run-time flags: launched (res == nullptr) or asked
// for its resources.
template <int G, int ML>
int wide_variant(const Args& a, bool segment, bool biased, bool vb, bool arg,
                 cudaStream_t s, int* res) {
  const size_t bytes = wide_bytes<G, ML>(a.n, a.E, segment, biased, vb);
  void (*kernel)(const Args) =
      !segment ? trip_wide_kernel<G, ML>
      : biased ? (vb ? segment_pass_biased_wide_kernel<G, ML, true>
                     : segment_pass_biased_wide_kernel<G, ML, false>)
      : arg    ? (vb ? segment_pass_wide_kernel<G, ML, true, true>
                     : segment_pass_wide_kernel<G, ML, false, true>)
               : (vb ? segment_pass_wide_kernel<G, ML, true>
                     : segment_pass_wide_kernel<G, ML, false>);
  if (res) return resources_of(kernel, BLOCK, bytes, BLOCK / G, res);
  const dim3 grid((unsigned)((a.P + BLOCK / G - 1) / (BLOCK / G)));
  return launch_kernel(kernel, a, grid, bytes, s);
}

}  // namespace

// the wide instantiation for n leaves: 8 lanes per particle up to 16
// leaves (16 particles a block), 16 above (8 a block); arg: the plain
// pass's ARG variant
extern "C" int smc_wide_dispatch(const void* args, int segment, int biased,
                                 int vb, int arg, void* stream, int* res) {
  const Args& a = *static_cast<const Args*>(args);
  cudaStream_t s = (cudaStream_t)stream;
  if (arg && (!segment || biased)) return (int)cudaErrorInvalidValue;
  return a.n <= 16
      ? wide_variant<8, 16>(a, segment != 0, biased != 0, vb != 0, arg != 0,
                            s, res)
      : wide_variant<16, WIDE_MAX_LEAVES>(a, segment != 0, biased != 0,
                                          vb != 0, arg != 0, s, res);
}

namespace {

#endif

#if SMC_WIDE_PROP
// dynamic shared bytes of a block of a wide guided or local pass
template <int G, int ML>
size_t wide_proposal_bytes(int n, int E, bool biased, bool vb, bool guide,
                           bool local) {
  return sizeof(float)
      * (size_t)wide_block_words<ML>(G, 2 * n - 1, E, true, biased, vb,
                                     local, guide);
}

// A wide guided or local kernel for the run-time flags: launched (res ==
// nullptr) or asked for its resources.
template <int G, int ML, bool VB>
int wide_proposal_variant(const Args& a, bool biased, bool guide, bool local,
                          cudaStream_t s, int* res) {
  const size_t bytes =
      wide_proposal_bytes<G, ML>(a.n, a.E, biased, VB, guide, local);
  void (*kernel)(const Args) =
      !biased ? segment_pass_wide_local_kernel<G, ML, VB>
      : !guide ? segment_pass_biased_wide_proposal_kernel<G, ML, VB, false,
                                                          true>
      : local  ? segment_pass_biased_wide_proposal_kernel<G, ML, VB, true,
                                                          true>
               : segment_pass_biased_wide_proposal_kernel<G, ML, VB, true,
                                                          false>;
  if (res) return resources_of(kernel, BLOCK, bytes, BLOCK / G, res);
  const dim3 grid((unsigned)((a.P + BLOCK / G - 1) / (BLOCK / G)));
  return launch_kernel(kernel, a, grid, bytes, s);
}

template <int G, int ML>
int wide_proposal_group(const Args& a, bool biased, bool vb, bool guide,
                        bool local, cudaStream_t s, int* res) {
  return vb ? wide_proposal_variant<G, ML, true>(a, biased, guide, local, s,
                                                 res)
            : wide_proposal_variant<G, ML, false>(a, biased, guide, local,
                                                  s, res);
}

}  // namespace

// the wide guided and local kernels for n leaves, grouped as the wide
// passes are (8 lanes per particle up to 16 leaves, 16 above): the plain
// pass with local recording, the biased pass guided, with local recording
// or both (each with and without VB)
extern "C" int smc_wide_proposal_dispatch(const void* args, int biased,
                                          int vb, int guide, int local,
                                          void* stream, int* res) {
  const Args& a = *static_cast<const Args*>(args);
  cudaStream_t s = (cudaStream_t)stream;
  if (!(guide || local) || (guide && !biased))
    return (int)cudaErrorInvalidValue;
  return a.n <= 16
      ? wide_proposal_group<8, 16>(a, biased != 0, vb != 0, guide != 0,
                                   local != 0, s, res)
      : wide_proposal_group<16, WIDE_MAX_LEAVES>(a, biased != 0, vb != 0,
                                                 guide != 0, local != 0, s,
                                                 res);
}

namespace {

#endif

#if SMC_MIG || SMC_MIG_VB
// The migration pass's variant for the run-time flags (arg: the ARG
// variant; bias, guide: guided and biased, local: a proposal variant),
// launched (res == nullptr) or asked for its resources.
template <bool VB>
int mig_variant(const Args& a, bool arg, bool bias, bool guide, bool local,
                dim3 grid, size_t bytes, int ppb, cudaStream_t s, int* res) {
  void (*kernel)(const Args) =
      guide ? (local ? segment_pass_mig_proposal_kernel<VB, true, true, true>
                     : segment_pass_mig_proposal_kernel<VB, true, true, false>)
      : bias ? (local
                    ? segment_pass_mig_proposal_kernel<VB, true, false, true>
                    : segment_pass_mig_proposal_kernel<VB, true, false, false>)
      : local ? segment_pass_mig_proposal_kernel<VB, false, false, true>
      : arg   ? segment_pass_mig_kernel<VB, true>
              : segment_pass_mig_kernel<VB>;
  if (res) return resources_of(kernel, ppb * 32, bytes, ppb, res);
  return launch_kernel(kernel, a, grid, bytes, s, ppb * 32);
}
}  // namespace

#if SMC_MIG
extern "C" int smc_mig_dispatch(const void* args, int vb, int arg, int bias,
                                int guide, int local, unsigned blocks,
                                size_t bytes, int ppb, void* stream,
                                int* res) {
  if (vb)
    return smc_mig_vb_dispatch(args, arg, bias, guide, local, blocks, bytes,
                               ppb, stream, res);
  return mig_variant<false>(*static_cast<const Args*>(args), arg != 0,
                            bias != 0, guide != 0, local != 0, dim3(blocks),
                            bytes, ppb, (cudaStream_t)stream, res);
}
#endif

#if SMC_MIG_VB
extern "C" int smc_mig_vb_dispatch(const void* args, int arg, int bias,
                                   int guide, int local, unsigned blocks,
                                   size_t bytes, int ppb, void* stream,
                                   int* res) {
  return mig_variant<true>(*static_cast<const Args*>(args), arg != 0,
                           bias != 0, guide != 0, local != 0, dim3(blocks),
                           bytes, ppb, (cudaStream_t)stream, res);
}
#endif

namespace {

#endif

#if SMC_NARROW
// The segment pass's variant for the run-time flags: its kernel, launched
// (run) or asked for its resources (shape: out[7]).
template <int NP, bool VB, bool LOCAL, bool ARG = false>
int plain_variant(const Args& a, dim3 grid, size_t bytes, cudaStream_t s,
                  int* res) {
  return res ? resources_of(segment_pass_kernel<NP, VB, LOCAL, ARG>, BLOCK,
                            bytes, BLOCK / GROUP, res)
             : launch_kernel(segment_pass_kernel<NP, VB, LOCAL, ARG>, a, grid,
                             bytes, s);
}

template <int NP, bool VB, bool GUIDE, bool LOCAL, bool ARG = false>
int biased_variant(const Args& a, dim3 grid, size_t bytes, cudaStream_t s,
                   int* res) {
  return res ? resources_of(
                   segment_pass_biased_kernel<NP, VB, GUIDE, LOCAL, ARG>,
                   BLOCK, bytes, BLOCK / GROUP, res)
             : launch_kernel(
                   segment_pass_biased_kernel<NP, VB, GUIDE, LOCAL, ARG>, a,
                   grid, bytes, s);
}

// arg: the plain or biased pass's ARG variant (no guide, no local
// recording)
template <int NP, bool VB>
int segment_variant(const Args& a, bool biased, bool guide, bool local,
                    bool arg, dim3 grid, size_t bytes, cudaStream_t s,
                    int* res) {
  if (arg)
    return biased
        ? biased_variant<NP, VB, false, false, true>(a, grid, bytes, s, res)
        : plain_variant<NP, VB, false, true>(a, grid, bytes, s, res);
  if (!biased)
    return local ? plain_variant<NP, VB, true>(a, grid, bytes, s, res)
                 : plain_variant<NP, VB, false>(a, grid, bytes, s, res);
  if (guide)
    return local ? biased_variant<NP, VB, true, true>(a, grid, bytes, s, res)
                 : biased_variant<NP, VB, true, false>(a, grid, bytes, s, res);
  return local ? biased_variant<NP, VB, false, true>(a, grid, bytes, s, res)
               : biased_variant<NP, VB, false, false>(a, grid, bytes, s, res);
}

// dynamic shared bytes of a block of the trip or segment pass
size_t pass_bytes(int n, int E, bool segment, bool biased, bool vb,
                  bool guide, bool local, int S) {
  return sizeof(float)
      * ((size_t)tables_words(E, segment, biased, vb, local, guide)
         + (size_t)(BLOCK / GROUP)
             * work_words(2 * n - 1, E, segment, biased, S, guide));
}

template <int NP>
int launch(const Args& a, bool segment, cudaStream_t stream) {
  const int per_block = BLOCK / GROUP;
  const bool biased = a.log_pilot != nullptr;
  const bool vb = segment && a.vb_coal != nullptr;
  const bool guide = segment && a.g_rel != nullptr;
  const bool local = segment && a.lr_pos != nullptr;
  const bool arg = segment && a.arg_pos != nullptr;
  const size_t bytes =
      pass_bytes(a.n, a.E, segment, biased, vb, guide, local, a.S);
  const dim3 grid((unsigned)((a.P + per_block - 1) / per_block));
  if (segment)
    return vb ? segment_variant<NP, true>(a, biased, guide, local, arg, grid,
                                          bytes, stream, nullptr)
              : segment_variant<NP, false>(a, biased, guide, local, arg,
                                           grid, bytes, stream, nullptr);
  return launch_kernel(trip_kernel<NP>, a, grid, bytes, stream);
}

int dispatch(const Args& a, bool segment, void* stream) {
  // above MAX_LEAVES the wide kernels: the plain and biased passes and
  // trip, the guided and local passes, no migration; ARG recording in the
  // plain, the biased and the migration pass and the wide plain pass,
  // without the guide or local recording (nor bias in the migration pass)
  const bool wide = a.n > MAX_LEAVES;
  const bool arg = a.arg_pos != nullptr;
  if (a.n < 2 || a.n > WIDE_MAX_LEAVES || a.E < 1 || a.E > MAX_EPOCHS
      || a.trips < 0 || (wide && a.pop != nullptr)
      || (arg && (!segment || a.g_rel != nullptr || a.lr_pos != nullptr
                  || (wide && a.log_pilot != nullptr)
                  || (a.pop != nullptr && a.log_pilot != nullptr) || a.A < 1
                  || a.arg_code == nullptr || a.arg_time == nullptr
                  || a.arg_from == nullptr || a.arg_to == nullptr
                  || a.arg_desc == nullptr || a.arg_n == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.log_pilot != nullptr
      && (a.K < 1 || a.K > MAX_DELAY_SLOTS || a.S < 1 || a.S > MAX_SECTIONS
          || a.delay_k < 1 || a.delay_k > 30))
    return (int)cudaErrorInvalidValue;
  if (a.g_rel != nullptr
      && (!segment || a.log_pilot == nullptr || a.cum_mass == nullptr
          || a.g_leaf == nullptr || a.g_top == nullptr || a.Wg < 1
          || !(a.ws > 0.0f)))
    return (int)cudaErrorInvalidValue;
  if (a.lr_pos != nullptr
      && (!segment || a.R < 1 || a.R > MAX_LOCAL_SLOTS || a.lr_due == nullptr
          || a.lr_time == nullptr || a.lr_desc == nullptr
          || a.lr_dropped == nullptr || a.lags == nullptr
          || a.ropp == nullptr))
    return (int)cudaErrorInvalidValue;
  if (a.pop != nullptr) {  // the migration pass
    if (!segment || a.Pp < 1 || a.Pp > MAX_POPS || a.Mw < 1
        || a.Mw > MAX_MIG || a.max_events < 1)
      return (int)cudaErrorInvalidValue;
    if (a.P <= 0) return 0;
    int ppb;
    size_t bytes;
    const bool vb = a.vb_coal != nullptr;
    const bool bias = a.log_pilot != nullptr, guide = a.g_rel != nullptr;
    const bool local = a.lr_pos != nullptr;
    if (vb && a.vb_mig == nullptr) return (int)cudaErrorInvalidValue;
    const int err = mig_shape(a.n, a.E, a.Pp, a.Mw, vb, ppb, bytes, bias,
                              guide, local, bias ? a.S : 0);
    if (err != 0) return err;
    return smc_mig_dispatch(&a, vb, arg, bias, guide, local,
                            (unsigned)((a.P + ppb - 1) / ppb), bytes, ppb,
                            stream, nullptr);
  }
  if (a.P <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide && (a.g_rel != nullptr || a.lr_pos != nullptr))
    return smc_wide_proposal_dispatch(&a, a.log_pilot != nullptr,
                                      a.vb_coal != nullptr,
                                      a.g_rel != nullptr,
                                      a.lr_pos != nullptr, s, nullptr);
  if (wide)
    return smc_wide_dispatch(&a, segment, a.log_pilot != nullptr,
                             segment && a.vb_coal != nullptr, arg, s,
                             nullptr);
  return a.n <= 4 ? launch<7>(a, segment, s)
                  : launch<MAX_NODES>(a, segment, s);
}

#endif
}  // namespace

#if SMC_NARROW
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
    const float* inv2ne, const unsigned char* has_data, float* log_pilot,
    float* df_pos, float* df_logf, float* df_delta, int* df_k,
    const float* bias_heights, const float* bias_strengths,
    const float* delays, int K, int S, float front, int delay_type,
    int delay_k, int* pop, float* mig_time, int* mig_dest, double* diag,
    const int* key, const float* ne, const float* mig, const float* tot_mig,
    const int* pop_map, int Pp, int Mw, int max_events,
    const float* vb_coal, const float* vb_mig, const float* g_rel,
    const float* cum_mass, const float* g_leaf, const float* g_top, int Wg,
    float ws,
    float* lr_pos, float* lr_due, float* lr_time, long long* lr_desc,
    int* lr_dropped, const float* lags, float* ropp, int R, float* arg_pos,
    signed char* arg_code, float* arg_time, signed char* arg_from,
    signed char* arg_to, long long* arg_desc, int* arg_n, int A,
    void* stream) {
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
  a.fifo_stride = (long long)F * (pop != nullptr
                                    ? 3 * E * Pp + E * Pp * Pp + 2 * E
                                    : 6 * E);
  a.fifo_mask = fifo_mask;
  a.tl_out = tl_out;
  a.log_pilot = log_pilot;
  a.df_pos = df_pos;
  a.df_logf = df_logf;
  a.df_delta = df_delta;
  a.df_k = df_k;
  a.bias_heights = bias_heights;
  a.bias_strengths = bias_strengths;
  a.delays = delays;
  a.K = K;
  a.S = S;
  a.front = front;
  a.delay_type = delay_type;
  a.delay_k = delay_k;
  a.pop = pop;
  a.mig_time = mig_time;
  a.mig_dest = mig_dest;
  a.diag = diag;
  a.key = key;
  a.ne = ne;
  a.mig = mig;
  a.tot_mig = tot_mig;
  a.pop_map = pop_map;
  a.Pp = Pp;
  a.Mw = Mw;
  a.max_events = max_events;
  a.vb_coal = vb_coal;
  a.vb_mig = vb_mig;
  a.g_rel = g_rel;
  a.cum_mass = cum_mass;
  a.g_leaf = g_leaf;
  a.g_top = g_top;
  a.Wg = Wg;
  a.ws = ws;
  a.lr_pos = lr_pos;
  a.lr_due = lr_due;
  a.lr_time = lr_time;
  a.lr_desc = lr_desc;
  a.lr_dropped = lr_dropped;
  a.lags = lags;
  a.ropp = ropp;
  a.R = R;
  a.arg_pos = arg_pos;
  a.arg_code = arg_code;
  a.arg_time = arg_time;
  a.arg_from = arg_from;
  a.arg_to = arg_to;
  a.arg_desc = arg_desc;
  a.arg_n = arg_n;
  a.A = A;
  return dispatch(a, true, stream);
}

template <int NP>
int resources_np(int kind, int n, int E, int S, bool vb, bool guide,
                 bool local, bool arg, int* out) {
  const bool segment = kind != 0, biased = kind == 2;
  const size_t bytes =
      pass_bytes(n, E, segment, biased, vb, guide, local, S);
  if (kind == 0)
    return resources_of(trip_kernel<NP>, BLOCK, bytes, BLOCK / GROUP, out);
  const Args none = {};
  return vb ? segment_variant<NP, true>(none, biased, guide, local, arg,
                                        dim3(1), bytes, nullptr, out)
            : segment_variant<NP, false>(none, biased, guide, local, arg,
                                         dim3(1), bytes, nullptr, out);
}

// kind 0: trip, 1: segment_pass, 2: its biased variant (S sections), 3:
// its migration variant (Pp populations, buffers of Mw events), 4: the
// migration variant biased (S sections); at n leaves (above MAX_LEAVES
// the wide kernels of kinds 0-2, guided and local ones among them), E
// epochs; vb: the pass's VB variant (not for trip); guide: the biased or
// biased migration pass's guided variant; local: the plain, biased or
// migration pass's local recording; arg: the ARG variant of the plain,
// biased (narrow) or migration pass.
extern "C" int smc_kernel_resources(int kind, int n, int E, int S, int Pp,
                                    int Mw, int vb, int guide, int local,
                                    int arg, int* out) {
  if (kind < 0 || kind > 4 || n < 2 || n > WIDE_MAX_LEAVES || E < 1
      || E > MAX_EPOCHS
      || ((kind == 2 || kind == 4) && (S < 1 || S > MAX_SECTIONS))
      || (kind == 0 && vb) || (guide && kind != 2 && kind != 4)
      || (local && kind == 0)
      || (n > MAX_LEAVES && kind >= 3)
      || (arg && (kind == 0 || kind == 4 || guide || local
                  || (n > MAX_LEAVES && kind == 2))))
    return (int)cudaErrorInvalidValue;
  if (n > MAX_LEAVES) {
    Args a = {};
    a.n = n;
    a.E = E;
    a.S = S;
    if (guide || local)
      return smc_wide_proposal_dispatch(&a, kind == 2, vb != 0, guide != 0,
                                        local != 0, nullptr, out);
    return smc_wide_dispatch(&a, kind != 0, kind == 2, vb != 0, arg != 0,
                             nullptr, out);
  }
  if (kind < 3)
    return n <= 4
        ? resources_np<7>(kind, n, E, S, vb != 0, guide != 0, local != 0,
                          arg != 0, out)
        : resources_np<MAX_NODES>(kind, n, E, S, vb != 0, guide != 0,
                                  local != 0, arg != 0, out);
  if (Pp < 1 || Pp > MAX_POPS || Mw < 1 || Mw > MAX_MIG)
    return (int)cudaErrorInvalidValue;
  int ppb;
  size_t bytes;
  const bool bias = kind == 4;
  const int shape = mig_shape(n, E, Pp, Mw, vb != 0, ppb, bytes, bias,
                              guide != 0, local != 0, bias ? S : 0);
  if (shape != 0) return shape;
  const Args none = {};
  return smc_mig_dispatch(&none, vb, arg, bias, guide, local, 1u, bytes, ppb,
                          nullptr, out);
}

// An empty launch, for timing what any launch costs on the card.
extern "C" int smc_noop_launch(void* stream) {
  noop_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* smc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif
