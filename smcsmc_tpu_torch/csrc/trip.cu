// Recombination trip of the SMC' particle filter, one thread per particle.
//
// Replaces the Pallas TPU kernel smcsmc_tpu/kernels/pallas_trip.py
// (_trip_kernel, entered through fused_trip).  The plain torch version it is
// held against is smcsmc_tpu_torch/kernels/trip.py (trip_plain); the math is
// the same step for step, including the INF = 3e38 arithmetic, the uniform
// clip to [1e-7, 1 - 1e-7], first-true selection in node order and the
// 0.99*INF clamp on the re-coalescence time.
//
// What bounds it on Hopper: not bytes and not FLOPs.  Each particle does a
// few hundred to a few tens of thousands of scalar operations on a tree of
// at most 15 nodes and up to 64 epochs, with data-dependent control flow
// (first-true selection, SPR pointer surgery, ancestor chains), so the
// kernel is latency- and occupancy-bound.  Per-thread rows live in local
// arrays (spilled to L1), and the [P, N] rows are read with a stride of N
// elements between neighbouring threads, which is only partly coalesced.
//
// What the design does about it: one launch runs ALL trips of a segment
// (the per-particle loop over the pre-drawn uniforms [T, P, 4]), so the
// host neither synchronises nor launches per trip; a particle leaves the
// loop as soon as its next recombination passes the segment end, and
// particles that start inactive touch nothing.  The epoch tables sit in
// shared memory.  A transposed (node-major) layout and register-resident
// trees are left for later work.

#include <cuda_runtime.h>
#include <math.h>

#define MAX_LEAVES 8
#define MAX_NODES (2 * MAX_LEAVES - 1)
#define MAX_EPOCHS 64
#define BLOCK 128

static __device__ __forceinline__ float clip_u(float u) {
  return fminf(fmaxf(u, 1e-7f), (float)(1.0 - 1e-7));
}

__global__ void __launch_bounds__(BLOCK)
trip_kernel(const float* __restrict__ uniforms, int trips, int P, int n,
            int E, int leaf_status, float* __restrict__ time,
            int* __restrict__ parent, int* __restrict__ child0,
            int* __restrict__ child1, float* __restrict__ next_rec,
            float* __restrict__ upd, float* __restrict__ log_w,
            float* tl, float* B,  // may alias: B is tl for complete data
            float* __restrict__ tl_e, float* __restrict__ pending, float L,
            float mu, float rho, const float* __restrict__ epoch_start,
            const float* __restrict__ inv2ne,
            const unsigned char* __restrict__ has_data) {
  const float INF = 3e38f;
  __shared__ float s_est[MAX_EPOCHS];
  __shared__ float s_eend[MAX_EPOCHS];
  __shared__ float s_i2n[MAX_EPOCHS];
  __shared__ int s_hd[MAX_LEAVES];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    s_est[e] = epoch_start[e];
    s_eend[e] = (e + 1 < E) ? epoch_start[e + 1] : INF;
    s_i2n[e] = inv2ne[e];
  }
  for (int l = threadIdx.x; l < n; l += blockDim.x) s_hd[l] = has_data[l] != 0;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float nr = next_rec[i];
  if (!(nr < L)) return;  // inactive: every output stays as it is

  const int N = 2 * n - 1;
  float t[MAX_NODES], pt[MAX_NODES], bl[MAX_NODES];
  int par[MAX_NODES], c0[MAX_NODES], c1[MAX_NODES];
  float tle[MAX_EPOCHS];
  for (int j = 0; j < N; ++j) {
    t[j] = time[(size_t)i * N + j];
    par[j] = parent[(size_t)i * N + j];
    c0[j] = child0[(size_t)i * N + j];
    c1[j] = child1[(size_t)i * N + j];
  }
  for (int e = 0; e < E; ++e) tle[e] = tl_e[(size_t)i * E + e];
  float up = upd[i], lw = log_w[i], tli = tl[i], Bi = B[i];
  float* pend = pending + (size_t)i * 6 * E;
  int total_data = 0;
  for (int l = 0; l < n; ++l) total_data += s_hd[l];

  for (int k = 0; k < trips; ++k) {
    if (!(nr < L)) break;
    const float* u4 = uniforms + ((size_t)k * P + i) * 4;
    const float u_pt = clip_u(u4[0]), u_exp = clip_u(u4[1]);
    const float u_tgt = clip_u(u4[2]), u_gap = clip_u(u4[3]);

    // ---- extension: no-mutation likelihood + recombination opportunity --
    const float delta = nr - up;
    lw = lw - mu * Bi * delta;

    // ---- recombination point: first node whose prefix sum >= u*total ----
    for (int j = 0; j < N; ++j) {
      pt[j] = par[j] < 0 ? INF : t[par[j]];
      bl[j] = par[j] < 0 ? 0.0f : pt[j] - t[j];
    }
    float total = 0.0f;
    for (int j = 0; j < N; ++j) total += bl[j];
    const float x_pt = u_pt * total;
    int c = -1;
    float prev = 0.0f, cum = 0.0f;
    for (int j = 0; j < N; ++j) {
      cum += bl[j];
      if (c < 0 && cum >= x_pt) {
        c = j;
        prev = cum - bl[j];
      }
    }
    const float h_r = (c >= 0 ? t[c] : 0.0f) + (x_pt - prev);

    // ---- SMC' hazard inversion over {node times} U {epoch starts} -------
    // lam(v) = sum_{e,j} inv2ne_e * |branch_j ∩ epoch_e ∩ [h_r, v]|
    const float x_exp = -log1pf(-u_exp);
    float t_lo = -INF;
    for (int v = 0; v < N + E; ++v) {
      const float vc = v < N ? t[v] : s_est[v - N];
      float lam = 0.0f;
      for (int e = 0; e < E; ++e) {
        const float lo_e = fmaxf(s_est[e], h_r);
        for (int j = 0; j < N; ++j) {
          const float lo = fmaxf(t[j], lo_e);
          const float hi = fminf(pt[j], s_eend[e]);
          lam += fmaxf(fminf(hi, vc) - lo, 0.0f) * s_i2n[e];
        }
      }
      if (lam <= x_exp) t_lo = fmaxf(t_lo, vc);
    }
    t_lo = fmaxf(t_lo, h_r);
    float lam_lo = 0.0f, inv2ne_lo = 0.0f;
    for (int e = 0; e < E; ++e) {
      const float lo_e = fmaxf(s_est[e], h_r);
      for (int j = 0; j < N; ++j) {
        const float lo = fmaxf(t[j], lo_e);
        const float hi = fminf(pt[j], s_eend[e]);
        lam_lo += fmaxf(fminf(hi, t_lo) - lo, 0.0f) * s_i2n[e];
      }
      if (t_lo >= s_est[e] && t_lo < s_eend[e]) inv2ne_lo += s_i2n[e];
    }
    float k_lo = 0.0f;
    for (int j = 0; j < N; ++j) k_lo += (t[j] <= t_lo && t_lo < pt[j]) ? 1.0f : 0.0f;
    const float rate_lo = k_lo * inv2ne_lo;
    float t_c = t_lo + (rate_lo > 0.0f ? (x_exp - lam_lo) / fmaxf(rate_lo, 1e-30f)
                                       : INF);
    t_c = fminf(t_c, (float)(0.99 * 3e38));

    // ---- coalescence target: the r-th branch crossing t_c ---------------
    float kc = 0.0f;
    for (int j = 0; j < N; ++j) kc += (t[j] <= t_c && t_c < pt[j]) ? 1.0f : 0.0f;
    const int r = (int)floorf(u_tgt * fmaxf(kc, 1.0f));
    int d = -1, seen = -1;
    for (int j = 0; j < N; ++j) {
      if (t[j] <= t_c && t_c < pt[j]) {
        ++seen;
        if (d < 0 && seen == r) d = j;
      }
    }

    // ---- opportunity / count records ------------------------------------
    // layout: [coal_opp | coal_cnt | mig_opp | mig_cnt | recomb_opp |
    //          recomb_cnt], E columns each
    for (int e = 0; e < E; ++e) {
      const float lo_e = fmaxf(s_est[e], h_r);
      float coal_opp = 0.0f;
      for (int j = 0; j < N; ++j) {
        const float lo = fmaxf(t[j], lo_e);
        const float hi = fminf(pt[j], s_eend[e]);
        coal_opp += fmaxf(fminf(hi, t_c) - lo, 0.0f);
      }
      const float span = fmaxf(fminf(s_eend[e], t_c) - lo_e, 0.0f);
      const bool in_c = t_c >= s_est[e] && t_c < s_eend[e];
      const bool in_r = h_r >= s_est[e] && h_r < s_eend[e];
      pend[e] += coal_opp;
      pend[E + e] += in_c ? 1.0f : 0.0f;
      pend[2 * E + e] += span;
      pend[4 * E + e] += delta * tle[e];
      pend[5 * E + e] += in_r ? 1.0f : 0.0f;
    }

    // ---- SPR: cut the branch above c, regraft onto d at t_c -------------
    // pick(x, idx) reads 0 for idx < 0, and writes to idx < 0 are dropped,
    // as in the reference's one-hot index algebra
#define PICK(arr, idx) ((idx) >= 0 ? (arr)[(idx)] : 0)
    const int p = PICK(par, c);
    const int sib0 = PICK(c0, p), sib1 = PICK(c1, p);
    const int o = sib0 == c ? sib1 : sib0;
    const int g = PICK(par, p);
    const bool noop = d == c;
    const int d_eff = d == p ? o : d;
    const int gp = d_eff == o ? g : PICK(par, d_eff);
#undef PICK
    if (!noop) {
      if (o >= 0) par[o] = g;
      if (d_eff >= 0) par[d_eff] = p;
      if (p >= 0) par[p] = gp;
      if (g >= 0) {
        if (c0[g] == p) c0[g] = o;
        if (c1[g] == p) c1[g] = o;
      }
      if (p >= 0) {
        c0[p] = c;
        c1[p] = d_eff;
      }
      if (gp >= 0) {
        if (c0[gp] == d_eff) c0[gp] = p;
        if (c1[gp] == d_eff) c1[gp] = p;
      }
      if (p >= 0) t[p] = t_c;
    }

    // ---- refreshed tree summaries ---------------------------------------
    for (int j = 0; j < N; ++j) {
      pt[j] = par[j] < 0 ? INF : t[par[j]];
      bl[j] = par[j] < 0 ? 0.0f : pt[j] - t[j];
    }
    float tl2 = 0.0f;
    for (int e = 0; e < E; ++e) {
      float s = 0.0f;
      for (int j = 0; j < N; ++j) {
        const float ov = par[j] < 0 ? 0.0f
            : fmaxf(fminf(pt[j], s_eend[e]) - fmaxf(t[j], s_est[e]), 0.0f);
        s += ov;
        tl2 += ov;
      }
      tle[e] = s;
    }
    float B2;
    if (leaf_status == 1) {
      B2 = tl2;
    } else if (leaf_status == -1) {
      B2 = 0.0f;
    } else {
      // informative branches: >= 1 and < all data leaves below
      int cnt[MAX_NODES];
      for (int j = 0; j < N; ++j) cnt[j] = 0;
      for (int l = 0; l < n; ++l) {
        if (!s_hd[l]) continue;
        int cur = l;
        for (int s = 0; s < n && cur >= 0; ++s) {
          cnt[cur] += 1;
          cur = par[cur];
        }
      }
      B2 = 0.0f;
      for (int j = 0; j < N; ++j)
        if (cnt[j] >= 1 && cnt[j] < total_data) B2 += bl[j];
    }
    tli = tl2;
    Bi = B2;

    // ---- next recombination gap from the refreshed tree length ----------
    const float gap = -log1pf(-u_gap) / fmaxf(rho * tli, 1e-30f);
    up = nr;
    nr = nr + gap;
  }

  for (int j = 0; j < N; ++j) {
    time[(size_t)i * N + j] = t[j];
    parent[(size_t)i * N + j] = par[j];
    child0[(size_t)i * N + j] = c0[j];
    child1[(size_t)i * N + j] = c1[j];
  }
  for (int e = 0; e < E; ++e) tl_e[(size_t)i * E + e] = tle[e];
  next_rec[i] = nr;
  upd[i] = up;
  log_w[i] = lw;
  tl[i] = tli;
  B[i] = Bi;
}

extern "C" int smc_trip_launch(
    const float* uniforms, int trips, int P, int n, int E, int leaf_status,
    float* time, int* parent, int* child0, int* child1, float* next_rec,
    float* upd, float* log_w, float* tl, float* B, float* tl_e,
    float* pending, float L, float mu, float rho, const float* epoch_start,
    const float* inv2ne, const unsigned char* has_data, void* stream) {
  if (n < 2 || n > MAX_LEAVES || E < 1 || E > MAX_EPOCHS || trips < 1)
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const dim3 grid((unsigned)((P + BLOCK - 1) / BLOCK));
  trip_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      uniforms, trips, P, n, E, leaf_status, time, parent, child0, child1,
      next_rec, upd, log_w, tl, B, tl_e, pending, L, mu, rho, epoch_start,
      inv2ne, has_data);
  return (int)cudaGetLastError();
}

extern "C" const char* smc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
