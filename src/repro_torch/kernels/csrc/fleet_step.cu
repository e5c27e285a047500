// One round of the energy fleet's step program, for Hopper (sm_90a):
//
//   leaked    = charge * leak
//   pre       = fma(-charge, leak, charge) + harvest
//   available = min(pre, capacity)
//   overflow  = max(pre - capacity, 0)
//   mask      = want * (available >= round_cost)       (gate: see GATE)
//   consumed  = mask * round_cost
//   charge'   = available - consumed
//   depleted  = available < round_cost
//   with HIST: soc = charge' / max(capacity, 1e-20),
//              spend_frac = consumed / max(capacity, 1e-20),
//              streak' = (streak + 1) * depleted
//
// plus the round's telemetry: valid-weighted totals of mask, harvest,
// consumed, leaked and overflow, the averages of charge' and depleted, the
// per-group participants and depleted fraction, and the histograms of soc,
// spend_frac and streak' (exact integer counts).
//
// Replaces the TPU kernel repro/kernels/fleet_step.py::fused_step (body
// _make_kernel) for the fleet program of repro/energy/step_ops.py;
// csrc/serve_step.cu runs the serve program.  It computes the same
// function as the port's plain version (repro_torch.energy.step_ops.
// run_step) and as the reference's jitted run_step_lax:
// * Every float operation is written as __fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn, which nvcc never contracts.  The absorb site alone is
//   __fmaf_rn: in the reference's jitted fleet scan XLA's CPU backend
//   contracts charge - charge * leak into one fused multiply-add, and its
//   `available` is that FMA.  So every per-client output is bitwise equal
//   to the plain version on any inputs.
// * Telemetry: each block reduces its clients to one row of partial sums,
//   in the layout of the TPU kernel's _partials_width (totals, average
//   numerators, sum of valid, then per group [participants, depleted
//   numerator, sum of w_g]), stored column-major (F, blocks) so that the
//   second pass reads each column contiguously.  Order is fixed: each
//   thread adds its CPT clients in ascending order (from +0, as XLA's
//   reduce starts), a warp adds lanes by a shuffle tree, lane sums of the
//   8 warps are added in warp order.  Histogram counts are int counters in
//   shared memory (atomicAdd of integers: exact in any order), written as
//   an int column block (128, blocks).
// * fleet_step_reduce, a second launch of one block, adds every column
//   over the blocks in a fixed order (lane l of warp w takes rows l, l+32,
//   ... of its columns, then a shuffle tree), counts as 64-bit integers,
//   and only then forms the averages as num / max(den, 1) (write_stats).
//   On dyadic inputs every partial sum is exact, so the stats equal the
//   reference's bit for bit; otherwise they lie within the wrapper's
//   kernel_tolerance of the exact sums.
// * The sharded fleet (one rank a slab of clients): given a `row`, the
//   reduce writes the column totals and the counts there as float64 (each
//   float32 total and each integer count exactly) and forms no stats.  The
//   caller sums the ranks' rows (one all-reduce), and fleet_step_finalize,
//   one block, rounds each sum to float32 once and forms the stats through
//   the same write_stats.  So one rank's stats equal the host-local
//   launch's bit for bit, counts stay exact integers across ranks (below
//   2^53), and on dyadic inputs any number of ranks gives the host-local
//   stats.
// * Scalar inputs (battery fields, round_cost, threshold, and valid where
//   the wrapper passes a scalar) are read through a stride of 0; the ragged
//   tail is masked by a bounds check, so nothing is padded or copied.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  A few dozen flops per
// client against 4 bytes for each per-client input read and each output
// written: at N = 10,000,000 with charge, harvest, want, valid and streak
// in and charge', streak' and mask out, 280 MB, 84 us at the card's rate.
// This first version relies on the warps in flight to cover latency; it
// has no vector loads and no cp.async pipeline.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 16;                       // clients per thread
constexpr int TILE = THREADS * CPT;           // clients per block
constexpr int NT = 5;                         // totals
constexpr int NA = 2;                         // averages
constexpr int BASE = NT + NA + 1;             // + sum of valid
constexpr int MAX_GROUPS = 64;
constexpr int MAX_F = BASE + 3 * MAX_GROUPS;  // float columns
constexpr int BINS_SOC = 32, BINS_SPEND = 32, BINS_STREAK = 64;
constexpr int NBINS = BINS_SOC + BINS_SPEND + BINS_STREAK;
constexpr int REDUCE_THREADS = 1024;
constexpr int FINALIZE_THREADS = 256;       // >= MAX_F and NBINS
constexpr unsigned FULL = 0xffffffffu;

enum Gate { SUSTAINABLE = 0, THRESHOLD = 1, GREEDY = 2 };

struct Args {
  const float* charge; long long s_charge;
  const float* harvest; long long s_harvest;
  const float* capacity; long long s_capacity;
  const float* leak; long long s_leak;
  const float* round_cost; long long s_round_cost;
  const float* threshold; long long s_threshold;
  const float* want; long long s_want;
  const float* valid; long long s_valid;
  const int* groups; long long s_groups;
  const float* streak; long long s_streak;
  float* charge_out;
  float* streak_out;
  float* mask_out;
  float* partials;      // (F, blocks)
  int* counts;          // (NBINS, blocks)
  long long n;
  int num_groups;
  int blocks;
};

__device__ __forceinline__ float ld(const float* p, long long i, long long s) {
  return p[i * s];
}

// float32(1e-20), the smallest capacity the distribution ops divide by
__device__ __forceinline__ float tiny() { return __int_as_float(0x1e3ce508); }

// floor((v - 0) * scale) clipped into [0, bins - 1]: hist.bin_index
__device__ __forceinline__ int bin_of(float v, float scale, int bins) {
  float t = floorf(__fmul_rn(__fsub_rn(v, 0.f), scale));
  t = fminf(fmaxf(t, 0.f), (float)(bins - 1));
  return (int)t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

template <int GATE, bool HIST, bool GROUPED, bool EMIT>
__global__ void __launch_bounds__(THREADS) fleet_step_kernel(Args a) {
  __shared__ float warp_part[MAX_F][WARPS];
  __shared__ int hist[NBINS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (HIST) {
    for (int b = tid; b < NBINS; b += THREADS) hist[b] = 0;
    __syncthreads();
  }

  float acc[BASE];
#pragma unroll
  for (int c = 0; c < BASE; ++c) acc[c] = 0.f;
  // per-client values the group columns need (registers: CPT is static)
  float g_mask[GROUPED ? CPT : 1], g_dep[GROUPED ? CPT : 1],
      g_valid[GROUPED ? CPT : 1];
  int g_id[GROUPED ? CPT : 1];

  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const long long i = base + (long long)k * THREADS + tid;
    if constexpr (GROUPED) { g_valid[k] = 0.f; g_mask[k] = 0.f; g_dep[k] = 0.f; g_id[k] = -1; }
    if (i >= a.n) continue;                 // ragged tail: nothing touched
    const float c = ld(a.charge, i, a.s_charge);
    const float h = ld(a.harvest, i, a.s_harvest);
    const float cap = ld(a.capacity, i, a.s_capacity);
    const float lk = ld(a.leak, i, a.s_leak);
    const float rc = ld(a.round_cost, i, a.s_round_cost);
    const float v = ld(a.valid, i, a.s_valid);

    // absorb: the one contraction the reference makes (see the header)
    const float leaked = __fmul_rn(c, lk);
    const float pre = __fadd_rn(__fmaf_rn(-c, lk, c), h);
    const float overflow = fmaxf(__fsub_rn(pre, cap), 0.f);
    const float avail = fminf(pre, cap);
    // gate, drain, depleted
    const float feasible = avail >= rc ? 1.f : 0.f;
    float want;
    if constexpr (GATE == SUSTAINABLE) want = ld(a.want, i, a.s_want);
    else if constexpr (GATE == THRESHOLD)
      want = avail >= __fmul_rn(ld(a.threshold, i, a.s_threshold), rc) ? 1.f : 0.f;
    else want = 1.f;
    const float mask = __fmul_rn(want, feasible);
    const float consumed = __fmul_rn(mask, rc);
    const float cout = __fsub_rn(avail, consumed);
    const float depleted = avail < rc ? 1.f : 0.f;

    a.charge_out[i] = cout;
    if constexpr (EMIT) a.mask_out[i] = mask;

    // valid * value, in the reference's product order, added in k order
    acc[0] = __fadd_rn(acc[0], __fmul_rn(v, mask));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(v, h));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(v, consumed));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(v, leaked));
    acc[4] = __fadd_rn(acc[4], __fmul_rn(v, overflow));
    acc[5] = __fadd_rn(acc[5], __fmul_rn(v, cout));
    acc[6] = __fadd_rn(acc[6], __fmul_rn(v, depleted));
    acc[7] = __fadd_rn(acc[7], __fmul_rn(v, 1.f));

    if constexpr (HIST) {
      const float capg = fmaxf(cap, tiny());
      const float soc = __fdiv_rn(cout, capg);
      const float spend = __fdiv_rn(consumed, capg);
      const float sk = __fmul_rn(__fadd_rn(ld(a.streak, i, a.s_streak), 1.f),
                                 depleted);
      a.streak_out[i] = sk;
      if (v != 0.f) {                       // valid holds 0. or 1.
        atomicAdd(&hist[bin_of(soc, 32.f, BINS_SOC)], 1);
        atomicAdd(&hist[BINS_SOC + bin_of(spend, 32.f, BINS_SPEND)], 1);
        atomicAdd(&hist[BINS_SOC + BINS_SPEND + bin_of(sk, 1.f, BINS_STREAK)], 1);
      }
    }
    if constexpr (GROUPED) {
      g_valid[k] = v; g_mask[k] = mask; g_dep[k] = depleted;
      g_id[k] = a.groups[i * a.s_groups];
    }
  }

  // block reduction of the float columns, in a fixed order
#pragma unroll
  for (int c = 0; c < BASE; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0) warp_part[c][warp] = s;
  }
  if constexpr (GROUPED) {
    for (int g = 0; g < a.num_groups; ++g) {
      float p = 0.f, d = 0.f, w = 0.f;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const float wg = __fmul_rn(g_valid[k], g_id[k] == g ? 1.f : 0.f);
        p = __fadd_rn(p, __fmul_rn(wg, g_mask[k]));
        d = __fadd_rn(d, __fmul_rn(wg, g_dep[k]));
        w = __fadd_rn(w, __fmul_rn(wg, 1.f));
      }
      p = warp_sum(p); d = warp_sum(d); w = warp_sum(w);
      if (lane == 0) {
        warp_part[BASE + 3 * g][warp] = p;
        warp_part[BASE + 3 * g + 1][warp] = d;
        warp_part[BASE + 3 * g + 2][warp] = w;
      }
    }
  }
  __syncthreads();
  const int F = BASE + (GROUPED ? 3 * a.num_groups : 0);
  for (int c = tid; c < F; c += THREADS) {
    float s = warp_part[c][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, warp_part[c][w]);
    a.partials[(long long)c * a.blocks + blockIdx.x] = s;
  }
  if constexpr (HIST)
    for (int b = tid; b < NBINS; b += THREADS)
      a.counts[(long long)b * a.blocks + blockIdx.x] = hist[b];
}

// The stats from the column totals fsum (F) and the bin counts csum (H),
// both in shared memory: sums (F + H), the totals and the counts as
// float32; stats (7 + 2G + H): participants, harvested, consumed, leaked,
// overflowed, mean_charge, frac_depleted, group_participants[G],
// group_frac_depleted[G], then the bin counts.  The one place the averages
// are formed, for the host-local reduce and the sharded finalize alike.
// Needs blockDim.x >= max(F, H).
__device__ void write_stats(const float* fsum, const long long* csum, int F,
                            int H, int G, float* __restrict__ sums,
                            float* __restrict__ stats) {
  const int t = threadIdx.x;
  if (t < F) sums[t] = fsum[t];
  if (t < H) sums[F + t] = (float)csum[t];
  if (t < NT) stats[t] = fsum[t];
  const float den = fmaxf(fsum[NT + NA], 1.f);
  if (t < NA) stats[NT + t] = __fdiv_rn(fsum[NT + t], den);
  if (t < G) {
    stats[NT + NA + t] = fsum[BASE + 3 * t];
    stats[NT + NA + G + t] =
        __fdiv_rn(fsum[BASE + 3 * t + 1], fmaxf(fsum[BASE + 3 * t + 2], 1.f));
  }
  if (t < H) stats[NT + NA + 2 * G + t] = (float)csum[t];
}

// Adds the blocks' partial rows in a fixed order; then either forms the
// stats (row == nullptr) or writes the rank's row (F + H float64) for the
// all-reduce and leaves sums and stats alone.
__global__ void __launch_bounds__(REDUCE_THREADS)
fleet_step_reduce(const float* __restrict__ partials,
                  const int* __restrict__ counts, int F, int H, int blocks,
                  int G, float* __restrict__ sums, float* __restrict__ stats,
                  double* __restrict__ row) {
  __shared__ float fsum[MAX_F];
  __shared__ long long csum[NBINS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < F + H; c += REDUCE_THREADS / 32) {
    if (c < F) {
      const float* col = partials + (long long)c * blocks;
      float s = 0.f;
      for (int r = lane; r < blocks; r += 32) s = __fadd_rn(s, col[r]);
      s = warp_sum(s);
      if (lane == 0) fsum[c] = s;
    } else {
      const int* col = counts + (long long)(c - F) * blocks;
      long long s = 0;
      for (int r = lane; r < blocks; r += 32) s += col[r];
      s = warp_sum_ll(s);
      if (lane == 0) csum[c - F] = s;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (row == nullptr) {
    write_stats(fsum, csum, F, H, G, sums, stats);
  } else {
    if (t < F) row[t] = (double)fsum[t];
    if (t < H) row[F + t] = (double)csum[t];
  }
}

// The sharded finalize: the all-reduced row (F + H float64) rounded to
// float32 once a column, the counts taken back as integers, then the stats
// as the host-local reduce forms them.
__global__ void __launch_bounds__(FINALIZE_THREADS)
fleet_step_finalize_kernel(const double* __restrict__ row, int F, int H,
                           int G, float* __restrict__ sums,
                           float* __restrict__ stats) {
  __shared__ float fsum[MAX_F];
  __shared__ long long csum[NBINS];
  const int t = threadIdx.x;
  if (t < F) fsum[t] = __double2float_rn(row[t]);
  if (t < H) csum[t] = __double2ll_rn(row[F + t]);
  __syncthreads();
  write_stats(fsum, csum, F, H, G, sums, stats);
}

template <int GATE, bool HIST, bool GROUPED, bool EMIT>
int launch_step(const Args& a, cudaStream_t st) {
  fleet_step_kernel<GATE, HIST, GROUPED, EMIT><<<a.blocks, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int GATE, bool HIST, bool GROUPED>
int pick_emit(const Args& a, int emit, cudaStream_t st) {
  return emit ? launch_step<GATE, HIST, GROUPED, true>(a, st)
              : launch_step<GATE, HIST, GROUPED, false>(a, st);
}

template <int GATE, bool HIST>
int pick_grouped(const Args& a, int emit, cudaStream_t st) {
  return a.num_groups > 0 ? pick_emit<GATE, HIST, true>(a, emit, st)
                          : pick_emit<GATE, HIST, false>(a, emit, st);
}

template <int GATE>
int pick_hist(const Args& a, int hist, int emit, cudaStream_t st) {
  return hist ? pick_grouped<GATE, true>(a, emit, st)
              : pick_grouped<GATE, false>(a, emit, st);
}

}  // namespace

extern "C" {

// One round.  Each float input comes with a stride, 0 (a scalar) or 1 (one
// value per client); groups likewise.  gate: 0 SUSTAINABLE (reads want),
// 1 THRESHOLD (reads threshold), 2 GREEDY/ALWAYS.  num_groups: 0 for no
// groups.  partials (F, blocks) float and counts (128, blocks) int are
// scratch; sums (F + 128) and stats (7 + 2G + 128) the results, with
// F = 8 + 3 num_groups, and the 128 count entries present only with hist.
// With a `row` (F + 128 float64; else nullptr) the launch writes the
// rank's column totals and counts there instead of sums and stats, for
// the caller to all-reduce and pass to fleet_step_finalize.
// Returns the cudaError_t of the launches (0 on success), -1 for a bad
// gate, -2 for n < 1 or num_groups outside [0, 64].
int fleet_step(const float* charge, long long s_charge,
               const float* harvest, long long s_harvest,
               const float* capacity, long long s_capacity,
               const float* leak, long long s_leak,
               const float* round_cost, long long s_round_cost,
               const float* threshold, long long s_threshold,
               const float* want, long long s_want,
               const float* valid, long long s_valid,
               const int* groups, long long s_groups,
               const float* streak, long long s_streak,
               float* charge_out, float* streak_out, float* mask_out,
               float* partials, int* counts, float* sums, float* stats,
               double* row, long long n, int gate, int hist, int emit,
               int num_groups, void* stream) {
  if (n < 1 || num_groups < 0 || num_groups > MAX_GROUPS) return -2;
  if (gate < SUSTAINABLE || gate > GREEDY) return -1;
  Args a{charge, s_charge, harvest, s_harvest, capacity, s_capacity,
         leak, s_leak, round_cost, s_round_cost, threshold, s_threshold,
         want, s_want, valid, s_valid, groups, s_groups, streak, s_streak,
         charge_out, streak_out, mask_out, partials, counts, n, num_groups,
         (int)((n + TILE - 1) / TILE)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (gate == SUSTAINABLE) err = pick_hist<SUSTAINABLE>(a, hist, emit, st);
  else if (gate == THRESHOLD) err = pick_hist<THRESHOLD>(a, hist, emit, st);
  else err = pick_hist<GREEDY>(a, hist, emit, st);
  if (err) return err;
  const int F = BASE + 3 * num_groups;
  fleet_step_reduce<<<1, REDUCE_THREADS, 0, st>>>(
      partials, counts, F, hist ? NBINS : 0, a.blocks, num_groups, sums, stats,
      row);
  return static_cast<int>(cudaGetLastError());
}

// The stats from an all-reduced row (F + 128 float64, F = 8 + 3
// num_groups, the counts present only with hist) into sums and stats as
// fleet_step lays them out.  One block.  Returns the cudaError_t of the
// launch, -2 for num_groups outside [0, 64].
int fleet_step_finalize(const double* row, float* sums, float* stats,
                        int hist, int num_groups, void* stream) {
  if (num_groups < 0 || num_groups > MAX_GROUPS) return -2;
  fleet_step_finalize_kernel<<<1, FINALIZE_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      row, BASE + 3 * num_groups, hist ? NBINS : 0, num_groups, sums, stats);
  return static_cast<int>(cudaGetLastError());
}

const char* fleet_step_error_string(int code) {
  if (code == -1) return "unknown gate";
  if (code == -2) return "empty fleet or num_groups outside [0, 64]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
