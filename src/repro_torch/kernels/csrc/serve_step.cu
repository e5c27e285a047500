// One serving epoch of the serve step program, for Hopper (sm_90a):
//
//   leaked    = charge * leak
//   pre       = fma(-charge, leak, charge) + harvest
//   available = min(pre, capacity),  overflow = max(pre - capacity, 0)
//   full_req  = fma(full_tokens,  jpd, prompt * jpp) + upload
//   short_req = fma(short_tokens, jpd, prompt * jpp) + upload
//   mode      = admission(available, requests, prices, hi * admit,
//                         lo * admit)                       (see ADM)
//   per_req   = mode == FULL ? full_req : short_req
//   admitted  = mode > SHED ? requests : 0
//   served    = min(admitted, floor(available / max(per_req, 1e-20)))
//   consumed_serve = served * per_req
//   charge_serve   = fma(-served, per_req, available)
//   the ledger: served_full, served_short, shed, missed = admitted - served,
//               depleted = available < short_req
//   tmask     = want * (charge_serve >= round_cost)           (see TRAIN)
//   consumed_train = tmask * round_cost,  charge' = charge_serve - it
//   tokens    = served_full * full_tokens + served_short * short_tokens
//   consumed_total = consumed_serve + consumed_train
//   with HIST: soc = charge' / max(capacity, 1e-20),
//              spend_frac = consumed_total / max(capacity, 1e-20),
//              streak' = (streak + 1) * depleted
//
// plus the epoch's telemetry: valid-weighted totals of tmask, harvest,
// consumed_total, leaked, overflow, requests, served_full, served_short,
// shed, missed, tokens, consumed_serve and consumed_train, the averages of
// charge' and depleted, and the histograms of soc, spend_frac and streak'
// (exact integer counts).
//
// Replaces the TPU kernel repro/kernels/fleet_step.py::fused_step (body
// _make_kernel) for the serve program of repro/energy/step_ops.py
// (serve_step_program); csrc/fleet_step.cu runs the fleet program.  It
// computes the same function as the port's plain version
// (repro_torch.energy.step_ops.run_step on that program):
// * Every float operation is written as __fmul_rn / __fadd_rn / __fsub_rn /
//   __fdiv_rn, which nvcc never contracts.  Three sites are __fmaf_rn, as
//   XLA's CPU backend contracts them in the reference's jitted serving
//   scan: the absorb, the decode term of each price, and the serve drain.
//   So every per-client output is bitwise equal to the plain version on
//   any inputs.
// * Telemetry as in fleet_step.cu: each block reduces its clients to one
//   row of 16 partial sums (13 totals, 2 average numerators, the sum of
//   valid) in a fixed order, stored column-major (16, blocks); histogram
//   counts are integer atomics in shared memory, an int column block
//   (128, blocks).  serve_step_reduce, a second one-block launch, adds the
//   columns over the blocks in a fixed order, counts as 64-bit integers,
//   and only then forms the averages as num / max(den, 1).
// * Every input is read through a stride of 0 (one value for the fleet)
//   or 1 (one per client); the ragged tail is masked by a bounds check.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  At N = 10,000,000
// with charge, harvest, requests, valid, twant and streak in and charge'
// and streak' out, 320 MB, 96 us at the card's rate.  Like fleet_step.cu,
// this first version has no vector loads and no cp.async pipeline.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 16;                       // clients per thread
constexpr int TILE = THREADS * CPT;           // clients per block
constexpr int NT = 13;                        // totals
constexpr int NA = 2;                         // averages
constexpr int F = NT + NA + 1;                // + sum of valid
constexpr int BINS_SOC = 32, BINS_SPEND = 32, BINS_STREAK = 64;
constexpr int NBINS = BINS_SOC + BINS_SPEND + BINS_STREAK;
constexpr int REDUCE_THREADS = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SHED = 0, DEGRADED = 1, FULL = 2;

enum Admission { AGNOSTIC = 0, BATTERY_GATED = 1, CHARGE_GATED = 2 };
enum Train { NONE = 0, SUSTAINABLE = 1, THRESHOLD = 2, GREEDY = 3 };
// the order of the inputs in serve_step's `in` and `strides` arrays
enum In {
  CHARGE, HARVEST, REQUESTS, VALID, CAPACITY, LEAK, JPP, JPD, UPLOAD,
  PROMPT, FULL_TOK, SHORT_TOK, HI, LO, ADMIT, ROUND_COST, TRAIN_THR, TWANT,
  STREAK, N_IN
};

struct Args {
  const float* p[N_IN];
  long long s[N_IN];
  float* charge_out;
  float* streak_out;
  int* mode_out;
  float* partials;      // (F, blocks)
  int* counts;          // (NBINS, blocks)
  long long n;
  int blocks;
  int emit;
};

// float32(1e-20), the floor of the divisions by capacity and price
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
    v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ long long warp_sum_ll(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

template <int ADM, int TRAIN, bool HIST>
__global__ void __launch_bounds__(THREADS) serve_step_kernel(Args a) {
  __shared__ float warp_part[F][WARPS];
  __shared__ int hist[NBINS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (HIST) {
    for (int b = tid; b < NBINS; b += THREADS) hist[b] = 0;
    __syncthreads();
  }
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.f;

  const long long base = (long long)blockIdx.x * TILE;
#pragma unroll 4
  for (int k = 0; k < CPT; ++k) {
    const long long i = base + (long long)k * THREADS + tid;
    if (i >= a.n) continue;                 // ragged tail: nothing touched
    auto ld = [&](int j) { return a.p[j][i * a.s[j]]; };
    const float c = ld(CHARGE), h = ld(HARVEST), req = ld(REQUESTS);
    const float v = ld(VALID), cap = ld(CAPACITY), lk = ld(LEAK);

    // absorb (the reference scan's contraction)
    const float leaked = __fmul_rn(c, lk);
    const float pre = __fadd_rn(__fmaf_rn(-c, lk, c), h);
    const float overflow = fmaxf(__fsub_rn(pre, cap), 0.f);
    const float avail = fminf(pre, cap);
    // price: prompt * jpp shared, the decode term fused
    const float jpd = ld(JPD), up = ld(UPLOAD);
    const float ft = ld(FULL_TOK), st = ld(SHORT_TOK);
    const float pa = __fmul_rn(ld(PROMPT), ld(JPP));
    const float full_req = __fadd_rn(__fmaf_rn(ft, jpd, pa), up);
    const float short_req = __fadd_rn(__fmaf_rn(st, jpd, pa), up);
    // admission, thresholds scaled by the controller's knob first
    int mode;
    if constexpr (ADM == AGNOSTIC) {
      mode = FULL;
    } else {
      const float adm = ld(ADMIT);
      const float hs = __fmul_rn(ld(HI), adm), ls = __fmul_rn(ld(LO), adm);
      if constexpr (ADM == BATTERY_GATED)
        mode = avail >= __fmul_rn(hs, __fmul_rn(req, full_req)) ? FULL
               : avail >= __fmul_rn(ls, __fmul_rn(req, short_req)) ? DEGRADED
                                                                    : SHED;
      else
        mode = avail >= hs ? FULL : avail >= ls ? DEGRADED : SHED;
    }
    // serve drain and ledger
    const float per_req = mode == FULL ? full_req : short_req;
    const float admitted = mode > SHED ? req : 0.f;
    const float afford = floorf(__fdiv_rn(avail, fmaxf(per_req, tiny())));
    const float served = fminf(admitted, afford);
    const float cserve = __fmul_rn(served, per_req);
    const float charge_serve = __fmaf_rn(-served, per_req, avail);
    const float served_full = mode == FULL ? served : 0.f;
    const float served_short = mode == DEGRADED ? served : 0.f;
    const float shed = mode == SHED ? req : 0.f;
    const float missed = __fsub_rn(admitted, served);
    const float depleted = avail < short_req ? 1.f : 0.f;
    // training gate and drain on what serving left
    float tmask = 0.f, ctrain = 0.f, cout = charge_serve;
    if constexpr (TRAIN != NONE) {
      const float rc = ld(ROUND_COST);
      const float feasible = charge_serve >= rc ? 1.f : 0.f;
      float want;
      if constexpr (TRAIN == SUSTAINABLE) want = ld(TWANT);
      else if constexpr (TRAIN == THRESHOLD)
        want = charge_serve >= __fmul_rn(ld(TRAIN_THR), rc) ? 1.f : 0.f;
      else want = 1.f;
      tmask = __fmul_rn(want, feasible);
      ctrain = __fmul_rn(tmask, rc);
      cout = __fsub_rn(charge_serve, ctrain);
    }
    const float tokens = __fadd_rn(__fmul_rn(served_full, ft),
                                   __fmul_rn(served_short, st));
    const float ctotal = __fadd_rn(cserve, ctrain);

    a.charge_out[i] = cout;
    if (a.emit) a.mode_out[i] = mode;

    // valid * value, in the reference's product order, added in k order
    const float col[F - 1] = {tmask, h, ctotal, leaked, overflow, req,
                              served_full, served_short, shed, missed,
                              tokens, cserve, ctrain, cout, depleted};
#pragma unroll
    for (int j = 0; j < F - 1; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(v, col[j]));
    acc[F - 1] = __fadd_rn(acc[F - 1], __fmul_rn(v, 1.f));

    if constexpr (HIST) {
      const float capg = fmaxf(cap, tiny());
      const float soc = __fdiv_rn(cout, capg);
      const float spend = __fdiv_rn(ctotal, capg);
      const float sk = __fmul_rn(__fadd_rn(ld(STREAK), 1.f), depleted);
      a.streak_out[i] = sk;
      if (v != 0.f) {                       // valid holds 0. or 1.
        atomicAdd(&hist[bin_of(soc, 32.f, BINS_SOC)], 1);
        atomicAdd(&hist[BINS_SOC + bin_of(spend, 32.f, BINS_SPEND)], 1);
        atomicAdd(&hist[BINS_SOC + BINS_SPEND + bin_of(sk, 1.f, BINS_STREAK)],
                  1);
      }
    }
  }

  // block reduction of the float columns, in a fixed order
#pragma unroll
  for (int c = 0; c < F; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == 0) warp_part[c][warp] = s;
  }
  __syncthreads();
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

// Adds the blocks' partial rows in a fixed order and forms the stats:
// sums (F + H): the column totals; stats (15 + H): the 13 totals, then
// mean_charge and frac_depleted, then the bin counts.
__global__ void __launch_bounds__(REDUCE_THREADS)
serve_step_reduce(const float* __restrict__ partials,
                  const int* __restrict__ counts, int H, int blocks,
                  float* __restrict__ sums, float* __restrict__ stats) {
  __shared__ float fsum[F];
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
  if (t < F) sums[t] = fsum[t];
  if (t < H) sums[F + t] = (float)csum[t];
  if (t < NT) stats[t] = fsum[t];
  const float den = fmaxf(fsum[NT + NA], 1.f);
  if (t < NA) stats[NT + t] = __fdiv_rn(fsum[NT + t], den);
  if (t < H) stats[NT + NA + t] = (float)csum[t];
}

template <int ADM, int TRAIN, bool HIST>
int launch_step(const Args& a, cudaStream_t st) {
  serve_step_kernel<ADM, TRAIN, HIST><<<a.blocks, THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ADM, int TRAIN>
int pick_hist(const Args& a, int hist, cudaStream_t st) {
  return hist ? launch_step<ADM, TRAIN, true>(a, st)
              : launch_step<ADM, TRAIN, false>(a, st);
}

template <int ADM>
int pick_train(const Args& a, int train, int hist, cudaStream_t st) {
  switch (train) {
    case NONE: return pick_hist<ADM, NONE>(a, hist, st);
    case SUSTAINABLE: return pick_hist<ADM, SUSTAINABLE>(a, hist, st);
    case THRESHOLD: return pick_hist<ADM, THRESHOLD>(a, hist, st);
    default: return pick_hist<ADM, GREEDY>(a, hist, st);
  }
}

}  // namespace

extern "C" {

// One epoch.  `in` holds N_IN (19) float pointers in the order of enum In,
// `strides` their strides: 0 (one value for the fleet) or 1 (one per
// client); a pointer the variant does not read may be null.  admission: 0
// agnostic, 1 battery-gated, 2 charge-gated; train: 0 none, 1 sustainable
// (reads twant), 2 threshold, 3 greedy/always.  partials (16, blocks) float
// and counts (128, blocks) int are scratch; sums (16 + 128) and stats
// (15 + 128) the results, the 128 count entries present only with hist.
// Returns the cudaError_t of the launches (0 on success), -1 for an
// unknown admission or training gate, -2 for n < 1.
int serve_step(const float* const* in, const long long* strides,
               float* charge_out, float* streak_out, int* mode_out,
               float* partials, int* counts, float* sums, float* stats,
               long long n, int admission, int train, int hist, int emit,
               void* stream) {
  if (n < 1) return -2;
  if (admission < AGNOSTIC || admission > CHARGE_GATED || train < NONE ||
      train > GREEDY)
    return -1;
  Args a;
  for (int j = 0; j < N_IN; ++j) {
    a.p[j] = in[j];
    a.s[j] = strides[j];
  }
  a.charge_out = charge_out;
  a.streak_out = streak_out;
  a.mode_out = mode_out;
  a.partials = partials;
  a.counts = counts;
  a.n = n;
  a.blocks = (int)((n + TILE - 1) / TILE);
  a.emit = emit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (admission == AGNOSTIC) err = pick_train<AGNOSTIC>(a, train, hist, st);
  else if (admission == BATTERY_GATED)
    err = pick_train<BATTERY_GATED>(a, train, hist, st);
  else err = pick_train<CHARGE_GATED>(a, train, hist, st);
  if (err) return err;
  serve_step_reduce<<<1, REDUCE_THREADS, 0, st>>>(
      partials, counts, hist ? NBINS : 0, a.blocks, sums, stats);
  return static_cast<int>(cudaGetLastError());
}

const char* serve_step_error_string(int code) {
  if (code == -1) return "unknown admission rule or training gate";
  if (code == -2) return "empty fleet";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
