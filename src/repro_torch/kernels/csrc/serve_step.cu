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
// * Telemetry in a fixed order: each thread adds its clients' valid *
//   value terms in client order (clients tid and tid + 256 of each
//   512-client tile it walks), a warp adds its lanes in a shuffle tree
//   and a block its 8 warps in order, into one row of 16 partial sums (13
//   totals, 2 average numerators, the sum of valid) per block, stored
//   column-major (16, grid).  The fold adds those rows in a fixed order
//   (lane l of a warp takes rows l, l + 32, ..., then a shuffle tree),
//   whichever block finishes last, and only then forms the averages as
//   num / max(den, 1).  Histogram counts are exact integers: shared-memory
//   counts a warp, added to global counts with integer atomics.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes.  At N = 10,000,000
// with charge, harvest, requests, valid, twant and streak in and charge'
// and streak' out, 320 MB, 96 us at the card's rate.  The first version of
// this kernel (a block a 4096-client tile, 2442 blocks at N = 1e7, then a
// one-block launch over their rows) reached 45% of that.  What held it
// back, and what this design does about each (probes/serve_variants.py
// times the variants; PERF.md keeps the numbers):
// * Loads in flight.  A thread's loads of one client could not run ahead
//   of the previous client's arithmetic, and holding several clients'
//   inputs in registers (4 clients a thread, float4 loads) spilled and
//   cut the blocks an SM.  Here the six per-client streams (charge,
//   harvest, requests, valid, twant, streak) go through shared memory:
//   the block copies each tile with cp.async one tile ahead of the one
//   it computes (16 bytes a copy where every per-client pointer is
//   16-byte aligned, 4 bytes otherwise), so the copies hold no registers
//   and are in flight during the arithmetic.  A thread then takes one
//   client at a time from shared memory (clients tid and tid + 256 of
//   the tile), and stores charge', streak' and mode straight out,
//   coalesced.  The inputs with one value for the fleet are read once a
//   block into shared memory; the wrapper says which inputs hold a value
//   per client.  Tiles of 512 clients keep the blocks' shares of the
//   walk within one small tile of each other.
// * Shared-memory atomics that serialise: the streak histogram sends every
//   client that is not depleted to bin 0, so all the block's warps hit one
//   address.  Here each warp counts into its own row of the block's
//   counts, and the rows are added once a block.  (Aggregating a warp's
//   equal bins first, by a ballot or __match_any_sync, measured slower:
//   the kernel is short of issue slots, not of atomic throughput.)
// * Instructions.  With the loads in flight, the issue slots bound the
//   kernel: where exactly the streams hold a value a client (the main
//   path), every other input is the fleet's one value, held in registers
//   for a tile, and nothing is checked per client.
// * 2442 partial rows and a one-block second launch that read them back:
//   here the grid is persistent (blocks = SMs x BLOCKS_PER_SM, each block
//   walks tiles b, b + grid, ...), so there are a few hundred rows, and
//   the last block to finish (a ticket counter that it leaves at 0 for
//   the next call) folds them in the same launch.  The global bin counts
//   and the ticket live in scratch the wrapper zeroes once; the fold
//   leaves them at 0.
//
// The sharded fleet (one rank a slab of clients): given a `row`, the fold
// writes the column totals and the counts there as float64 (each float32
// total and each integer count exactly), still leaving the ticket and the
// counts at 0, and forms no stats.  The caller sums the ranks' rows (one
// all-reduce), and serve_step_finalize, one block, rounds each sum to
// float32 once and forms the stats through the same write_stats as the
// fold.  So one rank's stats equal the host-local launch's bit for bit,
// counts stay exact integers across ranks (below 2^53), and on dyadic
// inputs any number of ranks gives the host-local stats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 2;                        // clients a thread a tile
constexpr int TILE = THREADS * CPT;           // clients a block a tile
constexpr int BLOCKS_PER_SM = 3;              // the persistent grid's depth
constexpr int NT = 13;                        // totals
constexpr int NA = 2;                         // averages
constexpr int F = NT + NA + 1;                // + sum of valid
constexpr int BINS_SOC = 32, BINS_SPEND = 32, BINS_STREAK = 64;
constexpr int NBINS = BINS_SOC + BINS_SPEND + BINS_STREAK;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SHED = 0, DEGRADED = 1, FULL = 2;

enum Admission { AGNOSTIC = 0, BATTERY_GATED = 1, CHARGE_GATED = 2 };
enum Train { NONE = 0, SUSTAINABLE = 1, THRESHOLD = 2, GREEDY = 3 };
// the order of the inputs in serve_step's `in` array and `per_client` bits
enum In {
  CHARGE, HARVEST, REQUESTS, VALID, CAPACITY, LEAK, JPP, JPD, UPLOAD,
  PROMPT, FULL_TOK, SHORT_TOK, HI, LO, ADMIT, ROUND_COST, TRAIN_THR, TWANT,
  STREAK, N_IN
};
// the per-client streams, staged in shared memory a tile at a time
constexpr int NS = 6;
constexpr int STAGE = NS * TILE;              // floats of one staged tile
constexpr int SMEM = 2 * STAGE * sizeof(float);   // two staged tiles
__host__ __device__ constexpr int stream_input(int q) {
  return q == 0 ? CHARGE : q == 1 ? HARVEST : q == 2 ? REQUESTS
         : q == 3 ? VALID : q == 4 ? TWANT : STREAK;
}

struct Args {
  const float* p[N_IN];
  unsigned per_client;  // bit j: input j holds one value a client
  float* charge_out;
  float* streak_out;
  int* mode_out;
  float* partials;      // (F, grid)
  int* counts;          // [0] the ticket, [1 + b] bin b; 0 between calls
  float* sums;          // (F + H): the column totals
  float* stats;         // (15 + H)
  double* row;          // (F + H) the rank's row instead, or nullptr
  long long n;
  long long tiles;
  int grid;
  int vec;              // every per-client input is 16-byte aligned
  int emit;
};

template <int ADM, int TRAIN, bool HIST>
__host__ __device__ constexpr bool reads(int j) {
  return j == HI || j == LO || j == ADMIT ? ADM != AGNOSTIC
         : j == ROUND_COST ? TRAIN != NONE
         : j == TRAIN_THR ? TRAIN == THRESHOLD
         : j == TWANT ? TRAIN == SUSTAINABLE
         : j == STREAK ? HIST
                       : true;
}

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

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int size, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (size == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copies tile t of every per-client stream (bit q of `copied`) into `buf`
// (NS rows of TILE floats) with cp.async: on the vector path 16 bytes a
// copy, THREADS / (TILE / 4) streams at once; otherwise 4 bytes (one
// client) a copy, a stream at a time.  Clients past n read as 0.
__device__ __forceinline__ void stage_tile(const Args& a, float* buf,
                                           long long t, unsigned copied,
                                           bool vec) {
  const long long base = t * TILE;
  if (vec) {
    constexpr int CHUNKS = TILE / 4, SPAN = THREADS / CHUNKS;
    const int e = (threadIdx.x % CHUNKS) * 4, q0 = threadIdx.x / CHUNKS;
#pragma unroll
    for (int m = 0; m < NS; m += SPAN) {
      const int q = q0 + m;
      if (!(copied >> q & 1)) continue;
      const float* row = a.p[stream_input(q)];
      const long long left = a.n - base - e;
      const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
      cp_async(buf + q * TILE + e, bytes ? row + base + e : row, 16, bytes);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      if (!(copied >> q & 1)) continue;
      const float* row = a.p[stream_input(q)];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int e = threadIdx.x + k * THREADS;
        const bool in = base + e < a.n;
        cp_async(buf + q * TILE + e, in ? row + base + e : row, 4, in ? 4 : 0);
      }
    }
  }
}

// One client: its outputs, its terms added to acc, its bins counted in
// the warp's row of the histogram.  s[q] is input stream_input(q); op(j)
// any other input.
template <int ADM, int TRAIN, bool HIST, typename Op>
__device__ __forceinline__ void client(const float (&s)[NS], Op op,
                                       float* acc, float& cout, float& sk,
                                       int& mode, int* whist) {
  const float c = s[0], h = s[1], req = s[2], v = s[3];
  const float cap = op(CAPACITY), lk = op(LEAK);

  // absorb (the reference scan's contraction)
  const float leaked = __fmul_rn(c, lk);
  const float pre = __fadd_rn(__fmaf_rn(-c, lk, c), h);
  const float overflow = fmaxf(__fsub_rn(pre, cap), 0.f);
  const float avail = fminf(pre, cap);
  // price: prompt * jpp shared, the decode term fused
  const float jpd = op(JPD), up = op(UPLOAD);
  const float ft = op(FULL_TOK), st = op(SHORT_TOK);
  const float pa = __fmul_rn(op(PROMPT), op(JPP));
  const float full_req = __fadd_rn(__fmaf_rn(ft, jpd, pa), up);
  const float short_req = __fadd_rn(__fmaf_rn(st, jpd, pa), up);
  // admission, thresholds scaled by the controller's knob first
  if constexpr (ADM == AGNOSTIC) {
    mode = FULL;
  } else {
    const float adm = op(ADMIT);
    const float hs = __fmul_rn(op(HI), adm), ls = __fmul_rn(op(LO), adm);
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
  float tmask = 0.f, ctrain = 0.f;
  cout = charge_serve;
  if constexpr (TRAIN != NONE) {
    const float rc = op(ROUND_COST);
    const float feasible = charge_serve >= rc ? 1.f : 0.f;
    float want;
    if constexpr (TRAIN == SUSTAINABLE) want = s[4];
    else if constexpr (TRAIN == THRESHOLD)
      want = charge_serve >= __fmul_rn(op(TRAIN_THR), rc) ? 1.f : 0.f;
    else want = 1.f;
    tmask = __fmul_rn(want, feasible);
    ctrain = __fmul_rn(tmask, rc);
    cout = __fsub_rn(charge_serve, ctrain);
  }
  const float tokens = __fadd_rn(__fmul_rn(served_full, ft),
                                 __fmul_rn(served_short, st));
  const float ctotal = __fadd_rn(cserve, ctrain);

  // valid * value, in the reference's product order, added in client
  // order; valid holds 0. or 1., so the product is exact and product and
  // sum round once, as one fmaf
  const float col[F - 1] = {tmask, h, ctotal, leaked, overflow, req,
                            served_full, served_short, shed, missed,
                            tokens, cserve, ctrain, cout, depleted};
#pragma unroll
  for (int j = 0; j < F - 1; ++j) acc[j] = __fmaf_rn(v, col[j], acc[j]);
  acc[F - 1] = __fadd_rn(acc[F - 1], v);

  if constexpr (HIST) {
    const float capg = fmaxf(cap, tiny());
    const float soc = __fdiv_rn(cout, capg);
    const float spend = __fdiv_rn(ctotal, capg);
    sk = __fmul_rn(__fadd_rn(s[5], 1.f), depleted);
    if (v != 0.f) {                         // valid holds 0. or 1.
      atomicAdd(&whist[bin_of(soc, 32.f, BINS_SOC)], 1);
      atomicAdd(&whist[BINS_SOC + bin_of(spend, 32.f, BINS_SPEND)], 1);
      atomicAdd(&whist[BINS_SOC + BINS_SPEND + bin_of(sk, 1.f, BINS_STREAK)],
                1);
    }
  }
}

// The stats from the column totals fsum (F) and the bin counts csum (H),
// both in shared memory: sums (F + H), the totals and the counts as
// float32; stats (15 + H).  The one place the averages are formed, for the
// fold and the sharded finalize alike.  Run by one block of THREADS
// threads.
__device__ void write_stats(const float* fsum, const long long* csum, int H,
                            float* sums, float* stats) {
  const int t = threadIdx.x;
  if (t < F) sums[t] = fsum[t];
  if (t < NT) stats[t] = fsum[t];
  const float den = fmaxf(fsum[NT + NA], 1.f);
  if (t < NA) stats[NT + t] = __fdiv_rn(fsum[NT + t], den);
  for (int b = t; b < H; b += THREADS) {
    const float cnt = (float)csum[b];
    sums[F + b] = cnt;
    stats[NT + NA + b] = cnt;
  }
}

// Adds the rows of partials in a fixed order (lane l: rows l, l + 32, ...,
// then a shuffle tree), takes the global counts (leaving them at 0), and
// writes sums and stats, or with a.row the rank's row.  Run by one block
// of THREADS threads.
__device__ void fold(const Args& a, int H) {
  __shared__ float fsum[F];
  __shared__ long long csum[NBINS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c = warp; c < F; c += WARPS) {
    const float* col = a.partials + (long long)c * a.grid;
    float s = 0.f;
#pragma unroll 8
    for (int r = lane; r < a.grid; r += 32) s = __fadd_rn(s, __ldcg(col + r));
    s = warp_sum(s);
    if (lane == 0) fsum[c] = s;
  }
  for (int b = t; b < H; b += THREADS) csum[b] = atomicExch(&a.counts[1 + b], 0);
  __syncthreads();
  if (a.row == nullptr) {
    write_stats(fsum, csum, H, a.sums, a.stats);
  } else {
    if (t < F) a.row[t] = (double)fsum[t];
    for (int b = t; b < H; b += THREADS) a.row[F + b] = (double)csum[b];
  }
}

// The sharded finalize: the all-reduced row (F + H float64) rounded to
// float32 once a column, the counts taken back as integers, then the stats
// as the fold forms them.
__global__ void __launch_bounds__(THREADS)
    serve_step_finalize_kernel(const double* __restrict__ row, int H,
                               float* sums, float* stats) {
  __shared__ float fsum[F];
  __shared__ long long csum[NBINS];
  const int t = threadIdx.x;
  if (t < F) fsum[t] = __double2float_rn(row[t]);
  for (int b = t; b < H; b += THREADS) csum[b] = __double2ll_rn(row[F + b]);
  __syncthreads();
  write_stats(fsum, csum, H, sums, stats);
}

// The bits of per_client when exactly the streams the instantiation reads
// hold a value a client: the main path's layout.
template <int ADM, int TRAIN, bool HIST>
__host__ __device__ constexpr unsigned stream_bits() {
  unsigned bits = 0;
  for (int q = 0; q < NS; ++q)
    if (reads<ADM, TRAIN, HIST>(stream_input(q))) bits |= 1u << stream_input(q);
  return bits;
}

// The CPT clients of tile t this thread computes, one at a time: clients
// tid, tid + THREADS, ... of the tile, from the staged streams `cur`.
// STREAMS_ONLY: the per-client inputs are exactly the streams read, so
// every other input is the fleet's one value cv[j] (in registers);
// otherwise each input is checked and read per client if it must.
template <int ADM, int TRAIN, bool HIST, bool STREAMS_ONLY>
__device__ __forceinline__ void tile_clients(const Args& a, const float* cur,
                                             const float (&cv)[N_IN],
                                             long long t, float* acc,
                                             int* whist) {
  const unsigned pc = a.per_client;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const long long i = t * TILE + e;
    if (i < a.n) {
      float sv[NS];
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const int j = stream_input(q);
        sv[q] = !reads<ADM, TRAIN, HIST>(j)    ? 0.f
                : STREAMS_ONLY || pc >> j & 1 ? cur[q * TILE + e]
                                              : cv[j];
      }
      auto op = [&](int j) {
        return !STREAMS_ONLY && pc >> j & 1 ? __ldg(a.p[j] + i) : cv[j];
      };
      float cout, sk;
      int mode;
      client<ADM, TRAIN, HIST>(sv, op, acc, cout, sk, mode, whist);
      a.charge_out[i] = cout;
      if constexpr (HIST) a.streak_out[i] = sk;
      if (a.emit) a.mode_out[i] = mode;
    }
  }
}

template <int ADM, int TRAIN, bool HIST>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    serve_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ float4 staged[];          // two tiles of the streams
  __shared__ float cst[N_IN];                 // the inputs one a fleet
  __shared__ float warp_part[F][WARPS];
  __shared__ int hist[HIST ? WARPS * NBINS : 1];   // a row a warp
  __shared__ bool last;
  float* stage = reinterpret_cast<float*>(staged);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned pc = a.per_client;
  const bool vec = a.vec;
  const bool streams_only = pc == stream_bits<ADM, TRAIN, HIST>();
  int* whist = hist + warp * NBINS;
  if constexpr (HIST)
    for (int b = tid; b < WARPS * NBINS; b += THREADS) hist[b] = 0;
  if (tid < N_IN)
    cst[tid] = reads<ADM, TRAIN, HIST>(tid) && !(pc >> tid & 1)
                   ? __ldg(a.p[tid]) : 0.f;
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.f;

  // tile t is computed from one buffer while tile t + grid is copied into
  // the other
  unsigned copied = 0;
#pragma unroll
  for (int q = 0; q < NS; ++q)
    if (reads<ADM, TRAIN, HIST>(stream_input(q)) && pc >> stream_input(q) & 1)
      copied |= 1u << q;
  int buf = 0;
  stage_tile(a, stage, blockIdx.x, copied, vec);
  cp_async_commit();
  __syncthreads();
  float cv[N_IN];                             // the fleet's values, held
#pragma unroll
  for (int j = 0; j < N_IN; ++j) cv[j] = cst[j];
  for (long long t = blockIdx.x; t < a.tiles; t += a.grid) {
    cp_async_wait<0>();
    // every thread's copies of tile t are in, and every thread is done
    // with the other buffer
    __syncthreads();
    if (t + a.grid < a.tiles) {
      stage_tile(a, stage + (buf ^ 1) * STAGE, t + a.grid, copied, vec);
      cp_async_commit();
    }
    const float* cur = stage + buf * STAGE;
    if (streams_only)
      tile_clients<ADM, TRAIN, HIST, true>(a, cur, cv, t, acc, whist);
    else
      tile_clients<ADM, TRAIN, HIST, false>(a, cur, cv, t, acc, whist);
    buf ^= 1;
  }
  // the block's row of the float columns, in a fixed order
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
    a.partials[(long long)c * a.grid + blockIdx.x] = s;
  }
  if constexpr (HIST)
    for (int b = tid; b < NBINS; b += THREADS) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += hist[w * NBINS + b];
      if (c) atomicAdd(&a.counts[1 + b], c);
    }
  // the last block to finish folds the rows: each block's row and counts
  // are visible before it takes its ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counts[0], 1) == a.grid - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold(a, HIST ? NBINS : 0);
  if (tid == 0) a.counts[0] = 0;            // the ticket, for the next call
}

__global__ void __launch_bounds__(THREADS)
    serve_step_fold(const __grid_constant__ Args a, int H) {
  fold(a, H);
}

// staged tiles of more than 48 KB (tiles of more than 1024 clients, or
// 1024 with the histogram) need the block to ask for them
template <int ADM, int TRAIN, bool HIST>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(serve_step_kernel<ADM, TRAIN, HIST>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM);
}

template <int ADM, int TRAIN, bool HIST>
int launch_step(const Args& a, cudaStream_t st) {
  const cudaError_t err = allow_smem<ADM, TRAIN, HIST>();
  if (err != cudaSuccess) return static_cast<int>(err);
  serve_step_kernel<ADM, TRAIN, HIST><<<a.grid, THREADS, SMEM, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int ADM, int TRAIN, bool HIST>
int occupancy() {
  int blocks = 0;
  cudaError_t err = allow_smem<ADM, TRAIN, HIST>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, serve_step_kernel<ADM, TRAIN, HIST>, THREADS, SMEM);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// calls Fn<ADM, TRAIN, HIST>::run(args...) for the runtime choices
template <template <int, int, bool> class Fn, typename... T>
int dispatch(int admission, int train, int hist, T... args) {
#define SERVE_TRAIN(ADM)                                                   \
  switch (train) {                                                         \
    case NONE: return hist ? Fn<ADM, NONE, true>::run(args...)             \
                           : Fn<ADM, NONE, false>::run(args...);           \
    case SUSTAINABLE: return hist ? Fn<ADM, SUSTAINABLE, true>::run(args...) \
                                  : Fn<ADM, SUSTAINABLE, false>::run(args...); \
    case THRESHOLD: return hist ? Fn<ADM, THRESHOLD, true>::run(args...)   \
                                : Fn<ADM, THRESHOLD, false>::run(args...); \
    default: return hist ? Fn<ADM, GREEDY, true>::run(args...)             \
                         : Fn<ADM, GREEDY, false>::run(args...);           \
  }
  if (admission == AGNOSTIC) { SERVE_TRAIN(AGNOSTIC) }
  if (admission == BATTERY_GATED) { SERVE_TRAIN(BATTERY_GATED) }
  SERVE_TRAIN(CHARGE_GATED)
#undef SERVE_TRAIN
  return -1;
}

template <int ADM, int TRAIN, bool HIST> struct Launch {
  static int run(const Args* a, cudaStream_t st) {
    return launch_step<ADM, TRAIN, HIST>(*a, st);
  }
};

template <int ADM, int TRAIN, bool HIST> struct Occupancy {
  static int run() { return occupancy<ADM, TRAIN, HIST>(); }
};

bool known(int admission, int train) {
  return admission >= AGNOSTIC && admission <= CHARGE_GATED &&
         train >= NONE && train <= GREEDY;
}

}  // namespace

extern "C" {

// One epoch.  `in` holds N_IN (19) float pointers in the order of enum In;
// bit j of `per_client` says input j holds one value a client (else one
// value for the fleet, read once); a pointer the variant does not read
// may be anything.  `vec` (1) says every per-client input is 16-byte
// aligned (the streams are then copied 16 bytes at a time).
// admission: 0 agnostic, 1 battery-gated, 2 charge-gated; train: 0 none,
// 1 sustainable (reads twant), 2 threshold, 3 greedy/always.  `grid`
// blocks (at most the number of 512-client tiles) walk the tiles.
// partials (16, grid) float is scratch; counts (1 + 128) int is scratch
// that must hold zeros, and is left holding zeros.  sums (16 + 128) and
// stats (15 + 128) are the results, the 128 count entries present only
// with hist.  With a `row` (16 + 128 float64; else nullptr) the launch
// writes the rank's column totals and counts there instead of sums and
// stats, for the caller to all-reduce and pass to serve_step_finalize.
// Returns the cudaError_t of the launches (0 on success), -1 for an
// unknown admission or training gate, -2 for n < 1, -3 for a grid outside
// [1, tiles].
int serve_step(const float* const* in, unsigned per_client, float* charge_out,
               float* streak_out, int* mode_out, float* partials, int* counts,
               float* sums, float* stats, double* row, long long n, int grid,
               int vec, int admission, int train, int hist, int emit,
               void* stream) {
  if (n < 1) return -2;
  if (!known(admission, train)) return -1;
  Args a;
  for (int j = 0; j < N_IN; ++j) a.p[j] = in[j];
  a.per_client = per_client;
  a.charge_out = charge_out;
  a.streak_out = streak_out;
  a.mode_out = mode_out;
  a.partials = partials;
  a.counts = counts;
  a.sums = sums;
  a.stats = stats;
  a.row = row;
  a.n = n;
  a.tiles = (n + TILE - 1) / TILE;
  if (grid < 1 || grid > a.tiles) return -3;
  a.grid = grid;
  a.vec = vec;
  a.emit = emit;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<Launch>(admission, train, hist, &a, st);
}

// The fold alone, on the partial rows and counts the last serve_step call
// on this scratch left (counts then read 0): for timing it apart from the
// walk.
int serve_step_fold_only(float* partials, int* counts, float* sums,
                         float* stats, int grid, int hist, void* stream) {
  Args a{};
  a.partials = partials;
  a.counts = counts;
  a.sums = sums;
  a.stats = stats;
  a.grid = grid;
  serve_step_fold<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, hist ? NBINS : 0);
  return static_cast<int>(cudaGetLastError());
}

// The stats from an all-reduced row (16 + 128 float64, the counts present
// only with hist) into sums and stats as serve_step lays them out.  One
// block.  Returns the cudaError_t of the launch.
int serve_step_finalize(const double* row, float* sums, float* stats,
                        int hist, void* stream) {
  serve_step_finalize_kernel<<<1, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      row, hist ? NBINS : 0, sums, stats);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the instantiation resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a
// cudaError_t, or -1 for an unknown admission or training gate.
int serve_step_occupancy(int admission, int train, int hist) {
  if (!known(admission, train)) return -1;
  return dispatch<Occupancy>(admission, train, hist);
}

// BLOCKS_PER_SM: the grid is SMs x this (fleet_step.py mirrors it).
int serve_step_blocks_per_sm() { return BLOCKS_PER_SM; }

const char* serve_step_error_string(int code) {
  if (code == -1) return "unknown admission rule or training gate";
  if (code == -2) return "empty fleet";
  if (code == -3) return "grid outside [1, tiles]";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
