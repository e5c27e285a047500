// Forward flash attention for Hopper (sm_90a), causal and/or sliding-window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel and
// computes the same function: online-softmax attention with the running max
// m, denominator l and output accumulator kept in fp32, fully masked KV tiles
// skipped (the skip is decided per query tile, as on the TPU, so the plain
// version mirrors this kernel's tiles: flash_attention.py tile_sizes), padded
// (ragged-tail) KV rows zeroed and masked, masks written with the finite
// NEG_INF = -1e30 before the row max (with -inf a row whose first live tile
// is fully masked would give exp(-inf - -inf) = NaN; with -1e30 it gets
// p = 1 there and the next tile's alpha = 0 wipes it, as on the TPU), and l
// clamped at 1e-30.  q, k, v are read as (B, S, heads, D) through their
// strides (head dim contiguous); query head h reads KV head h / (H / K), so
// repeat_kv is never materialised; the output is a contiguous (B, Sq, H, D).
// Blocks are launched heaviest causal query tile first, all heads of one
// query tile together (grid (H, q tiles, B)).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// two products take 4 D FLOPs per visible (query, key) pair and the bytes
// are q, k, v read once and o written once.  At S = 2048, causal:
//   granite-3-2b  (H=32, K=8, D=64)   17.2 GFLOP, 21.0 MB: 0.0174 ms of FLOPs
//   granite-8b    (H=32, K=8, D=128)  34.4 GFLOP, 41.9 MB: 0.0348 ms
//   recurrentgemma-2b (H=10, K=1, D=256, window 2048) 21.5 GFLOP: 0.0217 ms
// so the tensor cores bound it (the card's 295 FLOP/byte is passed above
// S ~ 740 at granite's shape).  At D = 64 the softmax's exponentials take
// as long as the products (16 exp per clock per SM against ~4096 bf16
// FLOPs: 4 D = 256 FLOPs per score), so the exps and the fp32 work around
// them must overlap the tensor cores rather than follow them.
//
// bf16 design (flash_fwd_bf16), tiles chosen by measurement
// (probes/flash_tiles.py; flash_attention.py tile_sizes):
// * A block is one query tile of BQ rows of one head: BQ / 64 consumer
//   warpgroups of 64 rows each and a producer.  D = 64 and 128: BQ = 64,
//   BK = 64, one consumer warpgroup and a lone producer warp, 3 (D = 64) or
//   2 (D = 128) blocks an SM, so one block's start and end overlap the
//   others' steady state; D = 256: BQ = 128, BK = 64, two consumer
//   warpgroups and a producer warpgroup that setmaxnreg cuts to 24
//   registers to give the consumers 240.  The C entry picks the tile from
//   (dtype, D); probes/flash_tiles.py --plant times another query tile
//   (BQ 64 or 128, BK 64) in a copy of the source.
// * Copies: one producer thread issues TMA loads (cp.async.bulk.tensor) of
//   the Q tile once and of K and V tiles into rings of STAGES = 2 stages,
//   K and V each with a full and an empty mbarrier per stage, so a K stage
//   is refilled as soon as its scores are in and a V stage once its P V is
//   done.  The tensor maps are 4-D views (D, heads, S, B) with the caller's
//   strides, encoded on the host through cuTensorMapEncodeTiled (reached
//   through cudaGetDriverEntryPoint: no -lcuda) and passed as
//   __grid_constant__ parameters.  Each box is 64 columns (128 bytes) x
//   rows, so a tile of D columns is D / 64 boxes, each laid out in the
//   128-byte swizzle that wgmma reads.  TMA zero-fills rows past S; keys
//   >= Skv are masked as well.
// * S = Q K^T: wgmma.m64nBKk16, both operands from shared memory (K-major,
//   128-byte swizzle: 8-row groups 1024 bytes apart, a k16 step is +32
//   bytes inside a 128-byte row, a 64-column chunk is the next box).
// * Softmax on the accumulator registers: a row of the m64nN accumulator
//   lives in 4 lanes, so its max takes 2 shuffles (its sum is kept per lane
//   and reduced once, at the end).  The scale is folded into exp2 with
//   log2(e): p = 2^(s c - m c), c = scale log2(e), one FFMA an element, on
//   raw scores masked to NEG_INF; a row that has seen only masked keys
//   takes c = 0, so its p is exactly 1, as on the TPU.  Only tiles that
//   cross the causal diagonal, the window's edge or Skv are masked element
//   by element.
// * O += P V: P is rounded to bf16 in registers and fed as wgmma's register
//   A operand (the m64nN accumulator layout of two n8 blocks is the A
//   fragment of one k16 slice), so scores and P never touch shared memory.
//   V is the B operand from shared memory, MN-major (tnspB): 64-column
//   chunks LBO = BK * 128 bytes apart, 8-key groups SBO = 1024 bytes.
//   l sums the unrounded p, so the output moves by at most
//   2^-9 sum_k p_k |v_k| / l against the fp32 product (flash_attention.py
//   kernel_tolerance).
// * Overlap: a consumer warpgroup issues tile i's Q K^T, then tile i-1's
//   P V, waits for the scores only and runs tile i's softmax while the
//   tensor cores do P V; O is rescaled by alpha once P V is in.  The
//   consumer warpgroups of an SM run unsynchronised, so one's softmax also
//   overlaps the others' products.
// * Epilogue: O / max(l, 1e-30) rounded to bf16, stored from registers;
//   rows >= Sq are left out.
// fp32 (flash_fwd_f32): both products are FMA loops in fp32 on shared-memory
// tiles (no TF32), one warp per BQ / 4 query rows; it is the path of the
// fp32 logits check, not of bf16 serving.
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;           // K/V ring depth (bf16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, K;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
};

// KV tiles [lo, hi) live for the query tile [q0, q0 + bq): those the TPU
// kernel does not skip (some query of the tile may see some key of it).
__device__ __forceinline__ void live_tiles(const Params& p, int q0, int bq, int bk, int& lo,
                                           int& hi) {
  const int nk = (p.Skv + bk - 1) / bk;
  lo = 0;
  hi = nk;
  if (p.causal) hi = min(hi, (q0 + bq - 1) / bk + 1);        // k0 <= q_max
  if (p.window > 0) {                                          // k0 + bk - 1 > q0 - window
    const int t = q0 - p.window - bk + 1;
    lo = t < 0 ? 0 : t / bk + 1;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------- bf16 kernel

template <int D, int BQ, int BK, int BLOCKS> struct Bf16Tile {
  static constexpr int NWG = BQ / 64;            // consumer warpgroups
  // the producer: a warpgroup that gives its registers away (setmaxnreg)
  // beside two consumer warpgroups, a lone warp beside one
  static constexpr int THREADS = NWG * 128 + (NWG == 2 ? 128 : 32);
  static constexpr int NCH = D / 64;             // 64-column (128-byte) chunks
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // offsets from the 1024-byte aligned base: Q, K ring, V ring, barriers
  // (q_full, then k_full, v_full, k_empty, v_empty per stage)
  static constexpr uint32_t q = 0, k = Q_BYTES, v = k + STAGES * KV_BYTES,
                            bar = v + STAGES * KV_BYTES;
  static constexpr size_t bytes = bar + 8 * (1 + 4 * STAGES) + 1024;
  // S tiles are m64n64 (wgmma_ss): BK = 64
  static_assert(D % 64 == 0 && (BQ == 64 || BQ == 128) && BK == 64, "tile");
  // BLOCKS blocks an SM at once: 228 KB of shared memory an SM, 1 KB of it
  // reserved per block
  static_assert(bytes <= 232448 && BLOCKS * (bytes + 1024) <= 233472, "shared memory");
};

// Issue S = Q K^T for K ring stage s (unscaled, fp32) and commit it.
template <int D, int BQ, int BK>
__device__ __forceinline__ void scores(float (&sc)[BK / 2], uint64_t dq, uint64_t dk, int s) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, dq + ((c * BQ * 128 + kk * 32) >> 4),
               dk + ((s * BK * D * 2 + c * BK * 128 + kk * 32) >> 4), c | kk);
  wgmma_commit();
}

// Issue O += P V for V ring stage s and commit it.
template <int D, int BK>
__device__ __forceinline__ void accumulate_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                              uint64_t dv, int s) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, pa[kk], dv + ((s * BK * D * 2 + kk * 16 * 128) >> 4));
  wgmma_commit();
}

// One tile's online softmax on the score registers: NEG_INF where masked
// (tested only on edge tiles), the new row max m of the raw scores (2
// shuffles: a row lives in the 4 lanes of a quad), alpha = 2^((m_old - m) c)
// and p = 2^(s c - m c) in place of the scores, c = scale log2(e), one FFMA
// each, and this lane's share of l.  A row masked so far (m = NEG_INF) takes
// c = 0 there, so its p = 2^0 = 1, as exp(s - m) = exp(0) gives on the TPU.
template <int BK>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], const Params& p, int k0, int row0,
                                        int lane, bool edge, float c2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        bool ok = col < p.Skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) ok = ok && row - col < p.window;
        if (!ok) sc[4 * j + e] = NEG_INF;
      }
  }
  float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f}, cr[2], mc[2];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * c2);
    m[r] = mx[r];
    cr[r] = mx[r] == NEG_INF ? 0.f : c2;
    mc[r] = mx[r] * cr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], cr[e >> 1], -mc[e >> 1]));
      rs[e >> 1] += sc[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// P in bf16 as wgmma's A fragments: the k16 slice kk is n8 blocks 2kk, 2kk+1
// of the accumulator, register for register.
template <int BK>
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[BK / 16][4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int D, int BQ, int BK, int BLOCKS>
__global__ void __launch_bounds__(Bf16Tile<D, BQ, BK, BLOCKS>::THREADS, BLOCKS)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const Params p) {
  using T = Bf16Tile<D, BQ, BK, BLOCKS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms need 1024-byte alignment
  const uint32_t sq = base + T::q, sk = base + T::k, sv = base + T::v;
  const uint32_t q_full = base + T::bar;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return q_full + 8u * (1 + 3 * STAGES + s); };

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);
  const int h = blockIdx.x, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q0 = iq * BQ;
  int lo, hi;
  live_tiles(p, q0, BQ, BK, lo, hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), T::NWG);      // one arrival per consumer warpgroup
      mbar_init(v_empty(s), T::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::NWG) {
    // ---- producer: one thread keeps the K and V rings full
    if constexpr (T::NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c)
        tma_load(&tmq, sq + c * BQ * 128, q_full, 64 * c, h, q0, b);
      for (int ik = lo, i = 0; ik < hi; ++ik, ++i) {
        const int s = i % STAGES;
        const uint32_t ph = (i / STAGES) & 1;
        mbar_wait(k_empty(s), ph ^ 1);    // the first pass over the ring finds it free
        mbar_expect_tx(k_full(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(&tmk, sk + s * T::KV_BYTES + c * BK * 128, k_full(s), 64 * c, kh, ik * BK, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(&tmv, sv + s * T::KV_BYTES + c * BK * 128, v_full(s), 64 * c, kh, ik * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg + [0, 64).  Tile i's
    // S = Q K^T is issued before tile i-1's O += P V, so its softmax runs
    // while the tensor cores do P V.
    if constexpr (T::NWG == 2) setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;   // this lane's rows: row0, row0 + 8
    const int rmin = q0 + 64 * wg, rmax = rmin + 63;
    const float c2 = p.scale * LOG2E;
    // does tile ik need the per-element mask for this warpgroup's rows?
    auto edge = [&](int ik) {
      const int k0 = ik * BK;
      return k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > rmin) ||
             (p.window > 0 && k0 <= rmax - p.window);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this lane's share of the row sum

    // Q rows of this warpgroup: 64 rows x 128 bytes into each chunk
    const uint64_t dq = smem_desc(sq + wg * 64 * 128, 16, 1024);
    const uint64_t dk = smem_desc(sk, 16, 1024);
    const uint64_t dv = smem_desc(sv, BK * 128, 1024);
    mbar_wait(q_full, 0);

    const int n = hi - lo;
    if (n > 0) {
      float sc[BK / 2], alpha[2];
      uint32_t pa[BK / 16][4];
      mbar_wait(k_full(0), 0);
      wgmma_fence();
      scores<D, BQ, BK>(sc, dq, dk, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      if (t == 0) mbar_arrive(k_empty(0));
      softmax<BK>(sc, m, l, alpha, p, lo * BK, row0, lane, edge(lo), c2);
      to_bf16<BK>(pa, sc);                   // O is still 0: nothing to rescale

      for (int i = 1; i < n; ++i) {
        const int s = i % STAGES, ps = (i - 1) % STAGES;
        const uint32_t ph = (i / STAGES) & 1, pph = ((i - 1) / STAGES) & 1;
        mbar_wait(k_full(s), ph);
        wgmma_fence();
        scores<D, BQ, BK>(sc, dq, dk, s);
        mbar_wait(v_full(ps), pph);
        accumulate_pv<D, BK>(o, pa, dv, ps);
        wgmma_wait<1>();                     // the scores are in
        fence_regs(sc);
        if (t == 0) mbar_arrive(k_empty(s));
        softmax<BK>(sc, m, l, alpha, p, (lo + i) * BK, row0, lane, edge(lo + i), c2);
        wgmma_wait<0>();                     // so is P V of tile i - 1
        fence_regs(o);
        fence_regs(pa);
        if (t == 0) mbar_arrive(v_empty(ps));
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        to_bf16<BK>(pa, sc);
      }
      const int ls = (n - 1) % STAGES;
      mbar_wait(v_full(ls), ((n - 1) / STAGES) & 1);
      wgmma_fence();
      accumulate_pv<D, BK>(o, pa, dv, ls);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // epilogue: O / max(l, 1e-30) in bf16, rows < Sq only
    bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      const int row = row0 + 8 * r;
      if (row < p.Sq) {
        bf16* dst = og + (static_cast<long long>(b * p.Sq + row) * p.H + h) * D + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

// ------------------------------------------------------------- fp32 kernel

constexpr int F32_WARPS = 4;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int F32_BK = 64;          // keys per KV tile

__host__ __device__ constexpr size_t round_up(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory: Q (BQ x D), K (BK x D + 1 word per row, so lanes reading
// K[c][d] for c = lane hit distinct banks), V (BK x D), P (BQ x BK).
template <int D, int BQ> struct F32Tile {
  static constexpr int ROWS = BQ / F32_WARPS;    // query rows per warp
  static constexpr int LDK = D + 1;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round_up(sizeof(float) * BQ * D);
  static constexpr size_t v = k + round_up(sizeof(float) * F32_BK * LDK);
  static constexpr size_t pp = v + round_up(sizeof(float) * F32_BK * D);
  static constexpr size_t bytes = pp + round_up(sizeof(float) * BQ * F32_BK);
};

// Copy rows [row0, row0 + NROWS) of one head into shared memory with
// 16-byte loads; rows at or past `valid` are written as zeros (the ragged
// tail: zero keys are masked, zero values add nothing).
template <int D, int LD, int NROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long row_stride,
                                          int row0, int valid) {
  constexpr int VPR = D / 4;        // 16-byte vectors per row
  for (int i = threadIdx.x; i < NROWS * VPR; i += F32_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const int g = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < valid) val = *reinterpret_cast<const float4*>(src + (long long)g * row_stride + c);
    if constexpr (LD % 4 == 0) {
      *reinterpret_cast<float4*>(dst + r * LD + c) = val;
    } else {
      dst[r * LD + c] = val.x;
      dst[r * LD + c + 1] = val.y;
      dst[r * LD + c + 2] = val.z;
      dst[r * LD + c + 3] = val.w;
    }
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(F32_THREADS) flash_fwd_f32(const Params p) {
  using L = F32Tile<D, BQ>;
  constexpr int ROWS = L::ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* Ps = reinterpret_cast<float*>(smem + L::pp);

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.y);
  const int h = blockIdx.x, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int q0 = iq * BQ;
  const float* Qw = Qs + warp * ROWS * D;
  float* Pw = Ps + warp * ROWS * F32_BK;

  load_rows<D, D, BQ>(Qs, qg, p.q_ss, q0, p.Sq);

  float m[ROWS], l[ROWS], o[ROWS][D / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[r][j] = 0.f;
  }

  int lo, hi;
  live_tiles(p, q0, BQ, F32_BK, lo, hi);
  for (int ik = lo; ik < hi; ++ik) {
    const int k0 = ik * F32_BK;
    __syncthreads();                      // every warp is done with the last tile
    load_rows<D, L::LDK, F32_BK>(Ks, kg, p.k_ss, k0, p.Skv);
    load_rows<D, D, F32_BK>(Vs, vg, p.v_ss, k0, p.Skv);
    __syncthreads();

    // s[r][j] = Q[row r of this warp] . K[key lane + 32 j]   (unscaled)
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[lane * L::LDK + d];
      const float k1v = Ks[(lane + 32) * L::LDK + d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = Qw[r * D + d];
        s[r][0] = fmaf(qv, k0v, s[r][0]);
        s[r][1] = fmaf(qv, k1v, s[r][1]);
      }
    }

    float alpha[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + lane + 32 * j;
        bool ok = kpos < p.Skv;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && qpos - kpos < p.window;
        s[r][j] = ok ? s[r][j] * p.scale : NEG_INF;
      }
      float mx = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int x = 16; x > 0; x >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, x);
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
      Pw[r * F32_BK + lane] = p0;
      Pw[r * F32_BK + lane + 32] = p1;
    }
    __syncwarp();

    // o[r][j] = o[r][j] * alpha[r] + sum_k P[r][k] V[k][lane + 32 j]
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) o[r][j] *= alpha[r];
#pragma unroll 4
    for (int kk = 0; kk < F32_BK; ++kk) {
      float vv[D / 32];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) vv[j] = Vs[kk * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pr = Pw[r * F32_BK + kk];
#pragma unroll
        for (int j = 0; j < D / 32; ++j) o[r][j] = fmaf(pr, vv[j], o[r][j]);
      }
    }
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= p.Sq) break;
    const float lr = fmaxf(l[r], 1e-30f);
    float* row = og + ((long long)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) row[lane + 32 * j] = o[r][j] / lr;
  }
}

template <int D, int BQ, int BK, int BLOCKS>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tile<D, BQ, BK, BLOCKS>;
  static std::atomic<bool> ready[MAX_DEVICES];
  const cudaError_t attr = opt_in(flash_fwd_bf16<D, BQ, BK, BLOCKS>, T::bytes, ready);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, p.q, D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb, BQ);
  if (e == 0) e = encode(&tk, p.k, D, p.K, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb, BK);
  if (e == 0) e = encode(&tv, p.v, D, p.K, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb, BK);
  if (e != 0) return e;
  const dim3 grid(p.H, (p.Sq + BQ - 1) / BQ, p.B);
  flash_fwd_bf16<D, BQ, BK, BLOCKS><<<grid, T::THREADS, T::bytes, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = F32Tile<D, BQ>::bytes;
  static std::atomic<bool> ready[MAX_DEVICES];
  const cudaError_t attr = opt_in(flash_fwd_f32<D, BQ>, bytes, ready);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(p.H, (p.Sq + BQ - 1) / BQ, p.B);
  flash_fwd_f32<D, BQ><<<grid, F32_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  The tiles
// follow from (dtype, D), template <D, BQ, BK, blocks an SM> (mirrored by
// flash_attention.py tile_sizes).  Returns the cudaError_t of the launch (0
// on success), or a negative code of this file
// (flash_attention_error_string).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                        int B, int Sq, int Skv, int H, int K, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        int causal, int window, float scale, void* stream) {
  const Params p{q, k, v, o, B, Sq, Skv, H, K,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D == 64) return launch_bf16<64, 64, 64, 3>(p, st);
    if (D == 128) return launch_bf16<128, 64, 64, 2>(p, st);
    if (D == 256) return launch_bf16<256, 128, 64, 1>(p, st);
  } else if (dtype == 0) {
    if (D == 64) return launch_f32<64, 64>(p, st);
    if (D == 128) return launch_f32<128, 64>(p, st);
    if (D == 256) return launch_f32<256, 32>(p, st);
  }
  return ERR_UNSUPPORTED;
}

const char* flash_attention_error_string(int code) {
  if (code == ERR_UNSUPPORTED) return "unsupported dtype or head dim";
  if (code == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the q, k or v view";
  if (code == ERR_STRIDE) return "a bf16 q, k or v has stride 0 along a dimension of size > 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
