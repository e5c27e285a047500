// Mamba2's chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel and
// computes the same function, per (batch b, head h) over chunks of Q rows
// with the (P, N) state h carried in fp32:
//   cum_t  = sum_{r <= t} dt_r A            (within the chunk; in float64,
//                                            rounded once to float32)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s    (intra)
//          + exp(cum_t) C_t . h^T                                    (inter)
//   h'     = exp(cum_Q) h + dBx,  dBx = sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
// from x, B, C in bf16 or fp32.  The TPU kernel walks the chunks on a
// sequential grid dimension with h in VMEM scratch.  Unlike it, this one
// writes y in fp32 (the model adds D x and the gated norm before any
// rounding) and the final state, which the decode cache keeps.  Head h
// reads group h / (H / G) of B and C in place, and x, B and C are read
// through their strides (last dim contiguous): the model's slices of the
// conv output are not copied.  dt (B, S, H) and A (H,) are contiguous fp32.
//
// The prefix sums of dt A are one warp's shuffle scan in float64 (a
// 32-lane Hillis-Steele scan per 32 rows, then the carry), rounded once to
// float32; the plain version (ssd_scan.py chunk_cumsum) adds in the same
// order, so the two agree bit for bit and the exps of both see the same
// arguments.  Keep the two in step: kernel_tolerance relies on it.
//
// What bounds it on an H100 SXM (989 TFLOP/s on bf16 operands with fp32
// accumulation, 3.35 TB/s).  Per chunk: C B^T over the causal half
// (Q(Q+1)/2 N FMAs on bf16 operands: exact products), needed once a
// (b, group), since C_t . B_s depends on neither dt nor A; then, per
// (b, h), M x (Q(Q+1)/2 P), C h^T and the state update (2 Q P N), whose
// fp32 operand the bf16 path splits into two bf16 terms, so the tensor
// cores do them twice.  At the mamba2-1.3b prefill shape (S = 2048,
// H = 64, G = 1, P = 64, N = 128, Q = 256, bf16) that is 0.067 + 2 x 6.451
// GFLOP at 989 TFLOP/s, 0.0131 ms, against 54.0 MB of inputs and outputs
// at 3.35 TB/s, 0.0161 ms: the bytes bound it (chip_smoke.ssd_bound).
// This kernel does more than the bound counts: C B^T once a head (64 x
// 0.067 GFLOP at G = 1), and its own traffic: each chunk's dBx (fp32) and
// carried state (two bf16 planes), 33.6 MB at that shape, written once and
// read once or more, most of it in L2; and B, C and x are read once a
// 64-row query tile.
//
// bf16 design: three launches, so that the chunks of one (b, h) run in
// parallel and only the nC-step recurrence of the state is serial.  The two
// large ones have one consumer warpgroup and a lone producer warp that
// keeps TMA loads of 64-row tiles in flight (4-D views (D, heads, S, B)
// with the caller's strides, 64-column boxes in the 128-byte swizzle,
// zeros past S and past P or N; hopper.cuh) in two-stage rings with full
// and empty mbarriers.
// * ssd_scan_state_bf16, a block per (chunk, h, b): dBx += (x w)^T B over
//   the chunk's key tiles, wgmma m64nNk16 with (x w)^T (w_s = exp(cum_Q -
//   cum_s) dt_s) the register A operand and B's tile the MN-major B
//   operand; tile j + 1's x w is read while tile j's products run.  dBx,
//   exp(cum_Q) and the prefix sums and dt of the chunk (for the chunk pass)
//   go to the workspace.
// * ssd_scan_chain_bf16, 4 elements of a (b, h) state a thread: h_prev[0] =
//   0, h_prev[c + 1] = exp(cum_Q[c]) h_prev[c] + dBx[c] in fp32; writes
//   each h_prev[c], c >= 1, as its two bf16 terms, and the final state.
// * ssd_scan_chunk_bf16, a block per (64-row query tile, chunk, h, b),
//   heaviest tiles first, three blocks an SM: y = exp(cum_t) C_t h_prev^T
//   (both terms, wgmma with both operands from shared memory, the scale on
//   the fp32 accumulator; not for the first chunk, whose h_prev is 0),
//   then for each key tile of the causal prefix S = C B^T (wgmma, both
//   operands K-major), M = S exp(cum_t - cum_s) dt_s on the accumulator
//   registers (masked before exp: only s <= t < Q is exponentiated, since
//   exp(cum_t - cum_s) overflows above the diagonal) and y += M x with M's
//   two bf16 terms as the register A operand and x's tile MN-major.  Key
//   tile j's S is issued before tile j - 1's M x, and its weights computed
//   while the tensor cores do M x.  Rows of a tile past the chunk's end
//   (chunk 16 or 96) are masked in registers; TMA zero-fills only past S.
//   y is written once, from registers.
// * The split: v = hi + lo, hi = bf16(v), lo = bf16(v - hi) (the residual
//   is exact in fp32), so a product with an exact bf16 operand (x, B, C)
//   is off by at most 2^-16 |v| relative: M, the state update's x w, and
//   h_prev in C h^T.  Two terms pass kernel_tolerance at 0.03 (M) and 0.08
//   (the state) of the bound on the CPU model of the split
//   (tests/test_torch_ssd_scan.py); one term, M, x w or h in bf16, fails it
//   by 17x and 50x, TF32 by 2.4x and 5.9x.  So two terms: the fewest that
//   pass.
// What holds it back (0.1060-0.1063 ms of device time at that shape on an
// H100 80GB HBM3 at 700 W, 15.2% of the bound; the chunk pass 0.0732-0.0734
// ms of it; chip_smoke.py and probes/ssd_variants.py, PERF.md section 6):
// the chunk pass's exponentials and the masks, selects and split around
// them (~24 us), and L2 traffic that grows with the query tiles of a chunk
// (each reloads h_prev and its key tiles of B and x; ~15 us for h_prev's
// load and the inter term).
// fp32 inputs take ssd_scan_f32, the first design of this kernel: FMA
// loops on the CUDA cores, one block per (32 columns of P, head, batch)
// walking the chunks in series with h's rows in shared memory.  It is the
// path of the fp32 checks; bf16 is the served and timed path.
#include "hopper.cuh"

namespace {

constexpr int NMAX = 128;       // largest state size N
constexpr int PMAX_BF16 = 64;   // largest head dim P of the bf16 path (one wgmma tile)
constexpr int TQ = 64;          // rows of a query or key tile
constexpr int STAGES = 2;       // ring depth of the B and x tiles (bf16)
constexpr int BOX = TQ * 128;   // bytes of one 64-column box of a 64-row bf16 tile
// The dynamic shared memory a block may opt into (227 KB): the attribute is
// set once per kernel and device, to the most any chunk length may take.
constexpr size_t SMEM_OPT_IN = 232448;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  float* y;
  float* h;
  int B, S, H, P, G, N, chunk;
  long long x_sb, x_ss, x_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  // bf16 workspace (ssd_scan_workspace_bytes)
  float* decay;                 // (B, H, nC) exp(cum_Q) of each chunk
  float* cums;                  // (B, H, S) the within-chunk prefix sums of dt A
  float* dts;                   // (B, H, S) dt
  float* dbx;                   // (B, H, nC, P, N) each chunk's state update
  bf16* hsplit;                 // (B, H, nC, 2, P, N) h_prev of each chunk, two terms
};

// ------------------------------------------------------------------ fp32

constexpr int F32_PB = 32;      // columns of P (rows of h) per block
constexpr int F32_THREADS = 256;

// rows [row0, row0 + TQ) of a (rows, N) operand into dst[TQ][ld]; rows at
// or past `valid` are zeros
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long row_stride,
                                          int row0, int valid, int N, int ld) {
  for (int i = threadIdx.x; i < TQ * N; i += F32_THREADS) {
    const int r = i / N, n = i - r * N;
    dst[r * ld + n] = r < valid ? src[(long long)(row0 + r) * row_stride + n] : 0.f;
  }
}

// One block owns (32 columns of P, head h, batch b) and loops over the
// chunks, h's 32 rows in shared memory (the rows p of h are independent:
// y[:, p] reads only h[p, :] and x[:, p]).  A chunk is walked in 64-row
// query tiles against the 64-row key tiles of its causal prefix; the
// chunk's last query tile visits every key tile, so it accumulates h's
// update in registers there.  Shared-memory rows hold N + 1 floats so that
// lanes reading one column of 16 rows hit distinct banks.
__global__ void __launch_bounds__(F32_THREADS) ssd_scan_f32(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, Q = p.chunk, LDN = N + 1;
  constexpr int LDX = F32_PB + 1, LDM = TQ + 1;
  float* Cs = smem;                  // [TQ][LDN]  C rows of the query tile
  float* Bs = Cs + TQ * LDN;         // [TQ][LDN]  B rows of the key tile
  float* xs = Bs + TQ * LDN;         // [TQ][LDX]  x rows of the key tile
  float* Ms = xs + TQ * LDX;         // [TQ][LDM]  weights of a tile pair
  float* hs = Ms + TQ * LDM;         // [F32_PB][LDN]  the carried state
  float* cum = hs + F32_PB * LDN;    // [Q]
  float* dts = cum + Q;              // [Q]
  float* ws = dts + Q;               // [Q]  exp(cum_Q - cum_s) dt_s

  const int p0 = blockIdx.x * F32_PB, hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / (p.H / p.G);
  const int tid = threadIdx.x;
  const float A = p.A[hh];
  const float* xg = static_cast<const float*>(p.x) + b * p.x_sb + hh * p.x_sh + p0;
  const float* bg = static_cast<const float*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const float* cg = static_cast<const float*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dtg = p.dt + (long long)b * p.S * p.H + hh;
  const int pcols = min(F32_PB, p.P - p0);

  // tile roles: rows ty + 16a and columns tx + 16c of a 64-row tile (score
  // tile: 4 x 4 per thread, output tile: 4 x 2); state: p = sx + 8a,
  // n = sy + 32c (4 x 4 per thread)
  const int ty = tid / 16, tx = tid % 16;
  const int sx = tid % 8, sy = tid / 8;

  for (int i = tid; i < F32_PB * LDN; i += F32_THREADS) hs[i] = 0.f;

  const int nT = (Q + TQ - 1) / TQ, nC = p.S / Q;
  for (int ic = 0; ic < nC; ++ic) {
    const int s0 = ic * Q;
    __syncthreads();                 // the last chunk's readers are done
    for (int i = tid; i < Q; i += F32_THREADS) dts[i] = dtg[(long long)(s0 + i) * p.H];
    __syncthreads();
    if (tid < 32) {                  // prefix sums of dt A: one warp, float64
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + tid;
        double v = i < Q ? static_cast<double>(__fmul_rn(dts[i], A)) : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double up = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += up;
        }
        v += carry;
        if (i < Q) cum[i] = __double2float_rn(v);
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int i = tid; i < Q; i += F32_THREADS) ws[i] = expf(total - cum[i]) * dts[i];

    float dh[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dh[a][c] = 0.f;

    for (int it = 0; it < nT; ++it) {
      const int t0 = it * TQ;
      load_rows(Cs, cg, p.c_ss, s0 + t0, min(TQ, Q - t0), N, LDN);
      float acc[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int k0 = jt * TQ, kvalid = min(TQ, Q - k0);
        __syncthreads();             // readers of the last Bs, xs, Ms are done
        load_rows(Bs, bg, p.b_ss, s0 + k0, kvalid, N, LDN);
        for (int i = tid; i < TQ * F32_PB; i += F32_THREADS) {
          const int r = i / F32_PB, col = i % F32_PB;
          xs[r * LDX + col] = (r < kvalid && col < pcols)
                                  ? xg[(long long)(s0 + k0 + r) * p.x_ss + col]
                                  : 0.f;
        }
        __syncthreads();

        // scores C_t . B_s, then the weights of the causal prefix
        float sc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(cv[a], bv[c], sc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = t0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = k0 + tx + 16 * c;
            float m = 0.f;
            if (s <= t && t < Q) m = sc[a][c] * expf(cum[t] - cum[s]) * dts[s];
            Ms[(ty + 16 * a) * LDM + tx + 16 * c] = m;
          }
        }
        __syncthreads();

        // intra-chunk: y_t += sum_s M[t][s] x_s
#pragma unroll 4
        for (int s = 0; s < TQ; ++s) {
          const float x0 = xs[s * LDX + tx], x1 = xs[s * LDX + tx + 16];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float m = Ms[(ty + 16 * a) * LDM + s];
            acc[a][0] = fmaf(m, x0, acc[a][0]);
            acc[a][1] = fmaf(m, x1, acc[a][1]);
          }
        }

        // the chunk's last query tile visits every key tile once: the
        // state update's sum over s
        if (it == nT - 1) {
          for (int s = 0; s < kvalid; ++s) {
            const float w = ws[k0 + s];
            float xv[4], bv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) xv[a] = xs[s * LDX + sx + 8 * a] * w;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = sy + 32 * c;
              bv[c] = n < N ? Bs[s * LDN + n] : 0.f;
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int c = 0; c < 4; ++c) dh[a][c] = fmaf(xv[a], bv[c], dh[a][c]);
          }
        }
      }

      // inter-chunk: exp(cum_t) C_t . h^T, then y = intra + inter
      float inter[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) inter[a][0] = inter[a][1] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float h0 = hs[tx * LDN + n], h1 = hs[(tx + 16) * LDN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float cv = Cs[(ty + 16 * a) * LDN + n];
          inter[a][0] = fmaf(cv, h0, inter[a][0]);
          inter[a][1] = fmaf(cv, h1, inter[a][1]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int t = t0 + ty + 16 * a;
        if (t >= Q) continue;
        const float e = expf(cum[t]);
        float* row = p.y + (((long long)b * p.S + s0 + t) * p.H + hh) * p.P + p0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = tx + 16 * c;
          if (col < pcols) row[col] = acc[a][c] + e * inter[a][c];
        }
      }
      __syncthreads();               // readers of Cs and hs are done
    }

    // h' = exp(cum_Q) h + the chunk's update
    const float decay = expf(total);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = sy + 32 * c;
        if (n < N) {
          float* hv = hs + (sx + 8 * a) * LDN + n;
          *hv = decay * *hv + dh[a][c];
        }
      }
  }
  __syncthreads();
  for (int i = tid; i < pcols * N; i += F32_THREADS) {
    const int r = i / N, n = i - r * N;
    p.h[(((long long)b * p.H + hh) * p.P + p0 + r) * N + n] = hs[r * LDN + n];
  }
}

size_t f32_smem_bytes(int N, int chunk) {
  const size_t ldn = N + 1;
  return sizeof(float) * (2 * TQ * ldn + TQ * (F32_PB + 1) + TQ * (TQ + 1) + F32_PB * ldn +
                          3 * (size_t)chunk);
}

int launch_f32(const Params& p, cudaStream_t stream) {
  const size_t bytes = f32_smem_bytes(p.N, p.chunk);
  static std::atomic<bool> ready[MAX_DEVICES];
  const cudaError_t e = opt_in(ssd_scan_f32, SMEM_OPT_IN, ready);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.P + F32_PB - 1) / F32_PB, p.H, p.B);
  ssd_scan_f32<<<grid, F32_THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ bf16

constexpr int THREADS = 160;    // one consumer warpgroup and a producer warp

// the consumer warpgroup's own barrier (the producer warp does not join)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// dts[i] = dt[b, s0 + i, h] (dtg points at row s0, stride H) and cum[i] =
// the prefix sums of dt A over rows [0, n) of the chunk, in float64 in
// chunk_cumsum's order, rounded once; warp 0 of the consumers scans.
__device__ __forceinline__ void chunk_prefix(float* dts, float* cum, const float* dtg, int H,
                                             float A, int n, int t) {
  for (int i = t; i < n; i += 128) dts[i] = dtg[(long long)i * H];
  consumer_sync();
  if (t < 32) {
    double carry = 0.0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + t;
      double v = i < n ? static_cast<double>(__fmul_rn(dts[i], A)) : 0.0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double up = __shfl_up_sync(0xffffffffu, v, o);
        if (t >= o) v += up;
      }
      v += carry;
      if (i < n) cum[i] = __double2float_rn(v);
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  consumer_sync();
}

// (v0, v1) as two bf16 terms a register each: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// v[0..3] at elements i..i+3 of the hi and lo planes, as their two bf16
// terms (i a multiple of 4)
__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, long long i, const float* v) {
  uint32_t h01, l01, h23, l23;
  split_bf16(v[0], v[1], h01, l01);
  split_bf16(v[2], v[3], h23, l23);
  *reinterpret_cast<uint2*>(hi + i) = make_uint2(h01, h23);
  *reinterpret_cast<uint2*>(lo + i) = make_uint2(l01, l23);
}

// element (row r, column c) of a 64-row, 64-column bf16 tile that TMA
// wrote in the 128-byte swizzle (16-byte unit c / 8 of row r at c / 8 ^ r % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 64 + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// (v0, v1) at columns col, col + 1 of a row of `len` fp32 values; `pairs`
// says float2 stores are aligned (len even; an odd P can reach here when
// x's other dimensions have size 1)
__device__ __forceinline__ void store_pair(float* row, int col, int len, bool pairs, float v0,
                                           float v1) {
  if (pairs && col + 1 < len) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < len) row[col] = v0;
    if (col + 1 < len) row[col + 1] = v1;
  }
}

// A 64-row tile of B, C or h_prev is NCH = 1 (N <= 64) or 2 (N <= 128)
// 64-column boxes; the state update is wgmma m64n64k16 or m64n128k16.
// Pass 1 shared memory, from the 1024-byte aligned base: the B and x rings,
// full and empty barriers, then dts, cum, w (Q each).
template <int NCH> struct StateSmem {
  static constexpr uint32_t b = 0, x = STAGES * NCH * BOX,
                            bar = x + STAGES * BOX, f = bar + 16 * STAGES;
  static size_t bytes(int Q) { return f + 12 * (size_t)Q + 1024; }
};

template <int NCH>
__global__ void __launch_bounds__(THREADS, 2)
    ssd_scan_state_bf16(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmb, const Params p) {
  using L = StateSmem<NCH>;
  constexpr uint32_t TILE = NCH * BOX;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzle atoms need 1024-byte alignment
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t sb = base + L::b, sx = base + L::x;
  auto full = [&](int s) { return base + L::bar + 8u * s; };
  auto empty = [&](int s) { return base + L::bar + 8u * (STAGES + s); };

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (p.H / p.G);
  const int Q = p.chunk, s0 = c * Q, nT = (Q + TQ - 1) / TQ, nC = p.S / Q;
  float* dts = reinterpret_cast<float*>(gen + L::f);
  float* cum = dts + Q;
  float* ws = cum + Q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread keeps the B and x rings full
    if (threadIdx.x == 128) {
      for (int j = 0; j < nT; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);   // the first pass finds it free
        mbar_expect_tx(full(s), TILE + BOX);
        for (int k = 0; k < NCH; ++k)
          tma_load(&tmb, sb + s * TILE + k * BOX, full(s), 64 * k, g, s0 + TQ * j, b);
        tma_load(&tmx, sx + s * BOX, full(s), 0, h, s0 + TQ * j, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: dBx (P x N) of this chunk
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, q2 = 2 * (lane % 4);   // fragment rows r0, r0 + 8
  chunk_prefix(dts, cum, p.dt + ((long long)b * p.S + s0) * p.H + h, p.H, p.A[h], Q, t);
  const float total = cum[Q - 1];
  const long long row0 = ((long long)b * p.H + h) * p.S + s0;   // of the (B, H, S) planes
  for (int i = t; i < Q; i += 128) {
    ws[i] = expf(total - cum[i]) * dts[i];
    p.cums[row0 + i] = cum[i];                       // for the chunk pass
    p.dts[row0 + i] = dts[i];
  }
  consumer_sync();

  float acc[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) acc[i] = 0.f;
  const uint64_t db = smem_desc(sb, BOX, 1024);
  const bf16* xs = reinterpret_cast<const bf16*>(gen + L::x);
  // (x w)^T of tile j in fp32: fragment row p is column p of x's tile,
  // fragment column k its row; k16 slice kk, register r holds row
  // r0 + 8 (r & 1), columns 16 kk + q2 + 8 (r >> 1) + {0, 1}
  auto weighted = [&](float (&v)[4][4][2], int j) {
    const bf16* xt = xs + (j % STAGES) * (BOX / 2);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pr = r0 + 8 * (r & 1), k = 16 * kk + q2 + 8 * (r >> 1) + e;
          const int row = TQ * j + k;                // row of the chunk
          const float w = row < Q ? ws[min(row, Q - 1)] : 0.f;
          v[kk][r][e] = w * __bfloat162float(xt[swizzled(k, pr)]);
        }
  };
  // Tile j's wgmma (both terms) is issued before tile j + 1's x w is read,
  // so the tensor cores and the fragment loads overlap.
  float v[4][4][2];
  uint32_t ah[4][4], al[4][4];
  mbar_wait(full(0), 0);
  weighted(v, 0);
  for (int j = 0; j < nT; ++j) {
    const int s = j % STAGES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_bf16(v[kk][r][0], v[kk][r][1], ah[kk][r], al[kk][r]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ah[kk], db + ((s * TILE + kk * 16 * 128) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, al[kk], db + ((s * TILE + kk * 16 * 128) >> 4));
    wgmma_commit();
    if (j + 1 < nT) {
      mbar_wait(full((j + 1) % STAGES), ((j + 1) / STAGES) & 1);
      weighted(v, j + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ah);
    fence_regs(al);
    if (t == 0) mbar_arrive(empty(s));
  }

  // dBx (N is a multiple of 8: column pairs are aligned and whole) and the
  // chunk's decay to the workspace
  const long long PN = (long long)p.P * p.N, bh = (long long)b * p.H + h;
  float* dbx = p.dbx + (bh * nC + c) * PN;
#pragma unroll
  for (int jn = 0; jn < 8 * NCH; ++jn)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = r0 + 8 * half, n = 8 * jn + q2;
      if (pr < p.P && n < p.N)
        *reinterpret_cast<float2*>(dbx + pr * p.N + n) =
            make_float2(acc[4 * jn + 2 * half], acc[4 * jn + 2 * half + 1]);
    }
  if (t == 0) p.decay[bh * nC + c] = expf(total);
}

// The recurrence over the chunks, elementwise in fp32, 4 elements of
// (b, h)'s P x N state a thread (P N is a multiple of 8): h_prev[0] = 0,
// h_prev[c + 1] = exp(cum_Q[c]) h_prev[c] + dBx[c].  Writes h_prev[c],
// c >= 1, as its two bf16 terms and the final state.
__global__ void __launch_bounds__(128) ssd_scan_chain_bf16(const Params p) {
  const int nC = p.S / p.chunk;
  const long long PN = (long long)p.P * p.N, bh = (long long)blockIdx.z * p.H + blockIdx.y;
  const int PN4 = static_cast<int>(PN / 4), i4 = blockIdx.x * 128 + threadIdx.x;
  if (i4 >= PN4) return;
  const float4* __restrict__ dbh = reinterpret_cast<const float4*>(p.dbx + bh * nC * PN) + i4;
  const float* __restrict__ dec = p.decay + bh * nC;
  bf16* __restrict__ hs = p.hsplit + bh * nC * 2 * PN;
  float hv[4] = {0.f, 0.f, 0.f, 0.f};                // h_prev of chunk cc
  constexpr int BATCH = 8;                           // chunks whose loads are in flight at once
  for (int c0 = 0; c0 < nC; c0 += BATCH) {
    float4 d[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (c0 + k < nC) d[k] = __ldg(dbh + (long long)(c0 + k) * PN4);
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int cc = c0 + k;
      if (cc >= nC) break;
      const float dd[4] = {d[k].x, d[k].y, d[k].z, d[k].w}, decay = __ldg(dec + cc);
      float hp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hp[i] = hv[i];
        hv[i] = decay * hv[i] + dd[i];
      }
      if (cc > 0) store_split4(hs + 2 * cc * PN, hs + (2 * cc + 1) * PN, 4LL * i4, hp);
    }
  }
  reinterpret_cast<float4*>(p.h + bh * PN)[i4] = make_float4(hv[0], hv[1], hv[2], hv[3]);
}

// Pass 2 shared memory, from the 1024-byte aligned base: the C tile, the B
// ring (whose two stages first hold h_prev's two terms), the x ring, the
// C/h barrier, the h-consumed barrier, full and empty barriers, then dts and
// cum (Q each).  ~67 KB at N = 128: three blocks an SM.
template <int NCH> struct ChunkSmem {
  static constexpr uint32_t TILE = NCH * BOX;
  static constexpr uint32_t c = 0, b = TILE, x = b + STAGES * TILE, bar = x + STAGES * BOX,
                            f = bar + 8 * (2 + 2 * STAGES);
  static size_t bytes(int Q) { return f + 8 * (size_t)Q + 1024; }
};

// Issue S = C B^T (64 x 64, fp32) for B ring stage s and commit it.
template <int NCH>
__device__ __forceinline__ void cb_scores(float (&sc)[32], uint64_t dc, uint64_t db, int s) {
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sc, dc + ((k * BOX + kk * 32) >> 4),
               db + ((s * NCH * BOX + k * BOX + kk * 32) >> 4), k | kk);
  wgmma_commit();
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, 3)
    ssd_scan_chunk_bf16(const __grid_constant__ CUtensorMap tmx,
                        const __grid_constant__ CUtensorMap tmb,
                        const __grid_constant__ CUtensorMap tmc,
                        const __grid_constant__ CUtensorMap tmh, const Params p) {
  using L = ChunkSmem<NCH>;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t sc_ = base + L::c, sb = base + L::b, sx = base + L::x;
  const uint32_t c_full = base + L::bar, h_free = c_full + 8;
  auto full = [&](int s) { return c_full + 8u * (2 + s); };
  auto empty = [&](int s) { return c_full + 8u * (2 + STAGES + s); };

  const int nT = (p.chunk + TQ - 1) / TQ;
  const int c = blockIdx.x, h = blockIdx.y;
  const int it = nT - 1 - static_cast<int>(blockIdx.z) / p.B, b = blockIdx.z % p.B;
  const int g = h / (p.H / p.G);
  const int Q = p.chunk, s0 = c * Q, nC = p.S / Q;
  const int n = min(Q, TQ * (it + 1));               // rows of the chunk this tile reads
  float* dts = reinterpret_cast<float*>(gen + L::f);
  float* cum = dts + Q;

  if (threadIdx.x == 0) {
    mbar_init(c_full, 1);
    mbar_init(h_free, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: the C tile and h_prev once (h_prev's terms in the B
    // ring, until the consumers are done with them), B and x tiles 0..it
    if (threadIdx.x == 128) {
      mbar_expect_tx(c_full, c > 0 ? 3 * TILE : TILE);
      for (int k = 0; k < NCH; ++k)
        tma_load(&tmc, sc_ + k * BOX, c_full, 64 * k, g, s0 + TQ * it, b);
      if (c > 0) {
        for (int term = 0; term < 2; ++term)
          for (int k = 0; k < NCH; ++k)
            tma_load(&tmh, sb + term * TILE + k * BOX, c_full, 64 * k, 0, 0,
                     static_cast<int>(((long long)b * p.H + h) * nC + c) * 2 + term);
        mbar_wait(h_free, 0);
      }
      for (int j = 0; j <= it; ++j) {
        const int s = j % STAGES;
        mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), TILE + BOX);
        for (int k = 0; k < NCH; ++k)
          tma_load(&tmb, sb + s * TILE + k * BOX, full(s), 64 * k, g, s0 + TQ * j, b);
        tma_load(&tmx, sx + s * BOX, full(s), 0, h, s0 + TQ * j, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: y of query rows s0 + TQ it + [0, 64)
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int r0 = 16 * warp + lane / 4, q2 = 2 * (lane % 4);
  // the state pass's prefix sums and dt of rows [0, n) of the chunk
  const long long plane = ((long long)b * p.H + h) * p.S + s0;
  for (int i = t; i < n; i += 128) {
    cum[i] = p.cums[plane + i];
    dts[i] = p.dts[plane + i];
  }
  consumer_sync();

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t dc = smem_desc(sc_, 16, 1024);
  const uint64_t db = smem_desc(sb, 16, 1024), dx = smem_desc(sx, BOX, 1024);
  const bool inter = c > 0;                          // h_prev of the first chunk is 0

  // M = S exp(cum_t - cum_s) dt_s where s <= t < Q, else 0, in place of
  // key tile j's scores (row t = TQ it + r0 + 8 (r & 1) of the chunk,
  // column s = TQ j + 16 kk + q2 + 8 (r >> 1) + e: n8 blocks 2 kk and
  // 2 kk + 1 of the accumulator are the A fragment of k16 slice kk)
  const int row0 = TQ * it + r0;                     // this lane's rows: row0, row0 + 8
  const float ct[2] = {cum[min(row0, n - 1)], cum[min(row0 + 8, n - 1)]};
  auto weights = [&](float (&sc)[32], int j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {               // columns q2 + 8 (cb >> 1) + (cb & 1)
        const int col = TQ * j + 16 * kk + q2 + 8 * (cb >> 1) + (cb & 1);
        const int s_ = min(col, n - 1);
        const float cs = cum[s_], ds = dts[s_];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half, i = 8 * kk + 4 * (cb >> 1) + 2 * half + (cb & 1);
          const bool live = col <= row && row < Q;
          const float m = live ? sc[i] * expf(ct[half] - cs) * ds : 0.f;
          sc[i] = m;
        }
      }
  };
  auto split = [&](uint32_t (&mh)[4][4], uint32_t (&ml)[4][4], const float (&sc)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], mh[kk][r], ml[kk][r]);
  };
  // issue y += M x for x ring stage s, both terms of M, and commit
  auto mx = [&](const uint32_t (&mh)[4][4], const uint32_t (&ml)[4][4], int s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, mh[kk], dx + ((s * BOX + kk * 16 * 128) >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, ml[kk], dx + ((s * BOX + kk * 16 * 128) >> 4));
    wgmma_commit();
  };

  // inter-chunk: y = exp(cum_t) C_t h_prev^T, h_prev as its two terms (in
  // the B ring's stages)
  mbar_wait(c_full, 0);
  if (inter) {
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 2; ++term)
#pragma unroll
      for (int k = 0; k < NCH; ++k)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc, dc + ((k * BOX + kk * 32) >> 4),
                   db + ((term * TILE + k * BOX + kk * 32) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float e = expf(cum[min(TQ * it + r0 + 8 * half, n - 1)]);
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        acc[4 * jn + 2 * half] *= e;
        acc[4 * jn + 2 * half + 1] *= e;
      }
    }
  }
  if (c > 0 && t == 0) mbar_arrive(h_free);

  float sc[32];
  uint32_t mh[4][4], ml[4][4];
  mbar_wait(full(0), 0);
  wgmma_fence();
  cb_scores<NCH>(sc, dc, db, 0);
  wgmma_wait<0>();
  fence_regs(sc);
  weights(sc, 0);
  split(mh, ml, sc);

  // intra-chunk: key tile j's scores are issued before tile j - 1's M x,
  // and its weights computed while the tensor cores do M x
  for (int j = 1; j <= it; ++j) {
    const int s = j % STAGES, ps = (j - 1) % STAGES;
    mbar_wait(full(s), (j / STAGES) & 1);
    wgmma_fence();
    cb_scores<NCH>(sc, dc, db, s);
    mx(mh, ml, ps);
    wgmma_wait<1>();                                 // the scores are in
    fence_regs(sc);
    weights(sc, j);
    wgmma_wait<0>();                                 // so is M x of tile j - 1
    fence_regs(acc);
    fence_regs(mh);
    fence_regs(ml);
    if (t == 0) mbar_arrive(empty(ps));
    split(mh, ml, sc);
  }
  wgmma_fence();
  mx(mh, ml, it % STAGES);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(mh);
  fence_regs(ml);

  // y rows < Q of the chunk, columns < P, from registers
  const bool pairs = (p.P & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = TQ * it + r0 + 8 * half;
    if (row >= Q) continue;
    float* yrow = p.y + (((long long)b * p.S + s0 + row) * p.H + h) * p.P;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      store_pair(yrow, 8 * jn + q2, p.P, pairs, acc[4 * jn + 2 * half],
                 acc[4 * jn + 2 * half + 1]);
  }
}

// workspace layout of the bf16 path, each part 256-byte aligned
struct Workspace {
  size_t decay, cums, dts, dbx, hsplit, bytes;
  Workspace(int B, int S, int H, int P, int N, int chunk) {
    auto up = [](size_t v) { return (v + 255) / 256 * 256; };
    const size_t bh = (size_t)B * H, nC = chunk > 0 ? S / chunk : 0, pn = (size_t)P * N;
    decay = 0;
    cums = decay + up(4 * bh * nC);
    dts = cums + up(4 * bh * S);
    dbx = dts + up(4 * bh * S);
    hsplit = dbx + up(4 * bh * nC * pn);
    bytes = hsplit + up(2 * 2 * bh * nC * pn);
  }
};

template <int NCH>
int launch_bf16(Params p, void* work, cudaStream_t stream) {
  static std::atomic<bool> ready_state[MAX_DEVICES], ready_chunk[MAX_DEVICES];
  const int Q = p.chunk, nC = p.S / Q, nT = (Q + TQ - 1) / TQ;
  const size_t state_bytes = StateSmem<NCH>::bytes(Q), chunk_bytes = ChunkSmem<NCH>::bytes(Q);
  cudaError_t attr = opt_in(ssd_scan_state_bf16<NCH>, SMEM_OPT_IN, ready_state);
  if (attr == cudaSuccess) attr = opt_in(ssd_scan_chunk_bf16<NCH>, SMEM_OPT_IN, ready_chunk);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  const Workspace w(p.B, p.S, p.H, p.P, p.N, Q);
  unsigned char* ws = static_cast<unsigned char*>(work);
  p.decay = reinterpret_cast<float*>(ws + w.decay);
  p.cums = reinterpret_cast<float*>(ws + w.cums);
  p.dts = reinterpret_cast<float*>(ws + w.dts);
  p.dbx = reinterpret_cast<float*>(ws + w.dbx);
  p.hsplit = reinterpret_cast<bf16*>(ws + w.hsplit);

  CUtensorMap tx, tb, tc, th;
  int e = encode(&tx, p.x, p.P, p.H, p.S, p.B, p.x_sh, p.x_ss, p.x_sb, TQ);
  if (e == 0) e = encode(&tb, p.Bm, p.N, p.G, p.S, p.B, p.b_sg, p.b_ss, p.b_sb, TQ);
  if (e == 0) e = encode(&tc, p.Cm, p.N, p.G, p.S, p.B, p.c_sg, p.c_ss, p.c_sb, TQ);
  // h_prev's terms as (N, 1, P, B H nC 2) rows of P
  const long long pn = (long long)p.P * p.N;
  if (e == 0) e = encode(&th, p.hsplit, p.N, 1, p.P, 2 * nC * p.H * p.B, pn, p.N, pn, TQ);
  if (e != 0) return e;

  ssd_scan_state_bf16<NCH><<<dim3(nC, p.H, p.B), THREADS, state_bytes, stream>>>(tx, tb, p);
  cudaError_t r = cudaGetLastError();
  if (r != cudaSuccess) return static_cast<int>(r);
  const int pn4 = p.P * p.N / 4;
  ssd_scan_chain_bf16<<<dim3((pn4 + 127) / 128, p.H, p.B), 128, 0, stream>>>(p);
  r = cudaGetLastError();
  if (r != cudaSuccess) return static_cast<int>(r);
  ssd_scan_chunk_bf16<NCH>
      <<<dim3(nC, p.H, nT * p.B), THREADS, chunk_bytes, stream>>>(tx, tb, tc, th, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of device workspace the wrapper allocates for one call (0 for
// float32).
long long ssd_scan_workspace_bytes(int dtype, int B, int S, int H, int P, int N, int chunk) {
  if (dtype != 1) return 0;
  return static_cast<long long>(Workspace(B, S, H, P, N, chunk).bytes);
}

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16.  Strides are in
// elements; `work` holds ssd_scan_workspace_bytes.  Returns the
// cudaError_t of the launches (0 on success), or a negative code of
// hopper.cuh (ssd_scan_error_string) for an unsupported dtype or shape or
// a view TMA cannot take (the Python wrapper rejects those before calling).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 void* y, void* h, void* work, int dtype, int B, int S, int H, int P, int G,
                 int N, int chunk, long long x_sb, long long x_ss, long long x_sh, long long b_sb,
                 long long b_ss, long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                 void* stream) {
  if (N < 1 || N > NMAX || P < 1 || G < 1 || H % G || chunk < 1 || S % chunk)
    return ERR_UNSUPPORTED;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
                 static_cast<float*>(y), static_cast<float*>(h), B, S, H, P, G, N, chunk,
                 x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
                 nullptr, nullptr, nullptr, nullptr, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(p, st);
  if (dtype == 1 && P <= PMAX_BF16 && N % 8 == 0) return N <= 64 ? launch_bf16<1>(p, work, st)
                                                   : launch_bf16<2>(p, work, st);
  return ERR_UNSUPPORTED;
}

const char* ssd_scan_error_string(int code) {
  if (code == ERR_UNSUPPORTED) return "unsupported dtype or shape";
  if (code == ERR_NO_ENCODER) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == ERR_ENCODE) return "cuTensorMapEncodeTiled refused the x, B, C or state view";
  if (code == ERR_STRIDE) return "a bf16 x, B or C has stride 0 along a dimension of size > 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
