// Forward flash attention for Hopper (sm_90a), causal and/or sliding-window.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel and
// computes the same function: online-softmax attention with the running max
// m, denominator l and output accumulator kept in fp32, fully masked KV tiles
// skipped, padded (ragged-tail) KV rows zeroed and masked, masks written with
// the finite NEG_INF = -1e30 (with -inf a row whose first live tile is fully
// masked would give exp(-inf - -inf) = NaN), and l clamped at 1e-30.
//
// Design, against what differs from the TPU:
// * One thread block per (q-tile of 64 rows, query head h, batch b); a loop
//   over 64-key tiles inside the block takes the place of the TPU's
//   sequential k-block grid dimension.  Four warps; each warp owns 16 query
//   rows.  Blocks are launched latest-q-tile first, so the heaviest causal
//   tiles start first.
// * Layout: q, k, v are read as (B, S, heads, D) through their strides (the
//   head dim must be contiguous); no (B, H, S, D) copies are made.  The
//   output is a contiguous (B, Sq, H, D) tensor.
// * GQA: query head h reads KV head h / (H / K) directly; repeat_kv is never
//   materialised.  With K == H this is the TPU kernel's pre-repeated input.
// * bf16: Q K^T and P V run on the tensor cores through WMMA 16x16x16
//   fragments with fp32 accumulation; P is rounded to bf16 for the second
//   product (the TPU kernel multiplies p in fp32) while l sums the unrounded
//   p, so each output moves by at most 2^-9 sum_k p_k |v_k| / l against the
//   fp32 product (kernel_tolerance in flash_attention.py).  fp32: both products are
//   plain FMA loops in fp32, so no TF32 rounding enters.
// * Per row, lanes own columns lane and lane + 32 of the score tile and
//   columns lane + 32 j of the output; row max and row sum are warp
//   shuffles, so m, l and the fp32 output stay in registers.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s):
// causal FLOPs ~ 2 B H S^2 D (two products over the lower triangle), bytes ~
// 2 B S (2H + 2K) D for bf16 q, k, v read once and o written once.  At the
// granite-3-2b prefill shape (H=32, K=8, D=64) that is H S / (2H + 2K) =
// 0.4 S FLOP per byte, so the FLOPs bound it above S ~ 740 (the card's
// 295 FLOP/byte) and the bytes below.  This first version uses WMMA
// (mma.sync) and plain shared-memory tiles, not wgmma and TMA, and a
// per-row softmax across the warp, so it stays far from that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // keys per KV tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;    // query rows per warp (16)
constexpr float NEG_INF = -1e30f;

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

// Shared-memory leading dimensions (in elements) per type and head dim.
template <typename T, int D> struct Layout;

// bf16: rows padded by 8 elements (16 bytes) to spread banks; WMMA needs the
// leading dimension to be a multiple of 8 and 32-byte aligned tile pointers.
template <int D> struct Layout<bf16, D> {
  static constexpr int LDQ = D + 8, LDK = D + 8, LDV = D + 8, LDP = BK + 8;
  // fp32 scratch per warp: the score tile, then the P V tile
  static constexpr int LDS = (BK > D ? BK : D) + 4;
  static constexpr int SCRATCH = ROWS * LDS;   // floats per warp
};

// fp32: K rows padded by one word so that lanes reading K[c][d] for
// c = lane hit distinct banks.  Scores stay in registers: no scratch.
template <int D> struct Layout<float, D> {
  static constexpr int LDQ = D, LDK = D + 1, LDV = D, LDP = BK;
  static constexpr int SCRATCH = 0;
};

__host__ __device__ constexpr size_t round_up(size_t x) {
  return (x + 127) / 128 * 128;
}

template <typename T, int D> struct Smem {
  using L = Layout<T, D>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round_up(sizeof(T) * BQ * L::LDQ);
  static constexpr size_t v = k + round_up(sizeof(T) * BK * L::LDK);
  static constexpr size_t p = v + round_up(sizeof(T) * BK * L::LDV);
  static constexpr size_t s = p + round_up(sizeof(T) * BQ * L::LDP);
  static constexpr size_t bytes = s + round_up(sizeof(float) * WARPS * L::SCRATCH);
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + ROWS_T) of one head into shared memory with
// 16-byte loads; rows at or past `valid` are written as zeros (the ragged
// tail: zero keys are masked below, zero values add nothing).
template <typename T, int D, int LD, int ROWS_T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int row0, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;      // vectors per row
  for (int i = threadIdx.x; i < ROWS_T * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < valid) val = *reinterpret_cast<const uint4*>(src + (long long)g * row_stride + c);
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int t = 0; t < VEC; ++t) dst[r * LD + c + t] = e[t];
    }
  }
}

// s[r][j] = Q[row r of this warp] . K[column lane + 32 j]   (unscaled)
template <int D>
__device__ __forceinline__ void scores(float (&s)[ROWS][2], const float* Qw, const float* Ks,
                                       float*, int lane,
                                       const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                                            wmma::row_major>*) {
  using L = Layout<float, D>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float k0 = Ks[lane * L::LDK + d];
    const float k1 = Ks[(lane + 32) * L::LDK + d];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float qv = Qw[r * L::LDQ + d];
      s[r][0] = fmaf(qv, k0, s[r][0]);
      s[r][1] = fmaf(qv, k1, s[r][1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores(float (&s)[ROWS][2], const bf16*, const bf16* Ks,
                                       float* Sw, int lane,
                                       const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                                                            wmma::row_major>* qf) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // B(k = d, n = key) = Ks[key][d]: column-major with leading dim LDK
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, Ks + n * 16 * L::LDK + kk * 16, L::LDK);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(Sw + n * 16, acc, L::LDS, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    s[r][0] = Sw[r * L::LDS + lane];
    s[r][1] = Sw[r * L::LDS + lane + 32];
  }
  __syncwarp();
}

// o[r][j] = o[r][j] * alpha[r] + sum_k P[r][k] V[k][lane + 32 j]
template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[ROWS][D / 32], const float (&alpha)[ROWS],
                                              const float* Pw, const float* Vs, float*,
                                              int lane) {
  using L = Layout<float, D>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[r][j] *= alpha[r];
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float vv[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) vv[j] = Vs[kk * L::LDV + lane + 32 * j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float pr = Pw[r * L::LDP + kk];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) o[r][j] = fmaf(pr, vv[j], o[r][j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(float (&o)[ROWS][D / 32], const float (&alpha)[ROWS],
                                              const bf16* Pw, const bf16* Vs, float* Sw,
                                              int lane) {
  using L = Layout<bf16, D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, L::LDP);
      wmma::load_matrix_sync(vf, Vs + kk * 16 * L::LDV + n * 16, L::LDV);
      wmma::mma_sync(acc, pf, vf, acc);
    }
    wmma::store_matrix_sync(Sw + n * 16, acc, L::LDS, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      o[r][j] = o[r][j] * alpha[r] + Sw[r * L::LDS + lane + 32 * j];
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  using S = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  T* Vs = reinterpret_cast<T*>(smem + S::v);
  T* Ps = reinterpret_cast<T*>(smem + S::p);
  float* Ss = reinterpret_cast<float*>(smem + S::s);

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const int q0 = iq * BQ;
  const int q_max = q0 + BQ - 1;          // tile-level skip, as on the TPU

  T* Qw = Qs + warp * ROWS * L::LDQ;
  T* Pw = Ps + warp * ROWS * L::LDP;
  float* Sw = Ss + warp * L::SCRATCH;

  load_tile<T, D, L::LDQ, BQ>(Qs, qg, p.q_ss, q0, p.Sq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], reinterpret_cast<const bf16*>(Qw) + kk * 16, L::LDQ);
  }

  float m[ROWS], l[ROWS], o[ROWS][D / 32];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) o[r][j] = 0.f;
  }

  const int nk = (p.Skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    bool live = true;
    if (p.causal) live = live && k0 <= q_max;
    if (p.window > 0) live = live && k0 + BK - 1 > q0 - p.window;
    if (!live) continue;                  // uniform across the block

    __syncthreads();                      // every warp is done with the last tile
    load_tile<T, D, L::LDK, BK>(Ks, kg, p.k_ss, k0, p.Skv);
    load_tile<T, D, L::LDV, BK>(Vs, vg, p.v_ss, k0, p.Skv);
    __syncthreads();

    float s[ROWS][2];
    scores<D>(s, Qw, Ks, Sw, lane, qf);

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
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      Pw[r * L::LDP + lane] = from_float<T>(p0);
      Pw[r * L::LDP + lane + 32] = from_float<T>(p1);
    }
    __syncwarp();
    accumulate_pv<D>(o, alpha, Pw, Vs, Sw, lane);
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= p.Sq) break;
    const float lr = fmaxf(l[r], 1e-30f);
    T* row = og + ((long long)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) row[lane + 32 * j] = from_float<T>(o[r][j] / lr);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T, D>::bytes;
  // above 48 KB, dynamic shared memory must be opted into (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  Returns the
// cudaError_t of the launch (0 on success), or -1 for an unsupported
// dtype / head dim (the Python wrapper rejects those before calling).
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
  if (dtype == 1 && D == 64) return launch<bf16, 64>(p, st);
  if (dtype == 1 && D == 128) return launch<bf16, 128>(p, st);
  if (dtype == 0 && D == 64) return launch<float, 64>(p, st);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, st);
  return -1;
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "unsupported dtype or head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
