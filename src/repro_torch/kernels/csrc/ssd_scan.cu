// Mamba2's chunked SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel and
// computes the same function, per (batch b, head h), sequentially over
// chunks of Q rows with the (P, N) state h carried in fp32:
//   cum_t  = sum_{r <= t} dt_r A            (within the chunk; in float64,
//                                            rounded once to float32)
//   y_t    = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s    (intra)
//          + exp(cum_t) C_t . h^T                                    (inter)
//   h'     = exp(cum_Q) h + sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
// all in fp32 from x, B, C in bf16 or fp32.  Unlike the TPU kernel it
// writes y in fp32 (the model adds D x and the gated norm before any
// rounding) and writes the final state, which the decode cache keeps.
//
// Design, against what differs from the TPU:
// * The TPU walks chunks on a sequential grid dimension with h in VMEM
//   scratch.  Here one block owns (32 columns of P, head h, batch b) and
//   loops over the chunks itself, h's 32 rows in shared memory.  The rows p
//   of h are independent (y[:, p] reads only h[p, :] and x[:, p]), so P = 64
//   splits over two blocks, each recomputing the shared C B^T tiles: at B=1
//   and 64 heads that is 128 blocks for 132 SMs instead of 64.
// * A chunk of 256 rows does not fit: a whole fp32 Q x Q score tile is
//   256 KB, one chunk's B and C 256 KB.  The chunk is walked in 64-row
//   query tiles against the 64-row key tiles of its causal prefix, as flash
//   attention walks KV tiles; the score tile is 64 x 64 fp32 (16 KB).
//   Only tiles with s <= t are computed, and exp() only where s <= t: the
//   reference exponentiates the whole tile and masks after, which can
//   overflow above the diagonal.
// * The state update reads every key tile of the chunk once; the chunk's
//   last query tile visits them all, so it accumulates h's update in
//   registers there and applies it after the chunk's last inter term.
// * GQA-style groups: head h reads group h / (H / G) of B and C in place;
//   nothing is repeated to heads.  x, B and C are read through their
//   strides (last dim contiguous), so the model's slices of the conv output
//   are not copied.  dt (B, S, H) and A (H,) are contiguous fp32.
// * Arithmetic is plain fp32 FMA on the CUDA cores.  The prefix sums of
//   dt A are one warp's shuffle scan in float64, rounded once to float32;
//   the plain version (ssd_scan.py chunk_cumsum) adds in the same order, so
//   the two agree bit for bit and the exps of both see the same arguments.
//   Keep the two in step: the tolerance of the kernel check relies on it.
//   The shared-memory rows hold N + 1 floats so that lanes reading one
//   column of 16 rows hit distinct banks.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s for bf16 operands
// with fp32 accumulation, 67 TFLOP/s fp32): per (b, h) and chunk, C B^T
// over the causal half (Q(Q+1)/2 N FMAs, bf16 operands when x, B and C are
// bf16: their products are exact in fp32), M x (Q(Q+1)/2 P), C h^T and the
// state update (2 Q P N), fp32 operands.  At the mamba2-1.3b prefill shape
// (S = 2048, H = 64, P = 64, N = 128, Q = 256, bf16) that is ~4.3 GFLOP at
// the bf16 rate and ~6.5 at the fp32 rate against ~54 MB of bf16 inputs
// and fp32 outputs: the operations bound it (~0.10 ms).  This first version
// runs every product as FMA loops from shared memory, not on the tensor
// cores (wgmma), and loads tiles without TMA, so it stays far from that.
// M x and the state update stay fp32: rounding M or x dt exp(.) to TF32 or
// bf16 (tensor cores without a split) fails the kernel check.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;          // rows of a query or key tile
constexpr int PB = 32;          // columns of P (rows of h) per block
constexpr int NMAX = 128;       // largest state size N
constexpr int THREADS = 256;

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
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// rows [row0, row0 + TQ) of a (rows, N) operand into dst[TQ][ld] as fp32;
// rows at or past `valid` are zeros
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long row_stride,
                                          int row0, int valid, int N, int ld) {
  for (int i = threadIdx.x; i < TQ * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    dst[r * ld + n] = r < valid ? to_float(src[(long long)(row0 + r) * row_stride + n]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, Q = p.chunk, LDN = N + 1;
  constexpr int LDX = PB + 1, LDM = TQ + 1;
  float* Cs = smem;                  // [TQ][LDN]  C rows of the query tile
  float* Bs = Cs + TQ * LDN;         // [TQ][LDN]  B rows of the key tile
  float* xs = Bs + TQ * LDN;         // [TQ][LDX]  x rows of the key tile
  float* Ms = xs + TQ * LDX;         // [TQ][LDM]  weights of a tile pair
  float* hs = Ms + TQ * LDM;         // [PB][LDN]  the carried state
  float* cum = hs + PB * LDN;        // [Q]
  float* dts = cum + Q;              // [Q]
  float* ws = dts + Q;               // [Q]  exp(cum_Q - cum_s) dt_s

  const int p0 = blockIdx.x * PB, hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / (p.H / p.G);
  const int tid = threadIdx.x;
  const float A = p.A[hh];
  const T* xg = static_cast<const T*>(p.x) + b * p.x_sb + hh * p.x_sh + p0;
  const T* bg = static_cast<const T*>(p.Bm) + b * p.b_sb + g * p.b_sg;
  const T* cg = static_cast<const T*>(p.Cm) + b * p.c_sb + g * p.c_sg;
  const float* dtg = p.dt + (long long)b * p.S * p.H + hh;
  const int pcols = min(PB, p.P - p0);

  // tile roles: rows ty + 16a and columns tx + 16c of a 64-row tile (score
  // tile: 4 x 4 per thread, output tile: 4 x 2); state: p = sx + 8a,
  // n = sy + 32c (4 x 4 per thread)
  const int ty = tid / 16, tx = tid % 16;
  const int sx = tid % 8, sy = tid / 8;

  for (int i = tid; i < PB * LDN; i += THREADS) hs[i] = 0.f;

  const int nT = (Q + TQ - 1) / TQ, nC = p.S / Q;
  for (int ic = 0; ic < nC; ++ic) {
    const int s0 = ic * Q;
    __syncthreads();                 // the last chunk's readers are done
    for (int i = tid; i < Q; i += THREADS) dts[i] = dtg[(long long)(s0 + i) * p.H];
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
    for (int i = tid; i < Q; i += THREADS) ws[i] = expf(total - cum[i]) * dts[i];

    float dh[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dh[a][c] = 0.f;

    for (int it = 0; it < nT; ++it) {
      const int t0 = it * TQ;
      load_rows<T>(Cs, cg, p.c_ss, s0 + t0, min(TQ, Q - t0), N, LDN);
      float acc[4][2];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][0] = acc[a][1] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int k0 = jt * TQ, kvalid = min(TQ, Q - k0);
        __syncthreads();             // readers of the last Bs, xs, Ms are done
        load_rows<T>(Bs, bg, p.b_ss, s0 + k0, kvalid, N, LDN);
        for (int i = tid; i < TQ * PB; i += THREADS) {
          const int r = i / PB, col = i % PB;
          xs[r * LDX + col] = (r < kvalid && col < pcols)
                                  ? to_float(xg[(long long)(s0 + k0 + r) * p.x_ss + col])
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
  for (int i = tid; i < pcols * N; i += THREADS) {
    const int r = i / N, n = i - r * N;
    p.h[(((long long)b * p.H + hh) * p.P + p0 + r) * N + n] = hs[r * LDN + n];
  }
}

size_t smem_bytes(int N, int chunk) {
  const size_t ldn = N + 1;
  return sizeof(float) * (2 * TQ * ldn + TQ * (PB + 1) + TQ * (TQ + 1) + PB * ldn +
                          3 * (size_t)chunk);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.N, p.chunk);
  // above 48 KB, dynamic shared memory must be opted into (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.P + PB - 1) / PB, p.H, p.B);
  ssd_scan_kernel<T><<<grid, THREADS, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm): 0 = float32, 1 = bfloat16.  Strides are in
// elements.  Returns the cudaError_t of the launch (0 on success), or -1
// for an unsupported dtype or shape (the Python wrapper rejects those
// before calling).
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 void* y, void* h, int dtype, int B, int S, int H, int P, int G, int N,
                 int chunk, long long x_sb, long long x_ss, long long x_sh, long long b_sb,
                 long long b_ss, long long b_sg, long long c_sb, long long c_ss, long long c_sg,
                 void* stream) {
  if (N < 1 || N > NMAX || P < 1 || G < 1 || H % G || chunk < 1 || S % chunk) return -1;
  const Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm,
                 static_cast<float*>(y), static_cast<float*>(h), B, S, H, P, G, N, chunk,
                 x_sb, x_ss, x_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, st);
  if (dtype == 1) return launch<bf16>(p, st);
  return -1;
}

const char* ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
