// Server aggregation (Guler & Yener eqs. 12-13) for Hopper (sm_90a):
//
//   out[m] = w[m] * (1 - sum_c s[c]) + sum_c s[c] * w_stack[c][m]
//
// with s[c] = server_lr * alpha_c * p_c * scale_c, over the client-stacked
// parameters w_stack (C, M) of one leaf and the global leaf w (M,).
//
// Replaces the TPU kernel repro/kernels/fused_agg.py::_agg_kernel and
// computes the same function: fp32 accumulation whatever the storage type,
// one read of w_stack and of w and one write of out, the delta tensor
// (C, M) never materialised (sum_c s_c (w_c - w) = s @ w_stack - (sum s) w).
//
// Design, against what differs from the TPU:
// * The TPU kernel streams (C, 16384) tiles through VMEM and zero-pads the
//   ragged tail in a copy.  Here a thread owns VEC contiguous outputs
//   (VEC = 4 where the wrapper has checked that every row is aligned for a
//   vector load: 16 bytes of fp32, 8 of bf16; VEC = 1 otherwise) and loops
//   over the C clients; threads past the end return, so nothing is padded
//   and nothing is copied.  Neighbouring threads read neighbouring
//   addresses in every row, so each warp's loads coalesce.
// * s is staged in shared memory once per block (C floats; C <= 12288 so it
//   stays under the 48 KB that needs no opt-in).
// * Order is fixed: every thread sums s and its products over c = 0..C-1
//   in ascending order, so the result does not depend on the launch shape.
// * One launch a tree (fused_agg_segments): a table of up to 64 leaves of
//   one dtype (w, w_stack and out pointers, M, the vector width, the
//   leaf's first block) rides in the kernel's parameters, and each block
//   finds its leaf there.  The CIFAR CNN's nine small leaves (a few MB
//   each) fill a fraction of the 132 SMs alone and are then bound by
//   latency; in one launch with fc1.w their blocks fill the card beside
//   its blocks.  A single leaf (fused_agg) is a one-row table, so a leaf
//   is computed bit for bit the same either way.
//
// What bounds it on an H100 SXM (3.35 TB/s): it is bytes, with 2 FLOPs per
// element read: (C + 2) * M * sizeof(T) bytes.  For the CIFAR CNN's fc1.w
// at C = 40, M = 1,572,864, fp32, that is 264.2 MB, 78.9 us at the card's
// rate; the whole CNN tree is 286.1 MB, 85.4 us.  The kernel relies on the
// loads in flight across the C loop and the warps of the SM to cover
// memory latency; it has no cp.async / TMA pipeline.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One leaf of a launch: its rows, its length, its vector width and the
// first block of the launch that works on it.
struct Segment {
  const void* w;
  const void* w_stack;
  void* out;
  long long M;
  long long first_block;
  int vec;
};

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_CLIENTS = 12288;   // 48 KB of s in shared memory

template <typename T, int VEC> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<bf16, 4> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    uint2 x;
    *reinterpret_cast<__nv_bfloat162*>(&x.x) = __floats2bfloat162_rn(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&x.y) = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <> struct Vec<bf16, 1> {
  static __device__ __forceinline__ void load(const bf16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// MAX_SEGMENTS rows keep the table, passed by value, under the 4 KB of
// kernel parameters.
constexpr int MAX_SEGMENTS = 64;
struct Table {
  int count;
  Segment seg[MAX_SEGMENTS];
};

template <typename T, int VEC>
__device__ __forceinline__ void agg_block(const Segment& sg,
                                          const float* s_sh, int C,
                                          long long blk) {
  const T* __restrict__ w = static_cast<const T*>(sg.w);
  const T* __restrict__ w_stack = static_cast<const T*>(sg.w_stack);
  T* __restrict__ out = static_cast<T*>(sg.out);
  const long long M = sg.M;
  const long long i = (blk * THREADS + threadIdx.x) * VEC;
  if (i >= M) return;                  // ragged tail: nothing past M is touched

  float ssum = 0.f;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const T* col = w_stack + i;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float sc = s_sh[c];
    float v[VEC];
    Vec<T, VEC>::load(col + (long long)c * M, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(sc, v[j], acc[j]);
    ssum += sc;
  }

  float wv[VEC];
  Vec<T, VEC>::load(w + i, wv);
  const float keep = 1.f - ssum;
#pragma unroll
  for (int j = 0; j < VEC; ++j) wv[j] = wv[j] * keep + acc[j];
  Vec<T, VEC>::store(out + i, wv);
}

// Every block finds its segment in the table (the same for all its
// threads, so the branch on the vector width does not diverge).
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_agg_kernel(const __grid_constant__ Table tab,
                 const float* __restrict__ s, int C) {
  extern __shared__ float s_sh[];
  for (int c = threadIdx.x; c < C; c += THREADS) s_sh[c] = s[c];
  __syncthreads();

  int g = 0;
  while (g + 1 < tab.count && blockIdx.x >= tab.seg[g + 1].first_block) ++g;
  const Segment& sg = tab.seg[g];
  const long long blk = blockIdx.x - sg.first_block;
  if (sg.vec == 4) agg_block<T, 4>(sg, s_sh, C, blk);
  else agg_block<T, 1>(sg, s_sh, C, blk);
}

long long blocks_of(const Segment& sg) {
  const long long per_block = (long long)THREADS * sg.vec;
  return (sg.M + per_block - 1) / per_block;
}

// -2 for a bad client count or an empty leaf, -1 for a bad vector width,
// -3 for a table whose block offsets do not follow from its leaves.
int check(const Table& tab, int C) {
  if (C < 1 || C > MAX_CLIENTS || tab.count < 1 || tab.count > MAX_SEGMENTS)
    return -2;
  long long next = 0;
  for (int g = 0; g < tab.count; ++g) {
    const Segment& sg = tab.seg[g];
    if (sg.M < 1) return -2;
    if (!(sg.vec == 1 || (sg.vec == 4 && sg.M % 4 == 0))) return -1;
    if (sg.first_block != next) return -3;
    next += blocks_of(sg);
  }
  return 0;
}

int launch(const Table& tab, const float* s, int dtype, int C,
           cudaStream_t stream) {
  const int bad = check(tab, C);
  if (bad) return bad;
  const Segment& end = tab.seg[tab.count - 1];
  const long long blocks = end.first_block + blocks_of(end);
  const size_t smem = C * sizeof(float);
  if (dtype == 0)
    fused_agg_kernel<float><<<(unsigned)blocks, THREADS, smem, stream>>>(
        tab, s, C);
  else if (dtype == 1)
    fused_agg_kernel<bf16><<<(unsigned)blocks, THREADS, smem, stream>>>(
        tab, s, C);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One leaf.  dtype: 0 = float32, 1 = bfloat16; vec: 4 (rows aligned for
// vector loads, M % 4 == 0) or 1.  Returns the cudaError_t of the launch
// (0 on success), -1 for an unsupported dtype / vec, -2 for C outside
// [1, 12288] or M < 1 (the Python wrapper rejects those before calling).
int fused_agg(const void* w, const void* w_stack, const void* s, void* out,
              int dtype, int C, long long M, int vec, void* stream) {
  Table tab;
  tab.count = 1;
  tab.seg[0] = Segment{w, w_stack, out, M, 0, vec};
  return launch(tab, static_cast<const float*>(s), dtype, C,
                static_cast<cudaStream_t>(stream));
}

// Several leaves of one dtype in one launch: `segments` holds `count`
// (at most 64) rows, each leaf's first_block the sum of the blocks of the
// rows before it (ceil(M / (256 vec)) a row).  Each element is computed
// exactly as by fused_agg on its leaf alone.  Returns as fused_agg, or -3
// for block offsets that do not follow from the rows.
int fused_agg_segments(const Segment* segments, int count, const void* s,
                       int dtype, int C, void* stream) {
  if (count < 1 || count > MAX_SEGMENTS) return -2;
  Table tab;
  tab.count = count;
  for (int g = 0; g < count; ++g) tab.seg[g] = segments[g];
  return launch(tab, static_cast<const float*>(s), dtype, C,
                static_cast<cudaStream_t>(stream));
}

const char* fused_agg_error_string(int code) {
  if (code == -1) return "unsupported dtype or vector width";
  if (code == -2) return "client count outside [1, 12288], empty leaf or "
                         "segment count outside [1, 64]";
  if (code == -3) return "segment block offsets do not follow from the rows";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
