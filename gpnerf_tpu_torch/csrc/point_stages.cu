// Point-stage megakernel of the progressive renderer, for Hopper (sm_90a).
//
// Replaces the TPU kernel gpnerf_tpu/ops/pallas_point.py::_point_kernel
// (called through fused_point_stages_tabs) in the form the shipped "fast"
// render mode runs: one merged int8 [rgb|feat] quad table (T=1, C=35
// channels, 4 bilinear taps per row, V=3 source views) and two in-kernel
// geometry tables (the u8 level-1 octet table, 8 corners x 32 channels, and
// the int8 folded-coarse nearest table, 1 row x 64 channels), occ_geom off,
// no (P, F) feature input.
//
// Per point p it computes what the TPU kernel computes:
//   rgbfeat[v][c] = (sum_k rows[v*P+p][k*C+c] * w4[v][k][p]) * pscale[c]
//   mean/var over the V views
//   f = [lerp8(level-1 row) * gs0 | lerp1(coarse row) * gs1]      (96)
//   sigma_feat = ELU(W_sf f + b)            (W_sf = [W[:32] | I_64])
//   density MLP 134 -> 64 -> 32 -> 16 -> 1 (ELU, ELU, ELU, ReLU) on
//     [sigma_feat, mean, var]; sigma = 0 where sum(vmask) < 1 or !sig_ok;
//     alpha = 1 - exp(-sigma)
//   color: per view base_fc 105 -> 64 -> 32 (ELU) on [mean, var, rgbfeat[v]],
//     vis_fc residual on h/V (32 -> 32 -> 32, ELU), rgb_fc 96 -> 32 -> 16
//     -> 3 (ELU, ELU, sigmoid); rgb = 0 unless alpha > 1e-14 and sig_ok.
// Every dot input (weight and activation) is rounded to bf16 and the dot
// accumulates in f32, as on the TPU; ELU is x > 0 ? x : exp(min(x, 0)) - 1.
// Taps, mean and variance are summed with explicit roundings (no FMA
// contraction) in the order the plain version uses.
//
// Bound at the main-path shape (P = 13 * 24576 = 319,488 points): 856 bytes
// of input and output per point (420 quad-row bytes, 48 tap weights, 256 +
// 64 geometry-row bytes, 36 geometry weights, 12 view-mask bytes, 1 cull
// byte, 16 output bytes) -> ~0.27 GB per frame, 82 us at 3.35 TB/s; about
// 1.1e5 flop per point -> 35 GFLOP per frame, 35 us at the 989 TFLOP/s bf16
// tensor-core rate. So it is memory-bound once the MLPs run on tensor
// cores. This first version runs them as f32 FMA loops on the CUDA cores,
// where the 53K multiply-adds per point make it FMA-bound instead.
//
// Design: one thread per point, 256 points per block. All 12 weight
// matrices (bf16-rounded values stored as f32, 4 outputs interleaved per
// input so one 16-byte shared-memory broadcast feeds 4 independent FMA
// chains) and the biases and dequant scales are staged once per block in
// dynamic shared memory (~130 KB). Each layer copies its input into
// registers (statically indexed, fully unrolled) and walks its outputs four
// at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 3;
constexpr int C = 35;    // merged [rgb | feat] channels
constexpr int T = 4;     // bilinear taps per quad row
constexpr int C0 = 32;   // level-1 octet channels (u8), 8 corners
constexpr int C1 = 64;   // folded-coarse nearest channels (i8), 1 row
constexpr int NL = 12;   // MLP layers
constexpr int BLOCK = 256;

// layer order: sigma-feat, density d0..d3, base b0 b1, vis v0 v1, rgb r0..r2
constexpr int CIN[NL] = {C0 + C1, 64 + 2 * C, 64, 32, 16, 3 * C, 64, 32, 32, V * 32, 32, 16};
constexpr int COUT[NL] = {64, 64, 32, 16, 1, 64, 32, 32, 32, 32, 16, 3};

__host__ __device__ constexpr int wsize(int l) { return ((COUT[l] + 3) / 4) * 4 * CIN[l]; }
__host__ __device__ constexpr int woff(int l) { return l == 0 ? 0 : woff(l - 1) + wsize(l - 1); }
__host__ __device__ constexpr int boff(int l) { return l == 0 ? woff(NL) : boff(l - 1) + COUT[l - 1]; }
constexpr int WBUF = boff(NL);               // floats in the packed weight buffer
constexpr int SOFF = WBUF;                   // pscale (C), gs0 (C0), gs1 (C1)
constexpr int SMEM_FLOATS = WBUF + C + C0 + C1;

enum Act { ELU = 0, RELU = 1, SIGMOID = 2 };

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == ELU) return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
  if (ACT == RELU) return fmaxf(x, 0.f);
  return 1.f / (1.f + expf(-x));
}

// y[o] = act(sum_i W[o][i] * bf16(x[i]) + b[o]); W in shared memory as
// [COUT/4][CIN][4] (bf16-rounded), b as [COUT].
template <int L, int ACT>
__device__ __forceinline__ void dense(const float* __restrict__ sm,
                                      const float* x, float* y) {
  constexpr int ci = CIN[L];
  constexpr int co = COUT[L];
  float xr[ci];
#pragma unroll
  for (int i = 0; i < ci; ++i) xr[i] = bf16r(x[i]);
  constexpr int wo = woff(L);
  constexpr int bo = boff(L);
  const float4* w = reinterpret_cast<const float4*>(sm + wo);
  const float* b = sm + bo;
#pragma unroll 1
  for (int og = 0; og < (co + 3) / 4; ++og) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    const float4* wg = w + og * ci;
#pragma unroll
    for (int i = 0; i < ci; ++i) {
      const float4 ww = wg[i];
      a0 = fmaf(ww.x, xr[i], a0);
      a1 = fmaf(ww.y, xr[i], a1);
      a2 = fmaf(ww.z, xr[i], a2);
      a3 = fmaf(ww.w, xr[i], a3);
    }
    const int o = og * 4;
    y[o] = act<ACT>(a0 + b[o]);
    if (o + 1 < co) y[o + 1] = act<ACT>(a1 + b[o + 1]);
    if (o + 2 < co) y[o + 2] = act<ACT>(a2 + b[o + 2]);
    if (o + 3 < co) y[o + 3] = act<ACT>(a3 + b[o + 3]);
  }
}

__device__ __forceinline__ float sbyte(uint32_t word, int s) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * s)) & 0xffu));
}
__device__ __forceinline__ float ubyte(uint32_t word, int s) {
  return static_cast<float>((word >> (8 * s)) & 0xffu);
}

__global__ void __launch_bounds__(BLOCK)
point_stages_kernel(const int8_t* __restrict__ rows, const float* __restrict__ w4,
                    const float* __restrict__ pscale,
                    const uint8_t* __restrict__ g0_rows, const float* __restrict__ g0_w,
                    const float* __restrict__ g0_scale,
                    const int8_t* __restrict__ g1_rows, const float* __restrict__ g1_w,
                    const float* __restrict__ g1_scale,
                    const float* __restrict__ vmask, const uint8_t* __restrict__ sig_ok,
                    const float* __restrict__ wbuf, float* __restrict__ alpha_out,
                    float* __restrict__ rgb_out, int P) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < WBUF; i += BLOCK) sm[i] = wbuf[i];
  for (int i = threadIdx.x; i < C; i += BLOCK) sm[SOFF + i] = pscale[i];
  for (int i = threadIdx.x; i < C0; i += BLOCK) sm[SOFF + C + i] = g0_scale[i];
  for (int i = threadIdx.x; i < C1; i += BLOCK) sm[SOFF + C + C0 + i] = g1_scale[i];
  __syncthreads();
  const int p = blockIdx.x * BLOCK + threadIdx.x;
  if (p >= P) return;
  const float* ps = sm + SOFF;
  const float* gs0 = ps + C;
  const float* gs1 = gs0 + C0;

  // ---- projection quad lerp + dequant, per view ----
  float rf[V * C];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(
        rows + (static_cast<size_t>(v) * P + p) * (T * C));
    uint32_t wd[T * C / 4];
#pragma unroll
    for (int j = 0; j < T * C / 4; ++j) wd[j] = __ldg(row + j);
    float tw[T];
#pragma unroll
    for (int k = 0; k < T; ++k) tw[k] = __ldg(w4 + (static_cast<size_t>(v) * T + k) * P + p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float acc = __fmul_rn(sbyte(wd[c >> 2], c & 3), tw[0]);
#pragma unroll
      for (int k = 1; k < T; ++k) {
        const int b = k * C + c;
        acc = __fadd_rn(acc, __fmul_rn(sbyte(wd[b >> 2], b & 3), tw[k]));
      }
      rf[v * C + c] = __fmul_rn(acc, ps[c]);
    }
  }

  // ---- mean / variance over the views; density input [sf | mean | var] ----
  float xd[64 + 2 * C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float s = rf[c];
#pragma unroll
    for (int v = 1; v < V; ++v) s = __fadd_rn(s, rf[v * C + c]);
    const float m = s / static_cast<float>(V);
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = __fadd_rn(rf[v * C + c], -m);
      q = __fadd_rn(q, __fmul_rn(d, d));
    }
    xd[64 + c] = m;
    xd[64 + C + c] = q / static_cast<float>(V);
  }

  // ---- geometry: level-1 octet trilerp + coarse nearest, dequantized ----
  float f[C0 + C1];
  {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(g0_rows + static_cast<size_t>(p) * 8 * C0);
    float gw[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) gw[k] = __ldg(g0_w + static_cast<size_t>(k) * P + p);
#pragma unroll
    for (int c4 = 0; c4 < C0 / 4; ++c4) {
      uint32_t wd[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) wd[k] = __ldg(row + k * (C0 / 4) + c4);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float acc = __fmul_rn(ubyte(wd[0], s), gw[0]);
#pragma unroll
        for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(ubyte(wd[k], s), gw[k]));
        f[c4 * 4 + s] = __fmul_rn(acc, gs0[c4 * 4 + s]);
      }
    }
    const uint32_t* row1 = reinterpret_cast<const uint32_t*>(g1_rows + static_cast<size_t>(p) * C1);
    const float w1 = __ldg(g1_w + p);
#pragma unroll
    for (int c4 = 0; c4 < C1 / 4; ++c4) {
      const uint32_t wd = __ldg(row1 + c4);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        f[C0 + c4 * 4 + s] = __fmul_rn(__fmul_rn(sbyte(wd, s), w1), gs1[c4 * 4 + s]);
    }
  }

  // ---- sigma-feat linear + density MLP ----
  dense<0, ELU>(sm, f, xd);  // sigma_feat -> xd[0:64]
  float h1[64], h2[32], h3[16], sg[1];
  dense<1, ELU>(sm, xd, h1);
  dense<2, ELU>(sm, h1, h2);
  dense<3, ELU>(sm, h2, h3);
  dense<4, RELU>(sm, h3, sg);
  float nv = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) nv = __fadd_rn(nv, __ldg(vmask + static_cast<size_t>(v) * P + p));
  const bool ok = sig_ok[p] != 0;
  const float sigma = (nv < 1.f || !ok) ? 0.f : sg[0];
  const float alpha = 1.f - expf(-sigma);
  alpha_out[p] = alpha;

  // ---- color MLP: per-view base/vis, then rgb over the view concat ----
  float hc[V * 32];
  {
    float xc[3 * C], hb[64], hv[32], hvs[32], t[32], u[32];
#pragma unroll
    for (int c = 0; c < 2 * C; ++c) xc[c] = xd[64 + c];
#pragma unroll 1
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int c = 0; c < C; ++c) xc[2 * C + c] = rf[v * C + c];
      dense<5, ELU>(sm, xc, hb);
      dense<6, ELU>(sm, hb, hv);
#pragma unroll
      for (int i = 0; i < 32; ++i) hvs[i] = hv[i] / static_cast<float>(V);
      dense<7, ELU>(sm, hvs, t);
      dense<8, ELU>(sm, t, u);
#pragma unroll
      for (int i = 0; i < 32; ++i) hc[v * 32 + i] = __fadd_rn(hv[i], u[i]);
    }
  }
  float r1[32], r2[16], rgb[3];
  dense<9, ELU>(sm, hc, r1);
  dense<10, ELU>(sm, r1, r2);
  dense<11, SIGMOID>(sm, r2, rgb);
  const bool alive = alpha > 1e-14f && ok;
#pragma unroll
  for (int c = 0; c < 3; ++c) rgb_out[static_cast<size_t>(p) * 3 + c] = alive ? rgb[c] : 0.f;
}

}  // namespace

extern "C" {

// Sizes the Python wrapper checks its packed weight buffer against.
int point_stages_wbuf_floats() { return WBUF; }

int point_stages_launch(const void* rows, const void* w4, const void* pscale,
                        const void* g0_rows, const void* g0_w, const void* g0_scale,
                        const void* g1_rows, const void* g1_w, const void* g1_scale,
                        const void* vmask, const void* sig_ok, const void* wbuf,
                        void* alpha, void* rgb, int P, void* stream) {
  static bool configured = false;
  const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        point_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  if (P > 0) {
    const int grid = (P + BLOCK - 1) / BLOCK;
    point_stages_kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(rows), static_cast<const float*>(w4),
        static_cast<const float*>(pscale), static_cast<const uint8_t*>(g0_rows),
        static_cast<const float*>(g0_w), static_cast<const float*>(g0_scale),
        static_cast<const int8_t*>(g1_rows), static_cast<const float*>(g1_w),
        static_cast<const float*>(g1_scale), static_cast<const float*>(vmask),
        static_cast<const uint8_t*>(sig_ok), static_cast<const float*>(wbuf),
        static_cast<float*>(alpha), static_cast<float*>(rgb), P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
