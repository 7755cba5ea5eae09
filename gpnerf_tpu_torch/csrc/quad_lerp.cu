// Quad lerp of gathered projection rows: the 4-tap bilinear weighted sum and
// the per-channel dequantization, written channel-major.
//
// Replaces the TPU kernels of gpnerf_tpu/ops/pallas_lerp.py:
//   quad_lerp_rows_vcp (_lerp_kernel_vcp): rows (V*P, 4C) view-major,
//     w4 (V, 4, P), scale (C,) -> out (V, C, P)
//   quad_lerp_rows_cm  (_lerp_kernel):     rows (N, 4C), w4 (4, N),
//     scale (C,) -> out (C, N)
// with out[.., c, p] = scale[c] * sum_{k=0..3} w4[.., k, p] * rows[.., p, k*C + c].
//
// Semantics kept: tap k of channel c sits at column k*C + c; float32 rows
// are rounded to bf16 before the sum (int8/uint8 rows are exact, bf16 rows
// are used as they are, as the TPU kernel's cast leaves them); the sum runs
// in float32 from 0 in the order k = 0..3; the scale multiplies the sum;
// one rounding to the output type. Multiplies and adds are __fmul_rn and
// __fadd_rn, so no FMA contraction moves a bit against the plain PyTorch
// version. Not kept: the TPU kernel's one-hot selector matmuls, its block
// of 2048 and its zero padding of P (the ragged tail is masked here).
//
// Bound on this card: bytes. Per point and view the kernel reads 4C row
// bytes (int8) and 16 bytes of weights and writes C outputs; it does 8C
// float operations. At C = 35 that is 226 bytes against 280 operations,
// far below the card's operations-per-byte ratio.
//
// Design: the reads want to be row-contiguous and the writes
// point-contiguous, a transpose. A block takes TILE consecutive points of
// one view: their rows are one contiguous span of global memory (rows are
// 4-byte aligned and no more: 140 bytes at C = 35), copied to shared memory
// with coalesced 32-bit loads (every row is a multiple of 4 bytes: 4C of
// int8, 8C of bf16, 16C of float32). Then threads walk p fastest over (c, p):
// thread t keeps point t % TILE, so its 4 weights sit in registers, reads
// its row's bytes from shared memory (row stride C words for int8 rows; an
// odd C such as 35 gives conflict-free banks) and writes out[c, p0 + p]
// coalesced along p. Offsets are size_t: V*P*4C reaches 1.5e9 at the
// reference mode's P.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename RowT> __device__ __forceinline__ float row_value(RowT r);
template <> __device__ __forceinline__ float row_value<int8_t>(int8_t r) { return (float)r; }
template <> __device__ __forceinline__ float row_value<uint8_t>(uint8_t r) { return (float)r; }
template <> __device__ __forceinline__ float row_value<float>(float r) {
  return __bfloat162float(__float2bfloat16_rn(r));
}
template <> __device__ __forceinline__ float row_value<__nv_bfloat16>(__nv_bfloat16 r) {
  return __bfloat162float(r);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Grid (tiles of P, V): rows of view v start at row v*P, its weights at
// w4[v, k, :], its outputs at out[v, c, :]. The flat channel-major form is
// the same indexing with one view of N rows.
template <typename RowT, typename OutT, int TILE>
__global__ void __launch_bounds__(THREADS)
quad_lerp_kernel(const RowT* __restrict__ rows, const float* __restrict__ w4,
                 const float* __restrict__ scale, OutT* __restrict__ out,
                 int P, int C) {
  extern __shared__ uint32_t tile_words[];
  const int v = blockIdx.y;
  const int p0 = blockIdx.x * TILE;
  const int n = min(TILE, P - p0);
  const size_t row_bytes = (size_t)4 * C * sizeof(RowT);
  const size_t first = ((size_t)v * P + p0) * row_bytes;  // multiple of 4
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(rows) + first);
  const int n_words = (int)((size_t)n * row_bytes / 4);
  for (int i = threadIdx.x; i < n_words; i += THREADS) tile_words[i] = src[i];
  __syncthreads();

  const int p = threadIdx.x % TILE;
  if (p >= n) return;
  const float* wv = w4 + (size_t)v * 4 * P + p0 + p;
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = wv[(size_t)k * P];
  const RowT* row = reinterpret_cast<const RowT*>(tile_words) + (size_t)p * 4 * C;
  OutT* o = out + (size_t)v * C * P + p0 + p;
  for (int c = threadIdx.x / TILE; c < C; c += THREADS / TILE) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = __fadd_rn(acc, __fmul_rn(row_value<RowT>(row[k * C + c]), w[k]));
    store_out(o + (size_t)c * P, __fmul_rn(acc, scale[c]));
  }
}

template <typename RowT, typename OutT, int TILE>
int launch(const void* rows, const float* w4, const float* scale, void* out,
           int V, int P, int C, cudaStream_t stream) {
  static_assert(THREADS % TILE == 0, "a thread keeps one point");
  const size_t smem = (size_t)TILE * 4 * C * sizeof(RowT);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (V <= 0 || P <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((P + TILE - 1) / TILE, V);
  if (V > 65535) return (int)cudaErrorInvalidValue;
  quad_lerp_kernel<RowT, OutT, TILE><<<grid, THREADS, smem, stream>>>(
      static_cast<const RowT*>(rows), w4, scale, static_cast<OutT*>(out), P, C);
  return (int)cudaGetLastError();
}

// row_type: 0 int8, 1 uint8, 2 float32, 3 bfloat16; out_type: 0 float32,
// 1 bfloat16
int dispatch(const void* rows, const float* w4, const float* scale, void* out,
             int V, int P, int C, int row_type, int out_type, cudaStream_t s) {
  const int key = row_type * 2 + out_type;
  switch (key) {
    case 0: return launch<int8_t, float, 128>(rows, w4, scale, out, V, P, C, s);
    case 1: return launch<int8_t, __nv_bfloat16, 128>(rows, w4, scale, out, V, P, C, s);
    case 2: return launch<uint8_t, float, 128>(rows, w4, scale, out, V, P, C, s);
    case 3: return launch<uint8_t, __nv_bfloat16, 128>(rows, w4, scale, out, V, P, C, s);
    case 4: return launch<float, float, 32>(rows, w4, scale, out, V, P, C, s);
    case 5: return launch<float, __nv_bfloat16, 32>(rows, w4, scale, out, V, P, C, s);
    case 6: return launch<__nv_bfloat16, float, 64>(rows, w4, scale, out, V, P, C, s);
    case 7: return launch<__nv_bfloat16, __nv_bfloat16, 64>(rows, w4, scale, out, V, P, C, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest channel count the shared-memory tile holds, per row type.
extern "C" int quad_lerp_max_channels(int row_type) {
  return row_type == 2 ? 48 * 1024 / (32 * 16)
       : row_type == 3 ? 48 * 1024 / (64 * 8) : 48 * 1024 / (128 * 4);
}

// rows (V*P, 4C) view-major, w4 (V, 4, P), scale (C,), out (V, C, P).
extern "C" int quad_lerp_vcp_launch(const void* rows, const void* w4, const void* scale,
                                    void* out, int V, int P, int C, int row_type,
                                    int out_type, void* stream) {
  return dispatch(rows, static_cast<const float*>(w4), static_cast<const float*>(scale),
                  out, V, P, C, row_type, out_type, static_cast<cudaStream_t>(stream));
}

// rows (N, 4C), w4 (4, N), scale (C,), out (C, N): the flat channel-major
// form, one span of N rows.
extern "C" int quad_lerp_cm_launch(const void* rows, const void* w4, const void* scale,
                                   void* out, int N, int C, int row_type, int out_type,
                                   void* stream) {
  return dispatch(rows, static_cast<const float*>(w4), static_cast<const float*>(scale),
                  out, 1, N, C, row_type, out_type, static_cast<cudaStream_t>(stream));
}
