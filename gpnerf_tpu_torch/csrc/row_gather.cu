// Row gather: out[i, :] = table[idx[i], :].
//
// Replaces the TPU kernel `pallas_gather` of tools/bench_gather.py (an
// in-kernel gather from a table held in VMEM). The 2.6 MB table of the
// microbenchmark cannot sit in the 227 KB of shared memory a block has on
// this card; it stays resident in the 50 MB L2 cache instead, so the
// kernel's traffic to device memory is the index read and the output write.
//
// Bound on this card: bytes (no arithmetic). Each index and each output
// byte moves once; the table is read once.
//
// Design: rows are copied as 16-byte vectors when the row's byte length is
// a multiple of 16 (a 128-byte row is 8 threads with one uint4 each), else
// as 32-bit words. One thread per vector; consecutive threads take
// consecutive vectors of a row and then the next row, so the writes are
// fully coalesced and the reads are coalesced within a row. Indices are in
// range by contract. Offsets are size_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename VecT, typename IdxT>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const VecT* __restrict__ table, const IdxT* __restrict__ idx,
                  VecT* __restrict__ out, size_t n_rows, int row_vecs) {
  const size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_rows * (size_t)row_vecs) return;
  const size_t i = t / row_vecs;
  const int j = (int)(t - i * row_vecs);
  out[t] = table[(size_t)idx[i] * row_vecs + j];
}

template <typename VecT, typename IdxT>
int launch(const void* table, const void* idx, void* out, size_t n_rows,
           int row_bytes, cudaStream_t stream) {
  const int row_vecs = row_bytes / (int)sizeof(VecT);
  const size_t total = n_rows * (size_t)row_vecs;
  const size_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks == 0 || blocks > 2147483647u) return (int)cudaErrorInvalidValue;
  row_gather_kernel<VecT, IdxT><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const VecT*>(table), static_cast<const IdxT*>(idx),
      static_cast<VecT*>(out), n_rows, row_vecs);
  return (int)cudaGetLastError();
}

}  // namespace

// table (T, row_bytes), idx (n_rows,) int32 or int64 (idx_is_64), out
// (n_rows, row_bytes). row_bytes must be a multiple of 4; table and out must
// be 16-byte aligned.
extern "C" int row_gather_launch(const void* table, const void* idx, void* out,
                                 long long n_rows, int row_bytes, int idx_is_64,
                                 void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || row_bytes % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)n_rows;
  if (row_bytes % 16 == 0) {
    return idx_is_64 ? launch<uint4, int64_t>(table, idx, out, n, row_bytes, s)
                     : launch<uint4, int32_t>(table, idx, out, n, row_bytes, s);
  }
  return idx_is_64 ? launch<uint32_t, int64_t>(table, idx, out, n, row_bytes, s)
                   : launch<uint32_t, int32_t>(table, idx, out, n, row_bytes, s);
}
