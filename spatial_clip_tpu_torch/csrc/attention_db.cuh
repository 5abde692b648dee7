// The qkv-bias gradient's second pass, shared by the attention backward
// kernels that compute db (fused_attention_bwd.cu, attention_layouts.cu):
// each backward block writes the column sums of its rounded dq, dk, dv as one
// partial row; db[c] = the sum over the batch of part[b][c], in a fixed order
// (8 strided partial sums per column, then added in order). The result is
// the same bits every run, which atomicAdd into one vector is not.
#pragma once

#include <cuda_runtime.h>

namespace sc {
namespace bwd {
namespace {  // one copy per translation unit that launches it

constexpr int kReduceCols = 32;
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(kReduceCols * kReduceRows)
db_reduce_kernel(const float* __restrict__ part, float* __restrict__ db, int batch, int n) {
  __shared__ float acc_s[kReduceRows][kReduceCols + 1];
  const int c = blockIdx.x * kReduceCols + threadIdx.x;
  float acc = 0.f;
  if (c < n) {
#pragma unroll 4  // loads in flight together; the sum keeps its order
    for (int b = threadIdx.y; b < batch; b += kReduceRows) acc += part[size_t(b) * n + c];
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceRows; ++y) total += acc_s[y][threadIdx.x];
    db[c] = total;
  }
}

// db (n) from part (batch, n), on stream; returns cudaGetLastError().
cudaError_t db_reduce(const float* part, float* db, int batch, int n, cudaStream_t stream) {
  db_reduce_kernel<<<(n + kReduceCols - 1) / kReduceCols, dim3(kReduceCols, kReduceRows), 0,
                     stream>>>(part, db, batch, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace bwd
}  // namespace sc
