// Block-sparse-row SpMM  Y[row] = sum_k blocks[row, k] @ X[cols[row, k]].
//
// Replaces the Pallas TPU kernel
//   wavesandeigenvalues_jl_tpu/ops/pallas_spmv.py :: _bsr_spmm_kernel
// (built by _bsr_spmm_jit, wrapped by PallasBsrSpmm): the operator apply
// Y = L(w) X of a Cuthill-McKee-reordered family on a panel of r right-hand
// sides.
//
// Layout (complex64 = float2, all contiguous):
//   blocks [nbr, maxb, bs, bs]   dense blocks of each block row; padding
//                                blocks are zero (column 0), so they need
//                                no mask
//   cols   [nbr, maxb] int32     block-column index of each block
//   X      [nb, bs, r]           right-hand-side panel in block rows
//   Y      [nbr, bs, r]          output
// Sums are float32 complex FMAs: no TF32, no tensor cores.
//
// Design: one thread block per (block row, tile of 32 columns of the
// panel), 256 threads.  For each of the row's blocks it stages a bs x 32
// slice of the block and the matching 32 x 32 slice of the gathered X rows
// in shared memory, and every thread accumulates bs/8 outputs of one
// column in registers.  A warp shares one output row group, so its reads
// of the block slice are broadcasts and its reads of the X slice are
// consecutive.  What bounds it: with r = 128 the product does 8 bs^2 r
// flops per stored block against 8 bs^2 bytes of block, i.e. 128 flops a
// byte, above the H100's fp32 SIMT ridge (67 TFLOP/s over 3.35 TB/s = 20
// flops a byte), so the fp32 pipes are the roof; this first version
// re-reads each block once per column tile (r / 32 = 4 times, mostly from
// L2) and does not overlap loads with the FMAs.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileCols = 32;   // panel columns of one thread block
constexpr int kChunk = 32;      // inner (k) depth staged per step

template <int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float2* __restrict__ blocks,
                const int* __restrict__ cols,
                const float2* __restrict__ X, float2* __restrict__ Y,
                int maxb, int r)
{
    constexpr int kRowsPerThread = BS / (kThreads / kTileCols);
    __shared__ float2 As[BS][kChunk];
    __shared__ float2 Xs[kChunk][kTileCols];

    const int row = blockIdx.x;
    const int c0 = blockIdx.y * kTileCols;
    const int tid = threadIdx.x;
    const int c = tid % kTileCols;
    const int rg = tid / kTileCols;   // rows rg, rg + 8, ...

    float2 acc[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t)
        acc[t] = make_float2(0.f, 0.f);

    for (int k = 0; k < maxb; ++k) {
        const int cb = cols[(size_t)row * maxb + k];
        const float2* A = blocks + ((size_t)row * maxb + k) * BS * BS;
        const float2* Xb = X + (size_t)cb * BS * r + c0;
        for (int kk = 0; kk < BS; kk += kChunk) {
            for (int e = tid; e < BS * kChunk; e += kThreads)
                As[e / kChunk][e % kChunk] =
                    A[(size_t)(e / kChunk) * BS + kk + e % kChunk];
            for (int e = tid; e < kChunk * kTileCols; e += kThreads)
                Xs[e / kTileCols][e % kTileCols] =
                    Xb[(size_t)(kk + e / kTileCols) * r + e % kTileCols];
            __syncthreads();
#pragma unroll 8
            for (int q = 0; q < kChunk; ++q) {
                const float2 x = Xs[q][c];
#pragma unroll
                for (int t = 0; t < kRowsPerThread; ++t) {
                    const float2 a = As[rg + t * (kThreads / kTileCols)][q];
                    acc[t].x = fmaf(a.x, x.x, fmaf(-a.y, x.y, acc[t].x));
                    acc[t].y = fmaf(a.x, x.y, fmaf(a.y, x.x, acc[t].y));
                }
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
        const int rr = rg + t * (kThreads / kTileCols);
        Y[((size_t)row * BS + rr) * r + c0 + c] = acc[t];
    }
}

}  // namespace

extern "C" int bsr_spmm_c64(const void* blocks, const void* cols,
                            const void* X, void* Y, int nbr, int maxb,
                            int bs, int r, void* cuda_stream)
{
    if (r % kTileCols != 0 || nbr < 1 || maxb < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(nbr, r / kTileCols);
    const cudaStream_t st = (cudaStream_t)cuda_stream;
    const float2* b = (const float2*)blocks;
    const int* c = (const int*)cols;
    const float2* x = (const float2*)X;
    float2* y = (float2*)Y;
    switch (bs) {
    case 32:
        bsr_spmm_kernel<32><<<grid, kThreads, 0, st>>>(b, c, x, y, maxb, r);
        break;
    case 64:
        bsr_spmm_kernel<64><<<grid, kThreads, 0, st>>>(b, c, x, y, maxb, r);
        break;
    case 128:
        bsr_spmm_kernel<128><<<grid, kThreads, 0, st>>>(b, c, x, y, maxb, r);
        break;
    default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* bsr_spmm_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
