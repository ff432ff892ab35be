// CSR SpMM  Y[i, :] = sum_{k in row i} vals[k] * X[cols[k], :].
//
// Replaces both windowed Pallas TPU kernels of the large-operator apply:
//   wavesandeigenvalues_jl_tpu/ops/window_spmm.py  :: _make_kernel /
//       _build_call (K4: slot-padded 128x128 blocks per 1024-row tile,
//       wrapped by WindowSpmm)
//   wavesandeigenvalues_jl_tpu/ops/window_spmm2.py :: _build_call (K5:
//       compact 8x128 blocks chunked by a shared window column, wrapped by
//       ChunkSpmm)
// Both compute Y = A X for a Cuthill-McKee-ordered operator, complex64 data
// and float32 sums.  Their block layouts exist only because Mosaic cannot
// lower a per-row gather; this card gathers per row natively, so the kernel
// works on the compressed rows themselves and has no window limit.
//
// Layout (complex64 = float2, all contiguous):
//   indptr [n_rows + 1] int32   row starts
//   cols   [nnz] int32          column of each nonzero
//   vals   [nnz] complex64      value of each nonzero
//   X      [n_cols, r]          panel of right-hand sides
//   Y      [n_rows, r]          output
// r is a multiple of 4; X and Y are 16-byte aligned.  Sums are float32
// complex FMAs: no TF32, no tensor cores.
//
// Design: one warp per row, 8 rows per 256-thread block.  Each lane owns
// 4 consecutive complex columns of a 128-column tile (two 16-byte loads
// and stores, neighbouring lanes on neighbouring addresses); the warp
// loads up to 32 (col, val) pairs at a time, one per lane, and broadcasts
// them with __shfl_sync.  Column tiles loop for r > 128.
//
// What bounds it, at the main path's 57,210 DOF, 819,730 nonzeros and
// r = 128: bytes.  vals 6.56 MB, cols 3.28 MB, indptr 0.23 MB, X read once
// 58.59 MB and Y written once 58.59 MB, 127.2 MB in all, 0.0380 ms at
// 3.35 TB/s; the 8 nnz r = 0.839 GFLOP take 0.0125 ms at 67 TFLOP/s.  This
// first version re-reads a 1 KB row of X for every nonzero, about 0.84 GB
// in all; after Cuthill-McKee the band is a few hundred rows wide, so those
// rows are served from the 50 MB L2, and the kernel sits well above its
// bound.  Staging the X band in shared memory, cp.async and overlapping
// loads with the FMAs are the next steps.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // rows of one thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileCols = 128;           // complex columns: 4 per lane

__device__ __forceinline__ void cfma(float2& acc, float2 a, float xr,
                                     float xi)
{
    acc.x = fmaf(a.x, xr, fmaf(-a.y, xi, acc.x));
    acc.y = fmaf(a.x, xi, fmaf(a.y, xr, acc.y));
}

__global__ void __launch_bounds__(kThreads)
window_spmm_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ cols,
                   const float2* __restrict__ vals,
                   const float2* __restrict__ X, float2* __restrict__ Y,
                   int n_rows, int r)
{
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= n_rows)
        return;                          // uniform over the warp
    const int start = indptr[row];
    const int end = indptr[row + 1];

    for (int c0 = 0; c0 < r; c0 += kTileCols) {
        const int c = c0 + 4 * lane;     // the first of this lane's columns
        const bool active = c < r;       // r % 4 == 0: all four or none
        float2 acc[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
            acc[t] = make_float2(0.f, 0.f);

        for (int base = start; base < end; base += 32) {
            const int k = base + lane;
            int col = 0;
            float2 v = make_float2(0.f, 0.f);
            if (k < end) {
                col = __ldg(cols + k);
                v = __ldg(vals + k);
            }
            const int cnt = min(32, end - base);
            for (int j = 0; j < cnt; ++j) {
                const int cj = __shfl_sync(0xffffffffu, col, j);
                const float2 a = make_float2(
                    __shfl_sync(0xffffffffu, v.x, j),
                    __shfl_sync(0xffffffffu, v.y, j));
                if (active) {
                    const float4* xp = reinterpret_cast<const float4*>(
                        X + (size_t)cj * r + c);
                    const float4 x01 = __ldg(xp);
                    const float4 x23 = __ldg(xp + 1);
                    cfma(acc[0], a, x01.x, x01.y);
                    cfma(acc[1], a, x01.z, x01.w);
                    cfma(acc[2], a, x23.x, x23.y);
                    cfma(acc[3], a, x23.z, x23.w);
                }
            }
        }
        if (active) {
            float4* yp = reinterpret_cast<float4*>(Y + (size_t)row * r + c);
            yp[0] = make_float4(acc[0].x, acc[0].y, acc[1].x, acc[1].y);
            yp[1] = make_float4(acc[2].x, acc[2].y, acc[3].x, acc[3].y);
        }
    }
}

}  // namespace

extern "C" int window_spmm_c64(const void* indptr, const void* cols,
                               const void* vals, const void* X, void* Y,
                               int n_rows, int r, void* cuda_stream)
{
    if (n_rows < 1 || r < 4 || r % 4 != 0)
        return (int)cudaErrorInvalidValue;
    const int grid = (n_rows + kWarps - 1) / kWarps;
    window_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)cuda_stream>>>(
        (const int*)indptr, (const int*)cols, (const float2*)vals,
        (const float2*)X, (float2*)Y, n_rows, r);
    return (int)cudaGetLastError();
}

extern "C" const char* window_spmm_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
