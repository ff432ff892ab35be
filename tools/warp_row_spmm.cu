// The warp-per-row CSR SpMM that csrc/window_spmm.cu replaced, kept as a
// yardstick: tools/k45_floor.py times it and copies of it with lines
// changed, and chip_smoke.py times it beside the port's kernel on the same
// operator and panel.  The port never calls it.
//
//   Y[i, :] = sum_{k in row i} vals[k] * X[cols[k], :]
//
// Layout (complex64 = float2, all contiguous): indptr [n_rows + 1] int32,
// cols [nnz] int32, vals [nnz] complex64, X [n_cols, r], Y [n_rows, r]; r
// a multiple of 4, X and Y 16-byte aligned.  Float32 complex FMAs.
//
// Design: one warp per row, 8 rows per 256-thread block.  Each lane owns
// 4 consecutive complex columns of a 128-column tile (two 16-byte loads
// and stores); the warp loads up to 32 (col, val) pairs at a time, one per
// lane, and broadcasts them with __shfl_sync.  Column tiles loop for
// r > 128.  Every nonzero re-reads its 1 KB row of X (r = 128) through
// __ldg: about 0.84 GB at the 57,210-DOF operator, 6.6x the 127.2 MB that
// the product must move, served by L1 and L2.
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
warp_row_spmm_kernel(const int* __restrict__ indptr,
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

extern "C" int warp_row_spmm_c64(const void* indptr, const void* cols,
                               const void* vals, const void* X, void* Y,
                               int n_rows, int r, void* cuda_stream)
{
    if (n_rows < 1 || r < 4 || r % 4 != 0)
        return (int)cudaErrorInvalidValue;
    const int grid = (n_rows + kWarps - 1) / kWarps;
    warp_row_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)cuda_stream>>>(
        (const int*)indptr, (const int*)cols, (const float2*)vals,
        (const float2*)X, (float2*)Y, n_rows, r);
    return (int)cudaGetLastError();
}

extern "C" const char* warp_row_spmm_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
