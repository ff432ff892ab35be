// Complete restarted GMRES(m) on dense pre-preconditioned operators, in ONE
// cooperative launch.
//
// Replaces the Pallas TPU kernel
//   wavesandeigenvalues_jl_tpu/ops/pallas_gmres.py :: build_dense_gmres
// (kernel body `kernel`), the inner solver of the dense fused local
// eigensolver (nlevp/fused_local.py :: FusedPencilSolver).  For each of
// `sides` independent systems P x = b (P = D^-1 G already premultiplied by
// the caller) it runs `cycles` restarts from x0 = 0 of exactly m Arnoldi
// steps -- no early exit -- with the arithmetic of the TPU kernel:
//   * matvec w[i] = sum_j P[i,j] v[j];
//   * CGS2: two classical Gram-Schmidt projections over V[0..j], summed
//     into the Hessenberg column;
//   * norms clamped as sqrt(max(., 1e-37));
//   * complex Givens rotations with a real c and a complex s, with the
//     zero guards of the TPU kernel;
//   * back substitution with |R_ii|^2 clamped at 1e-37, then x += V y.
// Everything is complex64 (float2) with float32 sums: no TF32, no tensor
// cores.
//
// Layout (all contiguous, complex64 = float2):
//   P     [sides, N, N]        row-major operators
//   b     [sides, N]           right-hand sides
//   x     [sides, N]           solutions (output)
//   V     [sides, m+1, N]      Krylov basis (global scratch)
//   part  [sides, 3, m+1, G]   per-block partial sums (global scratch)
//   y     [sides, m+1]         least-squares solution (global scratch)
//
// What bounds it: every Arnoldi step streams P once (8 N^2 bytes a side);
// a launch streams it sides * cycles * (m+1) times, 2.57 GB at
// (sides, N, m, cycles) = (2, 1408, 80, 1).  Both sides' P (31.7 MB) fit
// the H100's 50 MB L2, so after the first step the stream comes mostly
// from L2.  The recursion is sequential in j, so the design spreads every
// step over the whole card with one cooperative launch: `sides` groups of
// G blocks, each block owning a contiguous range of R rows of its side.
// The matvec is a warp per row (float4 loads, contiguous in j, coalesced);
// each projection and each norm is a per-block partial over the owned rows,
// written to `part`, a grid-wide sync, and a fixed-order sum of the G
// partials that every block computes identically.  Four grid syncs per
// Arnoldi step; their latency, not bandwidth, is expected to bound the
// kernel at this size.  The O(m) Givens work of a column runs on thread 0
// of each side's first block (which keeps the Hessenberg store, cs, sn and
// g in shared memory); the back substitution on its first warp.
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinRowsPerBlock = 16;

__device__ __forceinline__ float2 warp_sum(float2 v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    return v;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b)      // a * b
{
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) // conj(a) * b
{
    return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

size_t smem_bytes(int N, int m, int R)
{
    const size_t m1 = (size_t)m + 1;
    // vsh N, wsh R, h1 h2 g sn y cs 6(m+1), Ht (m+1)^2, red kWarps+1
    return (N + R + 6 * m1 + m1 * m1 + kWarps + 1) * sizeof(float2);
}

// w[i - r0] = sum_j P[i, j] v[j] for the rows [r0, r1): one warp per row
__device__ void matvec(const float2* __restrict__ Ps, const float2* vsh,
                       float2* wsh, int r0, int r1, int N)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float4* v4 = reinterpret_cast<const float4*>(vsh);
    const int n2 = N / 2;
    for (int i = r0 + warp; i < r1; i += kWarps) {
        const float4* row = reinterpret_cast<const float4*>(Ps + (size_t)i * N);
        float ar = 0.f, ai = 0.f;
#pragma unroll 4
        for (int q = lane; q < n2; q += 32) {
            const float4 p = __ldg(row + q);
            const float4 v = v4[q];
            ar = fmaf(p.x, v.x, ar);
            ar = fmaf(-p.y, v.y, ar);
            ai = fmaf(p.x, v.y, ai);
            ai = fmaf(p.y, v.x, ai);
            ar = fmaf(p.z, v.z, ar);
            ar = fmaf(-p.w, v.w, ar);
            ai = fmaf(p.z, v.w, ai);
            ai = fmaf(p.w, v.z, ai);
        }
        const float2 s = warp_sum(make_float2(ar, ai));
        if (lane == 0)
            wsh[i - r0] = s;
    }
}

// sum of |w|^2 over the whole side: block partial -> pn[gb], grid sync,
// fixed-order sum of the G partials (identical in every block)
__device__ float side_norm2(cg::grid_group& grid, const float2* wsh,
                            int nrows, float2* pn, int gb, int G,
                            float2* red)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    float acc = 0.f;
    for (int i = threadIdx.x; i < nrows; i += kThreads) {
        const float2 w = wsh[i];
        acc = fmaf(w.x, w.x, fmaf(w.y, w.y, acc));
    }
    acc = warp_sum(make_float2(acc, 0.f)).x;
    if (lane == 0)
        red[warp].x = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w)
            s += red[w].x;
        pn[gb] = make_float2(s, 0.f);
    }
    grid.sync();
    if (warp == 0) {
        float s = 0.f;
        for (int g = lane; g < G; g += 32)
            s += __ldcg(pn + g).x;
        s = warp_sum(make_float2(s, 0.f)).x;
        if (lane == 0)
            red[kWarps].x = s;
    }
    __syncthreads();
    return red[kWarps].x;
}

// one classical Gram-Schmidt projection of w (owned rows) against
// V[0..j]: h[k] = sum_i conj(V[k,i]) w[i] over the side, then
// w -= sum_k h[k] V[k, :]
__device__ void project(cg::grid_group& grid, const float2* Vs, float2* wsh,
                        float2* h, float2* pp, int j, int r0, int r1, int N,
                        int gb, int G)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int k = warp; k <= j; k += kWarps) {
        float2 acc = make_float2(0.f, 0.f);
        for (int i = r0 + lane; i < r1; i += 32) {
            const float2 t = cmul_conj(__ldcg(Vs + (size_t)k * N + i),
                                       wsh[i - r0]);
            acc.x += t.x;
            acc.y += t.y;
        }
        acc = warp_sum(acc);
        if (lane == 0)
            pp[(size_t)k * G + gb] = acc;
    }
    grid.sync();
    for (int k = warp; k <= j; k += kWarps) {
        float2 acc = make_float2(0.f, 0.f);
        for (int g = lane; g < G; g += 32) {
            const float2 t = __ldcg(pp + (size_t)k * G + g);
            acc.x += t.x;
            acc.y += t.y;
        }
        acc = warp_sum(acc);
        if (lane == 0)
            h[k] = acc;
    }
    __syncthreads();
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
        float2 w = wsh[i - r0];
        for (int k = 0; k <= j; ++k) {
            const float2 t = cmul(h[k], __ldcg(Vs + (size_t)k * N + i));
            w.x -= t.x;
            w.y -= t.y;
        }
        wsh[i - r0] = w;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
dense_gmres_kernel(const float2* __restrict__ P, const float2* __restrict__ b,
                   float2* x, float2* V, float2* part, float2* ybuf,
                   int N, int m, int cycles, int G, int R)
{
    cg::grid_group grid = cg::this_grid();
    extern __shared__ float2 smem[];
    const int m1 = m + 1;
    float2* vsh = smem;               // vector being multiplied   [N]
    float2* wsh = vsh + N;            // owned rows of w           [R]
    float2* h1 = wsh + R;             // first projection          [m+1]
    float2* h2 = h1 + m1;             // second projection         [m+1]
    float2* gv = h2 + m1;             // rotated rhs g             [m+1]
    float2* sn = gv + m1;             // Givens s (complex)        [m+1]
    float2* yv = sn + m1;             // least-squares solution    [m+1]
    float* cs = reinterpret_cast<float*>(yv + m1);  // Givens c   [m+1]
    float2* Ht = yv + 2 * m1;         // Ht[j, k] = R[k, j]        [m+1, m+1]
    float2* red = Ht + (size_t)m1 * m1;   // reduction scratch   [kWarps+1]

    const int side = blockIdx.x / G;
    const int gb = blockIdx.x % G;
    const int r0 = min(N, gb * R);
    const int r1 = min(N, r0 + R);
    const int nrows = r1 - r0;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const bool lead = (gb == 0);      // keeps Ht, cs, sn, g of the side

    const float2* Ps = P + (size_t)side * N * N;
    const float2* bs = b + (size_t)side * N;
    float2* xs = x + (size_t)side * N;
    float2* Vs = V + (size_t)side * m1 * N;
    float2* p1 = part + (size_t)side * 3 * m1 * G;
    float2* p2 = p1 + (size_t)m1 * G;
    float2* pn = p2 + (size_t)m1 * G;
    float2* ys = ybuf + (size_t)side * m1;

    for (int i = r0 + tid; i < r1; i += kThreads)
        xs[i] = make_float2(0.f, 0.f);

    for (int cyc = 0; cyc < cycles; ++cyc) {
        // r = b - P x
        grid.sync();
        for (int q = tid; q < N; q += kThreads)
            vsh[q] = __ldcg(xs + q);
        __syncthreads();
        matvec(Ps, vsh, wsh, r0, r1, N);
        __syncthreads();
        for (int i = r0 + tid; i < r1; i += kThreads) {
            const float2 bi = bs[i];
            const float2 ax = wsh[i - r0];
            wsh[i - r0] = make_float2(bi.x - ax.x, bi.y - ax.y);
        }
        __syncthreads();
        const float beta = sqrtf(fmaxf(
            side_norm2(grid, wsh, nrows, pn, gb, G, red), 1e-37f));
        for (int i = r0 + tid; i < r1; i += kThreads) {
            const float2 w = wsh[i - r0];
            Vs[i] = make_float2(w.x / beta, w.y / beta);
        }
        if (lead) {
            // zeroed scratch: the back substitution reads all of Ht
            for (int q = tid; q < m1 * m1; q += kThreads)
                Ht[q] = make_float2(0.f, 0.f);
            for (int q = tid; q < m1; q += kThreads) {
                gv[q] = make_float2(q == 0 ? beta : 0.f, 0.f);
                sn[q] = make_float2(0.f, 0.f);
                cs[q] = 0.f;
            }
        }

        for (int j = 0; j < m; ++j) {
            grid.sync();                              // V[j] complete
            for (int q = tid; q < N; q += kThreads)
                vsh[q] = __ldcg(Vs + (size_t)j * N + q);
            __syncthreads();
            matvec(Ps, vsh, wsh, r0, r1, N);
            __syncthreads();
            project(grid, Vs, wsh, h1, p1, j, r0, r1, N, gb, G);
            project(grid, Vs, wsh, h2, p2, j, r0, r1, N, gb, G);
            const float hn = sqrtf(fmaxf(
                side_norm2(grid, wsh, nrows, pn, gb, G, red), 1e-37f));
            for (int i = r0 + tid; i < r1; i += kThreads) {
                const float2 w = wsh[i - r0];
                Vs[(size_t)(j + 1) * N + i] = make_float2(w.x / hn, w.y / hn);
            }
            if (lead && tid == 0) {
                // Hessenberg column j, rotated by the rotations 0..j-1
                float2* col = Ht + (size_t)j * m1;
                for (int k = 0; k <= j; ++k)
                    col[k] = make_float2(h1[k].x + h2[k].x, h1[k].y + h2[k].y);
                col[j + 1] = make_float2(hn, 0.f);
                for (int k = 0; k < j; ++k) {
                    const float c = cs[k];
                    const float2 s = sn[k];
                    const float2 a = col[k];
                    const float2 bb = col[k + 1];
                    col[k] = make_float2(c * a.x + s.x * bb.x - s.y * bb.y,
                                         c * a.y + s.x * bb.y + s.y * bb.x);
                    col[k + 1] = make_float2(
                        -(s.x * a.x + s.y * a.y) + c * bb.x,
                        -(s.x * a.y - s.y * a.x) + c * bb.y);
                }
                // new rotation zeroing col[j+1]
                const float2 a = col[j];
                const float2 bb = col[j + 1];
                const float a2 = a.x * a.x + a.y * a.y;
                const float absa = sqrtf(fmaxf(a2, 0.f));
                const float den = sqrtf(fmaxf(
                    a2 + bb.x * bb.x + bb.y * bb.y, 1e-37f));
                const float c = (den == 0.f) ? 1.f : absa / den;
                const float safe = (absa == 0.f) ? 1.f : absa;
                const float phr = (absa == 0.f) ? 1.f : a.x / safe;
                const float phi = (absa == 0.f) ? 0.f : a.y / safe;
                const float2 s = make_float2((phr * bb.x + phi * bb.y) / den,
                                             (phi * bb.x - phr * bb.y) / den);
                cs[j] = c;
                sn[j] = s;
                col[j] = make_float2(c * a.x + s.x * bb.x - s.y * bb.y,
                                     c * a.y + s.x * bb.y + s.y * bb.x);
                col[j + 1] = make_float2(0.f, 0.f);
                const float2 gj = gv[j];
                gv[j + 1] = make_float2(-(s.x * gj.x + s.y * gj.y),
                                        -(s.x * gj.y - s.y * gj.x));
                gv[j] = make_float2(c * gj.x, c * gj.y);
            }
        }

        // back substitution y_i = (g_i - sum_{c>i} R[i,c] y_c) / R[i,i]
        if (lead) {
            __syncthreads();
            if (warp == 0) {
                for (int k = lane; k < m1; k += 32)
                    yv[k] = make_float2(0.f, 0.f);
                __syncwarp();
                for (int i = m - 1; i >= 0; --i) {
                    float2 acc = make_float2(0.f, 0.f);
                    for (int c = i + 1 + lane; c < m1; c += 32) {
                        const float2 t = cmul(yv[c], Ht[(size_t)c * m1 + i]);
                        acc.x += t.x;
                        acc.y += t.y;
                    }
                    acc = warp_sum(acc);
                    if (lane == 0) {
                        const float2 num = make_float2(gv[i].x - acc.x,
                                                       gv[i].y - acc.y);
                        const float2 d = Ht[(size_t)i * m1 + i];
                        const float d2 = fmaxf(d.x * d.x + d.y * d.y, 1e-37f);
                        yv[i] = make_float2((num.x * d.x + num.y * d.y) / d2,
                                            (num.y * d.x - num.x * d.y) / d2);
                    }
                    __syncwarp();
                }
                for (int k = lane; k < m1; k += 32)
                    ys[k] = yv[k];
            }
        }
        grid.sync();                                  // y complete
        for (int k = tid; k < m1; k += kThreads)
            yv[k] = __ldcg(ys + k);
        __syncthreads();
        // x += V y on the owned rows
        for (int i = r0 + tid; i < r1; i += kThreads) {
            float2 acc = xs[i];
            for (int k = 0; k < m1; ++k) {
                const float2 t = cmul(yv[k], __ldcg(Vs + (size_t)k * N + i));
                acc.x += t.x;
                acc.y += t.y;
            }
            xs[i] = acc;
        }
    }
}

int configure(int sides, int N, int m, int G, int* R, size_t* smem)
{
    *R = (N + G - 1) / G;
    *smem = smem_bytes(N, m, *R);
    return (int)cudaFuncSetAttribute(
        dense_gmres_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)*smem);
}

}  // namespace

// Blocks per side of the cooperative grid: as many as keep kMinRowsPerBlock
// rows a block and fit co-resident on the card with the other sides.
extern "C" int dense_gmres_blocks_per_side(int sides, int N, int m, int* G_out)
{
    int dev = 0, nsm = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess)
        return (int)e;
    if (!coop)
        return (int)cudaErrorNotSupported;
    for (int G = (N + kMinRowsPerBlock - 1) / kMinRowsPerBlock; G >= 1; --G) {
        int R, occ = 0;
        size_t smem;
        e = (cudaError_t)configure(sides, N, m, G, &R, &smem);
        if (e != cudaSuccess)
            return (int)e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, dense_gmres_kernel, kThreads, smem);
        if (e != cudaSuccess)
            return (int)e;
        if ((long)occ * nsm >= (long)sides * G) {
            *G_out = G;
            return 0;
        }
    }
    return (int)cudaErrorCooperativeLaunchTooLarge;
}

extern "C" int dense_gmres_c64(const void* P, const void* b, void* x, void* V,
                               void* part, void* y, int sides, int N, int m,
                               int cycles, int G, void* cuda_stream)
{
    int R;
    size_t smem;
    const cudaError_t e = (cudaError_t)configure(sides, N, m, G, &R, &smem);
    if (e != cudaSuccess)
        return (int)e;
    const float2* Pp = (const float2*)P;
    const float2* bp = (const float2*)b;
    float2* xp = (float2*)x;
    float2* Vp = (float2*)V;
    float2* pp = (float2*)part;
    float2* yp = (float2*)y;
    void* args[] = {&Pp, &bp, &xp, &Vp, &pp, &yp, &N, &m, &cycles, &G, &R};
    const cudaError_t l = cudaLaunchCooperativeKernel(
        (const void*)dense_gmres_kernel, dim3(sides * G), dim3(kThreads),
        args, smem, (cudaStream_t)cuda_stream);
    if (l != cudaSuccess)
        return (int)l;
    return (int)cudaGetLastError();
}

extern "C" const char* dense_gmres_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
