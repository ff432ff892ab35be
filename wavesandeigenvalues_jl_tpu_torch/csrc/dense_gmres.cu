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
// cores.  Every sum is taken in a fixed order, so two launches on the same
// inputs give the same bits.
//
// What bounds it on an H100: the Arnoldi recursion is a chain of m steps,
// each a matvec with the side's N x N operator (15.9 MB at N = 1408), two
// projections and a norm, and every one of them is a reduction over all
// N rows.  A step's arithmetic is small (~0.2 us of the card's fp32
// rate at N = 1408), so the step's latency bounds the kernel: its
// cross-block reductions, and the bytes of P each SM must read per step.
// The kernel this design replaced took ~34 us a step on an H100 at
// (2, 1408, 80, 1) (tools/k2_step_profile.py): four grid-wide syncs,
// 2 x 88 blocks on 132 SMs, P and V streamed from L2, projection partials
// summed one k at a time, and the Givens rotations on one thread on the
// critical path.
//
// Design (the launch plan comes from ops/dense_gmres.py :: plan):
//  * `sides` groups of G row blocks, one per SM, each owning R consecutive
//    rows of its side (G = 64, R = 22 at N = 1408, sides = 2), and one
//    Givens block per side; sides * (G + 1) blocks, co-resident by a
//    cooperative launch.
//  * The first `res` of a block's rows of P stay in shared memory for the
//    whole launch (one bulk copy each, cp.async.bulk, at the start); of
//    the other R - res rows, the first kWarps (one per warp) are loaded
//    into registers by their warps before the step's first barrier wait,
//    so their L2 latency hides behind the wait.  Any more (on a card of
//    fewer SMs than an H100 SXM's 132, which gives each block more rows:
//    9 streamed rows at (2, 1408, 80) on 114 SMs) are read from L2 in the
//    matvec itself.
//  * The block's slice of the Krylov basis, V[0..m-1] on its R rows, lives
//    in shared memory for the whole cycle.  Only the full unnormalised w of
//    a step goes through global memory; the next step's load scales it by
//    1/hn, so the norm's barrier is also "V[j+1] complete".  CGS2's dots and
//    subtractions run over shared memory on all threads.
//  * Three barriers a step (two projections and the norm), per side, not
//    grid-wide: each block writes its partial sums, then one thread makes a
//    release add on the side's counter; a block waits with acquire loads
//    until the counter reaches G times the barrier's number, then sums the
//    G partials of each k in a fixed order (four threads a k).
//  * The Givens block of a side reads the same partials after the same
//    barriers, rotates the Hessenberg column, keeps R, cs, sn and g in its
//    shared memory and runs the back substitution; the row blocks never wait
//    for it until they need y at the end of a cycle.
//
// Shared memory of a row block (complex64 = 8 B):
//   res x N (resident P rows) + N (v) + R x m (V slice) + 2R (w, x)
//   + (m + 1) (projection) + 256 (reduction scratch) + an mbarrier;
//   at (N, m, R) = (1408, 80, 22) with res = 18: 231,152 of 232,448 B,
//   4 rows streamed.
// Of the Givens block: ((m+1)^2 + 5(m+1) + 256) x 8 B + 4(m+1) B.  A
// launch asks for the larger of the two.
//
// Layout (all contiguous, complex64 = float2):
//   P     [sides, N, N]          row-major operators
//   b     [sides, N]             right-hand sides
//   x     [sides, N]             solutions (output)
//   W     [sides, m+1, N]        unnormalised Krylov vectors (scratch)
//   part  [sides, 2, T, G]       projection partials, T = m(m+1)/2: step j,
//                                coefficient k at j(j+1)/2 + k (scratch)
//   pn    [sides, m+1, G] float  norm partials of W[j] (scratch)
//   y     [sides, m+1]           least-squares solution (scratch)
//   sync  [sides, 64] int32      zeroed by the caller: barrier counter at
//                                [side, 0], y counter at [side, 32]
#include <cuda_runtime.h>
#include <cstdint>

// stamp points of tools/k2_step_profile.py: empty unless it defines them
#ifndef K2_PROFILE_HOOKS
#define K2_MARK()
#define K2_STEP(j, m)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1408;                  // FUSED_MAX_DIM padded to 128
constexpr int kMaxQ = kMaxN / 64;            // float4 of a row per lane
constexpr int kVPerThread = (kMaxN + kThreads - 1) / kThreads;
constexpr int kMaxG = 132;                   // row blocks of a side, at most
constexpr int kMaxSplit = 8;                 // thread groups of a reduction
constexpr int kChunk = 24;                   // loads of a thread in flight
constexpr int kRowGroup = 8;                 // threads a row, subtractions
constexpr size_t kSmemMax = 232448;          // dynamic shared memory, H100
constexpr float kTiny = 1e-37f;

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

// two complex products of a row segment, accumulated into (ar, ai)
__device__ __forceinline__ void cfma2(float4 p, float4 v, float& ar,
                                      float& ai)
{
    ar = fmaf(p.x, v.x, ar);
    ar = fmaf(-p.y, v.y, ar);
    ai = fmaf(p.x, v.y, ai);
    ai = fmaf(p.y, v.x, ai);
    ar = fmaf(p.z, v.z, ar);
    ar = fmaf(-p.w, v.w, ar);
    ai = fmaf(p.z, v.w, ai);
    ai = fmaf(p.w, v.z, ai);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
}

// bytes (a multiple of 16) from global to own shared memory, completing
// on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier"
                 "::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar)) : "memory");
}

// every thread's writes so far, then one release add on the counter
__device__ __forceinline__ void arrive(int* ctr)
{
    __syncthreads();
    if (threadIdx.x == 0)
        asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n"
                     :: "l"(ctr) : "memory");
}

// thread 0 waits (acquire) until the counter reaches `target`; then the
// block; the data it guards is read with ld.global.cg (L2)
__device__ __forceinline__ void wait_for(const int* ctr, int target)
{
    if (threadIdx.x == 0) {
        int v;
        do {
            asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                         : "=r"(v) : "l"(ctr) : "memory");
        } while (v < target);
    }
    __syncthreads();
}

// sum over the side's G norm partials, in a fixed order (every warp gets
// the same value)
__device__ __forceinline__ float sum_norm(const float* pn, int G)
{
    const int lane = threadIdx.x & 31;
    float s = 0.f;
    for (int g = lane; g < G; g += 32)
        s += __ldcg(pn + g);
    return warp_sum(make_float2(s, 0.f)).x;
}

// threads per coefficient of a reduction over nk coefficients: as many
// groups of nk threads as the block holds, at most kMaxSplit
__device__ __forceinline__ int split(int nk)
{
    return min(kMaxSplit, kThreads / nk);
}

// h[k] = sum over g of pp[g * nk + k] (block g's nk partials side by
// side), k < nk <= kThreads, in a fixed order: thread group s sums the
// blocks of its range in order (all loads of a chunk issued first), then
// thread k adds the groups' sums in order.  `red` holds kThreads values.
__device__ void sum_partials(const float2* pp, int nk, int G, float2* red,
                             float2* h)
{
    const int ns = split(nk);
    const int per = (G + ns - 1) / ns;
    const int k = threadIdx.x % nk;
    const int grp = threadIdx.x / nk;
    if (grp < ns) {
        const int g1 = min(G, (grp + 1) * per);
        float2 acc = make_float2(0.f, 0.f);
        for (int c = grp * per; c < g1; c += kChunk) {
            float2 v[kChunk];
#pragma unroll
            for (int i = 0; i < kChunk; ++i)
                v[i] = c + i < g1 ? __ldcg(pp + (size_t)(c + i) * nk + k)
                                  : make_float2(0.f, 0.f);
#pragma unroll
            for (int i = 0; i < kChunk; ++i) {
                acc.x += v[i].x;
                acc.y += v[i].y;
            }
        }
        red[grp * nk + k] = acc;
    }
    __syncthreads();
    if (threadIdx.x < nk) {
        float2 acc = red[k];
        for (int g = 1; g < ns; ++g) {
            acc.x += red[g * nk + k].x;
            acc.y += red[g * nk + k].y;
        }
        h[k] = acc;
    }
}

size_t row_smem(int N, int m, int R, int res)
{
    return ((size_t)res * N + N + (size_t)R * m + 2 * R + (m + 1)
            + kThreads) * sizeof(float2) + sizeof(uint64_t);
}

size_t givens_smem(int m)
{
    const size_t m1 = (size_t)m + 1;
    return (m1 * m1 + 5 * m1 + kThreads) * sizeof(float2)
        + m1 * sizeof(float);
}

struct Args {
    const float2* P;
    const float2* b;
    float2* x;
    float2* W;
    float2* part;
    float* pn;
    float2* y;
    int* sync;
    int N, m, cycles, G, R, res;
};

// the vector w of the rows [r0, r0 + nrows) of one side: P rows as
// resident (shared memory) or streamed (row s < kWarps prefetched into `pf`
// by warp s; rows past kWarps, on cards of fewer SMs, read from L2 here by
// warp s % kWarps), v in shared memory; a warp takes up to three resident
// rows at once, so that it reads v once for them
__device__ __forceinline__ void matvec(const float2* Pres, const float2* Pstr,
                                       const float2* vsh, float2* wsh,
                                       const float4 (&pf)[kMaxQ], int N,
                                       int nres, int nstr)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nq = N / 64;
    const float4* v4 = reinterpret_cast<const float4*>(vsh);
    if (warp < nstr) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxQ; ++t)
            if (t < nq)
                cfma2(pf[t], v4[lane + 32 * t], ar, ai);
        const float2 s = warp_sum(make_float2(ar, ai));
        if (lane == 0)
            wsh[nres + warp] = s;
    }
    for (int s = warp + kWarps; s < nstr; s += kWarps) {
        const float4* p4 = reinterpret_cast<const float4*>(
            Pstr + (size_t)s * N) + lane;
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxQ; ++t)
            if (t < nq)
                cfma2(__ldg(p4 + 32 * t), v4[lane + 32 * t], ar, ai);
        const float2 sum = warp_sum(make_float2(ar, ai));
        if (lane == 0)
            wsh[nres + s] = sum;
    }
    // resident row i goes to warp (nstr + i) % kWarps
    for (int i = ((warp - nstr) % kWarps + kWarps) % kWarps; i < nres;
         i += 3 * kWarps) {
        const bool hb = i + kWarps < nres, hc = i + 2 * kWarps < nres;
        const float4* pa = reinterpret_cast<const float4*>(
            Pres + (size_t)i * N) + lane;
        const float4* pb = pa + (size_t)kWarps * N / 2;
        const float4* pc = pb + (size_t)kWarps * N / 2;
        float ar[3] = {0.f, 0.f, 0.f}, ai[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < kMaxQ; ++t)
            if (t < nq) {
                const float4 v = v4[lane + 32 * t];
                cfma2(pa[32 * t], v, ar[0], ai[0]);
                if (hb)
                    cfma2(pb[32 * t], v, ar[1], ai[1]);
                if (hc)
                    cfma2(pc[32 * t], v, ar[2], ai[2]);
            }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float2 s = warp_sum(make_float2(ar[q], ai[q]));
            if (lane == 0 && (q == 0 || (q == 1 && hb) || (q == 2 && hc)))
                wsh[i + q * kWarps] = s;
        }
    }
}

__device__ __forceinline__ void prefetch(float4 (&pf)[kMaxQ],
                                         const float2* row, int N, int nstr)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (warp < nstr) {
        const float4* r4 = reinterpret_cast<const float4*>(
            row + (size_t)warp * N);
        const int nq = N / 64;
#pragma unroll
        for (int t = 0; t < kMaxQ; ++t)
            if (t < nq)
                pf[t] = __ldg(r4 + lane + 32 * t);
    }
}

// w[r] -= sum_{k < nk} c[k] V[k, r] on the block's rows (or, with
// `accumulate`, x[r] += the sum): kRowGroup threads a row, each summing
// every kRowGroup-th k, then a butterfly over the group
__device__ __forceinline__ void combine_rows(const float2* Vsl, int m,
                                            const float2* c, int nk,
                                            float2* out, int nrows,
                                            bool accumulate)
{
    const int sub = threadIdx.x % kRowGroup;
    for (int r0 = 0; r0 < nrows; r0 += kThreads / kRowGroup) {
        const int r = r0 + threadIdx.x / kRowGroup;
        float2 s = make_float2(0.f, 0.f);
        if (r < nrows)
            for (int k = sub; k < nk; k += kRowGroup) {
                const float2 t = cmul(c[k], Vsl[(size_t)r * m + k]);
                s.x += t.x;
                s.y += t.y;
            }
#pragma unroll
        for (int o = kRowGroup / 2; o > 0; o >>= 1) {
            s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
            s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
        }
        if (sub == 0 && r < nrows)
            out[r] = accumulate
                ? make_float2(out[r].x + s.x, out[r].y + s.y)
                : make_float2(out[r].x - s.x, out[r].y - s.y);
    }
}

// one classical Gram-Schmidt projection of the block's w rows against
// V[0..j]: partials of h[k] = sum_i conj(V[k,i]) w[i] over the block's
// rows -> pp[gb * (j+1) + k] (groups of threads over the rows, added in
// order), the side's barrier, the fixed-order sums, w -= sum_k h[k] V[k, :]
__device__ __forceinline__ void project(const Args& a, const float2* Vsl,
                                        float2* wsh, float2* h, float2* red,
                                        float2* pp, int j, int nrows, int gb,
                                        int* ctr, int& ev)
{
    const int m = a.m;
    const int nk = j + 1;
    const int ns = split(nk);
    const int k = threadIdx.x % nk;
    const int part = threadIdx.x / nk;
    if (part < ns) {
        float2 acc = make_float2(0.f, 0.f);
        for (int r = part; r < nrows; r += ns) {
            const float2 t = cmul_conj(Vsl[(size_t)r * m + k], wsh[r]);
            acc.x += t.x;
            acc.y += t.y;
        }
        red[part * nk + k] = acc;
    }
    __syncthreads();
    if (threadIdx.x < nk) {
        float2 acc = red[k];
        for (int q = 1; q < ns; ++q) {
            acc.x += red[q * nk + k].x;
            acc.y += red[q * nk + k].y;
        }
        pp[(size_t)gb * nk + k] = acc;
    }
    K2_MARK();
    arrive(ctr);
    wait_for(ctr, ++ev * a.G);
    K2_MARK();
    sum_partials(pp, nk, a.G, red, h);
    __syncthreads();
    K2_MARK();
    combine_rows(Vsl, m, h, nk, wsh, nrows, false);
    __syncthreads();
    K2_MARK();
}

// W[jv] <- the block's w rows, pn[jv] <- their |w|^2 partial; arrive
__device__ __forceinline__ void publish_w(const Args& a, const float2* wsh,
                                          float2* Ws, float* pns, int jv,
                                          int r0, int nrows, int gb,
                                          int* ctr, int& ev)
{
    const int tid = threadIdx.x;
    for (int r = tid; r < nrows; r += kThreads)
        Ws[(size_t)jv * a.N + r0 + r] = wsh[r];
    if (tid < 32) {
        float s = 0.f;
        for (int r = tid; r < nrows; r += 32) {
            const float2 w = wsh[r];
            s = fmaf(w.x, w.x, fmaf(w.y, w.y, s));
        }
        s = warp_sum(make_float2(s, 0.f)).x;
        if (tid == 0)
            pns[(size_t)jv * a.G + gb] = s;
    }
    arrive(ctr);
    ++ev;
}

__device__ void row_block(const Args& a, unsigned char* smem, int side,
                          int gb)
{
    const int N = a.N, m = a.m, G = a.G, R = a.R;
    const int r0 = gb * R;
    const int nrows = min(R, N - r0);
    const int nres = min(nrows, a.res);
    const int nstr = nrows - nres;
    const int tid = threadIdx.x;

    float2* Pres = reinterpret_cast<float2*>(smem);      // [res, N]
    float2* vsh = Pres + (size_t)a.res * N;               // [N]
    float2* Vsl = vsh + N;                                // [R, m]
    float2* wsh = Vsl + (size_t)R * m;                    // [R]
    float2* xsh = wsh + R;                                // [R]
    float2* h = xsh + R;                                  // [m + 1]
    float2* red = h + m + 1;                              // [kThreads]
    uint64_t* bar = reinterpret_cast<uint64_t*>(red + kThreads);

    const float2* Ps = a.P + (size_t)side * N * N;
    const float2* bs = a.b + (size_t)side * N;
    float2* xs = a.x + (size_t)side * N;
    float2* Ws = a.W + (size_t)side * (m + 1) * N;
    const size_t T = (size_t)m * (m + 1) / 2;
    float2* p1 = a.part + (size_t)side * 2 * T * G;
    float2* p2 = p1 + T * G;
    float* pns = a.pn + (size_t)side * (m + 1) * G;
    const float2* ys = a.y + (size_t)side * (m + 1);
    int* ctr = a.sync + side * 64;
    const int* yctr = ctr + 32;

    if (tid == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        // the resident rows, once per launch
        const uint32_t bytes = (uint32_t)N * sizeof(float2);
        mbar_expect_tx(bar, bytes * nres);
        for (int r = 0; r < nres; ++r)
            bulk_load(Pres + (size_t)r * N, Ps + (size_t)(r0 + r) * N, bytes,
                      bar);
    }
    const float2* streamed = Ps + (size_t)(r0 + nres) * N;
    float4 pf[kMaxQ];
    int ev = 0;                      // barriers of this side passed

    for (int cyc = 0; cyc < a.cycles; ++cyc) {
        // r = b - P x (x = 0 on the first cycle)
        if (cyc == 0) {
            for (int r = tid; r < nrows; r += kThreads)
                wsh[r] = bs[r0 + r];
        } else {
            prefetch(pf, streamed, N, nstr);
            arrive(ctr);                                  // x complete
            wait_for(ctr, ++ev * G);
            for (int q = tid; q < N; q += kThreads)
                vsh[q] = __ldcg(xs + q);
            __syncthreads();
            matvec(Pres, streamed, vsh, wsh, pf, N, nres, nstr);
            __syncthreads();
            for (int r = tid; r < nrows; r += kThreads) {
                const float2 bi = bs[r0 + r];
                wsh[r] = make_float2(bi.x - wsh[r].x, bi.y - wsh[r].y);
            }
            __syncthreads();
        }
        publish_w(a, wsh, Ws, pns, 0, r0, nrows, gb, ctr, ev);

        for (int j = 0; j < m; ++j) {
            K2_STEP(j, m);
            K2_MARK();
            prefetch(pf, streamed, N, nstr);
            K2_MARK();
            wait_for(ctr, ev * G);                        // W[j] complete
            K2_MARK();
            float2 wv[kVPerThread];                       // loads first
#pragma unroll
            for (int t = 0; t < kVPerThread; ++t) {
                const int q = tid + t * kThreads;
                wv[t] = q < N ? __ldcg(Ws + (size_t)j * N + q)
                              : make_float2(0.f, 0.f);
            }
            const float hn = sqrtf(fmaxf(sum_norm(pns + (size_t)j * G, G),
                                         kTiny));
#pragma unroll
            for (int t = 0; t < kVPerThread; ++t) {
                const int q = tid + t * kThreads;
                const float2 v = make_float2(wv[t].x / hn, wv[t].y / hn);
                if (q < N)
                    vsh[q] = v;
                const int r = q - r0;
                if (r >= 0 && r < nrows)
                    Vsl[(size_t)r * m + j] = v;
            }
            __syncthreads();
            K2_MARK();
            mbar_wait(bar, 0);                            // resident rows
            matvec(Pres, streamed, vsh, wsh, pf, N, nres, nstr);
            __syncthreads();
            K2_MARK();
            const size_t tj = (size_t)j * (j + 1) / 2 * G;
            project(a, Vsl, wsh, h, red, p1 + tj, j, nrows, gb, ctr, ev);
            project(a, Vsl, wsh, h, red, p2 + tj, j, nrows, gb, ctr, ev);
            publish_w(a, wsh, Ws, pns, j + 1, r0, nrows, gb, ctr, ev);
            K2_MARK();
        }
        K2_STEP(-1, m);

        // x += V y on the owned rows, once the side's Givens block has y
        wait_for(yctr, cyc + 1);
        for (int k = tid; k < m; k += kThreads)
            h[k] = __ldcg(ys + k);
        __syncthreads();
        if (cyc == 0)
            for (int r = tid; r < nrows; r += kThreads)
                xsh[r] = make_float2(0.f, 0.f);
        __syncthreads();
        combine_rows(Vsl, m, h, m, xsh, nrows, true);
        __syncthreads();
        for (int r = tid; r < nrows; r += kThreads)
            xs[r0 + r] = xsh[r];
    }
}

// the side's Givens block: reads every projection and norm after its
// barrier, rotates the Hessenberg columns, solves for y
__device__ void givens_block(const Args& a, unsigned char* smem, int side)
{
    const int m = a.m, G = a.G;
    const int m1 = m + 1;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float2* Ht = reinterpret_cast<float2*>(smem);   // Ht[j, k] = R[k, j]
    float2* h1 = Ht + (size_t)m1 * m1;
    float2* h2 = h1 + m1;
    float2* gv = h2 + m1;
    float2* sn = gv + m1;
    float2* yv = sn + m1;
    float2* red = yv + m1;                          // [kThreads]
    float* cs = reinterpret_cast<float*>(red + kThreads);

    const size_t T = (size_t)m * m1 / 2;
    const float2* p1 = a.part + (size_t)side * 2 * T * G;
    const float2* p2 = p1 + T * G;
    const float* pns = a.pn + (size_t)side * m1 * G;
    float2* ys = a.y + (size_t)side * m1;
    int* ctr = a.sync + side * 64;
    int* yctr = ctr + 32;
    int ev = 0;

    for (int cyc = 0; cyc < a.cycles; ++cyc) {
        if (cyc > 0)
            ++ev;                                 // x complete (rows only)
        wait_for(ctr, ++ev * G);                  // W[0] complete
        const float beta = sqrtf(fmaxf(sum_norm(pns, G), kTiny));
        // zeroed scratch: the back substitution reads all of Ht
        for (int q = tid; q < m1 * m1; q += kThreads)
            Ht[q] = make_float2(0.f, 0.f);
        for (int q = tid; q < m1; q += kThreads) {
            gv[q] = make_float2(q == 0 ? beta : 0.f, 0.f);
            sn[q] = make_float2(0.f, 0.f);
            cs[q] = 0.f;
        }
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const size_t tj = (size_t)j * (j + 1) / 2 * G;
            K2_STEP(j, m);
            K2_MARK();
            wait_for(ctr, ++ev * G);
            K2_MARK();
            sum_partials(p1 + tj, j + 1, G, red, h1);
            K2_MARK();
            wait_for(ctr, ++ev * G);
            K2_MARK();
            sum_partials(p2 + tj, j + 1, G, red, h2);
            K2_MARK();
            wait_for(ctr, ++ev * G);
            K2_MARK();
            const float hn = sqrtf(fmaxf(
                sum_norm(pns + (size_t)(j + 1) * G, G), kTiny));
            __syncthreads();
            K2_MARK();
            if (tid == 0) {
                // Hessenberg column j (h1 + h2, then hn), rotated by the
                // rotations 0..j-1; the entry the chain carries stays in
                // registers, the loads do not depend on it
                float2* col = Ht + (size_t)j * m1;
                const float2* __restrict__ c1 = h1;
                const float2* __restrict__ c2 = h2;
                float2 u = make_float2(c1[0].x + c2[0].x, c1[0].y + c2[0].y);
#pragma unroll 4
                for (int k = 0; k < j; ++k) {
                    const float c = cs[k];
                    const float2 s = sn[k];
                    const float2 bb = make_float2(c1[k + 1].x + c2[k + 1].x,
                                                  c1[k + 1].y + c2[k + 1].y);
                    col[k] = make_float2(c * u.x + s.x * bb.x - s.y * bb.y,
                                         c * u.y + s.x * bb.y + s.y * bb.x);
                    u = make_float2(-(s.x * u.x + s.y * u.y) + c * bb.x,
                                    -(s.x * u.y - s.y * u.x) + c * bb.y);
                }
                // new rotation zeroing col[j+1]
                const float2 bb = make_float2(hn, 0.f);
                const float a2 = u.x * u.x + u.y * u.y;
                const float absa = sqrtf(fmaxf(a2, 0.f));
                const float den = sqrtf(fmaxf(
                    a2 + bb.x * bb.x + bb.y * bb.y, kTiny));
                const float c = (den == 0.f) ? 1.f : absa / den;
                const float safe = (absa == 0.f) ? 1.f : absa;
                const float phr = (absa == 0.f) ? 1.f : u.x / safe;
                const float phi = (absa == 0.f) ? 0.f : u.y / safe;
                const float2 s = make_float2((phr * bb.x + phi * bb.y) / den,
                                             (phi * bb.x - phr * bb.y) / den);
                cs[j] = c;
                sn[j] = s;
                col[j] = make_float2(c * u.x + s.x * bb.x - s.y * bb.y,
                                     c * u.y + s.x * bb.y + s.y * bb.x);
                col[j + 1] = make_float2(0.f, 0.f);
                const float2 gj = gv[j];
                gv[j + 1] = make_float2(-(s.x * gj.x + s.y * gj.y),
                                        -(s.x * gj.y - s.y * gj.x));
                gv[j] = make_float2(c * gj.x, c * gj.y);
            }
            __syncthreads();
            K2_MARK();
        }
        K2_STEP(-1, m);
        // back substitution y_i = (g_i - sum_{c>i} R[i,c] y_c) / R[i,i]
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
                    const float d2 = fmaxf(d.x * d.x + d.y * d.y, kTiny);
                    yv[i] = make_float2((num.x * d.x + num.y * d.y) / d2,
                                        (num.y * d.x - num.x * d.y) / d2);
                }
                __syncwarp();
            }
            for (int k = lane; k < m1; k += 32)
                ys[k] = yv[k];
        }
        arrive(yctr);                                     // y complete
    }
}

// blocks [0, sides * G) are the row blocks (side-major), then one Givens
// block per side
__global__ void __launch_bounds__(kThreads, 1)
dense_gmres_kernel(const Args a)
{
    extern __shared__ __align__(128) unsigned char smem[];
    K2_STEP(-1, a.m);
    const int sides = gridDim.x / (a.G + 1);
    if ((int)blockIdx.x < sides * a.G)
        row_block(a, smem, blockIdx.x / a.G, blockIdx.x % a.G);
    else
        givens_block(a, smem, blockIdx.x - sides * a.G);
}

}  // namespace

// The launch plan (G, R, res) comes from ops/dense_gmres.py :: plan; this
// checks it against what the kernel takes.  `sync` must be zeroed.
extern "C" int dense_gmres_c64(const void* P, const void* b, void* x, void* W,
                               void* part, void* pn, void* y, void* sync,
                               int sides, int N, int m, int cycles, int G,
                               int R, int res, void* cuda_stream)
{
    if (sides < 1 || m < 1 || m >= kThreads || cycles < 1 || N < 128
        || N % 128 != 0
        || N > kMaxN || G < 1 || G > kMaxG || R < 1 || (G - 1) * R >= N
        || G * R < N || res < 1 || res > R)
        return (int)cudaErrorInvalidValue;
    const size_t rs = row_smem(N, m, R, res);
    const size_t gs = givens_smem(m);
    const size_t smem = rs > gs ? rs : gs;
    if (smem > kSmemMax)
        return (int)cudaErrorInvalidValue;
    static size_t smem_set = 0;       // the attribute this process set last
    if (smem != smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            dense_gmres_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess)
            return (int)e;
        smem_set = smem;
    }
    Args a;
    a.P = (const float2*)P;
    a.b = (const float2*)b;
    a.x = (float2*)x;
    a.W = (float2*)W;
    a.part = (float2*)part;
    a.pn = (float*)pn;
    a.y = (float2*)y;
    a.sync = (int*)sync;
    a.N = N;
    a.m = m;
    a.cycles = cycles;
    a.G = G;
    a.R = R;
    a.res = res;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sides * (G + 1));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)cuda_stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, dense_gmres_kernel, a);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* dense_gmres_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
