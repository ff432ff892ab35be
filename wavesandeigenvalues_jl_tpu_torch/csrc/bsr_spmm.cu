// Block-sparse-row SpMM  Y[row] = sum_k blocks[row, k] @ X[cols[row, k]],
// on the nonzeros of the blocks only.
//
// Replaces the Pallas TPU kernel
//   wavesandeigenvalues_jl_tpu/ops/pallas_spmv.py :: _bsr_spmm_kernel
// (built by _bsr_spmm_jit, wrapped by PallasBsrSpmm): the operator apply
// Y = L(w) X of a Cuthill-McKee-reordered family on a panel of r right-hand
// sides, one program per block row.
//
// Layout (complex64 = float2, all contiguous; built by ops/bsr_spmm.pack):
//   row_ptr    [nbr * bs + 1] int32  start of each (padded) row's nonzeros
//   lcol       [nnz] int32           local column slot * bs + j: column j of
//                                    the block in slot `slot` of the row's
//                                    block row; ascending within a row
//   vals       [nnz] complex64       the nonzero values
//   block_cols [nbr, maxb] int32     block column of each slot; the real
//                                    slots come first with ascending
//                                    columns, padding slots repeat column 0
//                                    and own no nonzeros
//   X          [nb, bs, r]           right-hand-side panel in block rows
//   Y          [nbr, bs, r]          output; rows without nonzeros get 0
// r is a multiple of 32; X and Y are 16-byte aligned.  Sums are float32
// complex FMAs: no TF32, no tensor cores.
//
// What bounds it on this card: bytes.  Complex64 has no tensor-core route
// without TF32, and at the 7,259-DOF operator the blocks are about 4 %
// full, so the padded block product (2.84 GFLOP at bs 128, r 128) would
// cost more than the whole byte bound.  The work the product needs is
// 8 flops per nonzero and column (0.110 GFLOP); the bytes are each nonzero's
// value and column once, row_ptr and block_cols once, X once and Y once
// (about 16 MB, 0.005 ms at 3.35 TB/s).
//
// Design: one thread block of 512 threads per (block row, 32-column tile
// of the panel), and no stored zero is ever read.  The block stages the
// X window of its block row, the [bs, 32] slices of its real slots picked
// by block_cols, in dynamic shared memory: every slot's cp.async copies
// are issued at once and each slot completes on its own mbarrier, so a
// warp starts the FMAs of a row as soon as the slots that row reads have
// landed, while the later slots are still in flight.  (A ring of two
// slot buffers, tried first, had to keep each row's sums and cursor in
// registers across the slots: 123 registers, one 16-warp block per SM,
// and a row's ~15 nonzeros cut into three short pieces; it ran slower
// at the 7,259-DOF operator.)  A window wider than shared memory (more
// than `pass_slots` slots: 7 at bs 128, 14 at bs 64, 28 at bs 32) is
// staged in passes of pass_slots slots; a row's cursor waits in shared
// memory between passes and the later passes add to the Y the first one
// wrote.  Each warp takes rows w, w + 16, ...
// of the block row; it loads 32 (lcol, val) pairs of a row at a time, one
// per lane, and broadcasts them by shuffle, the lower half-warp taking the
// even ones and the upper half the odd ones, two at a time each, so the
// warp never diverges.  lcol indexes the staged window directly.  Each
// lane owns 2 neighbouring complex columns: one 16-byte shared-memory
// read per nonzero; the halves' sums meet by shuffle and the lower half
// writes the row with 16-byte stores.
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;                // complex columns of a tile
constexpr int kRowF4 = kTileCols / 2;        // float4 of one staged row
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxPassSlots = 32;         // bits of a warp's landed mask
constexpr int kSmemMax = 232448;          // dynamic shared memory, H100

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

// wait until every thread's copies of the slot behind `bar` have landed
// (the barrier's phase of parity `parity`: one phase per pass)
__device__ __forceinline__ void slot_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
}

__device__ __forceinline__ void cfma(float2& acc, float ar, float ai,
                                     float xr, float xi)
{
    acc.x = fmaf(ar, xr, fmaf(-ai, xi, acc.x));
    acc.y = fmaf(ar, xi, fmaf(ai, xr, acc.y));
}

// acc += v * (the lane's two columns of window row c), for batch entry i
// of the warp's (c, v) pairs if i < n
__device__ __forceinline__ void take(float2& a0, float2& a1,
                                     const float4* xs, int c, float2 v,
                                     int i, int n, int l)
{
    const int ci = __shfl_sync(kAll, c, i & 31);
    const float vr = __shfl_sync(kAll, v.x, i & 31);
    const float vi = __shfl_sync(kAll, v.y, i & 31);
    if (i < n) {
        const float4 x = xs[ci * kRowF4 + l];
        cfma(a0, vr, vi, x.x, x.y);
        cfma(a1, vr, vi, x.z, x.w);
    }
}

template <int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ lcol,
                const float2* __restrict__ vals,
                const int* __restrict__ block_cols,
                const float2* __restrict__ X, float2* __restrict__ Y,
                int maxb, int r, int pass_slots)
{
    constexpr int kSlotF4 = BS * kRowF4;     // float4 of one staged slot
    constexpr int kRows = BS / kWarps;       // rows of one warp
    constexpr int kNone = 0x7fffffff;        // lcol of an empty lane
    extern __shared__ float4 xs[];           // [pass_slots][BS][kRowF4]
    uint64_t* full = reinterpret_cast<uint64_t*>(xs + pass_slots * kSlotF4);
    int* cursor = reinterpret_cast<int*>(full + pass_slots);   // [BS]

    const int br = blockIdx.x;
    const int c0 = blockIdx.y * kTileCols;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int half = lane >> 4;              // takes entries half, half+2..
    const int l = lane & 15;                 // owns columns 2l, 2l + 1
    const int wp = tid >> 5;
    const int* bc = block_cols + (size_t)br * maxb;

    // real slots lead with ascending block columns; the rest is padding
    int nslots = 1;
    while (nslots < maxb && bc[nslots] > bc[nslots - 1])
        ++nslots;
    if (tid == 0)
        for (int k = 0; k < min(nslots, pass_slots); ++k)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_addr(full + k)), "r"(kThreads)
                         : "memory");
    __syncthreads();
    for (int k0 = 0, pass = 0; k0 < nslots; k0 += pass_slots, ++pass) {
        const int k1 = min(nslots, k0 + pass_slots);
        const uint32_t parity = pass & 1;
        if (pass > 0)
            __syncthreads();                 // the last window is read
        // every slot of the pass in flight at once, each on its barrier
        for (int k = k0; k < k1; ++k) {
            const float2* src = X + (size_t)bc[k] * BS * r + c0;
            float4* dst = xs + (k - k0) * kSlotF4;
            for (int e = tid; e < kSlotF4; e += kThreads)
                cp_async16(dst + e,
                           src + (size_t)(e / kRowF4) * r + 2 * (e % kRowF4));
            asm volatile(
                "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                :: "r"(smem_addr(full + (k - k0))) : "memory");
        }

        const int lo = k0 * BS, hi = k1 * BS;    // lcol range of the pass
        unsigned landed = 0;                     // slots this warp saw land
        for (int t = 0; t < kRows; ++t) {
            const int lr = wp + t * kWarps;      // row in the block row
            const int row = br * BS + lr;
            const int end = __ldg(row_ptr + row + 1);
            int p = pass == 0 ? __ldg(row_ptr + row) : cursor[lr];
            float2 a0 = make_float2(0.f, 0.f), a1 = a0, b0 = a0, b1 = a0;
            while (p < end) {
                const int q = p + lane;
                const int c = q < end ? __ldg(lcol + q) : kNone;
                const float2 v = q < end ? __ldg(vals + q)
                                         : make_float2(0.f, 0.f);
                // this pass's entries of the batch: a prefix, lcol ascends
                const int n = __popc(__ballot_sync(kAll, c < hi));
                if (n == 0)
                    break;
                // the slots this batch reads: from its first to its last
                const int klo = __shfl_sync(kAll, c, 0) / BS - k0;
                const int khi = __shfl_sync(kAll, c, n - 1) / BS - k0;
                for (int k = klo; k <= khi; ++k)
                    if (!(landed >> k & 1u)) {
                        slot_wait(full + k, parity);
                        landed |= 1u << k;
                    }
                const int cl = c - lo;           // row of the staged window
                for (int j = 0; j < n; j += 4) { // two chains per half-warp
                    take(a0, a1, xs, cl, v, j + half, n, l);
                    take(b0, b1, xs, cl, v, j + 2 + half, n, l);
                }
                p += n;
                if (n < 32)
                    break;
            }
            if (k1 < nslots && lane == 0)
                cursor[lr] = p;                  // where the next pass starts
            float4 y = make_float4(a0.x + b0.x, a0.y + b0.y, a1.x + b1.x,
                                   a1.y + b1.y);
            y.x += __shfl_xor_sync(kAll, y.x, 16);
            y.y += __shfl_xor_sync(kAll, y.y, 16);
            y.z += __shfl_xor_sync(kAll, y.z, 16);
            y.w += __shfl_xor_sync(kAll, y.w, 16);
            if (half == 0) {
                float4* out = reinterpret_cast<float4*>(
                    Y + (size_t)row * r + c0) + l;
                if (pass > 0) {
                    const float4 o = *out;
                    y.x += o.x; y.y += o.y; y.z += o.z; y.w += o.w;
                }
                *out = y;
            }
        }
        // no pass ends, and no block leaves, with copies still landing
        for (int k = 0; k < k1 - k0; ++k)
            if (!(landed >> k & 1u))
                slot_wait(full + k, parity);
    }
}

template <int BS>
int launch(const int* row_ptr, const int* lcol, const float2* vals,
           const int* block_cols, const float2* X, float2* Y, int nbr,
           int maxb, int r, cudaStream_t st)
{
    // as many slots as fit beside the barriers and the row cursors
    constexpr int kSlotBytes = BS * kTileCols * (int)sizeof(float2)
        + (int)sizeof(uint64_t);
    const int pass_slots = std::min({maxb, kMaxPassSlots,
                                     (kSmemMax - BS * (int)sizeof(int))
                                     / kSlotBytes});
    const int smem = pass_slots * kSlotBytes + BS * (int)sizeof(int);
    static int smem_set = 0;          // the largest this process allowed
    if (smem > smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            bsr_spmm_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess)
            return (int)e;
        smem_set = smem;
    }
    const dim3 grid(nbr, r / kTileCols);
    bsr_spmm_kernel<BS><<<grid, kThreads, smem, st>>>(
        row_ptr, lcol, vals, block_cols, X, Y, maxb, r, pass_slots);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bsr_spmm_c64(const void* row_ptr, const void* lcol,
                            const void* vals, const void* block_cols,
                            const void* X, void* Y, int nbr, int maxb,
                            int bs, int r, void* cuda_stream)
{
    if (r < kTileCols || r % kTileCols != 0 || nbr < 1 || maxb < 1)
        return (int)cudaErrorInvalidValue;
    const int* rp = (const int*)row_ptr;
    const int* lc = (const int*)lcol;
    const float2* v = (const float2*)vals;
    const int* bc = (const int*)block_cols;
    const float2* x = (const float2*)X;
    float2* y = (float2*)Y;
    const cudaStream_t st = (cudaStream_t)cuda_stream;
    switch (bs) {
    case 32:
        return launch<32>(rp, lc, v, bc, x, y, nbr, maxb, r, st);
    case 64:
        return launch<64>(rp, lc, v, bc, x, y, nbr, maxb, r, st);
    case 128:
        return launch<128>(rp, lc, v, bc, x, y, nbr, maxb, r, st);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* bsr_spmm_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
