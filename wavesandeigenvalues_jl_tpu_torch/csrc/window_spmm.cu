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
// and float32 sums.  K4 streamed X once through a sliding VMEM window;
// this kernel does the same in each SM's shared memory, from the
// compressed rows themselves.
//
// Layout (complex64 = float2, all contiguous):
//   indptr  [n_rows + 1] int32  row starts
//   slots   [nnz] int32         ring row of each nonzero's X row
//                               (col % kRingRows), or -1 - col for a
//                               nonzero outside its tile's window
//   vals    [nnz] complex64     value of each nonzero
//   tiles   [n_tiles] int2      (far, near): the last stage of its range's
//                               stream a tile reads (-1 without nonzeros),
//                               the first one it or a later tile reads
//   streams [n_ranges] int2     (first X stage, stages) of each range
//   order   [n_tiles * 128]     the rows each warp takes (-1 past the end)
//   X       [n_cols, r]         panel, read through a TMA tensor map
//   Y       [n_rows, r]         output
// ops/window_spmm.plan makes slots, tiles, streams and order once per
// structure.  r is a multiple of 4; X and Y are 16-byte aligned.  Sums are
// float32 complex FMAs in the order of the row's nonzeros (a nonzero
// outside the window after the others): no TF32 and no tensor cores (a
// tile of A is about 2 % full; the work is bound by bytes).
//
// What bounds it, at the main path's 57,210 DOF, 819,730 nonzeros and
// r = 128: bytes.  vals 6.56 MB, cols 3.28 MB, indptr 0.23 MB, X read once
// 58.59 MB and Y written once 58.59 MB, 127.2 MB in all, 0.0380 ms at
// 3.35 TB/s; the 8 nnz r = 0.839 GFLOP take 0.0125 ms at 67 TFLOP/s.  A
// gather of a whole X row per nonzero (the warp-per-row design this one
// replaced) moves 0.84 GB through L1 and L2 instead.
//
// Design: X streams from HBM about once, through shared memory.
//  * A block owns a column chunk of kChunk = 16 complex columns (128 B of
//    an X row; r = 260 ends on a ragged chunk of 4, r < 16 is one chunk of
//    r) and a range of kTileRows-row tiles.  The plan picks the number of
//    ranges so that chunks x ranges blocks fill the SMs, one block an SM.
//    The chunks of a range are neighbours in the grid, so they share its
//    slots and vals through L2.
//  * X is cut into stages of kStageRows rows; stage j lives in ring buffer
//    j % kStages, so X row c sits in ring row c % kRingRows (1,280 rows,
//    160 KB at 16 columns).  Under Cuthill-McKee the tiles' columns slide
//    down the matrix, and a range reads a stream of consecutive stages:
//    even ranges walk their tiles forward, a tile's window starting at the
//    least column of it and the range's later tiles (so it never moves
//    back); odd ranges walk backward, the window ending at the largest
//    column of it and the range's earlier tiles.  Two neighbouring ranges
//    so stage the X rows they share at the same time.  A window is kStages
//    stages; a tile waits for the stream from its window's edge to its
//    farthest column inside it.
//  * One producer thread loads the stream by TMA (X as a 2-D float tensor
//    [n_cols, 2r], boxes of kStageRows rows x 32 floats), each stage
//    completing on its buffer's "full" mbarrier.  Before it refills a
//    buffer it waits on the buffer's "empty" mbarrier, on which each
//    consumer warp arrives once when no later tile of its walk reads the
//    stage.  So the HBM stream runs ahead of the FMAs by the ring's slack
//    (~19 stages at the main path's ~660-row tile windows).
//  * Sixteen consumer warps take a tile's 128 rows, eight each, four lanes
//    a row, each lane two 16-byte units of the row's 128 B: per nonzero
//    two 16-byte shared-memory reads, rotated by the row's place in its
//    eight-lane phase so that a read has no bank conflict.  The plan deals
//    each tile's rows out by length, so that a warp's eight rows run
//    about as many rounds (on the reordered 2,996-DOF test operator the
//    rounds cover 1.08 x the nonzeros, 1.47 x in row order).  A
//    lane holds every fourth of its row's first kHeld (slot, val) pairs;
//    __shfl_sync broadcasts them to the row's lanes.  The loads run ahead
//    of the FMAs: pairs one tile ahead, row bounds two, rows three.  The
//    inner loop has no branch: pairs past a row's end and nonzeros
//    outside the window read a zero row of the ring.
//  * A warp waits for each stage before it releases it, so no warp can
//    release a buffer twice before every warp released it once, and the
//    warps run ahead of one another freely.
//  * Correct for any CSR: a nonzero outside its tile's window (a band
//    wider than the ring, an operator not reordered) is read from global
//    memory once the row's other nonzeros are summed.  The plan counts
//    them: none on the main path's operator.
//
// Measured on an H100 SXM (PERF.md, tools/k45_floor.py): 0.081-0.082 ms at
// r = 128, 2.2x the bound.  The stream and its barriers alone take 0.049
// ms, a copy of the panel 0.050 ms; the rest is the consumers' work, which
// overlaps the stream only in part: per nonzero and row 128 B of shared
// memory reads and 3/8 of a shuffle, at most 96 registers for 17 warps.
#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_runtime.h>
#include <cstdint>

// where a consumer warp's time goes: tools/k45_floor.py builds a copy that
// defines these hooks; here they are empty
#ifndef K45_PROFILE_HOOKS
#define K45_BEGIN()
#define K45_MARK(phase)
#define K45_END()
#endif

namespace {

// ops/window_spmm.py holds the same numbers (checked at load time)
constexpr int kChunk = 16;                   // complex columns of a block
constexpr int kTileRows = 128;
constexpr int kStageRows = 32;
constexpr int kStages = 40;
constexpr int kRingRows = kStageRows * kStages;
constexpr int kLanes = 4;                    // lanes of a row
constexpr int kUnits = 8 / kLanes;           // 16-byte units of a lane
constexpr int kRows = 32 / kLanes;           // rows of a warp at a time
constexpr int kConsumerWarps = kTileRows / kRows;   // a tile a pass
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;    // + 1 producer warp
constexpr int kHeld = 24;                    // pairs a row holds ahead
constexpr int kZeroRow = kRingRows;          // a ring row of zeros

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the phase of parity `parity` to complete (CTA-scope acquire)
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

// one TMA box [kStageRows rows x wb floats] of X -> own shared memory,
// completing on `bar`; (col, row) in floats and X rows
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
                 "::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(smem_addr(dst)), "l"((uint64_t)map),
                    "r"(smem_addr(bar)), "r"(col), "r"(row) : "memory");
}

__device__ __forceinline__ void cfma(float& re, float& im, float2 a, float xr,
                                     float xi)
{
    re = fmaf(a.x, xr, fmaf(-a.y, xi, re));
    im = fmaf(a.x, xi, fmaf(a.y, xr, im));
}

// a row's first kHeld (slot, val) pairs, pair kLanes m + q in lane q's
// [m]; past the row's end a zero value on the zero row
struct Pairs {
    int start, end;
    int s[kHeld / kLanes];
    float2 a[kHeld / kLanes];

    __device__ __forceinline__ void load(int2 b, const int* slots,
                                         const float2* vals, int q)
    {
        start = b.x;
        end = b.y;
#pragma unroll
        for (int m = 0; m < kHeld / kLanes; ++m) {
            const int k = start + kLanes * m + q;
            s[m] = kZeroRow;
            a[m] = make_float2(0.f, 0.f);
            if (k < end) {
                s[m] = __ldg(slots + k);
                a[m] = __ldg(vals + k);
            }
        }
    }
};

// J <= kLanes nonzeros of the warp's rows, lane j of a row's lanes holding
// pair j: each is broadcast to its row's lanes, which add their four
// columns of it, kUnits 16-byte units of the ring row (off[u] floats
// in).  A nonzero outside its tile's window reads the zero row here and
// sets `outside`; the row adds it from global memory afterwards.
template <int J>
__device__ __forceinline__ void step(float4 (&acc)[kUnits], int sm,
                                     float2 am, const float* ring,
                                     const int (&off)[kUnits],
                                     int wb, bool& outside)
{
    int s[J];
    float2 a[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        s[j] = __shfl_sync(0xffffffffu, sm, j, kLanes);
        const float ax = __shfl_sync(0xffffffffu, am.x, j, kLanes);
        const float ay = __shfl_sync(0xffffffffu, am.y, j, kLanes);
        a[j] = make_float2(ax, ay);
        outside |= s[j] < 0;
        s[j] = s[j] < 0 ? kZeroRow : s[j];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const float* row = ring + s[j] * wb;
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
            const float4 x = *reinterpret_cast<const float4*>(row + off[u]);
            cfma(acc[u].x, acc[u].y, a[j], x.x, x.y);
            cfma(acc[u].z, acc[u].w, a[j], x.z, x.w);
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
window_spmm_kernel(const __grid_constant__ CUtensorMap map,
                   const int* __restrict__ indptr,
                   const int* __restrict__ slots,
                   const float2* __restrict__ vals,
                   const int2* __restrict__ tiles,
                   const int2* __restrict__ ranges,
                   const int* __restrict__ order,
                   const float2* __restrict__ X, float2* __restrict__ Y,
                   int n_rows, int r, int n_tiles, int n_ranges, int chunks,
                   int wb)
{
    extern __shared__ __align__(128) unsigned char smem[];
    // [kRingRows + 1][wb] (the last the zero row) and 32 floats, so that
    // a lane's unit past a narrow row still lies in shared memory
    float* ring = reinterpret_cast<float*>(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem + ((size_t)(kRingRows + 1) * wb + 32) * sizeof(float));
    uint64_t* empty = full + kStages;

    const int range = blockIdx.x / chunks;
    const int chunk = blockIdx.x % chunks;
    const int t0 = (int)((long long)range * n_tiles / n_ranges);
    const int nt = (int)((long long)(range + 1) * n_tiles / n_ranges) - t0;
    // odd ranges walk their tiles from the last, so that neighbouring
    // ranges stage their shared halo at the same time
    const bool back = range & 1;
    const int2 stream = ranges[range];    // first stage, number of stages
    const int tid = threadIdx.x;

    for (int c = tid; c < wb; c += kThreads)
        ring[kZeroRow * wb + c] = 0.f;
    if (tid == 0) {
        for (int b = 0; b < kStages; ++b) {
            mbar_init(full + b, 1);
            mbar_init(empty + b, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // stage i of the range's stream is X stage first + i (first - i going
    // back), held in buffer (stage % kStages), whose (i / kStages)-th fill
    // it is
    if (tid >= kConsumers) {
        // producer: one thread loads the stream in order, each stage once
        // every consumer warp has released the buffer's previous stage
        if (tid == kConsumers) {
            const uint32_t bytes = kStageRows * wb * sizeof(float);
            for (int i = 0; i < stream.y; ++i) {
                const int j = back ? stream.x - i : stream.x + i;
                const int b = j % kStages;
                // a buffer's first fill waits on a phase that counts as
                // complete
                mbar_wait(empty + b, ((i / kStages) & 1) ^ 1);
                mbar_expect_tx(full + b, bytes);
                tma_load(ring + (size_t)b * kStageRows * wb, &map,
                         chunk * 2 * kChunk, j * kStageRows, full + b);
            }
        }
        return;
    }

    const int warp = tid >> 5, lane = tid & 31;
    const int q = lane % kLanes;             // this lane of its row's
    const int rho = (lane / kLanes) % kUnits;   // its row's place in a
                                                // phase of eight lanes
    // the lane's kUnits 16-byte units of a row's 128, rotated by the row's
    // place in its phase, so that over the eight lanes of a phase (8 /
    // kLanes rows) the units one LDS reads are all different
    int off[kUnits], col[kUnits];
    bool act[kUnits];
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
        const int unit = kLanes * ((u + rho) % kUnits) + q;
        off[u] = 4 * unit;
        col[u] = chunk * kChunk + 2 * unit;
        act[u] = col[u] < r;                 // r % 4 == 0: a unit or none
    }
    // the walk's tile i, and the warp's rows of it, this lane's
    // lane / kLanes: the plan deals each tile's rows out to the warps by
    // their nonzeros (-1 past the last row)
    auto tile_of = [&](int i) { return back ? t0 + nt - 1 - i : t0 + i; };
    auto row_of = [&](int i) {
        return __ldg(order + tile_of(i) * kTileRows + kRows * warp
                     + lane / kLanes);
    };
    auto bounds = [&](int row) {
        return row >= 0 ? make_int2(__ldg(indptr + row),
                                    __ldg(indptr + row + 1))
                        : make_int2(0, 0);
    };
    // loads run ahead of the FMAs: the rows of tile i + 3, their bounds in
    // tile i + 2, the first kHeld (slot, val) pairs, a lane each, and the
    // (far, near) stages of tile i + 1, while tile i computes
    Pairs cur, nxt;
    int2 stages = tiles[tile_of(0)];
    int row = row_of(0);
    int row1 = nt > 1 ? row_of(1) : -1;
    int row2 = nt > 2 ? row_of(2) : -1;
    cur.load(bounds(row), slots, vals, q);
    int2 ahead = bounds(row1);
    int waited = 0;                          // first stage not waited on
    int released = 0;                        // first stage not released
    K45_BEGIN();
    for (int i = 0; i < nt; ++i) {
        nxt.load(ahead, slots, vals, q);
        const int2 after = bounds(row2);
        const int row3 = i + 3 < nt ? row_of(i + 3) : -1;
        const int2 stages1 = i + 1 < nt ? tiles[tile_of(i + 1)]
                                        : make_int2(-1, stream.y);
        K45_MARK(0);
        // the tile's stages: up to far, the last stream stage it reads (-1
        // for a tile without nonzeros)
        for (; waited <= stages.x; ++waited) {
            const int j = back ? stream.x - waited : stream.x + waited;
            mbar_wait(full + j % kStages, (waited / kStages) & 1);
        }
        K45_MARK(1);
        const int nnz = cur.end - cur.start;     // 0 past the last row
        // the most nonzeros of the warp's rows, in rounds of kLanes (a last
        // one of at most kLanes / 2 takes half a round)
        const int most = (int)__reduce_max_sync(0xffffffffu, (unsigned)nnz);
        const int rounds = (most + kLanes - 1) / kLanes;
        float4 acc[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
            acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        bool outside = false;
#pragma unroll
        for (int m = 0; m < kHeld / kLanes; ++m) {
            if (m >= rounds)
                break;
            if (most - kLanes * m > kLanes / 2)
                step<kLanes>(acc, cur.s[m], cur.a[m], ring, off, wb, outside);
            else
                step<kLanes / 2>(acc, cur.s[m], cur.a[m], ring, off, wb,
                                 outside);
        }
        for (int m = kHeld / kLanes; m < rounds; ++m) {
            // a row of more than kHeld nonzeros: its further pairs now
            const int k = cur.start + kLanes * m + q;
            const bool in = k < cur.end;
            step<kLanes>(acc, in ? __ldg(slots + k) : kZeroRow,
                         in ? __ldg(vals + k) : make_float2(0.f, 0.f), ring,
                         off, wb, outside);
        }
        if (__any_sync(0xffffffffu, outside)) {
            // nonzeros outside the window, from global memory, in order
            for (int k = cur.start; k < cur.end; ++k) {
                const int sk = __ldg(slots + k);
                if (sk >= 0)
                    continue;
                const float2 a = __ldg(vals + k);
#pragma unroll
                for (int u = 0; u < kUnits; ++u)
                    if (act[u]) {
                        const float4 x = __ldg(reinterpret_cast<const float4*>(
                            X + (size_t)(-1 - sk) * r + col[u]));
                        cfma(acc[u].x, acc[u].y, a, x.x, x.y);
                        cfma(acc[u].z, acc[u].w, a, x.z, x.w);
                    }
            }
        }
        K45_MARK(2);
        if (row >= 0) {
#pragma unroll
            for (int u = 0; u < kUnits; ++u)
                if (act[u])
                    *reinterpret_cast<float4*>(Y + (size_t)row * r + col[u])
                        = acc[u];
        }
        if (i + 1 < nt) {
            // the stages before the next tile's first are done with; each
            // is waited on before its release, so that no warp releases a
            // buffer twice before every warp released it once
            const int hi = min(stages1.y, stream.y);
            for (; released < hi; ++released) {
                const int j = back ? stream.x - released
                                   : stream.x + released;
                if (released >= waited) {
                    mbar_wait(full + j % kStages, (released / kStages) & 1);
                    waited = released + 1;
                }
                __syncwarp();
                if (lane == 0)
                    mbar_arrive(empty + j % kStages);
            }
        }
        K45_MARK(3);
        cur = nxt;
        ahead = after;
        stages = stages1;
        row = row1;
        row1 = row2;
        row2 = row3;
    }
    K45_END();
}

size_t smem_bytes(int wb)
{
    return ((size_t)(kRingRows + 1) * wb + 32) * sizeof(float)
        + 2 * (size_t)kStages * sizeof(uint64_t);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to libcuda
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// X as a 2-D float tensor [n_cols rows, 2r floats], read in boxes of
// kStageRows rows x wb floats; boxes past the last column or row read zeros
cudaError_t panel_map(CUtensorMap* map, const void* X, int n_cols, int r,
                      int wb)
{
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (e != cudaSuccess)
            return e;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return cudaErrorNotSupported;
        encode = (EncodeTiled)fn;
    }
    const cuuint64_t dims[2] = {2 * (cuuint64_t)r, (cuuint64_t)n_cols};
    const cuuint64_t strides[1] = {2 * (cuuint64_t)r * sizeof(float)};
    const cuuint32_t box[2] = {(cuuint32_t)wb, kStageRows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(X), dims,
        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// the kernel's compile-time layout, for the wrapper to check against its
// own: chunk, tile rows, stage rows, stages, consumer warps
extern "C" int window_spmm_layout(int* out)
{
    out[0] = kChunk;
    out[1] = kTileRows;
    out[2] = kStageRows;
    out[3] = kStages;
    out[4] = kConsumerWarps;
    return 0;
}

extern "C" int window_spmm_c64(const void* indptr, const void* slots,
                               const void* vals, const void* tiles,
                               const void* ranges, const void* order,
                               const void* X, void* Y,
                               int n_rows, int n_cols, int r, int n_ranges,
                               void* cuda_stream)
{
    if (n_rows < 1 || n_cols < 1 || r < 4 || r % 4 != 0 || n_ranges < 1)
        return (int)cudaErrorInvalidValue;
    const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
    const int chunks = (r + kChunk - 1) / kChunk;
    const int wb = 2 * (r < kChunk ? r : kChunk);    // floats of a box row
    if (n_ranges > n_tiles)
        return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    cudaError_t e = panel_map(&map, X, n_cols, r, wb);
    if (e != cudaSuccess)
        return (int)e;
    const size_t smem = smem_bytes(wb);
    static size_t smem_set = 0;       // the attribute this process set last
    if (smem > smem_set) {
        e = cudaFuncSetAttribute(window_spmm_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess)
            return (int)e;
        smem_set = smem;
    }
    window_spmm_kernel<<<chunks * n_ranges, kThreads, smem,
                         (cudaStream_t)cuda_stream>>>(
        map, (const int*)indptr, (const int*)slots, (const float2*)vals,
        (const int2*)tiles, (const int2*)ranges, (const int*)order,
        (const float2*)X, (float2*)Y, n_rows, r, n_tiles, n_ranges, chunks,
        wb);
    return (int)cudaGetLastError();
}

extern "C" const char* window_spmm_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
