// Block-tridiagonal (Thomas) forward + backward substitution in ONE launch.
//
// Replaces the Pallas TPU kernel
//   wavesandeigenvalues_jl_tpu/ops/pallas_thomas.py :: build_slab_thomas
// (kernel body `kernel`, the inner solve of the fused slab-direct local
// eigensolver, nlevp/fused_slab.py).  The block-Thomas factorization is
// done once per Newton step in plain PyTorch; this kernel runs every
// subsequent solve as the pure recursion (row-vector convention)
//
//   y_i = bt_i - y_{i-1} * W^T_i        i = 0 .. m-1      (forward)
//   x_i = y_i  - x_{i+1} * C^T_i        i = m-1 .. 0      (backward)
//
// Layout (complex64 = float2, all contiguous, 16-byte aligned):
//   stream [sides, 2m, s, s]   W^T_i at [side, i], C^T_{m-1-i} at [side, m+i]
//   bt     [sides, m, s]       Dt^-1-pre-applied right-hand side, slab layout
//   x      [sides, m, s]       solution; the forward phase writes y_i here
//                              and the backward phase reads it back
// s is a multiple of 128, at most 9472 (the double-buffered carry and two
// ring stages of 8 rows fill shared memory there).  Products accumulate in
// float32 complex within a chunk of a stage, as the TPU kernel does
// (preferred_element_type=f32), and the chunks' sums, the reduction of a
// column's partial sums and y_i = bt_i - sum in float64 before y_i is
// rounded to complex64: a thread's float32 sum over a whole step (427
// terms at s = 1280) lost digits that ill-conditioned blocks (|W_i| ~ 1e4,
// the Hermite Rijke's) amplified past the plain version's error.
//
// What bounds it: every launch streams the W/C blocks once, 2 * 2m * s^2
// * 8 B = 126 MB at the Rijke slice (sides=2, m=60, s=256), about 38 us at
// the H100's 3.35 TB/s, and the 2m steps form a serial chain.  The blocks
// do not depend on the carry; only the [1,s]x[s,s] product waits for
// y_{i-1}.
//
// Design: one thread-block cluster of kCluster blocks per side.  Block c
// owns the column stripe j in [c*w, (c+1)*w), w = s / kCluster, of every
// block; row k of a transposed block is contiguous in j, so a chunk of a
// stripe is a 2-D box of `rows` rows x w complex values (64 rows where
// two stages fit, fewer for wide slabs; stripes wider than a TMA box, 128
// complex values, go as several boxes of wb columns, stored one after the
// other in the stage).
//  * A producer thread keeps a ring of stages in shared memory filled
//    with the next chunks of the stripes by TMA (the stream seen as a 2-D
//    tensor of floats), each stage completing on a "full" mbarrier; the
//    consumers free a stage through its "empty" mbarrier.  It never waits
//    on the carry, so the HBM stream runs ahead of the recursion by up to
//    the ring's depth.
//  * Eight consumer warps compute the block's w outputs of y_i.  In the
//    narrow form (s <= 2048: one box a stripe, 64-row chunks), thread
//    (j, ks) sums rows ks, ks + KS, ... of each chunk for column j, and the
//    KS partial sums of a column are reduced in a fixed order after a named
//    barrier.  In the wide form a thread owns columns tid, tid + 256, ...
//    and sums every row.  The two are instances of one template, so that
//    the narrow one, the main path's, carries none of the wide one's
//    per-column predicates in its inner loop (they cost it 30 %).
//  * Each block holds the full carry row y_{i-1} in its own shared memory
//    (double-buffered by the count of carries sent, so the first carry of
//    the backward phase never lands in the buffer the last forward step
//    still reads).  The threads that form y_i write it to x and store it
//    into every peer's next carry buffer through distributed shared
//    memory; after a consumer barrier, one thread per peer makes a
//    release arrive on that peer's "carry" mbarrier, and a block waits
//    (acquire) for the kCluster arrivals before it reads the carry.  That
//    arrive/wait pair is the step's only cluster-wide synchronisation.
//  * The first step of each phase has a zero carry: its block is neither
//    loaded nor multiplied.  The backward phase reads y_j back from the
//    block's own stripe of x (written by the same thread), so no grid-wide
//    sync is needed.
#include <cooperative_groups.h>
#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// blocks of one side's cluster: 16 (non-portable) beat 8 at the main path's
// (2, 60, 256); the two were measured by tools/k3_cluster_size.py
constexpr int kCluster = 16;
constexpr int kConsumers = 256;              // 8 consumer warps
constexpr int kThreads = kConsumers + 32;    // + 1 producer warp
constexpr int kChunkRows = 64;               // rows of a stage, at most
constexpr int kMinChunkRows = 8;
constexpr int kMaxCols = 3;                  // columns of a consumer thread
constexpr int kMaxStages = 16;
constexpr int kBoxCols = 128;                // complex values of a TMA box row
constexpr size_t kSmemMax = 232448;          // dynamic shared memory, H100

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

// the same with cluster-scope acquire: the arrivals come from peer blocks
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity)
{
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta"
                     ".b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
}

// one TMA box [rows x wb complex values] of the stream -> own shared
// memory, completing on `bar`; (col, row) in floats and stream rows
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
                 "::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(smem_addr(dst)), "l"((uint64_t)map),
                    "r"(smem_addr(bar)), "r"(col), "r"(row) : "memory");
}

// the address of `local` (own shared memory) in block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(const void* local,
                                              uint32_t rank)
{
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(smem_addr(local)), "r"(rank));
    return r;
}

__device__ __forceinline__ void peer_store(uint32_t addr, float2 v)
{
    asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n"
                 :: "r"(addr), "f"(v.x), "f"(v.y) : "memory");
}

__device__ __forceinline__ void peer_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64"
                 " _, [%0];\n" :: "r"(bar) : "memory");
}

// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
slab_thomas_kernel(const __grid_constant__ CUtensorMap map,
                   const float2* __restrict__ bt,
                   float2* __restrict__ x, int m, int s, int rows_arg,
                   int wb_arg, int stages)
{
    constexpr int kCols = kWide ? kMaxCols : 1;  // columns of a thread
    extern __shared__ __align__(128) unsigned char smem[];
    const int w = s / kCluster;                  // stripe width
    const int rows = kWide ? rows_arg : kChunkRows;
    const int wb = kWide ? wb_arg : w;           // columns of a TMA box
    const int stage_elems = rows * w;            // [w / wb][rows][wb]
    const int chunks = s / rows;                 // stages per step
    float2* ring = reinterpret_cast<float2*>(smem);          // [stages]
    float2* carry = ring + (size_t)stages * stage_elems;     // [2][s]
    // one buffer of partial sums: a step's reads of it end before the
    // consumer barrier of its publish, which the next step that writes it
    // follows (a step that does not publish is followed by a zero-carry
    // step that does not write it)
    double2* part = reinterpret_cast<double2*>(carry + 2 * s);  // [256]
    uint64_t* full = reinterpret_cast<uint64_t*>(part + kConsumers);
    uint64_t* empty = full + stages;
    uint64_t* cbar = empty + stages;                         // [2]

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int side = blockIdx.x / kCluster;
    const int j0 = rank * w;
    const int tid = threadIdx.x;
    const int steps = 2 * m;

    if (tid == 0) {
        for (int q = 0; q < stages; ++q) {
            mbar_init(full + q, 1);
            mbar_init(empty + q, kConsumers / 32);
        }
        mbar_init(cbar, kCluster);
        mbar_init(cbar + 1, kCluster);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();                  // peers' barriers exist from here on

    if (tid >= kConsumers) {
        // producer warp: one thread issues the TMA boxes of every chunk of
        // every step with a carry
        if (tid == kConsumers) {
            const uint32_t bytes = stage_elems * sizeof(float2);
            const int boxes = kWide ? w / wb : 1;
            int n = 0;                               // chunks issued
            for (int g = 0; g < steps; ++g) {
                if (g % m == 0)
                    continue;                        // zero carry: not needed
                for (int q = 0; q < chunks; ++q, ++n) {
                    const int st = n % stages;
                    float2* dst = ring + (size_t)st * stage_elems;
                    const int row = (side * steps + g) * s + q * rows;
                    mbar_wait(empty + st, ((n / stages) & 1) ^ 1);
                    mbar_expect_tx(full + st, bytes);
                    for (int b = 0; b < boxes; ++b)
                        tma_load(dst + b * rows * wb, &map,
                                 2 * (j0 + b * wb), row, full + st);
                }
            }
        }
    } else {
        // consumer warps
        const int ks_count = kWide ? 1 : kConsumers / w;   // slices of k
        const int ks = kWide ? 0 : tid / w;          // >= ks_count: idle
        const int jt = kWide ? tid : tid % w;        // first own column
        // columns this thread owns (wide: 0 to 3; narrow: one if tid < w)
        const int ncol = kWide ? (w - tid + kConsumers - 1) / kConsumers
                               : tid < w;
        int off[kCols];                              // columns in a stage
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
            const int j = jt + c * kConsumers;
            off[c] = kWide ? (j / wb) * rows * wb + j % wb : j;
        }
        const float2* brhs = bt + (size_t)side * m * s + j0 + jt;
        float2* xs = x + (size_t)side * m * s + j0 + jt;
        int used = 0;            // carries read so far
        int sent = 0;            // carries published so far
        int n = 0;               // chunks consumed
        for (int g = 0; g < steps; ++g) {
            const bool fwd = g < m;
            const int i = fwd ? g : g - m;
            const int slab = fwd ? i : m - 1 - i;
            float2 rhs[kCols];
            double sr[kCols], si[kCols];             // the step's sums
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                sr[c] = si[c] = 0.0;
                rhs[c] = make_float2(0.f, 0.f);
                if (c < ncol) {                      // issued before the wait
                    const size_t e = (size_t)slab * s + c * kConsumers;
                    rhs[c] = fwd ? brhs[e] : xs[e];
                }
            }
            if (i > 0) {
                // carry number `used` sits in buffer used & 1
                const float2* prev = carry + (used & 1) * s;
                mbar_wait_cluster(cbar + (used & 1), (used >> 1) & 1);
                ++used;
                for (int q = 0; q < chunks; ++q, ++n) {
                    const int st = n % stages;
                    mbar_wait(full + st, (n / stages) & 1);
                    if (ks < ks_count) {
                        const float2* B = ring + (size_t)st * stage_elems;
                        const float2* u = prev + q * rows;
                        float ar[kCols], ai[kCols];  // this chunk's sums
#pragma unroll
                        for (int c = 0; c < kCols; ++c)
                            ar[c] = ai[c] = 0.f;
#pragma unroll 4
                        for (int k = ks; k < rows; k += ks_count) {
                            const float2 a = u[k];
#pragma unroll
                            for (int c = 0; c < kCols; ++c)
                                if (!kWide || c < ncol) {
                                    const float2 b = B[off[c] + k * wb];
                                    ar[c] = fmaf(a.x, b.x,
                                                 fmaf(-a.y, b.y, ar[c]));
                                    ai[c] = fmaf(a.x, b.y,
                                                 fmaf(a.y, b.x, ai[c]));
                                }
                        }
#pragma unroll
                        for (int c = 0; c < kCols; ++c) {
                            sr[c] += ar[c];
                            si[c] += ai[c];
                        }
                    }
                    __syncwarp();
                    if ((tid & 31) == 0)
                        mbar_arrive(empty + st);
                }
                if (!kWide) {
                    part[tid] = make_double2(sr[0], si[0]);
                    consumer_sync();
                    if (tid < w) {
                        sr[0] = si[0] = 0.0;
                        for (int t = 0; t < ks_count; ++t) {
                            sr[0] += part[t * w + jt].x;
                            si[0] += part[t * w + jt].y;
                        }
                    }
                }
            }
            const bool publish = (g + 1) % m != 0;   // the next step's carry
            if (ncol > 0) {
#pragma unroll
                for (int c = 0; c < kCols; ++c)
                    if (c < ncol) {
                        const int jc = c * kConsumers;
                        const float2 y = make_float2(
                            (float)(rhs[c].x - sr[c]),
                            (float)(rhs[c].y - si[c]));
                        xs[(size_t)slab * s + jc] = y;
                        if (publish) {
                            const float2* next =
                                carry + (sent & 1) * s + j0 + jt + jc;
                            for (int r = 0; r < kCluster; ++r)
                                peer_store(peer_addr(next, r), y);
                        }
                    }
                if (publish)
                    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
            }
            if (publish) {
                // one arrive per block on each peer, after all its stores
                consumer_sync();
                if (tid < kCluster)
                    peer_arrive(peer_addr(cbar + (sent & 1), tid));
                ++sent;
            }
        }
    }
    cluster.sync();                  // no block leaves while peers write
}

size_t smem_bytes(int s, int rows, int stages)
{
    return (size_t)stages * rows * (s / kCluster) * sizeof(float2)
        + 2 * (size_t)s * sizeof(float2) + kConsumers * sizeof(double2)
        + (2 * (size_t)stages + 2) * sizeof(uint64_t);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link to libcuda
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// the stream as a 2-D float tensor [sides * 2m * s rows, 2s floats], read
// in boxes of `rows` rows x 2 wb floats
cudaError_t stream_map(CUtensorMap* map, const void* stream, int sides,
                       int m, int s, int rows, int wb)
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
    const cuuint64_t dims[2] = {2 * (cuuint64_t)s,
                                (cuuint64_t)sides * 2 * m * s};
    const cuuint64_t strides[1] = {2 * (cuuint64_t)s * sizeof(float)};
    const cuuint32_t box[2] = {2 * (cuuint32_t)wb, (cuuint32_t)rows};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(stream),
        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kWide>
cudaError_t launch(const CUtensorMap& map, const float2* bt, float2* x,
                   int sides, int m, int s, int rows, int wb, int stages,
                   cudaStream_t st)
{
    const size_t smem = smem_bytes(s, rows, stages);
    static size_t smem_set = 0;       // the attribute this process set last
    if (smem != smem_set) {
        cudaError_t e = cudaFuncSetAttribute(
            slab_thomas_kernel<kWide>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                slab_thomas_kernel<kWide>,
                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess)
            return e;
        smem_set = smem;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sides * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, slab_thomas_kernel<kWide>, map, bt, x, m, s, rows, wb, stages);
    return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" int slab_thomas_c64(const void* stream, const void* bt, void* x,
                               int sides, int m, int s, void* cuda_stream)
{
    if (sides < 1 || m < 1 || s < 128 || s % 128 != 0)
        return (int)cudaErrorInvalidValue;
    const int w = s / kCluster;
    if ((w + kConsumers - 1) / kConsumers > kMaxCols)
        return (int)cudaErrorInvalidValue;
    // the deepest chunk for which two stages fit, then as many stages as fit
    int rows = kChunkRows;
    while (rows > kMinChunkRows && smem_bytes(s, rows, 2) > kSmemMax)
        rows /= 2;
    if (smem_bytes(s, rows, 2) > kSmemMax)
        return (int)cudaErrorInvalidValue;
    int stages = kMaxStages;
    while (stages > 2 && smem_bytes(s, rows, stages) > kSmemMax)
        --stages;
    // the fewest boxes of an even width (16-byte rows) that tile the stripe
    int boxes = (w + kBoxCols - 1) / kBoxCols;
    while (w % boxes != 0 || (w / boxes) % 2 != 0)
        ++boxes;
    const int wb = w / boxes;
    CUtensorMap map;
    cudaError_t e = stream_map(&map, stream, sides, m, s, rows, wb);
    if (e != cudaSuccess)
        return (int)e;
    const cudaStream_t st = (cudaStream_t)cuda_stream;
    // the narrow form: one box a stripe and 64-row chunks (s <= 2048)
    const bool wide = boxes > 1 || rows != kChunkRows;
    e = wide ? launch<true>(map, (const float2*)bt, (float2*)x, sides, m, s,
                            rows, wb, stages, st)
             : launch<false>(map, (const float2*)bt, (float2*)x, sides, m,
                             s, rows, wb, stages, st);
    return (int)e;
}

extern "C" const char* slab_thomas_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
