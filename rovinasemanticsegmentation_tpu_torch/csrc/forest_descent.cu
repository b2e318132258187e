// Random-forest descent with the fused leaf-histogram sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel rovinasemanticsegmentation_tpu/ops/forest_pallas.py
// (_descent_kernel, driven by find_leaves_pallas / PallasForestPredictor).
// Per (point, tree) it repeats node = left + (x[feat] >= thr) from the root
// until left == 0, at most max_depth times (libforest classifier.cpp:97-117),
// and returns the leaf id in the natural node numbering. It then sums the
// trees' per-layer leaf log-histograms for each point, in tree order
// t = 0..T-1 (RandomForest::multiClassLogPosterior, classifier.cpp:187-208).
//
// Rows (ops/feature_rows.py). A point's features are one row of row_bytes
// bytes: feature f < pc is the byte row[f], read as a float (exact), and
// feature f >= pc the float32 at row + tail_off + 4 (f - pc). The frame path
// passes its packed rows (pc = 363, tail_off = 364, row_bytes = 384); a plain
// float32 [P, D] matrix is pc = tail_off = 0, row_bytes = 4 D.
//
// What bounds it on the card: a dependent chain of two loads per level --
// the 8-byte node record, then one feature of the point's row. The node
// tables of the bench forest (4 trees x 11008 nodes x 8 B = 0.35 MB) and the
// leaf histograms (3.2 MB) stay in L2. On a VGA frame a (point, tree) takes
// 11.3 levels on average (27 at most), and a point reads 41.5 distinct
// features: 12.75 MB of needed bytes as float32. The first version read
// them in place from the 112 MB float32 feature matrix of a frame (900 MB
// for a batch of 8), which does not fit the 50 MB L2, so each level's feature
// read was a scattered 32-byte sector from device memory at its latency.
//
// Design: persistent blocks walk tiles of TP consecutive points. A tile's
// rows are one contiguous span (TP x 384 B = 24.6 KB at TP = 64 on packed
// rows, 3.8x less than float32 rows). One thread copies the next tile's span
// into a two-stage shared-memory ring with cp.async.bulk (TMA), completing on
// an mbarrier, while the block's TP * T (point, tree) threads descend on the
// current tile with features from shared memory; node records stay __ldg
// int2 loads from L2. After the descent the tile's leaf ids sit in shared
// memory and the block's threads produce the [TP, L*C] posterior rows, each
// value summed over trees in order, so it is bit-identical to the plain
// version. x >= thr follows IEEE rules: NaN goes left, x == thr right. A tile
// whose span is not a whole number of 16-byte units, or starts unaligned (the
// last, partial tile; float32 rows with odd TP), is copied by all threads
// with plain loads instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity)
{
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

__global__ void forest_descent_kernel(
    const uint8_t* __restrict__ rows,  // [P, row_bytes]
    long long num_points, int row_bytes, int pc, int tail_off,
    const int2* __restrict__ records,  // [T, N] (meta, threshold bits)
    int num_trees, int n_nodes,
    const float* __restrict__ leaf_hist,  // [T, N, LC]
    int lc_width, int max_depth, int feat_bits, int tile_points,
    int stage_bytes,  // TP * row_bytes rounded up to 128
    int32_t* __restrict__ leaves,  // [P, T]
    float* __restrict__ posterior)  // [P, LC]
{
    extern __shared__ __align__(128) uint8_t smem[];
    uint8_t* stage[2] = {smem, smem + stage_bytes};
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * stage_bytes);
    int32_t* leaf_s = reinterpret_cast<int32_t*>(bar + 2);  // [TP, T]

    const int tid = threadIdx.x;
    const long long num_tiles = (num_points + tile_points - 1) / tile_points;
    const uint32_t full_bytes = (uint32_t)tile_points * row_bytes;
    // A full tile goes through TMA when its span is whole 16-byte units.
    const bool bulk_span = (full_bytes & 15) == 0
        && (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
    auto is_bulk = [&](long long tile) {
        return bulk_span && (tile + 1) * tile_points <= num_points;
    };
    auto tile_src = [&](long long tile) {
        return rows + tile * tile_points * (long long)row_bytes;
    };

    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&bar[0])) : "memory");
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&bar[1])) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    long long tile = blockIdx.x;
    if (tid == 0 && tile < num_tiles && is_bulk(tile)) {
        bulk_load(stage[0], tile_src(tile), full_bytes, &bar[0]);
    }
    const int lp = tid / num_trees;
    const int t = tid - lp * num_trees;
    const int2* tree = records + (long long)t * n_nodes;
    const int fmask = (1 << feat_bits) - 1;
    uint32_t phase = 0;  // bit s: the parity to wait for on stage s
    for (int k = 0; tile < num_tiles; ++k, tile += gridDim.x) {
        const int s = k & 1;
        const long long next = tile + gridDim.x;
        // Stage s ^ 1 was last read in iteration k - 1, which ended with a
        // block barrier, so the next tile can land there now.
        if (tid == 0 && next < num_tiles && is_bulk(next)) {
            bulk_load(stage[s ^ 1], tile_src(next), full_bytes, &bar[s ^ 1]);
        }
        const long long p0 = tile * tile_points;
        const int npts = (int)min((long long)tile_points, num_points - p0);
        if (is_bulk(tile)) {
            wait_parity(&bar[s], (phase >> s) & 1);
            phase ^= 1u << s;
        } else {
            const int words = npts * row_bytes / 4;  // row_bytes % 4 == 0
            const uint32_t* src = reinterpret_cast<const uint32_t*>(tile_src(tile));
            uint32_t* dst = reinterpret_cast<uint32_t*>(stage[s]);
            for (int w = tid; w < words; w += blockDim.x) dst[w] = __ldg(src + w);
            __syncthreads();
        }

        if (lp < npts) {
            const uint8_t* x = stage[s] + lp * row_bytes;
            int node = 0;
            for (int level = 0; level < max_depth; ++level) {
                const int2 rec = __ldg(tree + node);
                const int left = rec.x >> feat_bits;
                if (left == 0) break;
                const int f = rec.x & fmask;
                const float xv = f < pc
                    ? (float)x[f]
                    : *reinterpret_cast<const float*>(x + tail_off + 4 * (f - pc));
                node = left + (xv >= __int_as_float(rec.y) ? 1 : 0);
            }
            leaf_s[lp * num_trees + t] = node;
            leaves[(p0 + lp) * num_trees + t] = node;
        }
        __syncthreads();

        const int work = npts * lc_width;
        for (int w = tid; w < work; w += blockDim.x) {
            const int q = w / lc_width;
            const int c = w - q * lc_width;
            float acc = 0.0f;
            for (int tt = 0; tt < num_trees; ++tt) {
                const int leaf = leaf_s[q * num_trees + tt];
                acc += __ldg(leaf_hist
                             + ((long long)tt * n_nodes + leaf) * lc_width + c);
            }
            posterior[(p0 + q) * lc_width + c] = acc;
        }
        __syncthreads();  // stage s and leaf_s are free for the next tile
    }
}

int g_sm_count = 0;

int stage_bytes_for(int tile_points, int row_bytes)
{
    return (tile_points * row_bytes + 127) & ~127;
}

}  // namespace

extern "C" int rovina_forest_descent(
    const void* rows, long long num_points, int row_bytes, int pc,
    int tail_off, const void* records, int num_trees, int n_nodes,
    const void* leaf_hist, int lc_width, int max_depth, int feat_bits,
    int tile_points, void* leaves, void* posterior, void* stream)
{
    if (num_points <= 0) return (int)cudaGetLastError();
    const int threads = tile_points * num_trees;  // the wrapper keeps <= 1024
    const int stage_bytes = stage_bytes_for(tile_points, row_bytes);
    // Two stages of rows, two mbarriers, the tile's leaf ids.
    const int smem = 2 * stage_bytes + 16 + 4 * tile_points * num_trees;
    cudaError_t err = cudaFuncSetAttribute(
        forest_descent_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    if (g_sm_count == 0) {
        int device = 0;
        err = cudaGetDevice(&device);
        if (err != cudaSuccess) return (int)err;
        err = cudaDeviceGetAttribute(&g_sm_count,
                                     cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return (int)err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, forest_descent_kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    const long long num_tiles = (num_points + tile_points - 1) / tile_points;
    long long blocks = (long long)g_sm_count * (per_sm > 0 ? per_sm : 1);
    if (blocks > num_tiles) blocks = num_tiles;
    forest_descent_kernel<<<(unsigned)blocks, threads, smem,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)rows, num_points, row_bytes, pc, tail_off,
        (const int2*)records, num_trees, n_nodes, (const float*)leaf_hist,
        lc_width, max_depth, feat_bits, tile_points, stage_bytes,
        (int32_t*)leaves, (float*)posterior);
    return (int)cudaGetLastError();
}
