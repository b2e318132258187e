// Random-forest descent over a feature tile staged in shared memory, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_descent.py (_descent_kernel_v, driven
// by find_leaves_v): the leaf id of every (point, tree) over usage-permuted
// features, where the columns that internal nodes split on most come first
// (models/forest.py::usage_permutation). The TPU kernel skipped a
// 128-feature chunk's gather when no point of its tile needed that chunk;
// its transpose_pack flag only changed how the TPU moved lookups between
// lanes, with the same leaves.
//
// What bounds it on the card: kernel B (forest_descent.cu) walks a chain of
// dependent loads per level -- the 8-byte node record, then one feature of
// the point's row. The node tables stay in L2, the feature matrix of a VGA
// frame (76800 x 366 x 4 B = 112 MB) does not, so about 4 trees x 11.3
// levels (the mean on a VGA frame, 27 at most) of feature reads per point go
// to device memory as 32-byte sectors (~1.4 KB per point) at its latency.
//
// Design: a block takes TP consecutive points and TP * T threads, trees
// adjacent. It first copies each point's first `hot` features into shared
// memory with coalesced loads; when hot == D the tile is one contiguous span
// of the [P, D] matrix, loaded with 16-byte vector loads where it starts
// 16-byte aligned (TP even at D = 366: 2 x 1464 B = 183 x 16 B). That is one
// read of 1.46 KB per point. Each (point, tree) thread then descends with x
// from shared memory when feat < hot and through __ldg otherwise; the node
// record is one int2 as in B. x >= thr is the IEEE comparison: NaN goes
// left, x == thr goes right. Output: leaf ids [P, T] in the natural node
// numbering (the histogram sum stays kernel B's). Shared memory is
// TP * hot * 4 B (46.8 KB at TP = 32, hot = 366); above 48 KB the entry
// point opts in to the larger dynamic size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void forest_descent_staged_kernel(
    const float* __restrict__ feats,  // [P, D], usage-permuted columns
    long long num_points, int d, int hot,
    const int2* __restrict__ records,  // [T, N] (meta, threshold bits)
    int num_trees, int n_nodes, int max_depth, int feat_bits,
    int tile_points,
    int32_t* __restrict__ leaves)  // [P, T]
{
    extern __shared__ float4 xs4[];  // [tile_points, hot] floats
    float* xs = reinterpret_cast<float*>(xs4);
    const long long p0 = (long long)blockIdx.x * tile_points;
    const long long remaining = num_points - p0;
    const int npts = (int)(remaining < tile_points ? remaining : tile_points);

    // Stage the tile's hot columns: xs[q * hot + f] = feats[p0 + q, f].
    const float* tile = feats + p0 * d;
    if (hot == d && (reinterpret_cast<uintptr_t>(tile) & 15) == 0) {
        const int n = npts * d;
        const int n4 = n / 4;
        const float4* src4 = reinterpret_cast<const float4*>(tile);
        for (int k = threadIdx.x; k < n4; k += blockDim.x)
            xs4[k] = __ldg(src4 + k);
        for (int k = 4 * n4 + threadIdx.x; k < n; k += blockDim.x)
            xs[k] = __ldg(tile + k);
    } else {
        const int n = npts * hot;
        for (int k = threadIdx.x; k < n; k += blockDim.x) {
            const int q = k / hot;
            xs[k] = __ldg(tile + (long long)q * d + (k - q * hot));
        }
    }
    __syncthreads();

    const int lp = threadIdx.x / num_trees;
    const int t = threadIdx.x - lp * num_trees;
    if (lp >= npts) return;
    const long long p = p0 + lp;
    const float* x_row = feats + p * d;
    const float* x_hot = xs + lp * hot;
    const int2* tree = records + (long long)t * n_nodes;
    const int fmask = (1 << feat_bits) - 1;
    int node = 0;
    for (int level = 0; level < max_depth; ++level) {
        const int2 rec = __ldg(tree + node);
        const int left = rec.x >> feat_bits;
        if (left == 0) break;
        const int f = rec.x & fmask;
        const float xv = f < hot ? x_hot[f] : __ldg(x_row + f);
        node = left + (xv >= __int_as_float(rec.y) ? 1 : 0);
    }
    leaves[p * num_trees + t] = node;
}

}  // namespace

extern "C" int rovina_forest_descent_staged(
    const void* feats, long long num_points, int d, int hot,
    const void* records, int num_trees, int n_nodes, int max_depth,
    int feat_bits, int tile_points, void* leaves, void* stream)
{
    if (num_points > 0) {
        // The wrapper checks tile_points * num_trees <= 1024 and that the
        // tile fits the card's shared memory.
        const size_t smem = sizeof(float) * (size_t)tile_points * hot;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                forest_descent_staged_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        const long long blocks = (num_points + tile_points - 1) / tile_points;
        forest_descent_staged_kernel<<<(unsigned)blocks,
                                       tile_points * num_trees, smem,
                                       (cudaStream_t)stream>>>(
            (const float*)feats, num_points, d, hot, (const int2*)records,
            num_trees, n_nodes, max_depth, feat_bits, tile_points,
            (int32_t*)leaves);
    }
    return (int)cudaGetLastError();
}
