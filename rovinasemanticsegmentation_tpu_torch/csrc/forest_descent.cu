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
// What bounds it on the card: a dependent chain of two loads per level -- the
// 8-byte node record (meta | threshold), then one feature of the point's row.
// The node tables of the bench forest (4 trees x ~11k nodes x 8 B = 350 KB)
// and the leaf histograms (3 MB) stay in L2; the feature matrix of a VGA
// frame (76800 x 366 x 4 B = 112 MB) does not, so most feature reads go to
// device memory. It is bound by the latency of that chain (~20 levels), and
// needs many threads in flight to hide it.
//
// Design: one thread per (point, tree), trees fastest within a block, so the
// T threads of one point read the same feature row. Node records are read as
// one int2 ([T, N, 2] table from models/forest.py::pack_node_records). The
// TPU kernel's level-major renumbering, 128-lane chunk sweeps, lane packing
// and transpose_pack were workarounds for the TPU's lack of a fast scalar
// gather and are gone. After the descent the block's leaf ids sit in shared
// memory, and the block's threads then produce the [points, L*C] posterior
// rows, each value summed over trees in order, so it is bit-identical to the
// plain version. x >= thr follows IEEE rules: NaN goes left, x == thr right.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void forest_descent_kernel(
    const float* __restrict__ feats,  // [P, D]
    long long num_points, int d,
    const int2* __restrict__ records,  // [T, N] (meta, threshold bits)
    int num_trees, int n_nodes,
    const float* __restrict__ leaf_hist,  // [T, N, LC]
    int lc_width, int max_depth, int feat_bits, int points_per_block,
    int32_t* __restrict__ leaves,  // [P, T]
    float* __restrict__ posterior)  // [P, LC]
{
    extern __shared__ int32_t leaf_s[];  // [points_per_block, T]
    const long long p0 = (long long)blockIdx.x * points_per_block;
    const int lp = threadIdx.x / num_trees;
    const int t = threadIdx.x - lp * num_trees;
    const long long p = p0 + lp;
    if (lp < points_per_block && p < num_points) {
        const float* x = feats + p * d;
        const int2* tree = records + (long long)t * n_nodes;
        const int fmask = (1 << feat_bits) - 1;
        int node = 0;
        for (int level = 0; level < max_depth; ++level) {
            const int2 rec = __ldg(tree + node);
            const int left = rec.x >> feat_bits;
            if (left == 0) break;
            const float xv = __ldg(x + (rec.x & fmask));
            node = left + (xv >= __int_as_float(rec.y) ? 1 : 0);
        }
        leaf_s[lp * num_trees + t] = node;
        leaves[p * num_trees + t] = node;
    }
    __syncthreads();

    const long long remaining = num_points - p0;
    const int npts = (int)(remaining < points_per_block ? remaining
                                                         : points_per_block);
    const int work = npts * lc_width;
    for (int k = threadIdx.x; k < work; k += blockDim.x) {
        const int q = k / lc_width;
        const int c = k - q * lc_width;
        float acc = 0.0f;
        for (int tt = 0; tt < num_trees; ++tt) {
            const int leaf = leaf_s[q * num_trees + tt];
            acc += __ldg(leaf_hist
                         + ((long long)tt * n_nodes + leaf) * lc_width + c);
        }
        posterior[(p0 + q) * lc_width + c] = acc;
    }
}

}  // namespace

extern "C" int rovina_forest_descent(
    const void* feats, long long num_points, int d,
    const void* records, int num_trees, int n_nodes,
    const void* leaf_hist, int lc_width, int max_depth, int feat_bits,
    void* leaves, void* posterior, void* stream)
{
    if (num_points > 0) {
        // ~256 threads per block; the wrapper keeps num_trees <= 1024.
        const int ppb = num_trees >= 256 ? 1 : 256 / num_trees;
        const int threads = ppb * num_trees;
        const long long blocks = (num_points + ppb - 1) / ppb;
        const size_t smem = sizeof(int32_t) * (size_t)ppb * num_trees;
        forest_descent_kernel<<<(unsigned)blocks, threads, smem,
                                (cudaStream_t)stream>>>(
            (const float*)feats, num_points, d, (const int2*)records,
            num_trees, n_nodes, (const float*)leaf_hist, lc_width, max_depth,
            feat_bits, ppb, (int32_t*)leaves, (float*)posterior);
    }
    return (int)cudaGetLastError();
}
