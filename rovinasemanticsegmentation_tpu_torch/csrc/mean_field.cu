// Mean-field inference of the map path's dense CRF for Hopper (sm_90a): the
// permutohedral filter (splat, blur, slice) fused with the Potts update and
// the block softmax, one launch a phase.
//
// Replaces no TPU kernel: the JAX package's mean field is XLA ops
// (rovinasemanticsegmentation_tpu/models/crf.py), and the plain PyTorch
// version (models/crf.py::potts_mean_field_multi_plain_t over
// models/lattice.py::lattice_filter_t) runs ~80 launches of a few
// microseconds a filter, 812 a 30000-point map. These kernels were added for
// that stage's device time. They take the lattice as build_lattice_device
// and lattice_tensors give it: the splat stream sorted by vertex with each
// vertex's [start, end) rows (padded slots empty, overflowed ids clamped into
// the bucket), int64 corner ids and blur neighbours, the zero slot at index
// m (the bucket's size).
//
// Channels travel as float4 rows: a point's or a vertex's C values padded
// with zeros to CP = 4 V channels (V = 5 for the map path's 8 + 9 classes),
// so that a gather is V 16-byte loads and the per-channel sums sit in
// registers, V a template parameter.
//
// 1. mf_splat_kernel, one warp a vertex slot (and one for the zero slot):
//    lane l sums rows start + l, start + l + 32, ... of the vertex's segment,
//    each the float32 product value * weight as the plain version forms it,
//    in float64 in row order; the lanes' sums of a channel then go through
//    shared memory to one lane, which adds them in lane order and rounds
//    once to float32. No atomics: the same bits on every run, and no float64
//    prefix over the whole stream (the plain version's, whose differences a
//    direct sum does not need). The lanes split a long segment (hundreds of
//    rows), whose chain of gathers sets the launch's time; an empty segment
//    (a padded slot) writes its zeros and leaves.
// 2. mf_blur_kernel, one thread a (vertex, float4): one pass
//    v + 0.5 (v[n1] + v[n2]) of the d+1, ping-pong between two [M+1, CP]
//    buffers, the zero slot rewritten as 0. A pass reads the whole previous
//    pass, so the passes are separate launches.
// 3. mf_slice_kernel, one thread a (point, float4), 64 points a block: the
//    d+1 corners' weighted sum of the blurred vertices times alpha; then, by
//    mode, that filter value, the symmetric normalisation
//    1 / sqrt(x + 1e-20), or the Potts energy -U + w * norm * filtered (-U
//    alone for the first step) into shared memory, and after a barrier the
//    max-subtracted softmax of each block of channels by one thread of the
//    point; the marginals go out [C, N] and times norm [N, CP], the next
//    splat's input. A thread a float4 gives the gathers V times the warps
//    that a thread a point would (30000 points fill 7 warps an SM).
//
// Every float32 operation is an _rn intrinsic, so nvcc contracts nothing
// into an FMA; expf is the accurate one (no --use_fast_math, no __expf).
//
// What bounds it on the card: port_bench/roofline.py's map_stages counts one
// iteration at 30000 points, 17 classes, d + 1 = 7 and 16384 vertex slots
// as 6.7 MB (marginals read and written, corners and weights, the vertices'
// tables), ~2 us at 3.35 TB/s; its flops take under 1 us. The work lives in
// L2 (the [M+1, CP] vertices are 1.3 MB), so the time goes to dependent
// gathers and to the 9 launches an iteration, each a few microseconds of
// ramp and tail.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_D1 = 16;         // simplex corners a point: d + 1
constexpr int MAX_VEC = 16;        // float4s a row: 64 channels
constexpr int MAX_BLOCKS = 64;     // softmax blocks
constexpr int SPLAT_WARPS = 4;     // vertex slots a block
constexpr int BLUR_THREADS = 256;
constexpr int SLICE_POINTS = 64;  // points a slice block: 64 V threads

enum SliceMode { MODE_FILTER = 0, MODE_NORM = 1, MODE_INIT = 2, MODE_UPDATE = 3 };

struct Blocks {
    int count;
    int end[MAX_BLOCKS];  // one past each block's last channel
};

template <int V>
__device__ __forceinline__ void add_row(double (&acc)[4 * V],
                                        const float4 (&x)[V], float w)
{
#pragma unroll
    for (int j = 0; j < V; ++j) {
        acc[4 * j + 0] = __dadd_rn(acc[4 * j + 0], (double)__fmul_rn(x[j].x, w));
        acc[4 * j + 1] = __dadd_rn(acc[4 * j + 1], (double)__fmul_rn(x[j].y, w));
        acc[4 * j + 2] = __dadd_rn(acc[4 * j + 2], (double)__fmul_rn(x[j].z, w));
        acc[4 * j + 3] = __dadd_rn(acc[4 * j + 3], (double)__fmul_rn(x[j].w, w));
    }
}

template <int V>
__device__ __forceinline__ void load_row(const float4* __restrict__ values,
                                         int p, float4 (&x)[V])
{
#pragma unroll
    for (int j = 0; j < V; ++j)
        x[j] = values != nullptr ? values[(size_t)p * V + j]
                                 : make_float4(j == 0 ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

// Vertex sums [M+1, V] float4 of a points-major [N, V] float4 stream
// (nullptr: ones in channel 0).
template <int V>
__global__ void __launch_bounds__(SPLAT_WARPS * 32)
mf_splat_kernel(const float4* __restrict__ values,
                const long long* __restrict__ sorted_points,
                const float* __restrict__ sorted_weights,
                const long long* __restrict__ seg_starts,
                const long long* __restrict__ seg_ends, int m,
                float4* __restrict__ verts)
{
    extern __shared__ double partial[];  // [SPLAT_WARPS][4 V][33]
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int v = blockIdx.x * SPLAT_WARPS + warp;
    if (v > m) return;  // warp-uniform, as every branch below
    const int start = v < m ? (int)seg_starts[v] : 0;
    const int end = v < m ? (int)seg_ends[v] : 0;
    if (start >= end) {  // the zero slot and the padded slots
        if (lane < V) verts[(size_t)v * V + lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        return;
    }
    double acc[4 * V];
#pragma unroll
    for (int i = 0; i < 4 * V; ++i) acc[i] = 0.0;
    int r = start + lane;
    for (; r + 32 < end; r += 64) {  // two rows in flight, in row order
        const int p0 = (int)sorted_points[r];
        const int p1 = (int)sorted_points[r + 32];
        const float w0 = sorted_weights[r];
        const float w1 = sorted_weights[r + 32];
        float4 x0[V], x1[V];
        load_row<V>(values, p0, x0);
        load_row<V>(values, p1, x1);
        add_row<V>(acc, x0, w0);
        add_row<V>(acc, x1, w1);
    }
    if (r < end) {
        float4 x0[V];
        load_row<V>(values, (int)sorted_points[r], x0);
        add_row<V>(acc, x0, sorted_weights[r]);
    }
    // The lanes' sums of a channel added in lane order by one lane
    // (rows 33 doubles apart: no bank conflicts on either side).
    double* mine = partial + (size_t)warp * (4 * V * 33);
#pragma unroll
    for (int i = 0; i < 4 * V; ++i) mine[i * 33 + lane] = acc[i];
    __syncwarp();
    float* out = reinterpret_cast<float*>(verts + (size_t)v * V);
    for (int ch = lane; ch < 4 * V; ch += 32) {
        double total = mine[ch * 33];
        for (int k = 1; k < 32; ++k) total = __dadd_rn(total, mine[ch * 33 + k]);
        out[ch] = __double2float_rn(total);
    }
}

// One blur pass over [M+1, V] float4 vertices along the axis whose
// neighbour rows are n1 and n2 ([M] each); the zero slot m stays 0.
__global__ void __launch_bounds__(BLUR_THREADS)
mf_blur_kernel(const float4* __restrict__ in, const long long* __restrict__ n1,
               const long long* __restrict__ n2, int m, int vec,
               float4* __restrict__ out)
{
    const int idx = blockIdx.x * BLUR_THREADS + threadIdx.x;
    if (idx >= (m + 1) * vec) return;
    const int v = idx / vec;
    const int j = idx - v * vec;
    if (v == m) {
        out[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        return;
    }
    const float4 a = in[(size_t)n1[v] * vec + j];
    const float4 b = in[(size_t)n2[v] * vec + j];
    const float4 c = in[idx];
    out[idx] = make_float4(
        __fadd_rn(c.x, __fmul_rn(0.5f, __fadd_rn(a.x, b.x))),
        __fadd_rn(c.y, __fmul_rn(0.5f, __fadd_rn(a.y, b.y))),
        __fadd_rn(c.z, __fmul_rn(0.5f, __fadd_rn(a.z, b.z))),
        __fadd_rn(c.w, __fmul_rn(0.5f, __fadd_rn(a.w, b.w))));
}

// Slice, then by mode: the filter [C, N]; the normalisation [N]; or the
// Potts energy and block softmax -> marginals [C, N] and marginals * norm
// [N, V] float4, zero-padded. Thread (point, j) slices the point's float4 j
// of channels; after a barrier, thread (point, j) runs the softmax of blocks
// j, j + V, ... of the point from shared memory. The unary [C, N] is read
// through its strides.
template <int V>
__global__ void __launch_bounds__(SLICE_POINTS * V)
mf_slice_kernel(int mode, const float4* __restrict__ verts, int c,
                const long long* __restrict__ offsets,
                const float* __restrict__ bary, int n, int d1, float alpha,
                const float* __restrict__ norm, float weight,
                const float* __restrict__ unary, long long u_sc,
                long long u_sp, Blocks blocks, float* __restrict__ out,
                float4* __restrict__ qn)
{
    extern __shared__ float energy[];  // [4 V][SLICE_POINTS]
    const int lp = threadIdx.x % SLICE_POINTS;
    const int j = threadIdx.x / SLICE_POINTS;
    const int p = blockIdx.x * SLICE_POINTS + lp;
    const bool live = p < n;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live && mode != MODE_INIT) {
        int o[MAX_D1];
        float b[MAX_D1];
#pragma unroll
        for (int k = 0; k < MAX_D1; ++k) {
            if (k < d1) {
                o[k] = (int)offsets[(size_t)k * n + p];
                b[k] = bary[(size_t)k * n + p];
            }
        }
#pragma unroll
        for (int k = 0; k < MAX_D1; ++k) {
            if (k < d1) {
                const float4 x = verts[(size_t)o[k] * V + j];
                s[0] = __fadd_rn(s[0], __fmul_rn(x.x, b[k]));
                s[1] = __fadd_rn(s[1], __fmul_rn(x.y, b[k]));
                s[2] = __fadd_rn(s[2], __fmul_rn(x.z, b[k]));
                s[3] = __fadd_rn(s[3], __fmul_rn(x.w, b[k]));
            }
        }
    }
    if (mode == MODE_NORM) {  // block-uniform, as MODE_FILTER: no barrier
        if (live)
            out[p] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(s[0], alpha), 1e-20f)));
        return;
    }
    if (mode == MODE_FILTER) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if (live && 4 * j + i < c)
                out[(size_t)(4 * j + i) * n + p] = __fmul_rn(s[i], alpha);
        return;
    }
    const float nm = live ? norm[p] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int ch = 4 * j + i;
        if (live && ch < c) {
            float e = -unary[ch * u_sc + p * u_sp];
            if (mode == MODE_UPDATE)
                e = __fadd_rn(e, __fmul_rn(weight, __fmul_rn(__fmul_rn(s[i], alpha), nm)));
            energy[ch * SLICE_POINTS + lp] = e;
        }
    }
    __syncthreads();
    for (int bi = j; live && bi < blocks.count; bi += V) {
        const int lo = bi > 0 ? blocks.end[bi - 1] : 0;
        const int hi = blocks.end[bi];
        float mx = energy[lo * SLICE_POINTS + lp];
        for (int ch = lo + 1; ch < hi; ++ch)
            mx = fmaxf(mx, energy[ch * SLICE_POINTS + lp]);
        float sum = 0.0f;
        for (int ch = lo; ch < hi; ++ch) {
            const float ex = expf(__fsub_rn(energy[ch * SLICE_POINTS + lp], mx));
            energy[ch * SLICE_POINTS + lp] = ex;
            sum = __fadd_rn(sum, ex);
        }
        for (int ch = lo; ch < hi; ++ch) {
            const float q = __fdiv_rn(energy[ch * SLICE_POINTS + lp], sum);
            energy[ch * SLICE_POINTS + lp] = q;
            out[(size_t)ch * n + p] = q;
        }
    }
    __syncthreads();
    if (live) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int ch = 4 * j + i;
            s[i] = ch < c ? __fmul_rn(energy[ch * SLICE_POINTS + lp], nm) : 0.0f;
        }
        qn[(size_t)p * V + j] = make_float4(s[0], s[1], s[2], s[3]);
    }
}

struct Lattice {
    const long long* sorted_points;
    const float* sorted_weights;
    const long long* seg_starts;
    const long long* seg_ends;
    const long long* offsets;
    const float* bary;
    const long long* blur_n1;
    const long long* blur_n2;
    int m;
    int d1;
};

// The widths a row may take: V float4s, the wrapper's padding
// (ops/mean_field_cuda.py::row_width): the normalisation's one channel, the
// map path's 17 classes, and the most the kernels take.
#define FOR_WIDTHS(X) X(1) X(5) X(16)

template <int V>
cudaError_t splat_blur_v(const float4* values, const Lattice& lat,
                         bool reverse, float4* a, float4* b, cudaStream_t s,
                         float4** result)
{
    const int splat_blocks = (lat.m + 1 + SPLAT_WARPS - 1) / SPLAT_WARPS;
    const int smem = SPLAT_WARPS * 4 * V * 33 * (int)sizeof(double);
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {  // opt in above the default limit
        err = cudaFuncSetAttribute(mf_splat_kernel<V>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return err;
    }
    mf_splat_kernel<V><<<splat_blocks, SPLAT_WARPS * 32, smem, s>>>(
        values, lat.sorted_points, lat.sorted_weights, lat.seg_starts,
        lat.seg_ends, lat.m, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int blur_blocks = ((lat.m + 1) * V + BLUR_THREADS - 1) / BLUR_THREADS;
    for (int i = 0; i < lat.d1; ++i) {
        const int j = reverse ? lat.d1 - 1 - i : i;
        mf_blur_kernel<<<blur_blocks, BLUR_THREADS, 0, s>>>(
            a, lat.blur_n1 + (size_t)j * lat.m, lat.blur_n2 + (size_t)j * lat.m,
            lat.m, V, b);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        float4* tmp = a;
        a = b;
        b = tmp;
    }
    *result = a;
    return cudaSuccess;
}

// Splat and the d+1 blur passes of a points-major [N, V] float4 stream
// (nullptr: ones) -> the buffer (a or b) that holds the blurred vertices.
cudaError_t splat_blur(int vec, const float4* values, const Lattice& lat,
                       bool reverse, float4* a, float4* b, cudaStream_t s,
                       float4** result)
{
    switch (vec) {
#define CASE(V) case V: return splat_blur_v<V>(values, lat, reverse, a, b, s, result);
        FOR_WIDTHS(CASE)
#undef CASE
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t slice(int vec, int mode, const float4* verts, int c,
                  const Lattice& lat, int n, float alpha, const float* norm,
                  float weight, const float* unary, long long u_sc,
                  long long u_sp, const Blocks& blocks, float* out,
                  float4* qn, cudaStream_t s)
{
    const int grid = (n + SLICE_POINTS - 1) / SLICE_POINTS;
    const int smem = mode >= MODE_INIT ? 4 * vec * SLICE_POINTS * (int)sizeof(float) : 0;
    switch (vec) {
#define CASE(V) case V: mf_slice_kernel<V><<<grid, SLICE_POINTS * V, smem, s>>>( \
            mode, verts, c, lat.offsets, lat.bary, n, lat.d1, alpha, norm,    \
            weight, unary, u_sc, u_sp, blocks, out, qn); break;
        FOR_WIDTHS(CASE)
#undef CASE
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

Lattice make_lattice(const void* sorted_points, const void* sorted_weights,
                     const void* seg_starts, const void* seg_ends,
                     const void* offsets, const void* bary,
                     const void* blur_n1, const void* blur_n2, int m, int d1)
{
    return Lattice{(const long long*)sorted_points, (const float*)sorted_weights,
                   (const long long*)seg_starts, (const long long*)seg_ends,
                   (const long long*)offsets, (const float*)bary,
                   (const long long*)blur_n1, (const long long*)blur_n2, m, d1};
}

bool fits(int n, int c, int vec, int m, int d1)
{
    return n > 0 && c >= 1 && c <= 4 * vec && vec <= MAX_VEC && d1 >= 1
        && d1 <= MAX_D1 && m >= 0;
}

}  // namespace

// The filter of a points-major [N, 4 vec] stream, zero-padded past C
// (values nullptr: ones, C = 1): mode 0 writes splat -> blur -> slice,
// [C, N]; mode 1 the symmetric normalisation 1 / sqrt(filter + 1e-20), [N].
// a and b hold [M+1, 4 vec] each.
extern "C" int rovina_lattice_filter(
    const void* values, int n, int c, int vec, int mode,
    const void* sorted_points, const void* sorted_weights,
    const void* seg_starts, const void* seg_ends, const void* offsets,
    const void* bary, const void* blur_n1, const void* blur_n2, int m, int d1,
    int reverse, float alpha, void* a, void* b, void* out, void* stream)
{
    if (!fits(n, c, vec, m, d1) || (mode != MODE_FILTER && mode != MODE_NORM)
        || (mode == MODE_NORM && (c != 1 || values != nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Lattice lat = make_lattice(sorted_points, sorted_weights, seg_starts,
                                     seg_ends, offsets, bary, blur_n1, blur_n2,
                                     m, d1);
    float4* verts = nullptr;
    cudaError_t err = splat_blur(vec, (const float4*)values, lat, reverse != 0,
                                 (float4*)a, (float4*)b, s, &verts);
    if (err != cudaSuccess) return (int)err;
    Blocks none{};
    return (int)slice(vec, mode, verts, c, lat, n, alpha, nullptr, 0.0f,
                      nullptr, 0, 0, none, (float*)out, nullptr, s);
}

// n_iterations mean-field steps of per-block Potts CRFs on one lattice:
// Q = softmax_blocks(-U + w * norm * filter(norm * Q)) from
// Q = softmax_blocks(-U). unary [C, N] through its strides (u_sc, u_sp);
// q [C, N] out; qn [N, 4 vec], a and b [M+1, 4 vec] scratch.
extern "C" int rovina_mean_field(
    const void* unary, long long u_sc, long long u_sp, int n, int c, int vec,
    const int* block_ends, int num_blocks, const void* sorted_points,
    const void* sorted_weights, const void* seg_starts, const void* seg_ends,
    const void* offsets, const void* bary, const void* blur_n1,
    const void* blur_n2, int m, int d1, float alpha, const void* norm,
    float weight, int n_iterations, void* qn, void* a, void* b, void* q,
    void* stream)
{
    if (!fits(n, c, vec, m, d1) || num_blocks < 1 || num_blocks > MAX_BLOCKS
        || n_iterations < 0)
        return (int)cudaErrorInvalidValue;
    Blocks blocks{};
    blocks.count = num_blocks;
    int prev = 0;
    for (int i = 0; i < num_blocks; ++i) {
        if (block_ends[i] <= prev) return (int)cudaErrorInvalidValue;
        blocks.end[i] = prev = block_ends[i];
    }
    if (prev != c) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const Lattice lat = make_lattice(sorted_points, sorted_weights, seg_starts,
                                     seg_ends, offsets, bary, blur_n1, blur_n2,
                                     m, d1);
    const float* u = (const float*)unary;
    const float* nm = (const float*)norm;
    cudaError_t err = slice(vec, MODE_INIT, nullptr, c, lat, n, alpha, nm,
                            weight, u, u_sc, u_sp, blocks, (float*)q,
                            (float4*)qn, s);
    if (err != cudaSuccess) return (int)err;
    for (int it = 0; it < n_iterations; ++it) {
        float4* verts = nullptr;
        err = splat_blur(vec, (const float4*)qn, lat, false, (float4*)a,
                         (float4*)b, s, &verts);
        if (err != cudaSuccess) return (int)err;
        err = slice(vec, MODE_UPDATE, verts, c, lat, n, alpha, nm, weight, u,
                    u_sc, u_sp, blocks, (float*)q, (float4*)qn, s);
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}
