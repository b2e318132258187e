// Surface-normal angles at the stride grid for Hopper (sm_90a), in three
// launches a frame.
//
// Replaces no TPU kernel: the JAX package computes the normals with XLA ops
// (rovinasemanticsegmentation_tpu/ops/normals.py), and the plain PyTorch
// version (ops/normals.py::normal_angles_grid) runs ~845 launches of a few
// microseconds each for a VGA keyframe. These kernels were added for that
// stage's device time. For an integral smoothing size s (the saturated
// chamfer) they compute what the plain version computes on the card, bit for
// bit, by rounding where PyTorch's CUDA operators round:
//
// 1. normals_prepare_kernel, two kinds of blocks in one launch:
//    - column blocks, 32 chains (channel, column) each: the central-difference
//      gradients in float64 (_gradient_integral: NaN outside the image or on
//      a NaN point, nan_to_num, the two validity channels) and their running
//      sum down the column, in the order of PyTorch's
//      tensor_kernel_scan_outer_dim (sequential from row 0), into the
//      [8, H, W] float64 buffer. The block's 8 warps compute a batch of rows'
//      values into shared memory, and warp 0 runs the chains of adds;
//    - tile blocks, one a 32x32 pixel tile: the depth-change map
//      (_depth_change_map) and the saturated chamfer (_chamfer_iter) in
//      shared memory, over the tile and a halo of s pixels (of s + 1 for the
//      depth): s rounds of the 3x3 float32 min-plus relaxation. A round moves
//      a value by one pixel, so the halo keeps the tile exact. The distance
//      goes out at the tile's grid pixels only.
//    The tiles fill the SMs that the few column blocks leave idle.
// 2. normals_row_scan_kernel, one warp a row: the running sum along each row
//    of that buffer, in place, in the order of PyTorch's
//    tensor_kernel_scan_innermost_dim: chunks of 2 nx values, the total of
//    the chunks before added to a chunk's first value, then Sklansky's tree
//    over the chunk, by shuffles; nx comes from the wrapper, which picks it
//    as PyTorch does. The buffer is then the float64 integral image without
//    its zero row and column.
// 3. normals_angle_kernel, one thread a grid point: the box sums over the
//    point's own window (rect = int(min(distance, s)), corners clamped to
//    [0, H] x [0, W] as the plain version's stride branch clamps them and
//    combined in its order), the cross product, norm, ratio and acos in
//    float64 as PyTorch's cross, vector_norm and elementwise kernels round
//    them, the validity gates, and the float32 angle, -2 where invalid.
//
// Every operation is an _rn intrinsic, so nvcc fuses nothing into an FMA
// that PyTorch's kernels do not have; the one FMA of PyTorch's cross product
// is written out.
//
// What bounds it on the card: port_bench/roofline.py's "normals" least time
// (200 flops a pixel, 60 a grid point) is ~1 us at VGA; the float64 integral
// image (8 x 480 x 640 x 8 B = 19.7 MB) has to be written and read once,
// ~12 us at 3.35 TB/s. Launch 1 writes the column prefix (19.7 MB) and
// reads the points (3.7 MB); launch 2 reads and writes the buffer; launch 3
// reads 4 corners x 8 channels a grid point, mostly from L2. On the H100 at
// VGA the three take ~34, ~9.5 and ~7 us: the first is held by the column
// chains (480 dependent float64 adds and a store a row, ~27 us alone) and
// the tiles (~29 us alone), neither by bytes.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_W = 32;          // pixels of a distance tile: columns
constexpr int TILE_H = 32;          // and rows
constexpr int MAX_ROUNDS = 16;      // the largest smoothing size taken
constexpr int PREP_THREADS = 256;
constexpr int ANGLE_THREADS = 256;
constexpr int SCAN_THREADS = 256;   // 8 rows a block, a warp each
constexpr int COLUMN_BATCH = 64;    // rows of a column block's batch
constexpr int CHANNELS = 8;         // grad_x (3), grad_y (3), valid_x, valid_y

__device__ __forceinline__ double nan_to_num(double v)
{
    if (isnan(v)) return 0.0;
    if (isinf(v)) return v > 0.0 ? DBL_MAX : -DBL_MAX;
    return v;
}

// Channel c of the stack at (y, x): torch's _shift_nan(p, .., -1) -
// _shift_nan(p, .., 1) of coordinate c % 3 along x (c = 0-2, and 6 for its
// validity) or y (c = 3-5, and 7), in float64, then nan_to_num (or the
// validity).
__device__ __forceinline__ double stack_value(const float* __restrict__ pts,
                                              int h, int w, int c, int y,
                                              int x)
{
    const bool along_x = c < 3 || c == 6;
    const bool ok_a = along_x ? x + 1 < w : y + 1 < h;
    const bool ok_b = along_x ? x >= 1 : y >= 1;
    const float* p = pts + ((size_t)y * w + x) * 3 + (c < 6 ? c % 3 : 0);
    const int step = along_x ? 3 : 3 * w;  // floats to the next neighbour
    const double g = __dsub_rn(ok_a ? (double)__ldg(p + step) : NAN,
                               ok_b ? (double)__ldg(p - step) : NAN);
    return c < 6 ? nan_to_num(g) : (isnan(g) ? 0.0 : 1.0);
}

// A column block: 32 chains (channel c, column x), each the running sum of
// its channel down its column from row 0, in the order of PyTorch's
// tensor_kernel_scan_outer_dim. Only the adds are sequential: the block's 8
// warps compute the values of a batch of COLUMN_BATCH rows into shared
// memory, each its rows unrolled so that their loads go out together, and
// warp 0 adds them up.
__device__ void column_block(const float* __restrict__ pts, int h, int w,
                             int block, double* __restrict__ prefix,
                             double* values)  // [COLUMN_BATCH][32]
{
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    constexpr int WARPS = PREP_THREADS / 32;
    const int t = block * 32 + lane;
    const bool chain = t < CHANNELS * w;
    const int c = t / w, x = t % w;
    double* col = prefix + (size_t)c * h * w + x;
    double acc = 0.0;  // PyTorch's init: the first sum is 0 + v
    for (int y0 = 0; y0 < h; y0 += COLUMN_BATCH) {
#pragma unroll
        for (int k = 0; k < COLUMN_BATCH / WARPS; ++k) {
            const int i = k * WARPS + warp;
            if (chain && y0 + i < h)
                values[i * 32 + lane] = stack_value(pts, h, w, c, y0 + i, x);
        }
        __syncthreads();
        if (warp == 0 && chain) {
            const int n = min(COLUMN_BATCH, h - y0);
            int i = 0;
            for (; i + 8 <= n; i += 8) {
                double v[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) v[k] = values[(i + k) * 32 + lane];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    acc = __dadd_rn(acc, v[k]);
                    col[(size_t)(y0 + i + k) * w] = acc;
                }
            }
            for (; i < n; ++i) {
                acc = __dadd_rn(acc, values[i * 32 + lane]);
                col[(size_t)(y0 + i) * w] = acc;
            }
        }
        __syncthreads();
    }
}

__device__ __forceinline__ float depth_threshold(float z, float factor)
{
    // factor * (|z| + 1.0) * 2.0, each step rounded to float32
    return __fmul_rn(__fmul_rn(factor, __fadd_rn(fabsf(z), 1.0f)), 2.0f);
}

// Whether the pair (z0, z1), z1 right of or below z0, marks both pixels: a
// NaN in either, or a jump over the threshold of z0. No short circuit, so no
// branch.
__device__ __forceinline__ bool jumps(float z0, float z1, float factor)
{
    return (z0 != z0) | (z1 != z1)
        | (fabsf(__fsub_rn(z0, z1)) > depth_threshold(z0, factor));
}

__device__ void distance_tile(const float* __restrict__ pts, int h, int w,
                              int tile, float factor, int rounds, float sat,
                              int stride, int gw, float* __restrict__ dist,
                              float* smem)
{
    // The block as 32 x 8 threads walks the regions row by row.
    const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
    constexpr int TY = PREP_THREADS / 32;
    constexpr int REGION_ROWS = (TILE_H + 2 * MAX_ROUNDS + TY - 1) / TY;
    constexpr int REGION_COLS = (TILE_W + 2 * MAX_ROUNDS + 31) / 32;
    const int tiles_x = (w + TILE_W - 1) / TILE_W;
    const int y0 = (tile / tiles_x) * TILE_H;
    const int x0 = (tile % tiles_x) * TILE_W;
    const int dh = TILE_H + 2 * rounds, dw = TILE_W + 2 * rounds;  // distances
    const int zh = dh + 2, zw = dw + 2;                             // depth
    float* a = smem;  // depth, then distances
    float* b = a + max(zh * zw, dh * dw);
    unsigned char* pair = reinterpret_cast<unsigned char*>(b + dh * dw);

#pragma unroll
    for (int q = 0; q < REGION_ROWS + 1; ++q) {  // unrolled: the loads overlap
        const int i = ty + q * TY;
        const int y = y0 - rounds - 1 + i;
#pragma unroll
        for (int u = 0; u < REGION_COLS + 1; ++u) {
            const int j = tx + 32 * u;
            const int x = x0 - rounds - 1 + j;
            if (i < zh && j < zw)
                a[i * zw + j] = (y >= 0 && y < h && x >= 0 && x < w)
                    ? __ldg(pts + ((size_t)y * w + x) * 3 + 2) : NAN;
        }
    }
    __syncthreads();
    // Each pixel's right (bit 0) and lower (bit 1) pair, inside the image.
    for (int i = ty; i < zh - 1; i += TY) {
        const int y = y0 - rounds - 1 + i;
        for (int j = tx; j < zw - 1; j += 32) {
            const int x = x0 - rounds - 1 + j;
            const float* z = a + i * zw + j;
            const bool inside = y >= 0 && y < h && x >= 0 && x < w;
            pair[i * zw + j] =
                (inside & (x < w - 1) & jumps(z[0], z[1], factor))
                | ((inside & (y < h - 1) & jumps(z[0], z[zw], factor)) << 1);
        }
    }
    __syncthreads();
    // Seeds: 0 on the pixels of a marked pair, sat elsewhere and outside the
    // image.
    for (int i = ty; i < dh; i += TY) {
        for (int j = tx; j < dw; j += 32) {
            const unsigned char* f = pair + (i + 1) * zw + (j + 1);
            const bool change = (f[0] & 3) | (f[-1] & 1) | (f[-zw] & 2);
            b[i * dw + j] = change ? 0.0f : sat;
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < dh * dw; k += PREP_THREADS) a[k] = b[k];
    __syncthreads();
    // Both buffers hold the seeds. Columns 0 and w-1 stay pinned to their
    // seed and out-of-image cells at sat. Round r relaxes only the cells at
    // least r + 1 from the region's edge: the cells nearer have lost
    // neighbours, and their error, which moves inward a pixel a round, ends
    // in the halo; the tile, `rounds` from the edge, is exact at the end.
    float* src = a;
    float* dst = b;
    for (int r = 0; r < rounds; ++r) {
        // A thread's cells, unrolled and without branches in the body, so
        // that the loads of independent cells overlap. A cell that is not
        // relaxed is copied.
#pragma unroll
        for (int q = 0; q < REGION_ROWS; ++q) {
            const int i = ty + q * TY;
            if (i < r + 1 || i > dh - 2 - r) continue;  // the warp's row
            const int y = y0 - rounds + i;
            const bool row = y >= 0 && y < h;
#pragma unroll
            for (int u = 0; u < REGION_COLS; ++u) {
                const int j = tx + 32 * u;
                if (j < 1 || j > dw - 2) continue;
                const int x = x0 - rounds + j;
                const bool relax = row & (j >= r + 1) & (j <= dw - 2 - r)
                                 & (x >= 1) & (x <= w - 2);
                const float* s = src + i * dw + j;
                const float axial = fminf(fminf(s[1], s[-1]),
                                          fminf(s[dw], s[-dw]));
                const float diag = fminf(fminf(s[dw + 1], s[dw - 1]),
                                         fminf(s[-dw + 1], s[-dw - 1]));
                const float v = fminf(s[0], fminf(__fadd_rn(axial, 1.0f),
                                                  __fadd_rn(diag, 1.4f)));
                dst[i * dw + j] = relax ? v : s[0];
            }
        }
        __syncthreads();
        float* t = src;
        src = dst;
        dst = t;
    }
    for (int i = ty; i < TILE_H; i += TY) {
        for (int j = tx; j < TILE_W; j += 32) {
            const int y = y0 + i, x = x0 + j;
            if (y < h && x < w && y % stride == 0 && x % stride == 0)
                dist[(size_t)(y / stride) * gw + x / stride] =
                    src[(i + rounds) * dw + j + rounds];
        }
    }
}

// Blocks [0, column_blocks) are column blocks, the others distance tiles:
// the tiles fill the SMs that the column chains leave idle.
__global__ void __launch_bounds__(PREP_THREADS, 3) normals_prepare_kernel(
    const float* __restrict__ pts, int h, int w, int column_blocks,
    float factor, int rounds, float sat, int stride, int gw,
    double* __restrict__ prefix, float* __restrict__ dist)
{
    extern __shared__ __align__(16) float tile_smem[];
    if ((int)blockIdx.x < column_blocks) {
        column_block(pts, h, w, blockIdx.x, prefix,
                     reinterpret_cast<double*>(tile_smem));
        return;
    }
    distance_tile(pts, h, w, blockIdx.x - column_blocks, factor, rounds, sat,
                  stride, gw, dist, tile_smem);
}

// One warp a row, in chunks of C = 32 E values (C = 2 nx in PyTorch's
// kernel), lane l holding values [l E, l E + E) of a chunk. Sklansky's level
// m adds to each value whose index has bit m set the value at that index
// with bits 0..m cleared, less one: for 2^m < E within a lane, above that
// from the last value of another lane, by a shuffle. Every value gets PyTorch's
// adds in PyTorch's order.
template <int E>
__global__ void __launch_bounds__(SCAN_THREADS) normals_row_scan_kernel(
    double* __restrict__ data, int num_rows, int row_size)
{
    constexpr unsigned FULL = 0xffffffffu;
    constexpr int C = 32 * E;
    const int lane = threadIdx.x % 32;
    const int row = blockIdx.x * (SCAN_THREADS / 32) + threadIdx.x / 32;
    if (row >= num_rows) return;  // the whole warp
    double* r = data + (size_t)row * row_size;
    double next[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        const int c = lane * E + e;
        next[e] = c < row_size ? r[c] : 0.0;
    }
    double total = 0.0;
    for (int col0 = 0; col0 < row_size; col0 += C) {
        double v[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            v[e] = next[e];
            // The next chunk's loads go out before this chunk's tree.
            const int c = col0 + C + lane * E + e;
            next[e] = c < row_size ? r[c] : 0.0;
        }
        if (lane == 0) v[0] = __dadd_rn(v[0], total);
#pragma unroll
        for (int s = 1; s < E; s <<= 1) {
#pragma unroll
            for (int e = 0; e < E; ++e)
                if (e & s) v[e] = __dadd_rn(v[e], v[(e & ~(s - 1)) - 1]);
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            const int from = max(((lane >> k) << k) - 1, 0);
            const double t = __shfl_sync(FULL, v[E - 1], from);
            if (lane & (1 << k)) {
#pragma unroll
                for (int e = 0; e < E; ++e) v[e] = __dadd_rn(v[e], t);
            }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const int c = col0 + lane * E + e;
            if (c < row_size) r[c] = v[e];
        }
        total = __shfl_sync(FULL, v[E - 1], 31);
    }
}

template <int E>
cudaError_t launch_row_scan(double* data, int num_rows, int row_size,
                            cudaStream_t s)
{
    constexpr int rows_a_block = SCAN_THREADS / 32;
    normals_row_scan_kernel<E>
        <<<(num_rows + rows_a_block - 1) / rows_a_block, SCAN_THREADS, 0, s>>>(
            data, num_rows, row_size);
    return cudaGetLastError();
}

// The padded integral image's entry (y, x), y in [0, h], x in [0, w].
__device__ __forceinline__ double integral_at(const double* __restrict__ plane,
                                              int w, int y, int x)
{
    return (y == 0 || x == 0) ? 0.0 : plane[(size_t)(y - 1) * w + (x - 1)];
}

__global__ void __launch_bounds__(ANGLE_THREADS) normals_angle_kernel(
    const float* __restrict__ pts, const double* __restrict__ integ,
    const float* __restrict__ dist, int h, int w, int stride, int gh, int gw,
    float size, int border, float* __restrict__ out)
{
    const int p = blockIdx.x * ANGLE_THREADS + threadIdx.x;
    if (p >= gh * gw) return;
    const int gy = (p / gw) * stride, gx = (p % gw) * stride;
    const float smoothing = fminf(dist[p], size);
    const float z = pts[((size_t)gy * w + gx) * 3 + 2];
    if (!(smoothing > 2.0f) || isnan(z) || gy < border || gy >= h - border
        || gx < border || gx >= w - border) {
        out[p] = -2.0f;
        return;
    }
    const int rect = (int)smoothing;
    const int y0 = min(max(gy - rect / 2, 0), h);
    const int y1 = min(max(gy - rect / 2 + rect, 0), h);
    const int x0 = min(max(gx - rect / 2, 0), w);
    const int x1 = min(max(gx - rect / 2 + rect, 0), w);
    double acc[CHANNELS];
#pragma unroll
    for (int c = 0; c < CHANNELS; ++c) {
        const double* plane = integ + (size_t)c * h * w;
        acc[c] = __dadd_rn(
            __dsub_rn(__dsub_rn(integral_at(plane, w, y1, x1),
                                integral_at(plane, w, y0, x1)),
                      integral_at(plane, w, y1, x0)),
            integral_at(plane, w, y0, x0));
    }
    // torch.linalg.cross(sum_gy, sum_gx): PyTorch's cross_kernel computes
    // a * b - c * d as fma(a, b, -(c * d)).
    const double* sx = acc;
    const double* sy = acc + 3;
    const double n0 = __fma_rn(sy[1], sx[2], -__dmul_rn(sy[2], sx[1]));
    const double n1 = __fma_rn(sy[2], sx[0], -__dmul_rn(sy[0], sx[2]));
    const double n2 = __fma_rn(sy[0], sx[1], -__dmul_rn(sy[1], sx[0]));
    // vector_norm over 3 values: two lanes, (n0^2 + n2^2) + n1^2.
    const double norm = __dsqrt_rn(__dadd_rn(
        __dadd_rn(__dmul_rn(n0, n0), __dmul_rn(n2, n2)), __dmul_rn(n1, n1)));
    if (!(acc[6] > 0.0) || !(acc[7] > 0.0) || !(norm > 0.0)) {
        out[p] = -2.0f;
        return;
    }
    double nz = __ddiv_rn(fabs(n2), fmax(norm, 1e-20));
    if (!isnan(nz)) nz = fmin(fmax(nz, 0.0), 1.0);
    out[p] = __double2float_rn(acos(nz));
}

// The prepare kernel's shared memory: a distance tile's depth (then
// distances), distances and pair marks (a byte a pixel), or a column block's
// two batches of values, whichever is larger.
int prepare_shared_bytes(int rounds)
{
    const int dh = TILE_H + 2 * rounds, dw = TILE_W + 2 * rounds;
    const int tile = (int)sizeof(float)
        * (std::max((dh + 2) * (dw + 2), dh * dw) + dh * dw)
        + (dh + 2) * (dw + 2);
    return std::max(tile, (int)sizeof(double) * COLUMN_BATCH * 32);
}

}  // namespace

extern "C" int rovina_normals(
    const void* points, int h, int w, int stride, int gh, int gw,
    float factor, int size, int log_nx, void* integ, void* dist, void* out,
    void* stream)
{
    if (gh * gw == 0) return (int)cudaGetLastError();
    if (size < 1 || size > MAX_ROUNDS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int smem = prepare_shared_bytes(size);
    if (smem > 48 * 1024) {  // opt in above the default limit
        const cudaError_t err = cudaFuncSetAttribute(
            normals_prepare_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int column_blocks = (CHANNELS * w + 31) / 32;  // 32 chains each
    const int tiles = ((h + TILE_H - 1) / TILE_H) * ((w + TILE_W - 1) / TILE_W);
    normals_prepare_kernel<<<column_blocks + tiles, PREP_THREADS, smem, s>>>(
        (const float*)points, h, w, column_blocks, factor, size, (float)size,
        stride, gw, (double*)integ, (float*)dist);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int num_rows = CHANNELS * h;
    switch (log_nx) {  // chunks of 2^(log_nx + 1) values: E = 2^(log_nx - 4)
        case 4: err = launch_row_scan<1>((double*)integ, num_rows, w, s); break;
        case 5: err = launch_row_scan<2>((double*)integ, num_rows, w, s); break;
        case 6: err = launch_row_scan<4>((double*)integ, num_rows, w, s); break;
        case 7: err = launch_row_scan<8>((double*)integ, num_rows, w, s); break;
        case 8: err = launch_row_scan<16>((double*)integ, num_rows, w, s); break;
        case 9: err = launch_row_scan<32>((double*)integ, num_rows, w, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;

    normals_angle_kernel<<<(gh * gw + ANGLE_THREADS - 1) / ANGLE_THREADS,
                           ANGLE_THREADS, 0, s>>>(
        (const float*)points, (const double*)integ, (const float*)dist, h, w,
        stride, gh, gw, (float)size, size, (float*)out);
    return (int)cudaGetLastError();
}
