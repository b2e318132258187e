// Depth-adaptive patch resampling for Hopper (sm_90a), and the Lab pack.
//
// Replaces the TPU kernel rovinasemanticsegmentation_tpu/ops/patches_pallas.py
// (_kernel, driven by extract_patches_pallas). For every stride-grid point
// with depth d > 0 the window half-size is h = min(floor(B / (2 d)), B); the
// (2h+1)^2 window of the reflect-padded 8-bit Lab image around the point is
// resized bilinearly to R x R x 3 with OpenCV's fixed-point 8U rule: weights
// in 1/2048ths from the per-h tap tables (ops/patches.py::tap_tables) and
// rounding (acc + 2^21) >> 22. Points with d <= 0 get zeros. Reference:
// include/feature_extractor.h:125-175 of the C++ system.
//
// Output rows. Point p's R*R*3 bytes start at out + (row0 + p) * row_bytes,
// and the rest of its row, up to row_bytes, is written with zeros. With
// row_bytes = R*R*3 that is the [gh, gw, R, R, 3] patch tensor; with the
// packed feature row's stride (ops/feature_rows.py, 384 B by default) the
// kernel writes a frame's patch bytes straight into the batch's row buffer,
// where the float32 tail is written after it.
//
// What bounds it on the card: at VGA, stride 2 and R = 11 it writes 76800 x
// 363 B = 27.9 MB and reads a 634 x 794 packed int32 image (2.0 MB, L2- and
// L1-resident) and a 0.3 MB depth grid: about 30 MB, 9.5 us at 3.35 TB/s.
// The arithmetic, about 7 int32 instructions per output byte, is 6 multiplies
// and multiply-adds on the FMA pipe (164 M at VGA, about 9.8 us at 64 per SM
// per clock) and a shift on the ALU pipe, which issues beside it: bytes and
// operations bound it about equally. The first version (one thread per
// output pixel) spent its time elsewhere: two 64-bit divisions per thread,
// the window size recomputed by all 121 threads of a point, and single-byte
// stores at a 3-byte stride.
//
// Design: a block takes a tile of TILE consecutive grid points. The tile's
// points compute their half-size once, then their R row taps and R column
// taps (offsets and weights) into shared memory. Each thread owns one output
// pixel (i, j) of the R*R and walks the tile's points, so i and j are fixed
// per thread and all index arithmetic is 32-bit; four __ldg gathers of the
// packed image (R | G << 8 | B << 16, one 4-byte load per tap) give the three
// channels. The tile's rows are assembled in shared memory and written out as
// one contiguous span with 16-byte stores: TILE * row_bytes is a multiple of
// 16 for both strides (363 * 32 and 384 * 32). TILE = 32 keeps a block's
// shared memory near 23 KB (11.6 KB of rows, 11 KB of taps), so nine blocks
// fit on an SM. Integer arithmetic is exact and the half-size division stays
// IEEE (no fast-math), so the result is bit-identical to the plain version.
//
// pack_lab_kernel packs the padded [Hp, Wp, 3] uint8 image into that int32
// image in one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;  // grid points per block
constexpr int THREADS = 128;  // >= R * R for the default R = 11

__global__ void pack_lab_kernel(const uint8_t* __restrict__ lab, int n,
                                int32_t* __restrict__ out)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint8_t* px = lab + 3 * i;
    out[i] = (int32_t)px[0] | ((int32_t)px[1] << 8) | ((int32_t)px[2] << 16);
}

__global__ void __launch_bounds__(THREADS) patches_kernel(
    const int32_t* __restrict__ packed,  // [hp, wp] L | a << 8 | b << 16
    int wp,
    const float* __restrict__ depth,  // [gh, gw] metres, <= 0 masked
    int gw, int num_points,
    const int32_t* __restrict__ t0,  // [patch + 1, r] absolute padded offsets
    const int32_t* __restrict__ t1,
    const int32_t* __restrict__ w0,  // [patch + 1, r] weights in 1/2048ths
    const int32_t* __restrict__ w1,
    int patch, int r, int stride,
    uint8_t* __restrict__ out, long long row0, int row_bytes)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int tile_bytes = (TILE * row_bytes + 15) & ~15;
    uint8_t* rows = smem;
    int* half = (int*)(smem + tile_bytes);  // [TILE]
    int* ybase = half + TILE;  // [TILE] gy * stride * wp
    int* xbase = ybase + TILE;  // [TILE] gx * stride
    int* ry0 = xbase + TILE;  // [TILE, r] row tap offsets (times wp)
    int* ry1 = ry0 + TILE * r;
    int* wy0 = ry1 + TILE * r;
    int* wy1 = wy0 + TILE * r;
    int* cx0 = wy1 + TILE * r;  // [TILE, r] column taps
    int* cx1 = cx0 + TILE * r;
    int* wx0 = cx1 + TILE * r;
    int* wx1 = wx0 + TILE * r;

    const int p0 = blockIdx.x * TILE;
    const int nq = min(TILE, num_points - p0);
    const int tid = threadIdx.x;
    if (tid < nq) {
        const int p = p0 + tid;
        const float d = __ldg(depth + p);
        int h = -1;
        if (d > 0.0f) {
            // feature_extractor.h:140; IEEE division, clamped to the border.
            h = min((int)floorf((float)patch / (2.0f * fmaxf(d, 1e-6f))), patch);
        }
        const int gy = p / gw;
        half[tid] = h;
        ybase[tid] = gy * stride * wp;
        xbase[tid] = (p - gy * gw) * stride;
    }
    __syncthreads();
    for (int k = tid; k < nq * r; k += THREADS) {
        const int q = k / r;
        const int h = max(half[q], 0);
        const int e = h * r + (k - q * r);
        ry0[k] = ybase[q] + __ldg(t0 + e) * wp;
        ry1[k] = ybase[q] + __ldg(t1 + e) * wp;
        cx0[k] = xbase[q] + __ldg(t0 + e);
        cx1[k] = xbase[q] + __ldg(t1 + e);
        wy0[k] = wx0[k] = __ldg(w0 + e);
        wy1[k] = wx1[k] = __ldg(w1 + e);
    }
    // Zero each row's bytes after the patch.
    const int pc = 3 * r * r;
    const int pad = row_bytes - pc;
    for (int k = tid; k < nq * pad; k += THREADS) {
        const int q = k / pad;
        rows[q * row_bytes + pc + (k - q * pad)] = 0;
    }
    __syncthreads();

    for (int ij = tid; ij < r * r; ij += THREADS) {
        const int i = ij / r;
        const int j = ij - i * r;
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
            uint8_t* dst = rows + q * row_bytes + 3 * ij;
            if (half[q] < 0) {
                dst[0] = 0; dst[1] = 0; dst[2] = 0;
                continue;
            }
            const int a = q * r + i, b = q * r + j;
            const int y0 = ry0[a], y1 = ry1[a], x0 = cx0[b], x1 = cx1[b];
            const int fy0 = wy0[a], fy1 = wy1[a], fx0 = wx0[b], fx1 = wx1[b];
            const int32_t v00 = __ldg(packed + y0 + x0);
            const int32_t v01 = __ldg(packed + y0 + x1);
            const int32_t v10 = __ldg(packed + y1 + x0);
            const int32_t v11 = __ldg(packed + y1 + x1);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const int sh = 8 * ch;
                const int row0v = ((v00 >> sh) & 255) * fx0 + ((v01 >> sh) & 255) * fx1;
                const int row1v = ((v10 >> sh) & 255) * fx0 + ((v11 >> sh) & 255) * fx1;
                const int v = (row0v * fy0 + row1v * fy1 + (1 << 21)) >> 22;
                dst[ch] = (uint8_t)min(max(v, 0), 255);
            }
        }
    }
    __syncthreads();

    // The tile's rows are one contiguous span of the output.
    uint8_t* gdst = out + (row0 + p0) * (long long)row_bytes;
    const int span = nq * row_bytes;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(gdst) & 15) == 0) {
        const int n16 = span >> 4;
        const int4* src4 = reinterpret_cast<const int4*>(rows);
        int4* dst4 = reinterpret_cast<int4*>(gdst);
        for (int k = tid; k < n16; k += THREADS) dst4[k] = src4[k];
        done = n16 << 4;
    }
    for (int k = done + tid; k < span; k += THREADS) gdst[k] = rows[k];
}

int shared_bytes(int r, int row_bytes)
{
    return ((TILE * row_bytes + 15) & ~15) + 4 * (3 * TILE + 8 * TILE * r);
}

}  // namespace

extern "C" int rovina_pack_lab(const void* lab, int n, void* out, void* stream)
{
    if (n > 0) {
        const int threads = 256;
        pack_lab_kernel<<<(n + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
            (const uint8_t*)lab, n, (int32_t*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" int rovina_patches(
    const void* packed, int wp, const void* depth, int gh, int gw,
    const void* t0, const void* t1, const void* w0, const void* w1,
    int patch, int r, int stride, void* out, long long row0, int row_bytes,
    void* stream)
{
    const int num_points = gh * gw;  // the wrapper keeps it below 2^31
    if (num_points > 0) {
        const int smem = shared_bytes(r, row_bytes);
        if (smem > 48 * 1024) {  // opt in above the default limit
            const cudaError_t err = cudaFuncSetAttribute(
                patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                smem);
            if (err != cudaSuccess) return (int)err;
        }
        const int blocks = (num_points + TILE - 1) / TILE;
        patches_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
            (const int32_t*)packed, wp, (const float*)depth, gw, num_points,
            (const int32_t*)t0, (const int32_t*)t1, (const int32_t*)w0,
            (const int32_t*)w1, patch, r, stride, (uint8_t*)out, row0,
            row_bytes);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* rovina_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
