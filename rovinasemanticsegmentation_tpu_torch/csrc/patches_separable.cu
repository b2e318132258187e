// Depth-adaptive patch resampling in two separable stages, on a footprint of
// the packed image staged in shared memory, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_patches.py (_kernel_e, driven by
// extract_patches_e), which computes kernel A's function
// (rovinasemanticsegmentation_tpu/ops/patches_pallas.py::_kernel): for every
// stride-grid point with depth d > 0, h = min(floor(B / (2 d)), B), and the
// (2h+1)^2 window of the reflect-padded 8-bit Lab image is resized
// bilinearly to R x R x 3 with weights in 1/2048ths and rounding
// (acc + 2^21) >> 22; d <= 0 gives zeros. The TPU kernel DMA'd one band of
// the packed int32 image (L | a << 8 | b << 16) into fast memory per block,
// unpacked the channels there once, then ran a vertical row stage and a
// horizontal column stage.
//
// Input: kernel A's packed int32 image ([Hp, Wp], csrc/patches.cu
// pack_lab_kernel). Output: packed feature rows, as kernel A writes them:
// point p's R*R*3 bytes start at out + (row0 + p) * row_bytes, the rest of
// its row is zeros (row_bytes = R*R*3 gives the [gh, gw, R, R, 3] tensor).
//
// What bounds it on the card: at VGA, stride 2, R = 11 it writes 76800 rows
// (29.5 MB at 384 B) and must read the 2.0 MB image and 0.3 MB of depth:
// ~9.5 us at 3.35 TB/s. Its arithmetic is kernel A's, 6 multiplies and
// multiply-adds per output byte on the FMA pipe (164 M at VGA, ~9.8 us).
// Gathering each point's taps from L2 (726 single-byte loads per point on a
// planar copy of the image) reuses nothing between neighbouring points,
// whose windows overlap heavily at stride 2; a tile's footprint in shared
// memory does.
//
// Design: a block takes a tile of TY x TX = 4 x 8 grid points (4 grid rows,
// 8 columns) and 256 threads.
//   stage 0: each point's half-size (the same IEEE division as A), the
//            tile's largest one hmax, and from it the tile's footprint in the
//            padded image: (TY-1) s + 2 hmax + 1 rows by (TX-1) s + 2 hmax + 1
//            columns (at stride 2, 31 x 39 int32 = 4.8 KB at d ~ 3 m). If it
//            fits footprint_cap bytes (a launch argument: the wrapper's
//            FOOTPRINT_CAP, 24 KB, hmax <= 33 at stride 2, d >= 1.17 m), the block copies it into
//            shared memory once with cp.async (4-byte copies, one warp per
//            footprint row: the image's 3176-B pitch is not in 16-byte
//            units, so TMA cannot take it). While the copy is in flight it
//            writes each point's R row/column taps (offsets and weights,
//            shared because windows are square) into shared memory and zeros
//            the row bytes after each patch. A block whose footprint exceeds
//            the cap reads its taps from the image in device memory (L2) in
//            the same kernel, and adds one to *over_cap.
//   stage 1 (rows): one thread per output pixel (i, j) of a point, 128 per
//            point, two points at a time; for each of its two column taps
//            x0_j, x1_j it forms wy0 img[y0_i, x] + wy1 img[y1_i, x], three
//            channels from one 32-bit load per tap;
//   stage 2 (columns): (wx0 r0 + wx1 r1 + 2^21) >> 22, clamped, in
//            registers, three bytes into the tile's rows in shared memory;
//   stage 3: each grid row of the tile is one contiguous span of output rows
//            (8 x 384 B), stored as 16-byte words from the first 16-byte
//            boundary on.
// Every sum is exact in int32 (< 255 * 2^22 < 2^31), so the result is
// bit-identical to A and to the plain versions in either stage order.

#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int TY = 4;  // grid rows per tile
constexpr int TX = 8;  // grid columns per tile
constexpr int TILE = TY * TX;
constexpr int THREADS = 256;
constexpr int PIXEL_THREADS = 128;  // threads per point: one per (i, j)

// One tap of the packed image: from the staged footprint (offsets relative to
// its origin, pitch fw) or from device memory (absolute, pitch wp).
template <bool kStaged>
__device__ __forceinline__ int32_t load_tap(const int32_t* img, int pitch,
                                            int y, int x)
{
    if (kStaged) return img[y * pitch + x];
    return __ldg(img + y * pitch + x);
}

template <bool kStaged>
__device__ __forceinline__ void resample_tile(
    const int32_t* img, int pitch, int oy, int ox,  // image and its origin
    const int4* tap_s, const int* half_s, uint8_t* rows_s, int row_bytes,
    int r, int gy0, int gx0, int ny, int nx, int stride)
{
    const int rr = r * r;
    for (int ij = threadIdx.x % PIXEL_THREADS; ij < rr; ij += PIXEL_THREADS) {
        const int i = ij / r;
        const int j = ij - i * r;
        for (int q = threadIdx.x / PIXEL_THREADS; q < TILE;
             q += THREADS / PIXEL_THREADS) {
            const int ty = q / TX, tx = q % TX;
            if (ty >= ny || tx >= nx) continue;
            uint8_t* dst = rows_s + q * row_bytes + 3 * ij;
            if (half_s[q] < 0) {
                dst[0] = 0; dst[1] = 0; dst[2] = 0;
                continue;
            }
            const int4 a = tap_s[q * r + i];  // rows: t0, t1, wy0, wy1
            const int4 b = tap_s[q * r + j];  // columns: t0, t1, wx0, wx1
            const int py = (gy0 + ty) * stride - oy;
            const int px = (gx0 + tx) * stride - ox;
            const int32_t v00 = load_tap<kStaged>(img, pitch, py + a.x, px + b.x);
            const int32_t v10 = load_tap<kStaged>(img, pitch, py + a.y, px + b.x);
            const int32_t v01 = load_tap<kStaged>(img, pitch, py + a.x, px + b.y);
            const int32_t v11 = load_tap<kStaged>(img, pitch, py + a.y, px + b.y);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                const int sh = 8 * ch;
                // Row stage at the two column taps, then the column stage.
                const int r0 = a.z * ((v00 >> sh) & 255) + a.w * ((v10 >> sh) & 255);
                const int r1 = a.z * ((v01 >> sh) & 255) + a.w * ((v11 >> sh) & 255);
                const int v = (b.z * r0 + b.w * r1 + (1 << 21)) >> 22;
                dst[ch] = (uint8_t)min(max(v, 0), 255);
            }
        }
    }
}

// n bytes from shared memory to device memory, 16-byte stores where the
// destination is aligned.
__device__ __forceinline__ void store_span(uint8_t* g, const uint8_t* s, int n)
{
    const int head = min(
        n, (int)((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15));
    const int nvec = (n - head) >> 4;
    for (int k = threadIdx.x; k < head; k += THREADS) g[k] = s[k];
    uint4* g4 = reinterpret_cast<uint4*>(g + head);
    const uint8_t* sv = s + head;
    if ((reinterpret_cast<uintptr_t>(sv) & 15) == 0) {
        const uint4* s4 = reinterpret_cast<const uint4*>(sv);
        for (int k = threadIdx.x; k < nvec; k += THREADS) g4[k] = s4[k];
    } else {
        for (int k = threadIdx.x; k < nvec; k += THREADS) {
            const uint8_t* b = sv + 16 * k;
            uint32_t w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
                w[u] = (uint32_t)b[4 * u] | ((uint32_t)b[4 * u + 1] << 8)
                     | ((uint32_t)b[4 * u + 2] << 16)
                     | ((uint32_t)b[4 * u + 3] << 24);
            g4[k] = make_uint4(w[0], w[1], w[2], w[3]);
        }
    }
    for (int k = head + 16 * nvec + threadIdx.x; k < n; k += THREADS)
        g[k] = s[k];
}

__global__ void __launch_bounds__(THREADS) patches_separable_kernel(
    const int32_t* __restrict__ packed,  // [hp, wp] L | a << 8 | b << 16
    int wp,
    const float* __restrict__ depth,  // [gh, gw] metres, <= 0 masked
    int gh, int gw,
    const int32_t* __restrict__ t0,  // [patch + 1, r] absolute padded offsets
    const int32_t* __restrict__ t1,
    const int32_t* __restrict__ w0,  // [patch + 1, r] weights in 1/2048ths
    const int32_t* __restrict__ w1,
    int patch, int r, int stride,
    uint8_t* __restrict__ out, long long row0, int row_bytes,
    int footprint_cap,  // bytes, a multiple of 16
    int* __restrict__ over_cap)
{
    // Shared memory (the wrapper's separable_shared_bytes): taps [TILE, r] int4,
    // the footprint (footprint_cap bytes), the tile's rows, half-sizes, hmax.
    extern __shared__ __align__(16) uint8_t smem[];
    int4* tap_s = reinterpret_cast<int4*>(smem);
    int32_t* foot_s = reinterpret_cast<int32_t*>(smem + 16 * TILE * r);
    uint8_t* rows_s = smem + 16 * TILE * r + footprint_cap;
    int* half_s = reinterpret_cast<int*>(
        rows_s + ((TILE * row_bytes + 15) & ~15));
    int* hmax_s = half_s + TILE;

    const int tid = threadIdx.x;
    const int gy0 = blockIdx.y * TY, gx0 = blockIdx.x * TX;
    const int ny = min(TY, gh - gy0), nx = min(TX, gw - gx0);

    // Stage 0: feature_extractor.h:140; IEEE division, clamped to B.
    if (tid == 0) *hmax_s = -1;
    __syncthreads();
    if (tid < TILE) {
        const int ty = tid / TX, tx = tid % TX;
        int h = -1;
        if (ty < ny && tx < nx) {
            const float d = __ldg(depth + (long long)(gy0 + ty) * gw + gx0 + tx);
            if (d > 0.0f) {
                h = min((int)floorf((float)patch / (2.0f * fmaxf(d, 1e-6f))),
                        patch);
            }
        }
        half_s[tid] = h;
        if (h >= 0) atomicMax(hmax_s, h);
    }
    __syncthreads();
    const int hmax = *hmax_s;
    const int fy0 = gy0 * stride + patch - hmax;
    const int fx0 = gx0 * stride + patch - hmax;
    const int fh = (ny - 1) * stride + 2 * hmax + 1;
    const int fw = (nx - 1) * stride + 2 * hmax + 1;
    const bool staged = hmax >= 0 && 4LL * fh * fw <= footprint_cap;
    if (staged) {
        const int warp = tid / 32, lane = tid % 32;
        for (int y = warp; y < fh; y += THREADS / 32) {
            const int32_t* src = packed + (long long)(fy0 + y) * wp + fx0;
            int32_t* dst = foot_s + y * fw;
            for (int x = lane; x < fw; x += 32) cp_async4(dst + x, src + x);
        }
    } else if (hmax >= 0 && tid == 0) {
        atomicAdd(over_cap, 1);
    }
    for (int k = tid; k < TILE * r; k += THREADS) {
        const int q = k / r;
        const int h = half_s[q];
        if (h < 0) continue;
        const int e = h * r + (k - q * r);
        tap_s[k] = make_int4(__ldg(t0 + e), __ldg(t1 + e), __ldg(w0 + e),
                             __ldg(w1 + e));
    }
    const int pc = 3 * r * r;
    const int pad = row_bytes - pc;
    for (int k = tid; k < TILE * pad; k += THREADS) {
        const int q = k / pad;
        rows_s[q * row_bytes + pc + (k - q * pad)] = 0;
    }
    cp_async_wait_all();
    __syncthreads();

    // Stages 1-2.
    if (staged) {
        resample_tile<true>(foot_s, fw, fy0, fx0, tap_s, half_s, rows_s,
                            row_bytes, r, gy0, gx0, ny, nx, stride);
    } else {
        resample_tile<false>(packed, wp, 0, 0, tap_s, half_s, rows_s,
                             row_bytes, r, gy0, gx0, ny, nx, stride);
    }
    __syncthreads();

    // Stage 3: one span of nx rows per grid row of the tile.
    for (int ty = 0; ty < ny; ++ty) {
        uint8_t* g = out
            + (row0 + (long long)(gy0 + ty) * gw + gx0) * (long long)row_bytes;
        store_span(g, rows_s + ty * TX * row_bytes, nx * row_bytes);
    }
}

}  // namespace

extern "C" int rovina_patches_separable(
    const void* packed, int wp, const void* depth, int gh, int gw,
    const void* t0, const void* t1, const void* w0, const void* w1,
    int patch, int r, int stride, void* out, long long row0, int row_bytes,
    int footprint_cap, void* over_cap, void* stream)
{
    if ((long long)gh * gw > 0) {
        // The wrapper checks the image bounds and the shared-memory size.
        const int smem = 16 * TILE * r + footprint_cap
            + ((TILE * row_bytes + 15) & ~15) + 4 * TILE + 16;
        const cudaError_t e = cudaFuncSetAttribute(
            patches_separable_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
        const dim3 grid((unsigned)((gw + TX - 1) / TX),
                        (unsigned)((gh + TY - 1) / TY));
        patches_separable_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
            (const int32_t*)packed, wp, (const float*)depth, gh, gw,
            (const int32_t*)t0, (const int32_t*)t1, (const int32_t*)w0,
            (const int32_t*)w1, patch, r, stride, (uint8_t*)out, row0,
            row_bytes, footprint_cap, (int*)over_cap);
    }
    return (int)cudaGetLastError();
}
