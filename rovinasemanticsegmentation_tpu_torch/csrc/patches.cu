// Depth-adaptive patch resampling for Hopper (sm_90a).
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
// What bounds it on the card: at VGA, stride 2 and R = 11 the kernel writes
// 240*320*11*11*3 = 27.9 MB and gathers 4 packed pixels per output pixel
// from a 634x794 int32 image (2 MB, L2-resident). It is bound by the byte
// stores and by the gather latency, not by arithmetic (a dozen integer ops
// per channel).
//
// Design: one thread per (grid point, i, j) output pixel writes all three
// channels. The image is packed R | G << 8 | B << 16 into one int32 per pixel
// (as the TPU kernel packs it), so each tap is one 4-byte load instead of
// three. Tap rows and columns are y*s + t0[h, i] in padded coordinates, which
// takes any stride (the TPU kernel took 1, 2, 4 and 8 only). The TPU kernel's
// per-block h-sets, phase split, VMEM DMA and unswizzle were layout devices
// for the TPU's vector unit and are gone: outputs are written directly in
// feature order out[p, i, j, ch]. Integer arithmetic is exact, so the result
// is bit-identical to the plain version. No fast-math: the half-size division
// must be IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void patches_kernel(
    const int32_t* __restrict__ packed,  // [hp, wp] L | a << 8 | b << 16
    int wp,
    const float* __restrict__ depth,  // [gh, gw] metres, <= 0 masked
    int gw,
    long long total,  // gh * gw * r * r
    const int32_t* __restrict__ t0,  // [patch + 1, r] absolute padded offsets
    const int32_t* __restrict__ t1,
    const int32_t* __restrict__ w0,  // [patch + 1, r] weights in 1/2048ths
    const int32_t* __restrict__ w1,
    int patch, int r, int stride,
    uint8_t* __restrict__ out)  // [gh, gw, r, r, 3]
{
    long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int rr = r * r;
    const long long p = idx / rr;
    const int rem = (int)(idx - p * rr);
    const int i = rem / r;
    const int j = rem - i * r;
    uint8_t* dst = out + idx * 3;

    const float d = __ldg(depth + p);
    if (!(d > 0.0f)) {
        dst[0] = 0; dst[1] = 0; dst[2] = 0;
        return;
    }
    // feature_extractor.h:140; IEEE division, clamped to the border width.
    const float safe = fmaxf(d, 1e-6f);
    int h = (int)floorf((float)patch / (2.0f * safe));
    h = min(h, patch);

    const int gy = (int)(p / gw);
    const int gx = (int)(p - (long long)gy * gw);
    const int ti = h * r + i;
    const int tj = h * r + j;
    const int y0 = gy * stride + __ldg(t0 + ti);
    const int y1 = gy * stride + __ldg(t1 + ti);
    const int x0 = gx * stride + __ldg(t0 + tj);
    const int x1 = gx * stride + __ldg(t1 + tj);
    const int wy0 = __ldg(w0 + ti), wy1 = __ldg(w1 + ti);
    const int wx0 = __ldg(w0 + tj), wx1 = __ldg(w1 + tj);

    const int32_t v00 = __ldg(packed + (long long)y0 * wp + x0);
    const int32_t v01 = __ldg(packed + (long long)y0 * wp + x1);
    const int32_t v10 = __ldg(packed + (long long)y1 * wp + x0);
    const int32_t v11 = __ldg(packed + (long long)y1 * wp + x1);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        const int sh = 8 * ch;
        const int a00 = (v00 >> sh) & 255, a01 = (v01 >> sh) & 255;
        const int a10 = (v10 >> sh) & 255, a11 = (v11 >> sh) & 255;
        const int row0 = a00 * wx0 + a01 * wx1;
        const int row1 = a10 * wx0 + a11 * wx1;
        int v = (row0 * wy0 + row1 * wy1 + (1 << 21)) >> 22;
        v = min(max(v, 0), 255);
        dst[ch] = (uint8_t)v;
    }
}

}  // namespace

extern "C" int rovina_patches(
    const void* packed, int hp, int wp, const void* depth, int gh, int gw,
    const void* t0, const void* t1, const void* w0, const void* w1,
    int patch, int r, int stride, void* out, void* stream)
{
    (void)hp;  // bounds are checked by the Python wrapper
    const long long total = (long long)gh * gw * r * r;
    if (total > 0) {
        const int threads = 256;
        const long long blocks = (total + threads - 1) / threads;
        patches_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)packed, wp, (const float*)depth, gw, total,
            (const int32_t*)t0, (const int32_t*)t1, (const int32_t*)w0,
            (const int32_t*)w1, patch, r, stride, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* rovina_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
