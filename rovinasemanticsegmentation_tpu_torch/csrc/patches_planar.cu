// Depth-adaptive patch resampling in two separable stages on planar channels,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/exp_patches.py (_kernel_e, driven by
// extract_patches_e), which computes kernel A's function
// (rovinasemanticsegmentation_tpu/ops/patches_pallas.py::_kernel): for every
// stride-grid point with depth d > 0, h = min(floor(B / (2 d)), B), and the
// (2h+1)^2 window of the reflect-padded 8-bit Lab image is resized
// bilinearly to R x R x 3 with weights in 1/2048ths and rounding
// (acc + 2^21) >> 22; d <= 0 gives zeros. The TPU kernel unpacked the three
// packed channels once per block, then ran a vertical row stage over
// 3-channel stacks and a horizontal column stage.
//
// What bounds it on the card: at VGA, stride 2, R = 11 the output is
// 240 x 320 x 11 x 11 x 3 = 27.9 MB of bytes. Kernel A (patches.cu) writes
// three bytes per thread at a 3-byte pitch, so its stores are only partly
// coalesced, and gathers 4 taps per output pixel.
//
// Design: the wrapper makes the image planar once per frame ([3, Hp, Wp]
// uint8, the counterpart of the TPU kernel's pre-unpack). One block takes G
// consecutive grid points of one grid row:
//   stage 0: window half-size per point, with the same IEEE division as A,
//            then each point's taps into shared memory: row offsets and
//            weights per i (rows and columns share the tables: windows are
//            square), and the 2R column taps x_k (k = 2j: x0_j, 2j + 1: x1_j);
//   stage 1 (rows): ri[g, ch, i, k] = wy0 img[ch, y0_i, x_k]
//            + wy1 img[ch, y1_i, x_k], one thread per (g, i, k) for all three
//            channels, int32 in shared memory;
//   stage 2 (columns): out = clamp((wx0 ri[.., 2j] + wx1 ri[.., 2j + 1]
//            + 2^21) >> 22, 0, 255), one thread per (g, i, j), into a shared
//            byte tile in output order;
//   stage 3: the G points' outputs are contiguous in [gh, gw, R, R, 3]
//            (G * 3R^2 bytes), so the block stores them as 16-byte words
//            from the first 16-byte boundary on, bytes at the ends.
// Each row-stage value feeds exactly one output (the 2R column taps of a
// point are distinct), so the separable order saves no arithmetic here; it
// is kept because it is the TPU kernel's design. Every sum is exact in
// int32 (< 255 * 2^22 < 2^31), so the result is bit-identical to A and to
// the plain versions in any stage order. Taps are y * s + t[h, i] in padded
// coordinates, which takes any stride. No fast-math: the half-size
// division must be IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void patches_planar_kernel(
    const uint8_t* __restrict__ img,  // [3, hp, wp] planar Lab
    int hp, int wp,
    const float* __restrict__ depth,  // [gh, gw] metres, <= 0 masked
    int gw,
    const int32_t* __restrict__ t0,  // [patch + 1, r] absolute padded offsets
    const int32_t* __restrict__ t1,
    const int32_t* __restrict__ w0,  // [patch + 1, r] weights in 1/2048ths
    const int32_t* __restrict__ w1,
    int patch, int r, int stride, int group,
    uint8_t* __restrict__ out)  // [gh, gw, r, r, 3]
{
    // Shared memory, in order of alignment (the wrapper's
    // planar_shared_bytes): taps_s [group, r] int4 (y0 * wp, y1 * wp, w0, w1),
    // half_s [group], colx_s [group, 2r], ri [group, 3, r, 2r] int32, then
    // out_s [group, r, r, 3] bytes.
    extern __shared__ int4 taps_s[];
    const int r2 = 2 * r;
    const int per_point_ri = 3 * r * r2;
    const int rr3 = r * r * 3;
    int32_t* half_s = reinterpret_cast<int32_t*>(taps_s + group * r);
    int32_t* colx_s = half_s + group;
    int32_t* ri = colx_s + group * r2;
    uint8_t* out_s = reinterpret_cast<uint8_t*>(ri + group * per_point_ri);

    const int gy = blockIdx.y;
    const int gx0 = blockIdx.x * group;
    const int npts = min(group, gw - gx0);
    const long long p0 = (long long)gy * gw + gx0;

    // Stage 0: feature_extractor.h:140; IEEE division, clamped to B.
    for (int g = threadIdx.x; g < npts; g += blockDim.x) {
        const float d = __ldg(depth + p0 + g);
        int h = -1;
        if (d > 0.0f) {
            const float safe = fmaxf(d, 1e-6f);
            h = min((int)floorf((float)patch / (2.0f * safe)), patch);
        }
        half_s[g] = h;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < npts * r2; k += blockDim.x) {
        const int g = k / r2;
        const int h = half_s[g];
        if (h < 0) continue;
        const int c = k - g * r2;
        const int t = h * r + (c >> 1);
        colx_s[k] = (gx0 + g) * stride + __ldg(((c & 1) ? t1 : t0) + t);
        if ((c & 1) == 0) {
            const int y = gy * stride;
            taps_s[g * r + (c >> 1)] = make_int4(
                (y + __ldg(t0 + t)) * wp, (y + __ldg(t1 + t)) * wp,
                __ldg(w0 + t), __ldg(w1 + t));
        }
    }
    __syncthreads();

    // Stage 1: vertical taps at each of the 2R column taps, three channels.
    const long long plane = (long long)hp * wp;
    for (int k = threadIdx.x; k < npts * r * r2; k += blockDim.x) {
        const int g = k / (r * r2);
        if (half_s[g] < 0) continue;
        const int rem = k - g * r * r2;
        const int i = rem / r2;
        const int x = colx_s[g * r2 + rem - i * r2];
        const int4 ty = taps_s[g * r + i];
        int32_t* dst = ri + g * per_point_ri + rem;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const uint8_t* pc = img + ch * plane + x;
            dst[ch * r * r2] = ty.z * (int)__ldg(pc + ty.x)
                             + ty.w * (int)__ldg(pc + ty.y);
        }
    }
    __syncthreads();

    // Stage 2: horizontal taps, rounding and clamping, three channels, in
    // output order out_s[g, i, j, ch].
    for (int k = threadIdx.x; k < npts * r * r; k += blockDim.x) {
        const int g = k / (r * r);
        const int ij = k - g * r * r;
        uint8_t* dst = out_s + 3 * k;
        if (half_s[g] < 0) {
            dst[0] = 0; dst[1] = 0; dst[2] = 0;
            continue;
        }
        const int i = ij / r;
        const int j = ij - i * r;
        const int4 tx = taps_s[g * r + j];
        const int32_t* row = ri + g * per_point_ri + i * r2 + 2 * j;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
            const int32_t* rc = row + ch * r * r2;
            const int v = (tx.z * rc[0] + tx.w * rc[1] + (1 << 21)) >> 22;
            dst[ch] = (uint8_t)min(max(v, 0), 255);
        }
    }
    __syncthreads();

    // Stage 3: coalesced store of the block's npts * rr3 contiguous bytes.
    uint8_t* dst = out + p0 * rr3;
    const int nb = npts * rr3;
    const int head = min(
        nb, (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15));
    const int nvec = (nb - head) / 16;
    for (int k = threadIdx.x; k < head; k += blockDim.x) dst[k] = out_s[k];
    uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
    for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
        const uint8_t* s = out_s + head + 16 * k;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            w[q] = (uint32_t)s[4 * q] | ((uint32_t)s[4 * q + 1] << 8)
                 | ((uint32_t)s[4 * q + 2] << 16)
                 | ((uint32_t)s[4 * q + 3] << 24);
        dst4[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (int k = head + 16 * nvec + threadIdx.x; k < nb; k += blockDim.x)
        dst[k] = out_s[k];
}

}  // namespace

extern "C" int rovina_patches_planar(
    const void* planar, int hp, int wp, const void* depth, int gh, int gw,
    const void* t0, const void* t1, const void* w0, const void* w1,
    int patch, int r, int stride, int group, void* out, void* stream)
{
    if ((long long)gh * gw > 0) {
        // The wrapper checks bounds, gh <= 65535 and the shared-memory size.
        const size_t smem = (size_t)group * (16 * r + 4 + 4 * 2 * r
                                             + 4 * 6 * r * r + 3 * r * r);
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                patches_planar_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        const dim3 grid((unsigned)((gw + group - 1) / group), (unsigned)gh);
        patches_planar_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
            (const uint8_t*)planar, hp, wp, (const float*)depth, gw,
            (const int32_t*)t0, (const int32_t*)t1, (const int32_t*)w0,
            (const int32_t*)w1, patch, r, stride, group, (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
