// A frame's posterior maps for Hopper (sm_90a): the masked fill, the bilinear
// resize of every layer to full resolution and the floored argmax, in one
// launch.
//
// Replaces no TPU kernel: the JAX package resizes and takes the argmax with
// XLA ops (rovinasemanticsegmentation_tpu/pipelines/single_frame.py::
// _posterior_maps), and the plain PyTorch version
// (pipelines/single_frame.py::posterior_maps_plain) runs ~112 launches of a
// few microseconds each for a VGA frame, with full-resolution intermediates.
// This kernel was added for that stage's device time. It computes what the
// plain version computes on the card, bit for bit:
//
// - the fill: a grid point whose mask is false reads `fill` (torch.where);
// - the taps of ops/resize.py::_tap_coords (OpenCV's INTER_LINEAR mapping):
//   fx = (x + 0.5) * scale - 0.5 with scale the float32 rounding of src/dst
//   (the host passes it), the left tap floor(fx) and the fraction fx - floor,
//   zeroed where the tap is clamped at either border;
// - the vertical pass, then the horizontal one, each a * (1 - f) + b * f with
//   both products and the sum rounded on their own, as PyTorch's separate
//   elementwise kernels round them: every operation is an _rn intrinsic, so
//   nvcc contracts nothing into an FMA;
// - the argmax of each pixel's values as written: the first maximum (strict >
//   in ascending class order, as torch.argmax), and -1 unless the maximum is
//   > -1000 (a NaN among the values makes PyTorch's amax NaN, so -1 too).
//
// What bounds it on the card: the bytes. At VGA, stride 2, 8 + 9 classes it
// reads the stride posteriors' class values (76800 x 17 floats, 5.2 MB) and
// the mask, and writes the full-resolution posteriors (307200 x 17 floats,
// 20.9 MB) and two int8 label planes (0.6 MB): 26.8 MB, 8.0 us at 3.35 TB/s.
// The arithmetic is ~9 float operations a written value, ~1.5 us at the
// card's float32 rate.
//
// Design: a block takes a segment of TW consecutive pixels of one output row.
// 1. Its threads compute the vertical pass of every source column the
//    segment's taps reach (at most TW + 2 when the grid is no larger than the
//    frame), for every layer and class, into shared memory: the row's taps
//    are computed once a block, the two source rows read once from L2 with
//    neighbouring threads on neighbouring classes. A layer's columns are
//    C | 1 floats apart (an odd stride), so the second pass reads them
//    without bank conflicts.
// 2. Each thread takes a pixel: its column taps once for all layers, the
//    horizontal pass of every class from shared memory, the running argmax in
//    registers, the label stored (a warp's 32 labels are one 32-byte
//    sector), and the values staged in shared memory in the output's order.
// 3. The block copies each layer's staged values, one contiguous span of
//    TW * C floats in the [H, W, C] output, to device memory in 16-byte
//    stores. A span rarely starts on a 16-byte boundary (36-byte pixel
//    records), so each layer's staging starts as many floats past a boundary
//    as the span's first float does: its groups of four then line up with the
//    output's, and only the span's partial first and last groups go out as
//    single floats.
// No intermediate goes to device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 128;           // pixels of a block's row segment; threads
constexpr int COLS = TW + 2;      // source columns a segment's taps reach
constexpr int MAX_LAYERS = 2;     // ops/resize_argmax_cuda.py's maxima
constexpr int MAX_CLASSES = 32;
constexpr float FLOOR = -1000.0f; // test_multi.cpp:181,207

struct Layers {
    int n;
    int classes[MAX_LAYERS];
    float* out[MAX_LAYERS];       // [H, W, C_l] float32
    int8_t* labels[MAX_LAYERS];   // [H, W] int8
};

struct Tap {
    int i0, i1;  // left (upper) and right (lower) source index
    float f;     // the right tap's fraction
};

// ops/resize.py::_tap_coords at output coordinate d.
__device__ __forceinline__ Tap tap(int d, float scale, int src)
{
    const float fx =
        __fsub_rn(__fmul_rn(__fadd_rn((float)d, 0.5f), scale), 0.5f);
    int i = (int)floorf(fx);
    float f = __fsub_rn(fx, (float)i);
    if (i < 0) f = 0.0f;
    i = max(i, 0);
    if (i >= src - 1) f = 0.0f;
    i = min(i, src - 1);
    return {i, min(i + 1, src - 1), f};
}

// a * (1 - f) + b * f, each step rounded on its own.
__device__ __forceinline__ float lerp(float a, float b, float w0, float f)
{
    return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, f));
}

__host__ __device__ __forceinline__ int padded(int c) { return c | 1; }

// A layer's staging: up to 3 floats of lead-in, TW * C values, rounded up to
// a 16-byte multiple so that the next layer's staging stays aligned.
__host__ __device__ __forceinline__ int staging_floats(int c)
{
    return (TW * c + 3 + 3) & ~3;
}

__global__ void __launch_bounds__(TW) resize_argmax_kernel(
    const float* __restrict__ post,     // [gh * gw, rec] (layer l at l * cmax)
    const uint8_t* __restrict__ mask,   // [gh * gw]
    int gh, int gw, int rec, int cmax, Layers layers, float fill, int w,
    float scale_y, float scale_x)
{
    extern __shared__ __align__(16) float smem[];
    const int t = threadIdx.x;
    const int y = blockIdx.y;
    const int xs = blockIdx.x * TW;
    const int n = min(TW, w - xs);

    const Tap ty = tap(y, scale_y, gh);
    const float wy0 = __fsub_rn(1.0f, ty.f);
    const int cb = tap(xs, scale_x, gw).i0;
    const int ncols = tap(xs + n - 1, scale_x, gw).i1 - cb + 1;
    const int g0 = ty.i0 * gw + cb, g1 = ty.i1 * gw + cb;

    // Shared memory: every layer's vertical pass [COLS][C | 1], then every
    // layer's staging.
    int vert_total = 0;
#pragma unroll
    for (int l = 0; l < MAX_LAYERS; ++l)
        if (l < layers.n) vert_total += COLS * padded(layers.classes[l]);
    vert_total = (vert_total + 3) & ~3;

    // 1. The vertical pass of the segment's source columns. The layer loops
    // are unrolled so that `layers` is indexed by constants (no copy to
    // local memory), and both taps and masks are loaded before the select,
    // so that a few elements' loads are in flight at once.
    float* vert = smem;
#pragma unroll
    for (int l = 0; l < MAX_LAYERS; ++l) {
        if (l < layers.n) {
            const int c_n = layers.classes[l], cp = padded(c_n);
            const float* src = post + l * cmax;
#pragma unroll 4
            for (int e = t; e < ncols * c_n; e += TW) {
                const int j = e / c_n, c = e - j * c_n;
                const int p0 = g0 + j, p1 = g1 + j;
                const float a = __ldg(src + p0 * rec + c);
                const float b = __ldg(src + p1 * rec + c);
                const bool m0 = mask[p0], m1 = mask[p1];
                vert[j * cp + c] = lerp(m0 ? a : fill, m1 ? b : fill, wy0, ty.f);
            }
            vert += COLS * cp;
        }
    }
    __syncthreads();

    // 2. A pixel a thread: the horizontal pass, the staging and the argmax.
    const int row = y * w + xs;  // the segment's first pixel
    if (t < n) {
        const Tap tx = tap(xs + t, scale_x, gw);
        const float wx0 = __fsub_rn(1.0f, tx.f);
        const int j0 = tx.i0 - cb, j1 = tx.i1 - cb;
        const float* v = smem;
        float* stage = smem + vert_total;
#pragma unroll
        for (int l = 0; l < MAX_LAYERS; ++l) {
            if (l >= layers.n) break;
            const int c_n = layers.classes[l], cp = padded(c_n);
            const int lead = (int)(((uintptr_t)layers.out[l] >> 2) + (size_t)row * c_n) & 3;
            float* s = stage + lead + t * c_n;
            float best = 0.0f;
            int arg = 0;
            bool nan = false;
            for (int c = 0; c < c_n; ++c) {
                const float val = lerp(v[j0 * cp + c], v[j1 * cp + c], wx0, tx.f);
                s[c] = val;
                nan |= val != val;
                if (c == 0 || val > best) {
                    best = val;
                    arg = c;
                }
            }
            layers.labels[l][row + t] = (!nan && best > FLOOR) ? (int8_t)arg : (int8_t)-1;
            v += COLS * cp;
            stage += staging_floats(c_n);
        }
    }
    __syncthreads();

    // 3. Each layer's span to device memory, in 16-byte groups.
    const float* stage = smem + vert_total;
#pragma unroll
    for (int l = 0; l < MAX_LAYERS; ++l) {
        if (l >= layers.n) break;
        const int c_n = layers.classes[l];
        float* dst = layers.out[l] + (size_t)row * c_n;
        const int lead = (int)((uintptr_t)dst >> 2) & 3;
        float* base = dst - lead;  // 16-byte aligned; [0, lead) is not written
        const int end = lead + n * c_n;
        for (int k = 4 * t; k < end; k += 4 * TW) {
            if (k >= lead && k + 4 <= end) {
                *reinterpret_cast<float4*>(base + k) =
                    *reinterpret_cast<const float4*>(stage + k);
            } else {
                for (int i = max(k, lead); i < min(k + 4, end); ++i) base[i] = stage[i];
            }
        }
        stage += staging_floats(c_n);
    }
}

int shared_bytes(int layers, const int* classes)
{
    int vert = 0, staging = 0;
    for (int l = 0; l < layers; ++l) {
        vert += COLS * padded(classes[l]);
        staging += staging_floats(classes[l]);
    }
    return 4 * (((vert + 3) & ~3) + staging);
}

}  // namespace

// post: [gh * gw, rec] float32, layer l's classes at l * cmax; mask: [gh * gw]
// bool; classes, outs, labels: host arrays of `layers` entries; scale_y and
// scale_x: the float32 roundings of gh / h and gw / w. The wrapper keeps every
// offset below 2^31 and the grid no larger than the frame.
extern "C" int rovina_resize_argmax(
    const void* post, const void* mask, int gh, int gw, int rec, int cmax,
    int layers, const int* classes, float fill, int h, int w, float scale_y,
    float scale_x, void* const* outs, void* const* labels, void* stream)
{
    if (layers < 1 || layers > MAX_LAYERS || gh < 1 || gw < 1 || gh > h ||
        gw > w || h > 65535)
        return (int)cudaErrorInvalidValue;
    Layers ls{};
    ls.n = layers;
    for (int l = 0; l < layers; ++l) {
        if (classes[l] < 1 || classes[l] > MAX_CLASSES || classes[l] > cmax)
            return (int)cudaErrorInvalidValue;
        ls.classes[l] = classes[l];
        ls.out[l] = (float*)outs[l];
        ls.labels[l] = (int8_t*)labels[l];
    }
    const int smem = shared_bytes(layers, classes);
    if (smem > 48 * 1024) {  // opt in above the default limit (2 x 32: 66 KB)
        const cudaError_t err = cudaFuncSetAttribute(
            resize_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((w + TW - 1) / TW, h);
    resize_argmax_kernel<<<grid, TW, smem, (cudaStream_t)stream>>>(
        (const float*)post, (const uint8_t*)mask, gh, gw, rec, cmax, ls, fill,
        w, scale_y, scale_x);
    return (int)cudaGetLastError();
}
