// The training level loop's exact split search for Hopper (sm_90a): after the
// (segment, value) sort, every (feature slot, frontier segment)'s best split
// in one pass over the sorted stream, with the class prefixes, both children's
// entropies and the segment minimum in registers.
//
// Replaces no TPU kernel: the JAX package's search is XLA ops
// (rovinasemanticsegmentation_tpu/train/forest_trainer.py::split_search_step).
// The plain PyTorch search (train/forest_trainer.py::_split_search_plain)
// builds a one-hot [K, C, Ns], its int32 prefix and the [K, C, Ns] left and
// right counts (2.5 GB each at the recipe's K = 20, Ns = 3.47M), then ~40
// elementwise passes and two scatter minima: ~110 ms of the card's ~124 ms a
// level. These kernels were added for that stage's device time. They give the
// plain search's four [K, F] results bit for bit:
//
// - a position is valid where it is active (segment < F), its segment is the
//   previous position's, and v - prev >= 1e-6f in float32 (torch rounds the
//   constant to float32); then its left mass is > 0;
// - left counts are the class prefix within the segment, right counts the
//   segment's totals less them; each child's entropy is the plain version's
//   float32 arithmetic in its order: the terms -(float)n_c * table[n_c] (0
//   where n_c = 0) summed in class order from the first, then + (float)m *
//   table[m]; the weighted form (a [C] or [F, C] weight, and where the
//   `weighted` mask says so) the weighted counts, their class-order sum, the
//   terms -w * log2f(max(w, 1e-30)) where w > 0, + m * log2f(max(m, 1e-30))
//   where m > 0; then left + right. Every product and sum is an _rn
//   intrinsic, so nvcc contracts nothing into an FMA (the build leaves
//   contraction on), and log2f is the same full-precision routine torch's
//   log2 runs;
// - per (slot, segment) the least objective at its earliest position (-0.0
//   taken as +0.0, as `objective == best` takes it), +inf and position Ns - 1
//   where no position is valid; the threshold 0.5f * (prev + v) of the
//   original values (a -0.0 keeps its bits) and both masses read there.
//
// What bounds it: the bytes. A level reads each slot's sorted keys and order
// (8 B each a position) and writes a byte a position; at K = 20, Ns = 3.47M
// that is ~1.2 GB, ~0.35 ms at 3.35 TB/s when every position is active
// (utils/roofline.py's split_search_bound counts only the active positions).
// The entropies run only at valid positions, ~40 float and integer
// instructions a class; the log table (14 MB at Ns = 3.47M) is read through
// L2, and at deep levels, where segments are small, through L1.
//
// Design: reduce, then scan, in warp tiles of TILE sorted positions (a warp
// takes 32 consecutive positions a step, so every load is coalesced).
// 1. ss_stage: the class of each unsorted entry as a byte (INACTIVE off the
//    searched frontier), and the per-(slot, segment) minima set to
//    (+inf, Ns - 1).
// 2. ss_tile_counts: each tile's class counts (one ballot a class a step), and
//    its positions' class bytes written in sorted order (the gather through
//    `order` done once).
// 3. ss_tile_scan: a block a slot turns the tile counts into each tile's
//    exclusive class prefix.
// 4. ss_heads: on slot 0's stream (every slot has the same segments at the
//    same positions, and the same class totals before each), each segment's
//    first and end position and its class prefix at both.
// 5. ss_search: each position's left counts (its tile's prefix, the ballots
//    of the lanes before it, less its segment's prefix at its first
//    position), the entropies at valid positions, a segmented minimum over
//    the warp's lanes by shuffles, and one 64-bit atomicMin of (order-
//    preserving objective bits << 32 | position) a run of a segment within a
//    tile: the least key is the least objective at its earliest position,
//    whatever order the atomics land in.
// 6. ss_finish: each (slot, segment)'s objective, threshold and masses.
// Tiles past the active part of the stream (inactive entries sort last) leave
// at their first key. Nothing of size [K, C, Ns] is made.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef SS_WARPS
#define SS_WARPS 8
#endif
#ifndef SS_SCAN_THREADS
#define SS_SCAN_THREADS 1024
#endif

typedef unsigned long long u64;

constexpr int STEPS = 32;                   // warp steps of a tile
constexpr int TILE = 32 * STEPS;            // sorted positions a warp tile
constexpr int WARPS = SS_WARPS;             // warp tiles a block
constexpr int THREADS = 32 * WARPS;
constexpr int SCAN_THREADS = SS_SCAN_THREADS;
constexpr int MAX_CLASSES = 32;             // a lane a class's running count
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INACTIVE = 0xFF;              // class byte off the frontier
constexpr u64 NONE = ~0ull;                 // no candidate; a key past the end

// The float32 whose order-preserving bits are `u` (_float_order's inverse:
// a key's low word, or an objective's packed bits).
__device__ __forceinline__ float ordered_value(uint32_t u)
{
    return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// Order-preserving bits of an objective, -0.0 as +0.0.
__device__ __forceinline__ uint32_t ordered_bits(float x)
{
    const uint32_t b = __float_as_uint(x == 0.0f ? 0.0f : x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One term of the unweighted entropy: -(float)n * log2(n), 0 at n = 0.
__device__ __forceinline__ float table_term(int n, const float* __restrict__ table)
{
    return n > 0 ? __fmul_rn(-__int2float_rn(n), __ldg(table + n)) : 0.0f;
}

// torch.log2(w.clamp_min(1e-30)) on float32.
__device__ __forceinline__ float clamped_log2(float w)
{
    return log2f(fmaxf(w, 1e-30f));
}

__device__ __forceinline__ void flush(u64* best, u64 seg, u64 packed)
{
    if (packed != NONE) atomicMin(best + seg, packed);
}

__global__ void ss_stage(const long long* __restrict__ seg,
                         const long long* __restrict__ cls, int ns, int f,
                         uint8_t* __restrict__ cls8, u64* __restrict__ best,
                         long long kf, u64 init)
{
    const long long n = ns > kf ? (long long)ns : kf;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        if (i < ns) cls8[i] = seg[i] < f ? (uint8_t)cls[i] : (uint8_t)INACTIVE;
        if (i < kf) best[i] = init;
    }
}

__global__ void __launch_bounds__(THREADS) ss_tile_counts(
    const u64* __restrict__ keys, const long long* __restrict__ order,
    const uint8_t* __restrict__ cls8, int ns, int tiles, int f, int c,
    uint8_t* __restrict__ cls_sorted, int* __restrict__ counts)
{
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= tiles) return;
    const long long row = (long long)blockIdx.y * ns;
    const int base = t * TILE;
    int count = 0;  // lane cc: class cc's entries in the tile
    if ((keys[row + base] >> 32) < (u64)f) {
        for (int s = 0; s < STEPS; ++s) {
            const int i = base + s * 32 + lane;
            int cl = INACTIVE;
            if (i < ns) {
                cl = __ldg(cls8 + order[row + i]);
                cls_sorted[row + i] = (uint8_t)cl;
            }
            for (int cc = 0; cc < c; ++cc) {
                const unsigned b = __ballot_sync(FULL, cl == cc);
                if (lane == cc) count += __popc(b);
            }
        }
    }
    if (lane < c) counts[((long long)blockIdx.y * tiles + t) * c + lane] = count;
}

// A block a slot: its tiles' counts [tiles, C] -> exclusive prefixes.
__global__ void __launch_bounds__(SCAN_THREADS) ss_tile_scan(
    int* __restrict__ counts, int tiles, int c)
{
    __shared__ int warp_sums[SCAN_THREADS / 32];
    int* slot = counts + (long long)blockIdx.x * tiles * c;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int t0 = min((int)threadIdx.x * per, tiles), t1 = min(t0 + per, tiles);
    for (int cc = 0; cc < c; ++cc) {
        int sum = 0;
        for (int t = t0; t < t1; ++t) sum += slot[t * c + cc];
        int x = sum;  // inclusive over the warp
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
        __syncthreads();
        if (warp == 0) {
            int w = lane < SCAN_THREADS / 32 ? warp_sums[lane] : 0;
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(FULL, w, d);
                if (lane >= d) w += y;
            }
            if (lane < SCAN_THREADS / 32) warp_sums[lane] = w;
        }
        __syncthreads();
        int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
        for (int t = t0; t < t1; ++t) {
            const int v = slot[t * c + cc];
            slot[t * c + cc] = run;
            run += v;
        }
        __syncthreads();
    }
}

// Slot 0's stream: each segment's first position and end, and the class
// prefix at both (`offs`, `ends`, [F, C]).
__global__ void __launch_bounds__(THREADS) ss_heads(
    const u64* __restrict__ keys, const uint8_t* __restrict__ cls_sorted,
    const int* __restrict__ prefix, int ns, int tiles, int f, int c,
    int* __restrict__ seg_start, int* __restrict__ seg_end,
    int* __restrict__ offs, int* __restrict__ ends)
{
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= tiles) return;
    const int base = t * TILE;
    const unsigned lt = (1u << lane) - 1u;
    int p = lane < c ? prefix[t * c + lane] : 0;  // lane cc: class cc before
    u64 prev_key = base > 0 ? keys[base - 1] : NONE;
    if ((keys[base] >> 32) >= (u64)f) {  // inactive from here: one boundary
        const u64 ps = prev_key >> 32;
        if (ps < (u64)f) {
            if (lane == 0) seg_end[ps] = base;
            if (lane < c) ends[ps * c + lane] = p;
        }
        return;
    }
    for (int s = 0; s < STEPS; ++s) {
        const int i = base + s * 32 + lane;
        const bool in = i < ns;
        const u64 key = in ? keys[i] : NONE;
        const int cl = in ? cls_sorted[i] : INACTIVE;
        u64 pkey = __shfl_up_sync(FULL, key, 1);
        if (lane == 0) pkey = prev_key;
        prev_key = __shfl_sync(FULL, key, 31);
        const u64 seg = key >> 32, pseg = pkey >> 32;
        const bool head = in && seg != pseg;
        for (int cc = 0; cc < c; ++cc) {
            const unsigned b = __ballot_sync(FULL, cl == cc);
            const int at = __shfl_sync(FULL, p, cc) + __popc(b & lt);
            if (lane == cc) p += __popc(b);
            if (head) {
                if (seg < (u64)f) offs[seg * c + cc] = at;
                if (pseg < (u64)f) ends[pseg * c + cc] = at;
            }
        }
        if (head) {
            if (seg < (u64)f) seg_start[seg] = i;
            if (pseg < (u64)f) seg_end[pseg] = i;
        }
    }
    if (base + TILE >= ns) {  // the last tile: the stream's end
        const u64 sl = keys[ns - 1] >> 32;
        if (sl < (u64)f) {
            if (lane == 0) seg_end[sl] = ns;
            if (lane < c) ends[sl * c + lane] = p;
        }
    }
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(THREADS) ss_search(
    const u64* __restrict__ keys, const uint8_t* __restrict__ cls_sorted,
    const int* __restrict__ prefix, const int* __restrict__ offs,
    const int* __restrict__ ends, const float* __restrict__ table,
    const float* __restrict__ weights, int weight_rows,
    const uint8_t* __restrict__ weighted, int ns, int tiles, int f, int c,
    u64* __restrict__ best)
{
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (t >= tiles) return;
    const long long row = (long long)blockIdx.y * ns;
    const u64* kr = keys + row;
    const uint8_t* cr = cls_sorted + row;
    u64* slot_best = best + (long long)blockIdx.y * f;
    const int base = t * TILE;
    if ((kr[base] >> 32) >= (u64)f) return;
    const unsigned lt = (1u << lane) - 1u;
    int p = lane < c ? prefix[((long long)blockIdx.y * tiles + t) * c + lane] : 0;
    u64 prev_key = base > 0 ? kr[base - 1] : NONE;
    // The open run: the segment of the tile's positions so far that may go on
    // past them, and its least candidate (warp-uniform).
    u64 run_seg = NONE, run_best = NONE;
    for (int s = 0; s < STEPS; ++s) {
        const int i = base + s * 32 + lane;
        const bool in = i < ns;
        const u64 key = in ? kr[i] : NONE;
        const int cl = in ? cr[i] : INACTIVE;
        u64 pkey = __shfl_up_sync(FULL, key, 1);
        if (lane == 0) pkey = prev_key;
        prev_key = __shfl_sync(FULL, key, 31);
        const u64 seg = key >> 32, pseg = pkey >> 32;
        const bool valid = seg < (u64)f && seg == pseg &&
            __fsub_rn(ordered_value((uint32_t)key),
                      ordered_value((uint32_t)pkey)) >= 1e-6f;
        const u64 s31 = __shfl_sync(FULL, seg, 31);
        if (__ballot_sync(FULL, valid) == 0) {
            for (int cc = 0; cc < c; ++cc) {
                const unsigned b = __ballot_sync(FULL, cl == cc);
                if (lane == cc) p += __popc(b);
            }
            if (s31 != run_seg) {  // the step leaves the open run's segment
                if (lane == 0) flush(slot_best, run_seg, run_best);
                run_seg = s31;
                run_best = NONE;
            }
            continue;
        }

        bool use_w = false;
        if (WEIGHTED && valid) use_w = weighted == nullptr || weighted[seg];
        const int* so = offs + (valid ? seg * c : 0);
        const int* se = ends + (valid ? seg * c : 0);
        const float* w = weights + (weight_rows && valid ? seg * c : 0);
        float sum_l = 0.0f, sum_r = 0.0f, wm_l = 0.0f, wm_r = 0.0f;
        int m_l = 0, m_r = 0;
        for (int cc = 0; cc < c; ++cc) {
            const unsigned b = __ballot_sync(FULL, cl == cc);
            const int at = __shfl_sync(FULL, p, cc) + __popc(b & lt);
            if (lane == cc) p += __popc(b);
            if (!valid) continue;
            const int l = at - so[cc], r = se[cc] - at;
            m_l += l;
            m_r += r;
            float tl, tr;
            if (WEIGHTED && use_w) {
                const float wc = w[cc];
                const float xl = __fmul_rn(__int2float_rn(l), wc);
                const float xr = __fmul_rn(__int2float_rn(r), wc);
                wm_l = cc == 0 ? xl : __fadd_rn(wm_l, xl);
                wm_r = cc == 0 ? xr : __fadd_rn(wm_r, xr);
                tl = xl > 0.0f ? __fmul_rn(-xl, clamped_log2(xl)) : 0.0f;
                tr = xr > 0.0f ? __fmul_rn(-xr, clamped_log2(xr)) : 0.0f;
            } else {
                tl = table_term(l, table);
                tr = table_term(r, table);
            }
            sum_l = cc == 0 ? tl : __fadd_rn(sum_l, tl);
            sum_r = cc == 0 ? tr : __fadd_rn(sum_r, tr);
        }
        u64 packed = NONE;
        if (valid) {
            float el, er;
            if (WEIGHTED && use_w) {
                el = __fadd_rn(sum_l, wm_l > 0.0f ? __fmul_rn(wm_l, clamped_log2(wm_l)) : 0.0f);
                er = __fadd_rn(sum_r, wm_r > 0.0f ? __fmul_rn(wm_r, clamped_log2(wm_r)) : 0.0f);
            } else {
                el = __fadd_rn(sum_l, __fmul_rn(__int2float_rn(m_l), __ldg(table + m_l)));
                er = __fadd_rn(sum_r, __fmul_rn(__int2float_rn(m_r), __ldg(table + m_r)));
            }
            packed = ((u64)ordered_bits(__fadd_rn(el, er)) << 32) | (unsigned)i;
        }

        // Each lane: the least candidate from it to the end of its segment's
        // lanes (the segments' lanes are contiguous: the stream is sorted).
        for (int d = 1; d < 32; d <<= 1) {
            const u64 o = __shfl_down_sync(FULL, packed, d);
            const u64 os = __shfl_down_sync(FULL, seg, d);
            if (lane + d < 32 && os == seg && o < packed) packed = o;
        }
        const u64 s0 = __shfl_sync(FULL, seg, 0);
        const u64 m0 = __shfl_sync(FULL, packed, 0);
        u64 first = m0;  // lane 0's segment, with the open run if it goes on
        if (s0 == run_seg) {
            first = run_best < m0 ? run_best : m0;
        } else if (lane == 0) {
            flush(slot_best, run_seg, run_best);
        }
        if (s0 == s31) {
            run_seg = s0;
            run_best = first;
        } else {
            if (lane == 0) {
                flush(slot_best, s0, first);
            } else if (pseg != seg && seg != s31) {  // a segment within the step
                flush(slot_best, seg, packed);
            }
            const int last = __ffs(__ballot_sync(FULL, seg == s31)) - 1;
            run_seg = s31;
            run_best = __shfl_sync(FULL, packed, last);
        }
    }
    if (lane == 0) flush(slot_best, run_seg, run_best);
}

__global__ void ss_finish(const u64* __restrict__ best, const u64* __restrict__ keys,
                          const long long* __restrict__ order,
                          const float* __restrict__ vals,
                          const int* __restrict__ seg_start,
                          const int* __restrict__ seg_end, int ns, int f,
                          long long kf, float* __restrict__ obj,
                          float* __restrict__ thr, float* __restrict__ lm,
                          float* __restrict__ rm)
{
    const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (idx >= kf) return;
    const long long row = (idx / f) * ns;
    const u64 packed = best[idx];
    const int pos = (int)(uint32_t)packed;
    obj[idx] = ordered_value((uint32_t)(packed >> 32));
    const float v = vals[row + order[row + pos]];
    const float pv = vals[row + order[row + (pos > 0 ? pos - 1 : 0)]];
    thr[idx] = __fmul_rn(0.5f, __fadd_rn(pv, v));
    const u64 sp = keys[row + pos] >> 32;
    int l = 0, r = 0;
    if (sp < (u64)f) {
        l = pos - seg_start[sp];
        r = seg_end[sp] - pos;
    }
    lm[idx] = __int2float_rn(l);
    rm[idx] = __int2float_rn(r);
}

struct Scratch {
    uint8_t* cls8;        // [Ns]
    uint8_t* cls_sorted;  // [K, Ns]
    int* prefix;          // [K, tiles, C]
    u64* best;            // [K, F]
    int* seg_start;       // [F]
    int* seg_end;         // [F]
    int* offs;            // [F, C]
    int* ends;            // [F, C]
};

long long align256(long long n) { return (n + 255) & ~255ll; }

// Carves the scratch at `base` (null: only sizes it) -> its bytes.
long long carve(int k, int ns, int f, int c, uint8_t* base, Scratch* s)
{
    const long long tiles = (ns + TILE - 1) / TILE;
    const long long sizes[8] = {
        ns, (long long)k * ns, 4 * k * tiles * c, 8ll * k * f, 4ll * f, 4ll * f,
        4ll * f * c, 4ll * f * c};
    void** slots[8] = {(void**)&s->cls8, (void**)&s->cls_sorted,
                       (void**)&s->prefix, (void**)&s->best,
                       (void**)&s->seg_start, (void**)&s->seg_end,
                       (void**)&s->offs, (void**)&s->ends};
    long long at = 0;
    for (int j = 0; j < 8; ++j) {
        if (base != nullptr) *slots[j] = base + at;
        at += align256(sizes[j]);
    }
    return at;
}

}  // namespace

// Scratch bytes of a search of k slots over ns positions, f segments, c
// classes.
extern "C" int rovina_split_search_scratch(int k, int ns, int f, int c,
                                           long long* bytes)
{
    if (k < 1 || ns < 1 || f < 1 || c < 1) return (int)cudaErrorInvalidValue;
    Scratch s{};
    *bytes = carve(k, ns, f, c, nullptr, &s);
    return 0;
}

// keys, order: [k, ns] int64, the sort of (seg << 32) + _float_order(vals);
// vals: [k, ns] float32; seg, cls: [ns] int64 (seg == f: inactive; cls in
// [0, c) where active); table: [>= ns + 1] float32 log2 table; weights: null,
// [c] (weight_rows 0) or [f, c] (weight_rows 1) float32; weighted: null or
// [f] bool; obj, thr, lm, rm: [k, f] float32. The wrapper keeps 1 <= c <= 32,
// 1 <= k <= 65535 and ns + TILE < 2^31.
extern "C" int rovina_split_search(
    const void* keys, const void* order, const void* vals, const void* seg,
    const void* cls, const void* table, const void* weights, int weight_rows,
    const void* weighted, int k, int ns, int f, int c, void* scratch,
    void* obj, void* thr, void* lm, void* rm, void* stream)
{
    if (k < 1 || k > 65535 || ns < 1 || ns > 0x7FFFFFFF - TILE || f < 1 ||
        c < 1 || c > MAX_CLASSES)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    Scratch s{};
    carve(k, ns, f, c, (uint8_t*)scratch, &s);
    const int tiles = (ns + TILE - 1) / TILE;
    const long long kf = (long long)k * f;
    const u64 init = ((u64)0xFF800000u << 32) | (unsigned)(ns - 1);  // (+inf, Ns - 1)
    const long long n_stage = ns > kf ? (long long)ns : kf;
    const int stage_blocks = (int)((n_stage + 255) / 256 < 65536 ? (n_stage + 255) / 256 : 65536);
    const dim3 tile_grid((tiles + WARPS - 1) / WARPS, k);

    ss_stage<<<stage_blocks, 256, 0, st>>>((const long long*)seg, (const long long*)cls,
                                           ns, f, s.cls8, s.best, kf, init);
    ss_tile_counts<<<tile_grid, THREADS, 0, st>>>(
        (const u64*)keys, (const long long*)order, s.cls8, ns, tiles, f, c,
        s.cls_sorted, s.prefix);
    ss_tile_scan<<<k, SCAN_THREADS, 0, st>>>(s.prefix, tiles, c);
    ss_heads<<<tile_grid.x, THREADS, 0, st>>>(
        (const u64*)keys, s.cls_sorted, s.prefix, ns, tiles, f, c, s.seg_start,
        s.seg_end, s.offs, s.ends);
    if (weights != nullptr) {
        ss_search<true><<<tile_grid, THREADS, 0, st>>>(
            (const u64*)keys, s.cls_sorted, s.prefix, s.offs, s.ends,
            (const float*)table, (const float*)weights, weight_rows,
            (const uint8_t*)weighted, ns, tiles, f, c, s.best);
    } else {
        ss_search<false><<<tile_grid, THREADS, 0, st>>>(
            (const u64*)keys, s.cls_sorted, s.prefix, s.offs, s.ends,
            (const float*)table, nullptr, 0, nullptr, ns, tiles, f, c, s.best);
    }
    ss_finish<<<(int)((kf + 255) / 256), 256, 0, st>>>(
        s.best, (const u64*)keys, (const long long*)order, (const float*)vals,
        s.seg_start, s.seg_end, ns, f, kf, (float*)obj, (float*)thr, (float*)lm,
        (float*)rm);
    return (int)cudaGetLastError();
}
