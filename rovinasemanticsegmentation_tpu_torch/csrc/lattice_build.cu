// The permutohedral lattice build of the dense CRF for Hopper (sm_90a): the
// points' embedding, the vertex dedup by a hash table, the vertices' order by
// a sort of the distinct keys, the splat stream by a sort of (vertex, row),
// and the blur neighbours by direct lookups in the table.
//
// Replaces no TPU kernel: the JAX package's device build is XLA ops
// (rovinasemanticsegmentation_tpu/models/lattice.py::build_lattice_device),
// which keeps no hash table because the TPU has no atomics. The plain
// PyTorch build (models/lattice.py::_build_device_plain) sorts the whole
// stream of N (d+1) packed corner keys, finds its runs, and sort-merges every
// +1 blur query against the unique keys: ~607 launches of a few
// microseconds, 2.8 device ms a 30000-point map. These kernels were added for
// that stage's device time. They give the plain build's twelve results bit
// for bit, an overflowing build (more vertices than slots) included.
//
// 1. lb_embed_insert, one thread a (point, corner) row: the point's
//    elevation, remainder point, rank and barycentric weights with the plain
//    build's roundings (every float32 operation an _rn intrinsic, so nvcc
//    contracts nothing into an FMA; the elevation's a - b c in float64,
//    rounded once to float32, as _fused_sub forms it), the row's corner
//    written; then the corner's key, packed as _pack_keys16 packs it into
//    (d+1)/2 words, stored and inserted into an open-addressing table
//    (linear probing, a power-of-two capacity >= 2 N (d+1), fixed from N and
//    d on the host). The row that claims an empty slot (an acquire-release
//    CAS of row + 1, after its key is stored) appends itself to the list of
//    distinct keys; every row keeps its slot.
// 2. lb_key_tiles, lb_merge, lb_key_ranks: the m distinct keys (m read on the
//    device) sorted lexicographically: tiles of TILE by a bitonic sort (a
//    thread two keys: strides 1 to 32 in registers and across the warp's
//    lanes, 64 and up in shared memory), then passes that each merge GROUP
//    runs, a key's place being its place in its run plus its lower bound in
//    each other run of its group (the keys are distinct: no ties). The passes
//    are fixed by N (d+1), the bound of m, so nothing waits for the host;
//    blocks past m leave at once. The last pass writes each key's rank, the
//    plain build's lexicographic vertex id, into the key's table slot.
// 3. lb_row_ranks, lb_radix_pass: the rows sorted by (rank, row), which is
//    the plain build's stable sort: each row's rank (and its offset, clamped
//    into the bucket as the plain build clamps it) and the histogram of its
//    rank's digits, then stable LSD radix passes over digits of at most
//    MAX_DIGIT_BITS bits (two at 30000 points), each one launch: a block's
//    rows placed among its rows of their digit warp by warp, behind the
//    earlier blocks' rows by a decoupled look-back. The last pass writes the
//    splat stream.
// 4. lb_finish: each vertex slot's segment bounds from the sorted stream, the
//    stream's padding, and each slot's +1 and -1 neighbour along each axis
//    looked up in the table. The +1 map is one to one on the packed words, so
//    the -1 lookup gives the plain build's inversion of it; padded slots and
//    misses take the zero slot m_bucket.
//
// With overflow (m > m_bucket) slot m_bucket - 1 stands for the last vertex,
// m - 1, and the vertices m_bucket - 1 .. m - 2 have no slot, as the plain
// build's clamped ids and max-scatters leave them.
//
// What bounds it: port_bench/roofline.py's lattice_build stage counts, at
// 30000 points, d = 6 and 16384 slots, the features read, the corners,
// weights and blur tables written and a sort's worth of instructions:
// <= 0.99 us. The work stays in the 50 MB L2 (the table is 2 MB there); what
// is left is a fill and 8 launches in a chain, each a few microseconds of ramp
// and tail, the key tiles' barriers and the merge's dependent loads.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

#ifndef LB_TILE_THREADS
#define LB_TILE_THREADS 1024
#endif
#ifndef LB_RADIX_THREADS
#define LB_RADIX_THREADS 512
#endif

constexpr int MAX_D = 8;                          // feature dimensions d
constexpr int THREADS = 256;                      // a thread a row, key or slot
constexpr int TILE_THREADS = LB_TILE_THREADS;
constexpr int TILE = 2 * TILE_THREADS;            // keys a block sorts
constexpr int GROUP = 16;                         // runs a merge pass joins
constexpr int RANK_THREADS = 1024;
constexpr int RADIX_THREADS = LB_RADIX_THREADS;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int RADIX_ITEMS = 4;
constexpr int RADIX_BLOCK = RADIX_THREADS * RADIX_ITEMS;  // rows a radix block
constexpr int MAX_DIGIT_BITS = 10;

typedef unsigned long long u64;

// A sort element: K 64-bit words compared in order, then the payload.
template <int K>
struct Elem {
    u64 k[K];
    unsigned p;
};

template <int K>
__device__ __forceinline__ bool elem_less(const Elem<K>& a, const Elem<K>& b)
{
#pragma unroll
    for (int i = 0; i < K; ++i)
        if (a.k[i] != b.k[i]) return a.k[i] < b.k[i];
    return a.p < b.p;
}

// Pads a tile: after every real element (whose payload is < 2^31).
template <int K>
__device__ __forceinline__ Elem<K> elem_past_end()
{
    Elem<K> e;
#pragma unroll
    for (int i = 0; i < K; ++i) e.k[i] = ~0ull;
    e.p = 0xFFFFFFFFu;
    return e;
}

// -- begin device atomics
__device__ __forceinline__ int load_acquire(const int* p)
{
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ int cas_acq_rel(int* p, int expected, int desired)
{
    int old;
    asm volatile("atom.acq_rel.gpu.global.cas.b32 %0, [%1], %2, %3;"
                 : "=r"(old) : "l"(p), "r"(expected), "r"(desired) : "memory");
    return old;
}
// -- end device atomics

// _pack_pair16: hi * 2^16 + lo + 2^15, wrapped to int32.
__device__ __forceinline__ int pack_pair16(long long hi, long long lo)
{
    return (int)(unsigned)((u64)(hi * 65536 + lo + 32768) & 0xFFFFFFFFull);
}

template <int D>
__device__ __forceinline__ void pack_key(const long long (&c)[D], int (&w)[(D + 1) / 2])
{
#pragma unroll
    for (int i = 0; i < (D + 1) / 2; ++i)
        w[i] = pack_pair16(c[2 * i], 2 * i + 1 < D ? c[2 * i + 1] : -32768LL);
}

// The plain build's unpacking: hi = w >> 16 (arithmetic), lo = (w & 0xFFFF) - 2^15.
template <int D>
__device__ __forceinline__ void unpack_key(const int (&w)[(D + 1) / 2], long long (&c)[D])
{
#pragma unroll
    for (int i = 0; i < (D + 1) / 2; ++i) {
        c[2 * i] = w[i] >> 16;
        if (2 * i + 1 < D) c[2 * i + 1] = (long long)(w[i] & 0xFFFF) - 32768;
    }
}

template <int W>
__device__ __forceinline__ unsigned hash_key(const int (&w)[W])
{
    u64 x = 0x9E3779B97F4A7C15ull;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        x ^= (unsigned)w[i];
        x *= 0xBF58476D1CE4E5B9ull;
        x ^= x >> 31;
    }
    x *= 0x94D049BB133111EBull;
    return (unsigned)(x ^ (x >> 29));
}

// The packed words as sort words: each int32 biased to unsigned order, two a
// 64-bit word, the first most significant.
template <int K, int W>
__device__ __forceinline__ Elem<K> key_elem(const int* w, unsigned payload)
{
    Elem<K> e;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const u64 hi = (unsigned)w[2 * i] ^ 0x80000000u;
        const u64 lo = 2 * i + 1 < W ? (unsigned)w[2 * i + 1] ^ 0x80000000u : 0u;
        e.k[i] = (hi << 32) | lo;
    }
    e.p = payload;
    return e;
}

// The slot of vertex r: itself below m_bucket - 1; the last vertex in slot
// m_bucket - 1; m_bucket (missing) for the overflowed ones between.
__device__ __forceinline__ int slot_of_rank(int r, int m, int m_bucket)
{
    if (r < m_bucket - 1) return r;
    return r == m - 1 ? m_bucket - 1 : m_bucket;
}

template <int W>
__device__ __forceinline__ int find_key(const int* __restrict__ table, unsigned mask,
                                        const int* __restrict__ keys, const int (&q)[W])
{
    unsigned h = hash_key<W>(q) & mask;
    for (;;) {
        const int cur = __ldg(table + h);
        if (cur == 0) return -1;
        const int* kw = keys + (size_t)(cur - 1) * W;
        bool same = true;
#pragma unroll
        for (int i = 0; i < W; ++i) same = same && __ldg(kw + i) == q[i];
        if (same) return (int)h;
        h = (h + 1) & mask;
    }
}

struct Scale {
    float s[MAX_D];
};

// One thread a (point, corner) row t = p (d+1) + r.
template <int D>
__global__ void __launch_bounds__(THREADS)
lb_embed_insert(const float* __restrict__ features, int n, Scale scale,
                float* __restrict__ bary_t, float* __restrict__ rem0_out,
                long long* __restrict__ rank_out, int* keys, int* table,
                unsigned mask, int* count, int* __restrict__ uniq_row,
                int* __restrict__ uniq_slot, int* __restrict__ row_slot)
{
    constexpr int D1 = D + 1;
    constexpr int W = (D + 1) / 2;
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= n * D1) return;
    const int p = t / D1;
    const int r = t - p * D1;
    const float down = (float)(1.0 / D1);
    const float fd1 = (float)D1;

    // Elevation: suffix sums right to left; e_1 = s_1 - f_0 scale_0 and
    // e_j = s_j - j c_{j-1}, each in float64 rounded once.
    float f[D], c[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
        f[i] = features[(size_t)p * D + i];
        c[i] = __fmul_rn(f[i], scale.s[i]);
    }
    float suffix[D1];
    suffix[D] = 0.0f;
#pragma unroll
    for (int j = D - 1; j >= 0; --j) suffix[j] = __fadd_rn(suffix[j + 1], c[j]);
    float e[D1];
    e[0] = suffix[0];
    e[1] = __double2float_rn(__dsub_rn((double)suffix[1],
                                       __dmul_rn((double)f[0], (double)scale.s[0])));
#pragma unroll
    for (int j = 2; j <= D; ++j)
        e[j] = __double2float_rn(__dsub_rn((double)suffix[j],
                                           __dmul_rn((double)c[j - 1], (double)j)));

    // The nearest remainder point and its coordinate sum.
    float rem[D1];
    float rsum = 0.0f;
#pragma unroll
    for (int i = 0; i < D1; ++i) {
        const float v = __fmul_rn(e[i], down);
        const float up = __fmul_rn(ceilf(v), fd1);
        const float dn = __fmul_rn(floorf(v), fd1);
        rem[i] = __fsub_rn(up, e[i]) < __fsub_rn(e[i], dn) ? up : dn;
    }
#pragma unroll
    for (int i = 0; i < D1; ++i) rsum = __fadd_rn(rsum, rem[i]);
    const int rem_sum = (int)(long long)__fmul_rn(rsum, down);

    // Descending stable rank of the residuals, wrapped onto the plane.
    float diff[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) diff[i] = __fsub_rn(e[i], rem[i]);
    int rk[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
        int k = 0;
#pragma unroll
        for (int j = 0; j < D1; ++j)
            if (j != i && (j > i ? diff[i] < diff[j] : diff[j] >= diff[i])) ++k;
        rk[i] = k + rem_sum;
    }
#pragma unroll
    for (int i = 0; i < D1; ++i) {
        if (rk[i] < 0) {
            rk[i] += D1;
            rem[i] = __fadd_rn(rem[i], fd1);
        }
        if (rk[i] > D) {
            rk[i] -= D1;
            rem[i] = __fsub_rn(rem[i], fd1);
        }
    }

    // Corner r's weight: slot r takes +vbar[i] where d - rank[i] == r and
    // -vbar[i] where d - rank[i] == r - 1; slot 0 adds 1 + (0 - vbar of slot d).
    float vbar[D1];
#pragma unroll
    for (int i = 0; i < D1; ++i) vbar[i] = __fmul_rn(__fsub_rn(e[i], rem[i]), down);
    float plus = 0.0f, minus = 0.0f, wrap = 0.0f;
#pragma unroll
    for (int i = 0; i < D1; ++i) {
        if (D - rk[i] == r) plus = __fadd_rn(plus, vbar[i]);
        if (D - rk[i] == r - 1) minus = __fadd_rn(minus, vbar[i]);
        if (rk[i] == 0) wrap = __fadd_rn(wrap, vbar[i]);
    }
    float weight = __fsub_rn(plus, minus);
    if (r == 0) weight = __fadd_rn(weight, __fadd_rn(1.0f, __fsub_rn(0.0f, wrap)));
    bary_t[(size_t)r * n + p] = weight;
    rem0_out[t] = rem[r];
    rank_out[t] = rk[r];

    // Corner r's key: coordinate i steps by r, wrapping past d - r.
    long long coord[D];
#pragma unroll
    for (int i = 0; i < D; ++i)
        coord[i] = (long long)rem[i] + (rk[i] <= D - r ? r : r - D1);
    int w[W];
    pack_key<D>(coord, w);
    int* mine = keys + (size_t)t * W;
#pragma unroll
    for (int i = 0; i < W; ++i) mine[i] = w[i];

    // Insert: the CAS releases the key stored above; a row that reads another
    // row's id acquires that row's key.
    unsigned h = hash_key<W>(w) & mask;
    for (;;) {
        int cur = load_acquire(table + h);
        if (cur == 0) {
            cur = cas_acq_rel(table + h, 0, t + 1);
            if (cur == 0) {
                const int u = atomicAdd(count, 1);
                uniq_row[u] = t;
                uniq_slot[u] = (int)h;
                row_slot[t] = (int)h;
                return;
            }
        }
        const int* other = keys + (size_t)(cur - 1) * W;
        bool same = true;
#pragma unroll
        for (int i = 0; i < W; ++i) same = same && other[i] == w[i];
        if (same) {
            row_slot[t] = (int)h;
            return;
        }
        h = (h + 1) & mask;
    }
}

constexpr unsigned FULL = 0xFFFFFFFFu;

template <int K>
__device__ __forceinline__ Elem<K> shfl_xor(const Elem<K>& e, int mask)
{
    Elem<K> o;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const unsigned lo = __shfl_xor_sync(FULL, (unsigned)e.k[i], mask);
        const unsigned hi = __shfl_xor_sync(FULL, (unsigned)(e.k[i] >> 32), mask);
        o.k[i] = ((u64)hi << 32) | lo;
    }
    o.p = __shfl_xor_sync(FULL, e.p, mask);
    return o;
}

// Ascending bitonic sort of TILE elements, thread t holding positions 2t and
// 2t + 1 in v: a stride of 1 within the thread, 2 to 32 across the warp's
// lanes, 64 and up in shared memory s.
template <int K>
__device__ void bitonic_sort(Elem<K> (&v)[2], Elem<K>* s)
{
    const int t = threadIdx.x;
    for (int size = 2; size <= TILE; size <<= 1) {
        int stride = size >> 1;
        if (stride >= 64) {
            s[2 * t] = v[0];
            s[2 * t + 1] = v[1];
            for (; stride >= 64; stride >>= 1) {
                __syncthreads();
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const Elem<K> a = s[lo];
                const Elem<K> b = s[hi];
                if (elem_less<K>(b, a) == ((lo & size) == 0)) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
            __syncthreads();
            v[0] = s[2 * t];
            v[1] = s[2 * t + 1];
        }
        for (; stride >= 2; stride >>= 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int i = 2 * t + j;
                const Elem<K> o = shfl_xor<K>(v[j], stride >> 1);
                const bool keep_min = ((i & stride) == 0) == ((i & size) == 0);
                if (elem_less<K>(o, v[j]) == keep_min) v[j] = o;
            }
        }
        if (elem_less<K>(v[1], v[0]) == ((2 * t & size) == 0)) {
            const Elem<K> a = v[0];
            v[0] = v[1];
            v[1] = a;
        }
    }
}

// The distinct keys, a tile a block, sorted: payload = index in the list.
template <int K, int W>
__global__ void __launch_bounds__(TILE_THREADS)
lb_key_tiles(const int* __restrict__ keys, const int* __restrict__ uniq_row,
             const int* __restrict__ count, Elem<K>* __restrict__ out)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Elem<K>* tile = reinterpret_cast<Elem<K>*>(smem_raw);
    const int m = *count;
    const int base = blockIdx.x * TILE;
    if (base >= m) return;
    Elem<K> v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int u = base + 2 * threadIdx.x + j;
        v[j] = u < m ? key_elem<K, W>(keys + (size_t)uniq_row[u] * W, (unsigned)u)
                     : elem_past_end<K>();
    }
    bitonic_sort<K>(v, tile);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int u = base + 2 * threadIdx.x + j;
        if (u < m) out[u] = v[j];
    }
}

// Element i's place once its group of GROUP sorted runs of `width` merges:
// its place in its run plus its lower bound in each other run of the group.
template <int K>
__device__ __forceinline__ int merged_place(const Elem<K>* __restrict__ in, int count,
                                            int width, int i, const Elem<K>& e)
{
    const int run = i / width;
    const int first = run - run % GROUP;
    const int runs = (int)(((long long)count + width - 1) / width);
    const int last = min(first + GROUP, runs);
    int place = first * width + (i - run * width);
    for (int other = first; other < last; ++other) {
        if (other == run) continue;
        const Elem<K>* o = in + (size_t)other * width;
        int lo = 0, hi = min(width, count - other * width);
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (elem_less<K>(o[mid], e)) lo = mid + 1;
            else hi = mid;
        }
        place += lo;
    }
    return place;
}

// One merge pass of the distinct keys (m on the device).
template <int K>
__global__ void __launch_bounds__(THREADS)
lb_merge(const Elem<K>* __restrict__ in, Elem<K>* __restrict__ out,
         const int* __restrict__ count, int width)
{
    const int m = *count;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const Elem<K> e = in[i];
    out[merged_place<K>(in, m, width, i, e)] = e;
}

// The last pass of the keys: each key's rank into its table slot, and the
// row that holds the key of each rank.
template <int K>
__global__ void __launch_bounds__(THREADS)
lb_key_ranks(const Elem<K>* __restrict__ in, const int* __restrict__ count, int width,
             const int* __restrict__ uniq_row, const int* __restrict__ uniq_slot,
             int* __restrict__ rank_row, int* __restrict__ slot_rank)
{
    const int m = *count;
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const Elem<K> e = in[i];
    const int place = merged_place<K>(in, m, width, i, e);
    rank_row[place] = uniq_row[e.p];
    slot_rank[uniq_slot[e.p]] = place;
}

// Each row's rank: its offset (clamped into the bucket) into offsets_t
// [d+1, N], its sort word (rank << 32 | row) in row order, and the digits of
// its rank counted for every radix pass (a block's counts in shared memory,
// then one atomic a bucket).
__global__ void __launch_bounds__(RANK_THREADS)
lb_row_ranks(const int* __restrict__ row_slot, const int* __restrict__ slot_rank, int s,
             int n, int d1, int m_bucket, int passes, int bits,
             long long* __restrict__ offsets_t, u64* __restrict__ words,
             unsigned* __restrict__ hist)
{
    extern __shared__ unsigned block_hist[];  // [passes << bits]
    const int buckets = 1 << bits;
    for (int i = threadIdx.x; i < passes * buckets; i += RANK_THREADS) block_hist[i] = 0;
    __syncthreads();
    const int row = blockIdx.x * RANK_THREADS + threadIdx.x;
    if (row < s) {
        const int rank = slot_rank[row_slot[row]];
        const int p = row / d1;
        offsets_t[(size_t)(row - p * d1) * n + p] = min(rank, m_bucket - 1);
        words[row] = ((u64)(unsigned)rank << 32) | (unsigned)row;
        for (int pass = 0; pass < passes; ++pass)
            atomicAdd(block_hist + pass * buckets + ((rank >> (pass * bits)) & (buckets - 1)), 1u);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < passes * buckets; i += RANK_THREADS)
        if (block_hist[i] != 0) atomicAdd(hist + i, block_hist[i]);
}

// A radix pass's status words: a flag and a count a (block, bucket).
constexpr unsigned FLAG_AGGREGATE = 1u << 30;
constexpr unsigned FLAG_PREFIX = 2u << 30;
constexpr unsigned COUNT_MASK = (1u << 30) - 1;

// One stable pass of the rows' sort by rank over the digit (rank >> shift)
// of `bits` bits, RADIX_BLOCK rows a block (blocks take their turn from
// `ticket`, so that every block a block waits on runs): each row's place
// among the block's rows of its digit (warp by warp, 32 rows at a time, with
// __match_any_sync), the digit's rows in earlier blocks by a decoupled look-
// back over `status`, and the digit's start from the pass's histogram. The
// last pass writes the splat stream and each stream row's rank.
template <bool LAST>
__global__ void __launch_bounds__(RADIX_THREADS)
lb_radix_pass(const u64* __restrict__ in, u64* __restrict__ out, int s, int shift, int bits,
              const unsigned* __restrict__ hist, unsigned* status, int* ticket, int n, int d1,
              const float* __restrict__ bary_t, long long* __restrict__ pos_sorted,
              long long* __restrict__ sorted_points, float* __restrict__ sorted_weights,
              int* __restrict__ sorted_rank)
{
    extern __shared__ unsigned smem_u[];
    const int buckets = 1 << bits;
    unsigned* counts = smem_u;                       // [RADIX_WARPS][buckets]
    unsigned* base = counts + RADIX_WARPS * buckets;  // [buckets]
    unsigned* scan = base + buckets;                  // [2][buckets]
    __shared__ int block_id;
    if (threadIdx.x == 0) block_id = atomicAdd(ticket, 1);
    for (int i = threadIdx.x; i < RADIX_WARPS * buckets; i += RADIX_THREADS) counts[i] = 0;
    __syncthreads();
    const int b = block_id;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1;
    const int first = b * RADIX_BLOCK + warp * (32 * RADIX_ITEMS);
    u64 word[RADIX_ITEMS];
    int digit[RADIX_ITEMS];
    unsigned place[RADIX_ITEMS];
#pragma unroll
    for (int k = 0; k < RADIX_ITEMS; ++k) {
        const int i = first + 32 * k + lane;
        const bool valid = i < s;
        word[k] = valid ? in[i] : 0;
        digit[k] = valid ? (int)((word[k] >> (32 + shift)) & (unsigned)(buckets - 1)) : -1;
        const unsigned peers = __match_any_sync(FULL, digit[k]) & __ballot_sync(FULL, valid);
        unsigned before = 0;
        if (valid) before = counts[warp * buckets + digit[k]];
        __syncwarp();
        if (valid) {
            place[k] = before + __popc(peers & below);
            if (lane == __ffs(peers) - 1) counts[warp * buckets + digit[k]] = before + __popc(peers);
        }
        __syncwarp();
    }
    __syncthreads();
    // Per digit: the warps' exclusive offsets, the block's count published,
    // the earlier blocks' count looked back; the digit's global start by an
    // exclusive scan of the histogram.
    for (int dg = threadIdx.x; dg < buckets; dg += RADIX_THREADS) {
        unsigned run = 0;
        for (int w = 0; w < RADIX_WARPS; ++w) {
            const unsigned c = counts[w * buckets + dg];
            counts[w * buckets + dg] = run;
            run += c;
        }
        volatile unsigned* mine = status + (size_t)b * buckets + dg;
        unsigned earlier = 0;
        if (b == 0) {
            *mine = FLAG_PREFIX | run;
        } else {
            *mine = FLAG_AGGREGATE | run;
            for (int j = b - 1;;) {
                const unsigned v = *(volatile unsigned*)(status + (size_t)j * buckets + dg);
                if (v == 0) continue;
                earlier += v & COUNT_MASK;
                if ((v & ~COUNT_MASK) == FLAG_PREFIX) break;
                --j;
            }
            *mine = FLAG_PREFIX | (earlier + run);
        }
        base[dg] = earlier;
        scan[dg] = hist[dg];
    }
    __syncthreads();
    unsigned* from = scan;
    unsigned* to = scan + buckets;
    for (int off = 1; off < buckets; off <<= 1) {  // inclusive scan, Hillis-Steele
        for (int dg = threadIdx.x; dg < buckets; dg += RADIX_THREADS)
            to[dg] = dg >= off ? from[dg] + from[dg - off] : from[dg];
        __syncthreads();
        unsigned* t = from;
        from = to;
        to = t;
    }
    for (int dg = threadIdx.x; dg < buckets; dg += RADIX_THREADS)
        base[dg] += from[dg] - hist[dg];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RADIX_ITEMS; ++k) {
        if (digit[k] < 0) continue;
        const int pos = (int)(base[digit[k]] + counts[warp * buckets + digit[k]] + place[k]);
        if (!LAST) {
            out[pos] = word[k];
        } else {
            const int row = (int)(unsigned)(word[k] & 0xFFFFFFFFull);
            const int p = row / d1;
            pos_sorted[pos] = row;
            sorted_points[pos] = p;
            sorted_weights[pos] = bary_t[(size_t)(row - p * d1) * n + p];
            sorted_rank[pos] = (int)(word[k] >> 32);
        }
    }
}

// Blocks [0, stream_blocks): a thread a stream row or vertex slot: segment
// bounds, the stream's padding, the padded slots' empty segments and m. The
// rest: a thread a (axis, slot): the slot's blur neighbours.
template <int D>
__global__ void __launch_bounds__(THREADS)
lb_finish(const int* __restrict__ count, int s, int spad, int m_bucket, int stream_blocks,
          const int* __restrict__ sorted_rank, const int* __restrict__ keys,
          const int* __restrict__ table, unsigned mask, const int* __restrict__ slot_rank,
          const int* __restrict__ rank_row, long long* __restrict__ sorted_points,
          float* __restrict__ sorted_weights, long long* __restrict__ seg_starts,
          long long* __restrict__ seg_ends, long long* __restrict__ blur_n1,
          long long* __restrict__ blur_n2, long long* __restrict__ m_out)
{
    constexpr int D1 = D + 1;
    constexpr int W = (D + 1) / 2;
    const int m = *count;
    if ((int)blockIdx.x < stream_blocks) {
        const int t = blockIdx.x * THREADS + threadIdx.x;
        if (t == 0) *m_out = m;
        if (t < s) {
            const int r = sorted_rank[t];
            const int slot = slot_of_rank(r, m, m_bucket);
            if (slot < m_bucket) {
                if (t == 0 || sorted_rank[t - 1] != r) seg_starts[slot] = t;
                if (t == s - 1 || sorted_rank[t + 1] != r) seg_ends[slot] = t + 1;
            }
        } else if (t < spad) {
            sorted_points[t] = 0;
            sorted_weights[t] = 0.0f;
        }
        if (t >= m && t < m_bucket) {
            seg_starts[t] = 0;
            seg_ends[t] = 0;
        }
        return;
    }
    const int t = ((int)blockIdx.x - stream_blocks) * THREADS + threadIdx.x;
    if (t >= D1 * m_bucket) return;
    const int axis = t / m_bucket;
    const int v = t - axis * m_bucket;
    long long n1 = m_bucket, n2 = m_bucket;
    if (v < m) {
        const int vertex = v == m_bucket - 1 ? m - 1 : v;
        const int* kw = keys + (size_t)rank_row[vertex] * W;
        int w[W];
#pragma unroll
        for (int i = 0; i < W; ++i) w[i] = kw[i];
        long long c[D], fwd[D], back[D];
        unpack_key<D>(w, c);
#pragma unroll
        for (int i = 0; i < D; ++i) {
            const long long step = i == axis ? D : -1;
            fwd[i] = c[i] + step;
            back[i] = c[i] - step;
        }
        int q[W];
        pack_key<D>(fwd, q);
        int h = find_key<W>(table, mask, keys, q);
        if (h >= 0) n1 = slot_of_rank(slot_rank[h], m, m_bucket);
        pack_key<D>(back, q);
        h = find_key<W>(table, mask, keys, q);
        if (h >= 0) n2 = slot_of_rank(slot_rank[h], m, m_bucket);
    }
    blur_n1[t] = n1;
    blur_n2[t] = n2;
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

int blocks_of(long long threads, int per_block)
{
    return (int)((threads + per_block - 1) / per_block);
}

// Merge passes after the tiles until one run holds `bound` keys.
int merge_passes(int bound)
{
    int passes = 0;
    for (long long width = TILE; width < bound; width *= GROUP) ++passes;
    return passes;
}

// The rows' radix passes: ranks lie below s, so bit_length(s - 1) bits in
// passes of at most MAX_DIGIT_BITS.
void radix_plan(int s, int& passes, int& bits)
{
    int r = 0;
    while (r < 31 && (1LL << r) < s) ++r;
    passes = r > MAX_DIGIT_BITS ? (r + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS : 1;
    bits = r > passes ? (r + passes - 1) / passes : 1;
}

struct Scratch {
    // One zero fill from `table` to `status` inclusive.
    int* table;        // [cap] row + 1 of the key in each slot, 0 empty
    int* count;        // [1] distinct keys
    int* tickets;      // [passes] the radix passes' block tickets
    unsigned* hist;    // [passes][buckets] the rows' rank digits
    unsigned* status;  // [passes][radix blocks][buckets] look-back words
    size_t fill_bytes;
    int* keys;         // [s, W] packed corner keys
    int* uniq_row;     // [s] a row of each distinct key, in claim order
    int* uniq_slot;    // [s] its table slot
    int* row_slot;     // [s] each row's table slot
    int* slot_rank;    // [cap] the rank of the key in each claimed slot
    int* rank_row;     // [s] a row of each rank's key
    int* sorted_rank;  // [s] the rank of each stream row
    void* key_elems[2];
    u64* row_words[2];
    unsigned cap;
    int passes, bits, radix_blocks;
    size_t bytes;
};

Scratch carve(char* base, int n, int d)
{
    const int d1 = d + 1;
    const int w = (d + 1) / 2;
    const size_t s = (size_t)n * d1;
    const size_t key_elem = (w + 1) / 2 == 1 ? sizeof(Elem<1>) : sizeof(Elem<2>);
    Scratch sc;
    sc.cap = 2;
    while ((size_t)sc.cap < 2 * s) sc.cap <<= 1;
    radix_plan((int)s, sc.passes, sc.bits);
    sc.radix_blocks = blocks_of((long long)s, RADIX_BLOCK);
    const size_t buckets = (size_t)1 << sc.bits;
    const uintptr_t origin = reinterpret_cast<uintptr_t>(base);
    size_t at = 0;
    auto take = [&](size_t bytes) {
        void* p = reinterpret_cast<void*>(origin + at);
        at += align_up(bytes);
        return p;
    };
    // the zero-filled part, contiguous
    sc.table = static_cast<int*>(take(((size_t)sc.cap + 1 + sc.passes) * sizeof(int)));
    sc.count = sc.table + sc.cap;
    sc.tickets = sc.count + 1;
    sc.hist = static_cast<unsigned*>(take(sc.passes * buckets * sizeof(unsigned)));
    sc.status = static_cast<unsigned*>(
        take(sc.passes * (size_t)sc.radix_blocks * buckets * sizeof(unsigned)));
    sc.fill_bytes = at;
    sc.keys = static_cast<int*>(take(s * w * sizeof(int)));
    sc.uniq_row = static_cast<int*>(take(s * sizeof(int)));
    sc.uniq_slot = static_cast<int*>(take(s * sizeof(int)));
    sc.row_slot = static_cast<int*>(take(s * sizeof(int)));
    sc.slot_rank = static_cast<int*>(take((size_t)sc.cap * sizeof(int)));
    sc.rank_row = static_cast<int*>(take(s * sizeof(int)));
    sc.sorted_rank = static_cast<int*>(take(s * sizeof(int)));
    sc.key_elems[0] = take(s * key_elem);
    sc.key_elems[1] = take(s * key_elem);
    sc.row_words[0] = static_cast<u64*>(take(s * sizeof(u64)));
    sc.row_words[1] = static_cast<u64*>(take(s * sizeof(u64)));
    sc.bytes = at;
    return sc;
}

template <int D>
int build(const float* features, int n, const float* scale, int m_bucket, char* scratch,
          long long* sorted_points, float* sorted_weights, long long* seg_starts,
          long long* seg_ends, long long* offsets_t, float* bary_t, long long* blur_n1,
          long long* blur_n2, long long* m_out, long long* pos_sorted, float* rem0,
          long long* rank, cudaStream_t stream)
{
    constexpr int D1 = D + 1;
    constexpr int W = (D + 1) / 2;
    constexpr int K = (W + 1) / 2;
    const int s = n * D1;
    const int spad = (s + 127) / 128 * 128;
    const Scratch sc = carve(scratch, n, D);
    const int buckets = 1 << sc.bits;
    cudaMemsetAsync(sc.table, 0, sc.fill_bytes, stream);
    Scale sv;
    for (int i = 0; i < MAX_D; ++i) sv.s[i] = i < D ? scale[i] : 0.0f;
    lb_embed_insert<D><<<blocks_of(s, THREADS), THREADS, 0, stream>>>(
        features, n, sv, bary_t, rem0, rank, sc.keys, sc.table, sc.cap - 1, sc.count,
        sc.uniq_row, sc.uniq_slot, sc.row_slot);

    // The distinct keys: tiles, merge passes, ranks.
    const int tile_smem = TILE * (int)sizeof(Elem<K>);
    cudaFuncSetAttribute(lb_key_tiles<K, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         tile_smem);
    Elem<K>* in = static_cast<Elem<K>*>(sc.key_elems[0]);
    Elem<K>* out = static_cast<Elem<K>*>(sc.key_elems[1]);
    lb_key_tiles<K, W><<<blocks_of(s, TILE), TILE_THREADS, tile_smem, stream>>>(
        sc.keys, sc.uniq_row, sc.count, in);
    int width = TILE;
    for (int pass = 1; pass < merge_passes(s); ++pass, width *= GROUP) {
        lb_merge<K><<<blocks_of(s, THREADS), THREADS, 0, stream>>>(in, out, sc.count, width);
        Elem<K>* t = in;
        in = out;
        out = t;
    }
    lb_key_ranks<K><<<blocks_of(s, THREADS), THREADS, 0, stream>>>(
        in, sc.count, width, sc.uniq_row, sc.uniq_slot, sc.rank_row, sc.slot_rank);

    // The rows by (rank, row): ranks and digit counts, then the radix passes.
    lb_row_ranks<<<blocks_of(s, RANK_THREADS), RANK_THREADS,
                   sc.passes * buckets * sizeof(unsigned), stream>>>(
        sc.row_slot, sc.slot_rank, s, n, D1, m_bucket, sc.passes, sc.bits, offsets_t,
        sc.row_words[0], sc.hist);
    const int radix_smem = (RADIX_WARPS + 3) * buckets * (int)sizeof(unsigned);
    cudaFuncSetAttribute(lb_radix_pass<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         radix_smem);
    cudaFuncSetAttribute(lb_radix_pass<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         radix_smem);
    for (int pass = 0; pass < sc.passes; ++pass) {
        const u64* words = sc.row_words[pass % 2];
        u64* next = sc.row_words[(pass + 1) % 2];
        const unsigned* hist = sc.hist + (size_t)pass * buckets;
        unsigned* status = sc.status + (size_t)pass * sc.radix_blocks * buckets;
        if (pass + 1 < sc.passes) {
            lb_radix_pass<false><<<sc.radix_blocks, RADIX_THREADS, radix_smem, stream>>>(
                words, next, s, pass * sc.bits, sc.bits, hist, status, sc.tickets + pass, n,
                D1, bary_t, pos_sorted, sorted_points, sorted_weights, sc.sorted_rank);
        } else {
            lb_radix_pass<true><<<sc.radix_blocks, RADIX_THREADS, radix_smem, stream>>>(
                words, next, s, pass * sc.bits, sc.bits, hist, status, sc.tickets + pass, n,
                D1, bary_t, pos_sorted, sorted_points, sorted_weights, sc.sorted_rank);
        }
    }

    const int stream_blocks = blocks_of(spad > m_bucket ? spad : m_bucket, THREADS);
    lb_finish<D><<<stream_blocks + blocks_of((long long)D1 * m_bucket, THREADS), THREADS, 0,
                   stream>>>(
        sc.count, s, spad, m_bucket, stream_blocks, sc.sorted_rank, sc.keys, sc.table,
        sc.cap - 1, sc.slot_rank, sc.rank_row, sorted_points, sorted_weights, seg_starts,
        seg_ends, blur_n1, blur_n2, m_out);
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch the build of n points in d dimensions needs.
extern "C" int rovina_lattice_build_scratch(int n, int d, long long* bytes)
{
    *bytes = (long long)carve(nullptr, n, d).bytes;
    return 0;
}

// The build of features [n, d] float32 into build_lattice_device's outputs
// (int64 indices, float32 weights; offsets and weights [d+1, n], the blur
// tables [d+1, m_bucket], m a device scalar) and the stream rows' flat
// indices, rem0 and rank [n, d+1]. scale: the d float32 elevation scales.
// Launches on `stream` without a synchronisation.
extern "C" int rovina_lattice_build(
    const float* features, int n, int d, const float* scale, int m_bucket, void* scratch,
    long long* sorted_points, float* sorted_weights, long long* seg_starts,
    long long* seg_ends, long long* offsets_t, float* bary_t, long long* blur_n1,
    long long* blur_n2, long long* m_out, long long* pos_sorted, float* rem0,
    long long* rank, cudaStream_t stream)
{
    char* base = static_cast<char*>(scratch);
#define ROVINA_LATTICE_BUILD(DIM)                                                          \
    case DIM:                                                                              \
        return build<DIM>(features, n, scale, m_bucket, base, sorted_points,               \
                          sorted_weights, seg_starts, seg_ends, offsets_t, bary_t,         \
                          blur_n1, blur_n2, m_out, pos_sorted, rem0, rank, stream);
    switch (d) {
        ROVINA_LATTICE_BUILD(1)
        ROVINA_LATTICE_BUILD(2)
        ROVINA_LATTICE_BUILD(3)
        ROVINA_LATTICE_BUILD(4)
        ROVINA_LATTICE_BUILD(5)
        ROVINA_LATTICE_BUILD(6)
        ROVINA_LATTICE_BUILD(7)
        ROVINA_LATTICE_BUILD(8)
    }
#undef ROVINA_LATTICE_BUILD
    return (int)cudaErrorInvalidValue;
}
