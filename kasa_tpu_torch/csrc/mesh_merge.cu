// K14 mesh_merge: the per-read merge of the index shards' hit lists and
// the CSR pack of one dp block of the turbo mesh.
//
// Replaces kasa_tpu/parallel/turbo_mesh.py:230-275 (the step's merge
// after the all_gather over "ip": the key sort of each read's ip x WOUT
// (taxon, ksum) pairs, the segment sums by cumsum differences, the
// first WOUT taxa in key order, ofl |= ntax > WOUT, hc = min(ntax,
// WOUT), and the CSR pack of turbo.fused_turbo_acc's layout with the
// mesh's [total, nflagged] tail).
//
// Input: hts (ip, R, wout) int32 taxon rows (KASA_I32_MAX in an empty
// slot) and hks (ip, R, wout) float32 ksums, as the gather over "ip"
// lays them out (each shard's list holds distinct taxa, so a taxon
// appears at most ip times in a read's pairs); ofc and ofl (R,) bool,
// already ORed over the shards.
// Output: ht_m, hk_m (R, wout) the merged lists (KASA_I32_MAX / 0 after
// the read's taxa) and packed (2R + 2 cap + 2,) int32, zeroed by the
// caller: [hc (R) | flags (R) | CSR (tax, ksum bits) x cap | total hits,
// flagged reads].
//
// Launches, on one stream:
//   merge: one block per read.  Short arm (ip x wout <= 4096 pairs):
//          the read's pairs as 64-bit keys (taxon << 32 | position) in
//          shared memory, a bitonic sort, so equal taxa stay in shard
//          order.  Long arm: the pairs interleaved into a (R, ip x wout,
//          2) scratch, sorted within each read by radix.cuh's segmented
//          passes (stable, four 8-bit digits of the taxon).  Then, tile
//          by tile, a thread at the end of a run of equal taxa adds the
//          run's ksums in shard order (kasa_tpu subtracts cumsums, so
//          the floats agree within the contract, not bit for bit) and
//          writes the sum at the run's rank among the read's runs when
//          that rank is below wout; the run count is ntax;
//   scan:  one block; the exclusive scan of hc (the CSR offsets) and the
//          tail;
//   pack:  one block per read writes its first hc pairs at its offset,
//          those below cap.
//
// Bound on the H100: bytes (the gathered lists in, the packed row out);
// the single-block scan is latency, R = 8,192 values.
#include "radix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

// the short arm's sorted row: 64-bit keys in shared memory, the ksum
// read back from the gathered lists by the key's position
struct SharedRow {
    const unsigned long long* keys;
    const float* hks;
    long long r;
    int R, wout;
    __device__ int32_t key(int i) const { return (int32_t)(keys[i] >> 32); }
    __device__ float val(int i) const {
        const unsigned pos = (unsigned)(keys[i] & 0xffffffffu);
        const long long s = pos / wout, j = pos % wout;
        return hks[(s * R + r) * wout + j];
    }
};

// the long arm's sorted row: (taxon, ksum bits) pairs in global memory
struct GlobalRow {
    const int32_t* row;
    __device__ int32_t key(int i) const { return row[2 * i]; }
    __device__ float val(int i) const {
        return __int_as_float(row[2 * i + 1]);
    }
};

// Merges one sorted row of n pairs into ht_m / hk_m row r and writes
// hc[r] and flags[r] into packed.  Every thread of the block calls it.
template <class Row>
__device__ void merge_row(const Row& row, int n, long long r, int R,
                          int wout, const uint8_t* ofc, const uint8_t* ofl,
                          int32_t* ht_m, float* hk_m, int32_t* packed,
                          int* warp_sums) {
    const int tid = threadIdx.x;
    int32_t* htr = ht_m + r * wout;
    float* hkr = hk_m + r * wout;
    for (int i = tid; i < wout; i += kThreads) {
        htr[i] = KASA_I32_MAX;
        hkr[i] = 0.0f;
    }
    __syncthreads();
    int base = 0;
    for (int t0 = 0; t0 < n; t0 += kThreads) {
        const int i = t0 + tid;
        bool end = false;
        int32_t key = KASA_I32_MAX;
        if (i < n) {
            key = row.key(i);
            const int32_t nxt = i + 1 < n ? row.key(i + 1) : KASA_I32_MAX;
            end = key != nxt && key != KASA_I32_MAX;
        }
        int tot;
        const int rank = base + block_rank<kWarps>(end, warp_sums, &tot);
        if (end && rank < wout) {
            int j0 = i;
            while (j0 > 0 && row.key(j0 - 1) == key) --j0;
            float sum = 0.0f;
            for (int j = j0; j <= i; ++j) sum += row.val(j);
            htr[rank] = key;
            hkr[rank] = sum;
        }
        base += tot;
    }
    if (tid == 0) {
        const int hc = min(base, wout);
        const bool list_of = ofl[r] || base > wout;
        packed[r] = hc;
        packed[R + r] = (int32_t)(ofc[r] != 0) | ((int32_t)list_of << 1);
    }
}

__global__ void __launch_bounds__(kThreads) merge_short_kernel(
        const int32_t* __restrict__ hts, const float* __restrict__ hks,
        const uint8_t* __restrict__ ofc, const uint8_t* __restrict__ ofl,
        int ip, int R, int wout, int P, int32_t* __restrict__ ht_m,
        float* __restrict__ hk_m, int32_t* __restrict__ packed) {
    extern __shared__ unsigned long long keys[];
    __shared__ int warp_sums[kWarps];
    const long long r = blockIdx.x;
    const int n = ip * wout;
    for (int i = threadIdx.x; i < P; i += kThreads) {
        unsigned long long k = (unsigned long long)(unsigned)KASA_I32_MAX;
        if (i < n) {
            const long long s = i / wout, j = i % wout;
            k = (unsigned long long)(unsigned)hts[(s * R + r) * wout + j];
        }
        keys[i] = (k << 32) | (unsigned)i;
    }
    __syncthreads();
    block_bitonic_sort<unsigned long long, kThreads>(keys, P);
    merge_row(SharedRow{keys, hks, r, R, wout}, n, r, R, wout, ofc, ofl,
              ht_m, hk_m, packed, warp_sums);
}

// the long arm's input: read r's pairs in shard order as (taxon, ksum
// bits) rows
__global__ void __launch_bounds__(kThreads) interleave_kernel(
        const int32_t* __restrict__ hts, const float* __restrict__ hks,
        int ip, int R, int wout, int32_t* __restrict__ rows) {
    const long long r = blockIdx.x;
    const int n = ip * wout;
    for (int i = threadIdx.x; i < n; i += kThreads) {
        const long long s = i / wout, j = i % wout;
        const long long src = (s * R + r) * wout + j;
        rows[(r * n + i) * 2] = hts[src];
        rows[(r * n + i) * 2 + 1] = __float_as_int(hks[src]);
    }
}

__global__ void __launch_bounds__(kThreads) merge_long_kernel(
        const int32_t* __restrict__ srt, const uint8_t* __restrict__ ofc,
        const uint8_t* __restrict__ ofl, int ip, int R, int wout,
        int32_t* __restrict__ ht_m, float* __restrict__ hk_m,
        int32_t* __restrict__ packed) {
    __shared__ int warp_sums[kWarps];
    const long long r = blockIdx.x;
    const int n = ip * wout;
    merge_row(GlobalRow{srt + r * n * 2}, n, r, R, wout, ofc, ofl, ht_m,
              hk_m, packed, warp_sums);
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(
        int R, long long cap, int32_t* __restrict__ cum,
        int32_t* __restrict__ packed) {
    __shared__ long long buf[kScanThreads];
    const int tid = threadIdx.x;
    const int chunk = (R + kScanThreads - 1) / kScanThreads;
    const int r0 = min(tid * chunk, R), r1 = min(r0 + chunk, R);
    long long hits = 0, flagged = 0;
    for (int r = r0; r < r1; ++r) {
        hits += packed[r];
        flagged += packed[R + r] != 0;
    }
    long long total, nflag;
    long long run = block_exclusive_scan<kScanThreads>(hits, buf, &total);
    block_exclusive_scan<kScanThreads>(flagged, buf, &nflag);
    for (int r = r0; r < r1; ++r) {
        cum[r] = (int32_t)run;
        run += packed[r];
    }
    if (tid == 0) {
        int32_t* tail = packed + 2 * (long long)R + 2 * cap;
        tail[0] = (int32_t)total;
        tail[1] = (int32_t)nflag;
    }
}

__global__ void __launch_bounds__(128) pack_kernel(
        const int32_t* __restrict__ ht_m, const float* __restrict__ hk_m,
        const int32_t* __restrict__ cum, int R, int wout, long long cap,
        int32_t* __restrict__ packed) {
    const long long r = blockIdx.x;
    const int hc = packed[r];
    int32_t* csr = packed + 2 * (long long)R;
    for (int i = threadIdx.x; i < hc; i += blockDim.x) {
        const long long dest = (long long)cum[r] + i;
        if (dest >= cap) break;
        csr[2 * dest] = ht_m[r * wout + i];
        csr[2 * dest + 1] = __float_as_int(hk_m[r * wout + i]);
    }
}

}  // namespace

// P: the short arm's sort width (a power of two >= ip * wout, at most
// 4096), or 0 for the long arm, which needs scr_a and scr_b of
// R * ip * wout * 2 int32 each
extern "C" int kasa_mesh_merge(const void* hts, const void* hks,
                               const void* ofc, const void* ofl, int ip,
                               int R, int wout, int P, long long cap,
                               void* scr_a, void* scr_b, void* cum,
                               void* ht_m, void* hk_m, void* packed,
                               void* stream) {
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (P > 0) {
        merge_short_kernel<<<R, kThreads, P * sizeof(unsigned long long),
                             st>>>(
            (const int32_t*)hts, (const float*)hks, (const uint8_t*)ofc,
            (const uint8_t*)ofl, ip, R, wout, P, (int32_t*)ht_m,
            (float*)hk_m, (int32_t*)packed);
    } else {
        const int n = ip * wout;
        interleave_kernel<<<R, kThreads, 0, st>>>(
            (const int32_t*)hts, (const float*)hks, ip, R, wout,
            (int32_t*)scr_b);
        // pass 0 reads scr_b and writes scr_a; scr_b is free again when
        // pass 1 writes it
        const int cols[4] = {0, 0, 0, 0}, shifts[4] = {0, 8, 16, 24};
        const int32_t* srt = seg_radix_sort<2>(
            (const int32_t*)scr_b, (int32_t*)scr_a, (int32_t*)scr_b, R, n,
            cols, shifts, 4, st);
        merge_long_kernel<<<R, kThreads, 0, st>>>(
            srt, (const uint8_t*)ofc, (const uint8_t*)ofl, ip, R, wout,
            (int32_t*)ht_m, (float*)hk_m, (int32_t*)packed);
    }
    scan_kernel<<<1, kScanThreads, 0, st>>>(R, cap, (int32_t*)cum,
                                            (int32_t*)packed);
    pack_kernel<<<R, 128, 0, st>>>((const int32_t*)ht_m,
                                   (const float*)hk_m, (const int32_t*)cum,
                                   R, wout, cap, (int32_t*)packed);
    return (int)cudaGetLastError();
}
