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
// lays them out; ofc and ofl (R,) bool, already ORed over the shards.
// THE KERNEL RELIES ON ITS INPUT'S ORDER: each shard's row of a read
// holds distinct taxa in ascending order, then KASA_I32_MAX to its end
// (K3 post writes its lists so, as kasa_tpu's lax.sort does), so a taxon
// appears at most ip times in a read's pairs.  Nothing here checks it:
// the tests do.
// Output: ht_m, hk_m (R, wout) the merged lists (KASA_I32_MAX / 0 after
// the read's taxa) and packed (2R + 2 cap + 2,) int32, zeroed by the
// caller: [hc (R) | flags (R) | CSR (tax, ksum bits) x cap | total hits,
// flagged reads].
//
// Row arm (rows of ip x wout slots whose taxa fit a warp's share of
// shared memory, 4 bytes and 2 bits a slot): ONE launch.  A warp per read,
// G reads a block (G from the shared memory the rows take).  The rows
// are mostly padding (on the mesh's 8,192-read batch at ip = 2, 14 taxa
// of 320 slots a read): the warp works on the taxa alone.
//   load   the read's ip rows of taxa into shared memory, 32 slots a row
//          at a time, coalesced, the first 32 of eight rows in flight at
//          once, until a row's slots hold padding; the rows' taxa
//          counted by ballots;
//   pass A each taxon t of a row s, at j, finds its place in the merge
//          by a lower bound of t in every other shard's taxa (K3 post's
//          merge path over ip rows): P = j + the sum of the bounds.  The
//          copy of the lowest shard (no other shard below s holds t) is
//          the taxon's first; it sets bit P of the read's flag words
//          (distinct taxa take distinct places: a larger taxon counts the
//          smaller one's copies in its bounds);
//   scan   the warp's exclusive scan of the words' bit counts: the bits
//          below P give the taxon's rank among the read's distinct taxa,
//          the total is ntax; hc = min(ntax, wout), flags, and the
//          block's (hits, flagged reads) published at once for the
//          look-back;
//   pass B each first copy repeats its bounds, adds its taxon's ksums
//          (read from the lists in memory, all its copies' loads in
//          flight at once) in shard order (its own, then each higher
//          shard's copy: the floats are the parent's sort-then-sum bit
//          for bit) and writes the taxon and the sum at its rank when the
//          rank is below wout; the lanes fill the row past ntax.  The
//          rows need no offset: pass B runs while the block's successors
//          wait on its aggregate, before its own look-back;
//   look-back a decoupled look-back over the blocks (a block takes its
//          place from an atomic ticket, so every block it waits on is
//          running or done; the whole block reads blockDim status words
//          a step, a thread each, so that a block of the first wave walks
//          back over the wave in a few steps) gives the block's CSR
//          offset and flagged reads before it; the block publishes its
//          inclusive prefix, and the last block writes the tail;
//   CSR    the read's first hc pairs copied from its row at its offset,
//          those below cap.
// Long arm (rows too wide for the row arm): the pairs interleaved into a
// (R, ip x wout, 2) scratch, sorted within each read by radix.cuh's
// segmented passes (stable, four 8-bit digits of the taxon); then a
// block per read: a thread at the end of a run of equal taxa adds the
// run's ksums in shard order and writes the sum at the run's rank among
// the read's runs; a one-block scan of hc (the CSR offsets) and the
// tail; a block per read packs its first hc pairs below cap.
//
// Bound on the H100: bytes (the gathered lists in, the merged rows and
// the packed row out).
#include "radix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kRowWarps = 8;          // most reads a block of the row arm
constexpr int kMaxCopies = 8;         // shards whose ksums load at once

// a look-back status word: the state in bits 62-63 (0 not yet written,
// 1 the block's aggregate, 2 its inclusive prefix), flagged reads in bits
// 38-61, hits in bits 0-37 (summed as one integer: neither field carries)
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr int kHitBits = 38;
constexpr unsigned long long kHitMask = (1ull << kHitBits) - 1;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ int lower_bound_row(const int32_t* row, int n,
                                               int32_t t) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (row[mid] < t) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(kRowWarps * 32) merge_rows_kernel(
        const int32_t* __restrict__ hts, const float* __restrict__ hks,
        const uint8_t* __restrict__ ofc, const uint8_t* __restrict__ ofl,
        int ip, int R, int wout, long long cap,
        unsigned long long* __restrict__ status, int* __restrict__ ticket,
        int32_t* __restrict__ ht_m, float* __restrict__ hk_m,
        int32_t* __restrict__ packed) {
    extern __shared__ int32_t smem[];
    __shared__ int s_block, s_stop;
    __shared__ int s_hc[kRowWarps];
    __shared__ int s_flagged[kRowWarps];
    __shared__ unsigned long long s_part[kRowWarps];
    const int G = blockDim.x >> 5;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int n = ip * wout;
    if (threadIdx.x == 0) s_block = atomicAdd(ticket, 1);
    __syncthreads();
    const int b = s_block;
    const long long r = (long long)b * G + warp;
    const bool live = r < R;
    // the warp's taxa (int32, row s at s * wout), the merge's first-copy
    // flags as bits and their words' exclusive prefix (nw words each), and
    // the starts of the rows' taxa among the read's (ip + 1 ints)
    const int nw = (n + 31) >> 5;
    int32_t* tax = smem + (long long)warp * (n + 2 * nw + ip + 1);
    unsigned* bits = reinterpret_cast<unsigned*>(tax + n);
    int* wpre = reinterpret_cast<int*>(bits + nw);
    int* start = wpre + nw;
    const float* ksr = hks + r * wout;     // shard s: ksr[s * R * wout + j]
    const long long shard = (long long)R * wout;
    int ntax = 0, tot = 0;
    if (live) {
        // load: every row's first 32 slots, eight rows' loads in flight at
        // once; a row whose 32 slots all hold taxa then loads its next 32
        for (int s0 = 0; s0 < ip; s0 += 8) {
            int32_t t8[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                t8[u] = s0 + u < ip && lane < wout
                        ? hts[(s0 + u) * shard + r * wout + lane]
                        : KASA_I32_MAX;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int s = s0 + u;
                if (s >= ip) break;
                if (lane < wout) tax[s * wout + lane] = t8[u];
                int len = __popc(__ballot_sync(kFull, t8[u] != KASA_I32_MAX));
                // a row of 32 taxa or more: its next slots, four chunks of
                // 32 in flight at once
                for (int j0 = 32; len == j0 && j0 < wout; j0 += 128) {
                    int32_t t4[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int j = j0 + 32 * c + lane;
                        t4[c] = j < wout ? hts[s * shard + r * wout + j]
                                         : KASA_I32_MAX;
                    }
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int j = j0 + 32 * c + lane;
                        if (j < wout) tax[s * wout + j] = t4[c];
                        const int got = __popc(
                            __ballot_sync(kFull, t4[c] != KASA_I32_MAX));
                        if (len == j0 + 32 * c) len += got;
                    }
                }
                if (lane == 0) start[s] = len;
            }
        }
        __syncwarp();
        if (lane == 0) {
            int acc = 0;
            for (int s = 0; s < ip; ++s) {
                const int len = start[s];
                start[s] = acc;
                acc += len;
            }
            start[ip] = acc;
        }
        __syncwarp();
        // the read's taxa k = 0 .. tot - 1 run over the rows in order
        tot = start[ip];
        const int words = (tot + 31) >> 5;
        for (int k = lane; k < words; k += 32) bits[k] = 0;
        __syncwarp();
        // pass A: each taxon's first copy marks its slot in the merge
        for (int k = lane; k < tot; k += 32) {
            int s = 0;
            while (start[s + 1] <= k) ++s;
            const int j = k - start[s];
            const int32_t t = tax[s * wout + j];
            int P = j;
            bool first = true;
            for (int s2 = 0; s2 < ip; ++s2) {
                if (s2 == s) continue;
                const int32_t* row = tax + s2 * wout;
                const int len = start[s2 + 1] - start[s2];
                const int l = lower_bound_row(row, len, t);
                P += l;
                if (s2 < s && l < len && row[l] == t) first = false;
            }
            if (first) atomicOr(bits + (P >> 5), 1u << (P & 31));
        }
        __syncwarp();
        // the words' exclusive scan of their flags, a lane a chunk
        const int chunk = (words + 31) >> 5;
        const int a0 = min(lane * chunk, words), a1 = min(a0 + chunk, words);
        int sum = 0;
        for (int i = a0; i < a1; ++i) sum += __popc(bits[i]);
        int x = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
        }
        ntax = __shfl_sync(kFull, x, 31);
        int run = x - sum;
        for (int i = a0; i < a1; ++i) {
            wpre[i] = run;
            run += __popc(bits[i]);
        }
        if (lane == 0) {
            const bool list_of = ofl[r] || ntax > wout;
            const int32_t flags = (int32_t)(ofc[r] != 0)
                                  | ((int32_t)list_of << 1);
            packed[r] = min(ntax, wout);
            packed[R + r] = flags;
            s_hc[warp] = min(ntax, wout);
            s_flagged[warp] = flags != 0;
        }
    } else if (lane == 0) {
        s_hc[warp] = 0;
        s_flagged[warp] = 0;
    }
    __syncthreads();

    // the block's aggregate at once: its successors wait on it
    unsigned long long agg = 0;
    for (int w = 0; w < G; ++w)
        agg += ((unsigned long long)s_flagged[w] << kHitBits)
               + (unsigned long long)s_hc[w];
    if (threadIdx.x == 0)
        st_relaxed(status + b, (b == 0 ? kInclusive : kAggregate) | agg);

    // pass B: the sums at their ranks in the rows, before the look-back,
    // which only the CSR waits on
    const int hc = min(ntax, wout);
    int32_t* htr = ht_m + r * wout;
    float* hkr = hk_m + r * wout;
    if (live) {
        for (int k = lane; k < tot; k += 32) {
            int s = 0;
            while (start[s + 1] <= k) ++s;
            const int j = k - start[s];
            const int32_t t = tax[s * wout + j];
            int P = j;
            bool first = true;
            // the copies' places, then their ksums' loads all in flight
            // (up to kMaxCopies shards; more take them one by one)
            int at[kMaxCopies];
#pragma unroll
            for (int s2 = 0; s2 < kMaxCopies; ++s2) {
                at[s2] = -1;
                if (s2 >= ip) continue;
                if (s2 == s) {
                    at[s2] = j;
                    continue;
                }
                const int32_t* row = tax + s2 * wout;
                const int len = start[s2 + 1] - start[s2];
                const int l = lower_bound_row(row, len, t);
                P += l;
                if (l < len && row[l] == t) {
                    if (s2 < s) first = false;
                    at[s2] = l;
                }
            }
            for (int s2 = kMaxCopies; s2 < ip; ++s2) {
                if (s2 == s) continue;
                const int32_t* row = tax + s2 * wout;
                const int len = start[s2 + 1] - start[s2];
                const int l = lower_bound_row(row, len, t);
                P += l;
                if (s2 < s && l < len && row[l] == t) first = false;
            }
            if (!first) continue;
            float kv[kMaxCopies];
#pragma unroll
            for (int s2 = 0; s2 < kMaxCopies; ++s2)
                kv[s2] = at[s2] >= 0 ? ksr[s2 * shard + at[s2]] : 0.0f;
            float sum = 0.0f;
#pragma unroll
            for (int s2 = 0; s2 < kMaxCopies; ++s2)
                if (s2 >= s && at[s2] >= 0) sum += kv[s2];
            for (int s2 = max(s, kMaxCopies); s2 < ip; ++s2) {
                if (s2 == s) {
                    sum += ksr[s * shard + j];
                    continue;
                }
                const int32_t* row = tax + s2 * wout;
                const int len = start[s2 + 1] - start[s2];
                const int l = lower_bound_row(row, len, t);
                if (l < len && row[l] == t) sum += ksr[s2 * shard + l];
            }
            const int q = wpre[P >> 5]
                          + __popc(bits[P >> 5] & ((1u << (P & 31)) - 1u));
            if (q < wout) {
                htr[q] = t;
                hkr[q] = sum;
            }
        }
        for (int i = hc + lane; i < wout; i += 32) {
            htr[i] = KASA_I32_MAX;
            hkr[i] = 0.0f;
        }
    }
    __syncthreads();

    // the block's CSR offset: a decoupled look-back over the blocks, the
    // whole block reading blockDim.x status words a step
    unsigned long long excl = 0;
    const int nt = blockDim.x;
    for (long long top = (long long)b - 1; top >= 0; top -= nt) {
        const long long p = top - threadIdx.x;
        unsigned long long w = kInclusive;   // before block 0: zero
        if (p >= 0) {
            do {
                w = ld_relaxed(status + p);
            } while ((w >> 62) == 0);
        }
        if (threadIdx.x == 0) s_stop = nt;
        __syncthreads();
        if ((w >> 62) == 2) atomicMin(&s_stop, (int)threadIdx.x);
        __syncthreads();
        const int stop = s_stop;
        unsigned long long v = (int)threadIdx.x <= stop ? (w & kValueMask)
                                                        : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        if (lane == 0) s_part[warp] = v;
        __syncthreads();
        for (int w2 = 0; w2 < G; ++w2) excl += s_part[w2];
        __syncthreads();
        if (stop < nt) break;
    }
    if (threadIdx.x == 0) {
        if (b > 0) st_relaxed(status + b, kInclusive | (excl + agg));
        if ((long long)(b + 1) * G >= R) {
            const unsigned long long all = excl + agg;
            int32_t* tail = packed + 2 * (long long)R + 2 * cap;
            tail[0] = (int32_t)(all & kHitMask);
            tail[1] = (int32_t)(all >> kHitBits);
        }
    }
    if (!live) return;

    // the CSR: the read's first hc pairs, copied from its row at its offset
    long long off = (long long)(excl & kHitMask);
    for (int w = 0; w < warp; ++w) off += s_hc[w];
    int2* csr = reinterpret_cast<int2*>(packed + 2 * (long long)R);
    for (int i = lane; i < hc && off + i < cap; i += 32)
        csr[off + i] = make_int2(htr[i], __float_as_int(hkr[i]));
}

// ---------------------------------------------------------------------------
// long arm

// the sorted row: (taxon, ksum bits) pairs in global memory
struct GlobalRow {
    const int32_t* row;
    __device__ int32_t key(int i) const { return row[2 * i]; }
    __device__ float val(int i) const {
        return __int_as_float(row[2 * i + 1]);
    }
};

// Merges one sorted row of n pairs into ht_m / hk_m row r and writes
// hc[r] and flags[r] into packed.  Every thread of the block calls it.
__device__ void merge_row(const GlobalRow& row, int n, long long r, int R,
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

// warps: the row arm's reads a block (1..8; its shared memory is warps *
// 4 * (n + 2 ceil(n / 32) + ip + 1) bytes, n = ip * wout), and status
// holds one int ticket, then,
// 8-byte aligned, one 64-bit word per block, all zeroed by the caller),
// or 0 for the long arm, which needs scr_a and scr_b of R * ip * wout * 2
// int32 each and cum of R int32
extern "C" int kasa_mesh_merge(const void* hts, const void* hks,
                               const void* ofc, const void* ofl, int ip,
                               int R, int wout, int warps, long long cap,
                               void* scr_a, void* scr_b, void* cum,
                               void* status, void* ht_m, void* hk_m,
                               void* packed, void* stream) {
    if (ip < 1 || wout < 1 || warps < 0 || warps > kRowWarps
            || R >= (1 << 24))
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int n = ip * wout;
    if (warps > 0) {
        // a warp's taxa, flag words, their prefix and row starts
        const size_t smem =
            (size_t)warps * (n + 2 * ((n + 31) >> 5) + ip + 1) * 4;
        // the attribute of the widest row so far on each card, kept (a
        // host query each call costs as much as the kernel); per device,
        // as the attribute is, and not thread-safe: one host thread
        // launches on a card at a time
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return (int)err;
        if (dev < 0 || dev >= kMaxDevices)
            return (int)cudaErrorInvalidDevice;
        static size_t set_smem[kMaxDevices];
        if (smem > set_smem[dev]) {
            err = cudaFuncSetAttribute(
                merge_rows_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (err != cudaSuccess) return (int)err;
            set_smem[dev] = smem;
        }
        const int blocks = (R + warps - 1) / warps;
        merge_rows_kernel<<<blocks, warps * 32, smem, st>>>(
            (const int32_t*)hts, (const float*)hks, (const uint8_t*)ofc,
            (const uint8_t*)ofl, ip, R, wout, cap,
            (unsigned long long*)((char*)status + 8), (int*)status,
            (int32_t*)ht_m, (float*)hk_m, (int32_t*)packed);
        return (int)cudaGetLastError();
    }
    interleave_kernel<<<R, kThreads, 0, st>>>(
        (const int32_t*)hts, (const float*)hks, ip, R, wout,
        (int32_t*)scr_b);
    // pass 0 reads scr_b and writes scr_a; scr_b is free again when pass
    // 1 writes it
    const int cols[4] = {0, 0, 0, 0}, shifts[4] = {0, 8, 16, 24};
    const int32_t* srt = seg_radix_sort<2>(
        (const int32_t*)scr_b, (int32_t*)scr_a, (int32_t*)scr_b, R, n, cols,
        shifts, 4, st);
    merge_long_kernel<<<R, kThreads, 0, st>>>(
        srt, (const uint8_t*)ofc, (const uint8_t*)ofl, ip, R, wout,
        (int32_t*)ht_m, (float*)hk_m, (int32_t*)packed);
    scan_kernel<<<1, kScanThreads, 0, st>>>(R, cap, (int32_t*)cum,
                                            (int32_t*)packed);
    pack_kernel<<<R, 128, 0, st>>>((const int32_t*)ht_m,
                                   (const float*)hk_m, (const int32_t*)cum,
                                   R, wout, cap, (int32_t*)packed);
    return (int)cudaGetLastError();
}
