// K4 turbo_multi: the batch's global multi-taxa worklist.
//
// Replaces, from kasa_tpu/match/turbo.py:518 _turbo_core, the global
// half of "wsort1" (686-715: read bases, worklist addressing, grp2 ->
// hot-set id or d_tax4 header -> exact T), "wsort2" (740-775: the
// stable sort of the cold slots by T, the expansion-budget check and
// oflow_counts) and the dense branch of "bands" (776-869: the CSR
// expansion of the d_tax4 taxa rows folded into counts and per-read
// scores, and the hot-set credits).
//
// Four kernels on one stream:
//   scan:   one block; exclusive scan of the per-read multi counts
//           (read bases) and their total;
//   slots:  one block per read; worklist position base+i < B takes the
//           read's i-th payload, looks up grp2 and the exact T, and
//           counts cold slots per T in a histogram (one atomic per
//           distinct T of a warp's slots); the block also sums the read's
//           expansion rows and keeps its largest cold T and how many of
//           its cold slots have it;
//   cut:    one block; the budget cut without a global sort.  kasa_tpu
//           sorts the cold slots stably by T over a read-major
//           worklist and admits them while the running row count fits
//           EB.  The admitted set is a prefix: every T below some T*,
//           then the first c slots of T* in read order.  A block-wide
//           scan of the histogram's rows gives T* and c (each thread
//           walks its own bins from its exclusive prefix); a read's T*
//           slots follow from its largest T (none below it, all of them
//           at it), except for a read with a slot above T*, whose T*
//           slots a warp counts in its worklist; a scan over the reads
//           of their T* slot counts gives each read's rank, and a read
//           is flagged when a T* slot ranks >= c or it has a slot above
//           T* (with the worklist overflow and the > CW runs flags, as
//           in kasa_tpu);
//   expand: one block per read.  An unflagged read's slots first meet
//           in a hash table in shared memory keyed by (group, level),
//           which counts each distinct one's slots n; then each distinct
//           cold group adds n/T to the counts (numK, S) once per taxon
//           of the group, by a device atomic, and n w(k)/T to the read's
//           score row, which sits in shared memory (S floats) and is
//           written whole once, zeros included; a distinct hot set adds
//           n w(k)/T to the read's (R, H) credit row (in shared memory,
//           written whole) and n/T to the (numK, H) credits, which the
//           two hot-mask products fold (in the Python wrapper).  A
//           flagged read writes zero rows.  kasa_tpu's (R, numK, S)
//           accumulator (402 MB at R = 8192, S = 2048) is never built.
//           With a file_of_read map (identify_multiple, fused_turbo_files
//           at turbo.py:826-833 and 853-861) the count cell is (file *
//           numK + k) * S + tax of an (F, numK, S) matrix and the hot
//           credit row is file * numK + k of an (F * numK, H) matrix.
//           Counts-only arm (the sparse regime: S > SPARSE_FOLD_S and
//           no hot tier, the cflat of turbo.py:871-880 with its file
//           offset fk_e): dm, a3w and a3c are null, cold groups add only
//           to the counts and K6 (sparse_fold.cu) builds the per-read
//           lists, so no (R, S) buffer exists (328 MB at R = 8192, S =
//           10,002).  With no score row to keep, this arm takes a warp
//           per worklist slot over the whole worklist, each adding 1/T
//           per taxon: on the H100 a read's block with its hash table
//           took 0.1499 ms against 0.0969 on the sparse batch of
//           chip_smoke.py --stages, whose reads hold few repeated groups.
//
// Bound on the H100: bytes in the function's inputs and outputs (the
// score rows written once, R * S * 4 bytes), but the work is gathers and
// adds.  The score rows take no device atomic and need no zero fill, and
// a read adds to a count cell once per distinct group, n/T, where
// kasa_tpu's expansion adds 1/T once per admitted slot: kasa_tpu sums
// each read's (numK, S) counts first and then over the reads, and so
// does this.  The plain version adds 1/T per slot and taxon in sequence
// (index_add_); on a long-read batch a common cell takes ~10^5 such adds
// and the float32 orders differ by more than the contract's rtol (the
// checks on that batch hold the counts to a float64 sum).  A read's hash
// table holds the next power of two at or above twice its slots in the
// worklist (at least 32), up to kHash entries for reads of up to 4,096
// slots and kHashLong above; a slot that finds no place in kProbes probes
// expands alone (n = 1) from its thread.
//
// Split entry points (the mesh, parallel/turbo_mesh.py): kasa_turbo_multi
// queues all four; kasa_turbo_multi_cut queues scan, slots and cut, and
// kasa_turbo_multi_expand the expansion alone, after the caller has ORed
// the cut's flags over the index shards (kasa_tpu's flag_reduce,
// turbo.py:768-769).  The split expansion also recounts the expansion
// rows used (diag[1]) under those flags, one atomic per unflagged read;
// the cut's count is the shard's own.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kSlotThreads = 128;
constexpr int kExpandThreads = 256;
constexpr int kExpandWarps = kExpandThreads / 32;
constexpr int kHash = 1024;
constexpr int kHashLong = 4096;
constexpr int kProbes = 32;
constexpr unsigned long long kEmpty = ~0ull;
// the score row and the hot-credit row sit in shared memory up to these
// widths (the dense regime has S <= SPARSE_FOLD_S = 4,096), in the
// device buffers (zeroed first, device atomics) above
constexpr int kRowMax = 8192;
constexpr int kHotMax = 2048;


struct MultiParams {
    int R, SW, n, num_k, S, H, DR, B, cw, hist_n;
    long long EB;
};

__global__ void multi_scan_kernel(const int32_t* __restrict__ mcnt, int R,
                                  int32_t* __restrict__ read_base,
                                  int32_t* __restrict__ diag) {
    __shared__ long long buf[kScanThreads];
    const int tid = threadIdx.x;
    const int chunk = (R + kScanThreads - 1) / kScanThreads;
    const int r0 = min(tid * chunk, R), r1 = min(r0 + chunk, R);
    long long local = 0;
    for (int r = r0; r < r1; ++r) local += mcnt[r];
    long long total;
    long long run = block_exclusive_scan<kScanThreads>(local, buf, &total);
    for (int r = r0; r < r1; ++r) {
        read_base[r] = (int32_t)run;
        run += mcnt[r];
    }
    if (tid == 0) diag[0] = (int32_t)total;
}

__global__ void __launch_bounds__(kSlotThreads) multi_slots_kernel(
        const int32_t* __restrict__ cp, const int32_t* __restrict__ mcnt,
        const int32_t* __restrict__ read_base,
        const int32_t* __restrict__ grp2, const int4* __restrict__ d_tax4,
        const int32_t* __restrict__ t_hot, MultiParams p,
        int32_t* __restrict__ wl_row0, int32_t* __restrict__ wl_T,
        int32_t* __restrict__ wl_ridki, int32_t* __restrict__ hist,
        int32_t* __restrict__ r_rows, int32_t* __restrict__ r_tmax,
        int32_t* __restrict__ r_nmax) {
    __shared__ int s_rows, s_tmax, s_nmax;
    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const int cnt = mcnt[r];
    const int base = read_base[r];
    const long long gmax = (long long)p.num_k * p.n - 1;
    if (tid == 0) {
        s_rows = 0;
        s_tmax = 0;
        s_nmax = 0;
    }
    __syncthreads();
    int rows = 0, tmax = 0, nmax = 0;
    // whole warps iterate, so a warp's histogram adds combine
    for (int i0 = 0; i0 < cnt; i0 += kSlotThreads) {
        const int i = i0 + tid;
        const long long j = (long long)base + i;
        const bool act = i < cnt && j < p.B;
        unsigned bin = ~0u;
        if (act) {
            const int32_t mp = cp[(long long)r * p.SW + i];
            const int ki = mp & 7;
            const long long psel = mp >> 3;
            const int32_t row0 = grp2[min((long long)ki * p.n + psel, gmax)];
            int32_t T = 0;
            if (row0 > 0) {
                T = d_tax4[row0].x;      // the group's header row [T, ...]
                bin = (unsigned)min(T, p.hist_n - 1);
                rows += (T + 3) >> 2;
                if (T > tmax) {
                    tmax = T;
                    nmax = 0;
                }
                nmax += T == tmax;
            } else if (row0 < 0) {
                T = t_hot[-row0 - 1];
            }
            wl_row0[j] = row0;
            wl_T[j] = T;
            wl_ridki[j] = r * 8 + ki;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin != ~0u && lane == (unsigned)(__ffs(peers) - 1))
            atomicAdd(&hist[bin], __popc(peers));
    }
    atomicAdd(&s_rows, rows);
    atomicMax(&s_tmax, tmax);
    __syncthreads();
    if (tmax == s_tmax && nmax > 0) atomicAdd(&s_nmax, nmax);
    __syncthreads();
    if (tid == 0) {
        r_rows[r] = s_rows;
        r_tmax[r] = s_tmax;
        r_nmax[r] = s_nmax;
    }
}

__global__ void multi_cut_kernel(const int32_t* __restrict__ mcnt,
                                 const int32_t* __restrict__ runs,
                                 const int32_t* __restrict__ read_base,
                                 const int32_t* __restrict__ wl_row0,
                                 const int32_t* __restrict__ wl_T,
                                 const int32_t* __restrict__ hist,
                                 const int32_t* __restrict__ r_rows,
                                 const int32_t* __restrict__ r_tmax,
                                 const int32_t* __restrict__ r_nmax,
                                 MultiParams p,
                                 int32_t* __restrict__ r_star,
                                 uint8_t* __restrict__ ofc,
                                 int32_t* __restrict__ diag) {
    __shared__ long long buf[kScanThreads];
    __shared__ int s_tstar;
    __shared__ long long s_c;
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const int warp = tid >> 5;
    if (tid == 0) {
        s_tstar = KASA_I32_MAX;
        s_c = 0;
    }
    // T*: the first T whose cold slots do not all fit the budget, from
    // each thread's bins and the rows of every bin before them
    const int hchunk = (p.hist_n + kScanThreads - 1) / kScanThreads;
    const int h0 = min(tid * hchunk, p.hist_n);
    const int h1 = min(h0 + hchunk, p.hist_n);
    long long mine = 0;
    for (int T = h0; T < h1; ++T) mine += (long long)hist[T] * ((T + 3) >> 2);
    long long all;
    long long below = block_exclusive_scan<kScanThreads>(mine, buf, &all);
    int tstar = KASA_I32_MAX;
    long long c = 0;
    for (int T = h0; T < h1; ++T) {
        const long long cnt = hist[T];
        const long long rp = (T + 3) >> 2;
        if (cnt > 0 && below + cnt * rp > p.EB) {
            tstar = T;
            c = (p.EB - below) / rp;
            break;
        }
        below += cnt * rp;
    }
    if (tstar != KASA_I32_MAX) atomicMin(&s_tstar, tstar);
    __syncthreads();
    if (tstar != KASA_I32_MAX && tstar == s_tstar) s_c = c;
    __syncthreads();
    tstar = s_tstar;
    c = s_c;
    const bool batch_of = (long long)diag[0] > p.B;

    // each read's slots at T*: none below its largest T, all of them at
    // it; a warp counts them in the worklist of a read with a slot above
    for (int r = tid; r < p.R; r += kScanThreads)
        r_star[r] = r_tmax[r] == tstar ? r_nmax[r] : 0;
    __syncthreads();
    if (tstar != KASA_I32_MAX) {
        for (int r = warp; r < p.R; r += kScanThreads / 32) {
            if (r_tmax[r] <= tstar) continue;
            const long long b0 = read_base[r];
            const long long b1 = min(b0 + mcnt[r], (long long)p.B);
            int n = 0;
            for (long long j = b0 + lane; j < b1; j += 32)
                n += wl_row0[j] > 0 && wl_T[j] == tstar;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                n += __shfl_xor_sync(0xffffffffu, n, o);
            if (lane == 0) r_star[r] = n;
        }
    }
    __syncthreads();

    const int chunk = (p.R + kScanThreads - 1) / kScanThreads;
    const int r0 = min(tid * chunk, p.R), r1 = min(r0 + chunk, p.R);
    long long local = 0;
    for (int r = r0; r < r1; ++r) local += r_star[r];
    long long total;
    long long rank = block_exclusive_scan<kScanThreads>(local, buf, &total);
    long long used = 0;
    for (int r = r0; r < r1; ++r) {
        const int n_star = r_star[r];
        const bool dropped = r_tmax[r] > tstar
                             || (n_star > 0 && rank + n_star > c);
        rank += n_star;
        const bool flag = dropped || (batch_of && mcnt[r] > 0)
                          || runs[r] > p.cw;
        ofc[r] = flag;
        if (!flag) used += r_rows[r];
    }
    long long used_total;
    block_exclusive_scan<kScanThreads>(used, buf, &used_total);
    if (tid == 0) diag[1] = (int32_t)used_total;
}

__device__ __forceinline__ unsigned hash_slot(unsigned long long key,
                                              int mask) {
    return (unsigned)((key * 0x9E3779B97F4A7C15ull) >> 40) & (unsigned)mask;
}

// one distinct (group, level) of a read, n slots of it: its taxa (or its
// hot set) added by the `width` threads of the caller, `t0` this
// thread's place among them
__device__ __forceinline__ void expand_group(
        int32_t row0, int ki, int n, int t0, int width, long long fk,
        const int32_t* __restrict__ d_tax4,
        const int32_t* __restrict__ t_hot, const float* __restrict__ weights,
        const MultiParams& p, float* __restrict__ acc_ca, float* row,
        float* hot, float* __restrict__ a3c) {
    const float nf = (float)n;
    if (row0 > 0) {
        const int T = d_tax4[(long long)row0 * 4];
        const float inv = 1.0f / (float)T;
        const float cv = nf * inv;
        const float wv = nf * (weights[ki] * inv);
        const int lanes = ((T + 3) >> 2) * 4;
        for (int t = t0; t < lanes; t += width) {
            const long long rw = min((long long)row0 + 1 + (t >> 2),
                                     (long long)p.DR - 1);
            const int32_t tax = d_tax4[rw * 4 + (t & 3)];
            if (tax >= 0) {
                atomicAdd(&acc_ca[fk * p.S + tax], cv);
                if (row) atomicAdd(&row[tax], wv);
            }
        }
    } else if (t0 == 0 && hot) {
        const int hid = -row0 - 1;
        const float inv = 1.0f / (float)max(t_hot[hid], 1);
        atomicAdd(&hot[hid], nf * (weights[ki] * inv));
        atomicAdd(&a3c[fk * p.H + hid], nf * inv);
    }
}

__global__ void __launch_bounds__(kExpandThreads) multi_expand_kernel(
        const int32_t* __restrict__ mcnt,
        const int32_t* __restrict__ read_base,
        const int32_t* __restrict__ wl_row0,
        const int32_t* __restrict__ wl_ridki,
        const int32_t* __restrict__ r_rows,
        const uint8_t* __restrict__ ofc,
        const int32_t* __restrict__ d_tax4,
        const int32_t* __restrict__ t_hot,
        const float* __restrict__ weights, int32_t* __restrict__ diag,
        const int32_t* __restrict__ file_of_read, MultiParams p,
        int count_used, int hcap, float* __restrict__ acc_ca,
        float* __restrict__ dm, float* __restrict__ a3w,
        float* __restrict__ a3c) {
    extern __shared__ __align__(16) unsigned char xsmem[];
    unsigned long long* keys = reinterpret_cast<unsigned long long*>(xsmem);
    int* hcnt = reinterpret_cast<int*>(keys + hcap);
    int* list = hcnt + hcap;
    const bool srow = dm != nullptr && p.S <= kRowMax;
    const bool shot = a3w != nullptr && p.H <= kHotMax;
    float* s_row = reinterpret_cast<float*>(list + hcap);
    float* s_hot = s_row + (srow ? p.S : 0);
    __shared__ int s_nent;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long r = blockIdx.x;
    float* row = srow ? s_row : (dm ? dm + r * p.S : nullptr);
    float* hot = shot ? s_hot : (a3w ? a3w + r * p.H : nullptr);
    if (srow)
        for (int i = tid; i < p.S; i += kExpandThreads) s_row[i] = 0.0f;
    if (shot)
        for (int i = tid; i < p.H; i += kExpandThreads) s_hot[i] = 0.0f;
    const bool flagged = ofc[r] != 0;
    const long long b0 = read_base[r];
    const long long b1 = min(b0 + mcnt[r], (long long)p.B);
    // the read's table: only its own entries are cleared
    int hc = 32;
    while (hc < 2 * (b1 - b0) && hc < hcap) hc <<= 1;
    if (!flagged) {
        for (int i = tid; i < hc; i += kExpandThreads) {
            keys[i] = kEmpty;
            hcnt[i] = 0;
        }
        if (tid == 0) {
            s_nent = 0;
            if (count_used) atomicAdd(&diag[1], r_rows[r]);
        }
    }
    __syncthreads();
    if (!flagged) {
        const long long fk = file_of_read ? (long long)file_of_read[r]
                                            * p.num_k : 0;
        // the read's slots by (group, level); a slot that finds no place
        // expands alone
        const int mask = hc - 1;
        for (long long j = b0 + tid; j < b1; j += kExpandThreads) {
            const int32_t row0 = wl_row0[j];
            if (row0 == 0) continue;
            const int ki = wl_ridki[j] & 7;
            const unsigned long long key =
                ((unsigned long long)(uint32_t)row0 << 3) | (unsigned)ki;
            unsigned h = hash_slot(key, mask);
            bool done = false;
            for (int probe = 0; probe < kProbes; ++probe) {
                const unsigned long long old = atomicCAS(&keys[h], kEmpty,
                                                         key);
                if (old == kEmpty || old == key) {
                    atomicAdd(&hcnt[h], 1);
                    // the thread that placed a key lists its entry
                    if (old == kEmpty) list[atomicAdd(&s_nent, 1)] = h;
                    done = true;
                    break;
                }
                h = (h + 1) & (unsigned)mask;
            }
            if (!done)
                expand_group(row0, ki, 1, 0, 1, fk + ki, d_tax4, t_hot,
                             weights, p, acc_ca, row, hot, a3c);
        }
        __syncthreads();
        const int nent = s_nent;
        // a warp per distinct entry, its lanes over the group's taxa
        for (int e = warp; e < nent; e += kExpandWarps) {
            const int i = list[e];
            const unsigned long long key = keys[i];
            const int ki = (int)(key & 7u);
            expand_group((int32_t)(uint32_t)(key >> 3), ki, hcnt[i], lane,
                         32, fk + ki, d_tax4, t_hot, weights, p, acc_ca,
                         row, hot, a3c);
        }
    }
    __syncthreads();
    if (srow)
        for (int i = tid; i < p.S; i += kExpandThreads)
            dm[r * p.S + i] = s_row[i];
    if (shot)
        for (int i = tid; i < p.H; i += kExpandThreads)
            a3w[r * p.H + i] = s_hot[i];
}

// the counts-only arm's expansion: a warp per worklist slot of an
// unflagged read, its lanes over the cold group's taxa, 1/T to each
// count; the read's first slot adds its rows to diag[1] (count_used)
__global__ void __launch_bounds__(kExpandThreads) multi_count_kernel(
        const int32_t* __restrict__ read_base,
        const int32_t* __restrict__ wl_row0,
        const int32_t* __restrict__ wl_ridki,
        const int32_t* __restrict__ r_rows,
        const uint8_t* __restrict__ ofc,
        const int32_t* __restrict__ d_tax4,
        const float* __restrict__ weights, int32_t* __restrict__ diag,
        const int32_t* __restrict__ file_of_read, MultiParams p,
        int count_used, float* __restrict__ acc_ca) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long nb = min((long long)diag[0], (long long)p.B);
    for (long long j = warp; j < nb; j += nwarps) {
        const int ridki = wl_ridki[j];
        const int r = ridki >> 3, ki = ridki & 7;
        if (ofc[r]) continue;
        if (count_used && lane == 0 && j == read_base[r])
            atomicAdd(&diag[1], r_rows[r]);
        const int32_t row0 = wl_row0[j];
        if (row0 <= 0) continue;
        const long long fk = (file_of_read ? (long long)file_of_read[r]
                                             * p.num_k : 0) + ki;
        expand_group(row0, ki, 1, lane, 32, fk, d_tax4, nullptr, weights,
                     p, acc_ca, nullptr, nullptr, nullptr);
    }
}

enum { kCut = 1, kExpand = 2, kCountUsed = 4 };

int launch_multi(int parts,
        const void* cp, const void* mcnt, const void* runs,
        const void* grp2, const void* d_tax4, const void* t_hot,
        const void* weights, const void* file_of_read, int R, int SW, int n,
        int num_k, int S, int H, int DR, int B, long long EB, int cw,
        int hist_n, void* read_base, void* wl_row0, void* wl_T,
        void* wl_ridki, void* hist, void* r_stats, void* ofc, void* diag,
        void* acc_ca, void* dm, void* a3w, void* a3c, void* stream,
        void* marks) {
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    cudaEvent_t* ev = (cudaEvent_t*)marks;
    MultiParams p{R, SW, n, num_k, S, H, DR, B, cw, hist_n, EB};
    // r_stats: (4, R) int32, each read's expansion rows, largest cold T,
    // its slots at that T and its slots at T*
    int32_t* r_rows = (int32_t*)r_stats;
    int32_t* r_tmax = r_rows + R;
    int32_t* r_nmax = r_tmax + R;
    int32_t* r_star = r_nmax + R;
    if (ev) cudaEventRecord(ev[0], st);
    if (parts & kCut) {
        multi_scan_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)mcnt, R, (int32_t*)read_base, (int32_t*)diag);
        if (ev) cudaEventRecord(ev[1], st);
        multi_slots_kernel<<<R, kSlotThreads, 0, st>>>(
            (const int32_t*)cp, (const int32_t*)mcnt,
            (const int32_t*)read_base, (const int32_t*)grp2,
            (const int4*)d_tax4, (const int32_t*)t_hot, p,
            (int32_t*)wl_row0, (int32_t*)wl_T, (int32_t*)wl_ridki,
            (int32_t*)hist, r_rows, r_tmax, r_nmax);
        if (ev) cudaEventRecord(ev[2], st);
        multi_cut_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)mcnt, (const int32_t*)runs,
            (const int32_t*)read_base, (const int32_t*)wl_row0,
            (const int32_t*)wl_T, (const int32_t*)hist, r_rows, r_tmax,
            r_nmax, p, r_star, (uint8_t*)ofc, (int32_t*)diag);
        if (ev) cudaEventRecord(ev[3], st);
    }
    if (parts & kExpand) {
        const int count_used = (parts & kCountUsed) != 0;
        if (count_used)
            cudaMemsetAsync((int32_t*)diag + 1, 0, sizeof(int32_t), st);
        // rows too wide for shared memory take device atomics
        if (dm && S > kRowMax)
            cudaMemsetAsync(dm, 0, (size_t)R * S * sizeof(float), st);
        if (a3w && H > kHotMax)
            cudaMemsetAsync(a3w, 0, (size_t)R * H * sizeof(float), st);
        if (dm == nullptr) {
            // counts-only: a warp per worklist slot, 8 blocks an SM
            int dev = 0, sms = 0;
            cudaError_t e = cudaGetDevice(&dev);
            if (e == cudaSuccess)
                e = cudaDeviceGetAttribute(
                    &sms, cudaDevAttrMultiProcessorCount, dev);
            if (e != cudaSuccess) return (int)e;
            multi_count_kernel<<<sms * 8, kExpandThreads, 0, st>>>(
                (const int32_t*)read_base, (const int32_t*)wl_row0,
                (const int32_t*)wl_ridki, r_rows, (const uint8_t*)ofc,
                (const int32_t*)d_tax4, (const float*)weights,
                (int32_t*)diag, (const int32_t*)file_of_read, p, count_used,
                (float*)acc_ca);
        } else {
            const int hcap = SW <= 4096 ? kHash : kHashLong;
            const size_t smem = (size_t)hcap * 16
                + (S <= kRowMax ? (size_t)S * 4 : 0)
                + (a3w && H <= kHotMax ? (size_t)H * 4 : 0);
            const cudaError_t e = cudaFuncSetAttribute(
                multi_expand_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
            multi_expand_kernel<<<R, kExpandThreads, smem, st>>>(
                (const int32_t*)mcnt, (const int32_t*)read_base,
                (const int32_t*)wl_row0, (const int32_t*)wl_ridki, r_rows,
                (const uint8_t*)ofc, (const int32_t*)d_tax4,
                (const int32_t*)t_hot, (const float*)weights,
                (int32_t*)diag, (const int32_t*)file_of_read, p,
                count_used, hcap, (float*)acc_ca, (float*)dm, (float*)a3w,
                (float*)a3c);
        }
        if (ev) cudaEventRecord(ev[4], st);
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define KASA_MULTI_PARAMS \
        const void* cp, const void* mcnt, const void* runs, \
        const void* grp2, const void* d_tax4, const void* t_hot, \
        const void* weights, const void* file_of_read, int R, int SW, \
        int n, int num_k, int S, int H, int DR, int B, long long EB, \
        int cw, int hist_n, void* read_base, void* wl_row0, void* wl_T, \
        void* wl_ridki, void* hist, void* r_stats, void* ofc, void* diag, \
        void* acc_ca, void* dm, void* a3w, void* a3c, void* stream, \
        void* marks
#define KASA_MULTI_ARGS \
        cp, mcnt, runs, grp2, d_tax4, t_hot, weights, file_of_read, R, SW, \
        n, num_k, S, H, DR, B, EB, cw, hist_n, read_base, wl_row0, wl_T, \
        wl_ridki, hist, r_stats, ofc, diag, acc_ca, dm, a3w, a3c, stream, \
        marks

extern "C" int kasa_turbo_multi(KASA_MULTI_PARAMS) {
    return launch_multi(kCut | kExpand, KASA_MULTI_ARGS);
}

extern "C" int kasa_turbo_multi_cut(KASA_MULTI_PARAMS) {
    return launch_multi(kCut, KASA_MULTI_ARGS);
}

extern "C" int kasa_turbo_multi_expand(KASA_MULTI_PARAMS) {
    return launch_multi(kExpand | kCountUsed, KASA_MULTI_ARGS);
}
