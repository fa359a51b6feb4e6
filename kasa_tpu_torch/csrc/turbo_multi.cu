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
//           counts cold slots per T in a histogram;
//   cut:    one block; the budget cut without a global sort.  kasa_tpu
//           sorts the cold slots stably by T over a read-major
//           worklist and admits them while the running row count fits
//           EB.  The admitted set is a prefix: every T below some T*,
//           then the first c slots of T* in read order.  The histogram
//           gives T* and c; a scan over the reads of their T* slot
//           counts gives each read's rank, and a read is flagged when a
//           T* slot ranks >= c or it has a slot above T* (with the
//           worklist overflow and the > CW runs flags, as in kasa_tpu);
//   expand: one warp per worklist slot of an unflagged read: cold
//           slots add 1/T to counts (numK, S) and w(k)/T to the score
//           rows (R, S) for each taxon of their group, by atomics; hot
//           slots add to the (R, H) and (numK, H) credit matrices that
//           the two hot-mask products fold (in the Python wrapper).
//           kasa_tpu's (R, numK, S) accumulator (402 MB at R = 8192,
//           S = 2048) is never built.  With a file_of_read map
//           (identify_multiple, fused_turbo_files at turbo.py:826-833
//           and 853-861) the count cell is (file * numK + k) * S + tax
//           of an (F, numK, S) matrix and the hot credit row is
//           file * numK + k of an (F * numK, H) matrix.  Counts-only arm
//           (the sparse regime: S > SPARSE_FOLD_S and no hot tier, the
//           cflat of turbo.py:871-880 with its file offset fk_e):
//           dm, a3w and a3c are null, cold slots add only to the counts
//           and K6 (sparse_fold.cu) builds the per-read lists, so no
//           (R, S) buffer exists (328 MB at R = 8192, S = 10,002).
//
// Bound on the H100: atomics and gathers of the expansion.  Each cold
// slot gathers ceil(T/4) 16-byte taxa rows and issues 2T float atomics
// on the 64 MB score rows (L2-resident); the worklist itself is small.
//
// Split entry points (the mesh, parallel/turbo_mesh.py): kasa_turbo_multi
// queues all four; kasa_turbo_multi_cut queues scan, slots and cut, and
// kasa_turbo_multi_expand the expansion alone, after the caller has ORed
// the cut's flags over the index shards (kasa_tpu's flag_reduce,
// turbo.py:768-769).  The split expansion also recounts the expansion
// rows used (diag[1]) under those flags, one atomic per admitted slot;
// the cut's count is the shard's own.
//
// Design: simple first.  The two single-block kernels walk at most B
// worklist slots and R reads with 1024 threads; the expansion gives a
// warp to a slot so a group's taxa rows load coalesced.
#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;

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

__global__ void multi_slots_kernel(const int32_t* __restrict__ cp,
                                   const int32_t* __restrict__ mcnt,
                                   const int32_t* __restrict__ read_base,
                                   const int32_t* __restrict__ grp2,
                                   const int4* __restrict__ d_tax4,
                                   const int32_t* __restrict__ t_hot,
                                   MultiParams p,
                                   int32_t* __restrict__ wl_row0,
                                   int32_t* __restrict__ wl_T,
                                   int32_t* __restrict__ wl_ridki,
                                   int32_t* __restrict__ hist) {
    const int r = blockIdx.x;
    const int cnt = mcnt[r];
    const int base = read_base[r];
    const long long gmax = (long long)p.num_k * p.n - 1;
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
        const long long j = (long long)base + i;
        if (j >= p.B) break;
        const int32_t mp = cp[(long long)r * p.SW + i];
        const int ki = mp & 7;
        const long long psel = mp >> 3;
        const int32_t row0 = grp2[min((long long)ki * p.n + psel, gmax)];
        int32_t T = 0;
        if (row0 > 0) {
            T = d_tax4[row0].x;          // the group's header row [T, ...]
            atomicAdd(&hist[min(T, p.hist_n - 1)], 1);
        } else if (row0 < 0) {
            T = t_hot[-row0 - 1];
        }
        wl_row0[j] = row0;
        wl_T[j] = T;
        wl_ridki[j] = r * 8 + ki;
    }
}

__global__ void multi_cut_kernel(const int32_t* __restrict__ mcnt,
                                 const int32_t* __restrict__ runs,
                                 const int32_t* __restrict__ read_base,
                                 const int32_t* __restrict__ wl_row0,
                                 const int32_t* __restrict__ wl_T,
                                 const int32_t* __restrict__ hist,
                                 MultiParams p,
                                 int32_t* __restrict__ r_cnt,
                                 int32_t* __restrict__ r_rows,
                                 uint8_t* __restrict__ r_big,
                                 uint8_t* __restrict__ ofc,
                                 int32_t* __restrict__ diag) {
    __shared__ long long buf[kScanThreads];
    __shared__ int s_tstar;
    __shared__ long long s_c;
    const int tid = threadIdx.x;
    if (tid == 0) {
        // the first T whose cold slots do not all fit the budget
        long long below = 0;
        int tstar = KASA_I32_MAX;
        long long c = 0;
        for (int T = 0; T < p.hist_n; ++T) {
            const long long cnt = hist[T];
            if (cnt == 0) continue;
            const long long rp = (T + 3) >> 2;
            if (below + cnt * rp > p.EB) {
                tstar = T;
                c = (p.EB - below) / rp;
                break;
            }
            below += cnt * rp;
        }
        s_tstar = tstar;
        s_c = c;
    }
    __syncthreads();
    const int tstar = s_tstar;
    const long long c = s_c;
    const bool batch_of = (long long)diag[0] > p.B;

    const int chunk = (p.R + kScanThreads - 1) / kScanThreads;
    const int r0 = min(tid * chunk, p.R), r1 = min(r0 + chunk, p.R);
    long long local = 0;
    for (int r = r0; r < r1; ++r) {
        const int cnt = mcnt[r];
        const long long base = read_base[r];
        int n_star = 0, rows = 0;
        bool big = false;
        for (int i = 0; i < cnt; ++i) {
            const long long j = base + i;
            if (j >= p.B) break;
            if (wl_row0[j] <= 0) continue;      // hot or no group
            const int T = wl_T[j];
            n_star += T == tstar;
            big = big || T > tstar;
            rows += (T + 3) >> 2;
        }
        r_cnt[r] = n_star;
        r_rows[r] = rows;
        r_big[r] = big;
        local += n_star;
    }
    long long total;
    long long rank = block_exclusive_scan<kScanThreads>(local, buf, &total);
    long long used = 0;
    for (int r = r0; r < r1; ++r) {
        const int n_star = r_cnt[r];
        const bool dropped = r_big[r] || (n_star > 0 && rank + n_star > c);
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

__global__ void multi_expand_kernel(const int32_t* __restrict__ wl_row0,
                                    const int32_t* __restrict__ wl_T,
                                    const int32_t* __restrict__ wl_ridki,
                                    const uint8_t* __restrict__ ofc,
                                    const int32_t* __restrict__ d_tax4,
                                    const float* __restrict__ weights,
                                    int32_t* __restrict__ diag,
                                    const int32_t* __restrict__ file_of_read,
                                    MultiParams p, int count_used,
                                    float* __restrict__ acc_ca,
                                    float* __restrict__ dm,
                                    float* __restrict__ a3w,
                                    float* __restrict__ a3c) {
    const int lane = threadIdx.x & 31;
    const long long warp = ((long long)blockIdx.x * blockDim.x
                            + threadIdx.x) >> 5;
    const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
    const long long nb = min((long long)diag[0], (long long)p.B);
    for (long long j = warp; j < nb; j += nwarps) {
        const int32_t row0 = wl_row0[j];
        if (row0 == 0) continue;
        const int ridki = wl_ridki[j];
        const int r = ridki >> 3, ki = ridki & 7;
        if (ofc[r]) continue;
        const int T = wl_T[j];
        const long long fk = (file_of_read ? (long long)file_of_read[r]
                                             * p.num_k : 0) + ki;
        if (row0 > 0) {
            if (count_used && lane == 0) atomicAdd(&diag[1], (T + 3) >> 2);
            const float inv = 1.0f / (float)T;
            const float wv = weights[ki] * inv;
            const int lanes = ((T + 3) >> 2) * 4;
            for (int t = lane; t < lanes; t += 32) {
                const long long row = min((long long)row0 + 1 + (t >> 2),
                                          (long long)p.DR - 1);
                const int32_t tax = d_tax4[row * 4 + (t & 3)];
                if (tax >= 0) {
                    atomicAdd(&acc_ca[fk * p.S + tax], inv);
                    if (dm) atomicAdd(&dm[(long long)r * p.S + tax], wv);
                }
            }
        } else if (lane == 0 && a3w) {
            const int hid = -row0 - 1;
            const float inv = 1.0f / (float)max(T, 1);
            atomicAdd(&a3w[(long long)r * p.H + hid], weights[ki] * inv);
            atomicAdd(&a3c[fk * p.H + hid], inv);
        }
    }
}

enum { kCut = 1, kExpand = 2, kCountUsed = 4 };

int launch_multi(int parts,
        const void* cp, const void* mcnt, const void* runs,
        const void* grp2, const void* d_tax4, const void* t_hot,
        const void* weights, const void* file_of_read, int R, int SW, int n,
        int num_k, int S, int H,
        int DR, int B, long long EB, int cw, int hist_n,
        void* read_base, void* wl_row0, void* wl_T, void* wl_ridki,
        void* hist, void* r_cnt, void* r_rows, void* r_big,
        void* ofc, void* diag, void* acc_ca, void* dm, void* a3w, void* a3c,
        int expand_blocks, void* stream) {
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    MultiParams p{R, SW, n, num_k, S, H, DR, B, cw, hist_n, EB};
    if (parts & kCut) {
        multi_scan_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)mcnt, R, (int32_t*)read_base, (int32_t*)diag);
        multi_slots_kernel<<<R, 128, 0, st>>>(
            (const int32_t*)cp, (const int32_t*)mcnt,
            (const int32_t*)read_base, (const int32_t*)grp2,
            (const int4*)d_tax4, (const int32_t*)t_hot, p,
            (int32_t*)wl_row0, (int32_t*)wl_T, (int32_t*)wl_ridki,
            (int32_t*)hist);
        multi_cut_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)mcnt, (const int32_t*)runs,
            (const int32_t*)read_base, (const int32_t*)wl_row0,
            (const int32_t*)wl_T, (const int32_t*)hist, p, (int32_t*)r_cnt,
            (int32_t*)r_rows, (uint8_t*)r_big, (uint8_t*)ofc,
            (int32_t*)diag);
    }
    if (parts & kExpand) {
        const int count_used = (parts & kCountUsed) != 0;
        if (count_used)
            cudaMemsetAsync((int32_t*)diag + 1, 0, sizeof(int32_t), st);
        multi_expand_kernel<<<expand_blocks, 256, 0, st>>>(
            (const int32_t*)wl_row0, (const int32_t*)wl_T,
            (const int32_t*)wl_ridki, (const uint8_t*)ofc,
            (const int32_t*)d_tax4, (const float*)weights,
            (int32_t*)diag, (const int32_t*)file_of_read, p, count_used,
            (float*)acc_ca, (float*)dm, (float*)a3w,
            (float*)a3c);
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
        void* wl_ridki, void* hist, void* r_cnt, void* r_rows, \
        void* r_big, void* ofc, void* diag, void* acc_ca, void* dm, \
        void* a3w, void* a3c, int expand_blocks, void* stream
#define KASA_MULTI_ARGS \
        cp, mcnt, runs, grp2, d_tax4, t_hot, weights, file_of_read, R, SW, \
        n, num_k, S, H, DR, B, EB, cw, hist_n, read_base, wl_row0, wl_T, \
        wl_ridki, hist, r_cnt, r_rows, r_big, ofc, diag, acc_ca, dm, a3w, \
        a3c, expand_blocks, stream

extern "C" int kasa_turbo_multi(KASA_MULTI_PARAMS) {
    return launch_multi(kCut | kExpand, KASA_MULTI_ARGS);
}

extern "C" int kasa_turbo_multi_cut(KASA_MULTI_PARAMS) {
    return launch_multi(kCut, KASA_MULTI_ARGS);
}

extern "C" int kasa_turbo_multi_expand(KASA_MULTI_PARAMS) {
    return launch_multi(kExpand | kCountUsed, KASA_MULTI_ARGS);
}
