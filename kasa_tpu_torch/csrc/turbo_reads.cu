// K3 turbo_reads: the per-read stages of the turbo classify step.
//
// Replaces, from kasa_tpu/match/turbo.py:518 _turbo_core, the per-read
// half of "wsort1" (672-686: compaction of a read's multi slots),
// "t1sort" (717-738: per-read sort of the T == 1 keys, run ends and run
// counts), "fold" (922-948: the first CW runs, zeroed for flagged
// reads, added to counts_all and counts_unique) and "lists" (950-996:
// the T1 taxa sums, the read's first WM multi taxa, their merge into
// the top WOUT hit list and oflow_lists), plus the packed tail of
// fused_turbo_acc (1226-1241: exclusive scan of the hit counts, the
// CSR of (tax, ksum bits) pairs, flags and the 4-int tail).
//
// Two entry points, around K4 (turbo_multi.cu):
//   pre:  one block per read sorts the read's SW slot keys in shared
//         memory (bitonic, padded to a power of two P), writes the
//         first CW runs (key, count), the run count, and compacts the
//         multi payloads to the front of the read's row;
//   post: one block per read adds its runs to the count accumulators
//         (integer atomics for counts_unique; with a file_of_read map,
//         identify_multiple's fused_turbo_files at turbo.py:936-945, the
//         cell is (file * numK + k) * S + tax of an (F, numK, S) matrix),
//         takes the read's first WM multi taxa in taxon order, merges
//         them with the T1 taxa and writes the hit list, hit count and
//         flags; then one block scans the hit counts and one block per
//         read scatters its CSR pairs.  The multi taxa come from one of
//         two arms: the dense arm scans the read's (R, S) score row for
//         the taxa with a positive score (turbo.py:968-973); the list
//         arm (the sparse regime) reads K6's (R, WM) list and its
//         multi_of flag (turbo.py:914-918), and S is passed explicitly.
//
// The additive arm replaces kasa_tpu/match/tiered.py:354 tiered_finish,
// the resident tail with four differences: pre keeps every run (cw =
// SW) and compacts no multi payloads (mpay null, the tiered pass has
// already expanded the multi groups); post keeps a flagged read's counts
// and T1 scores (the flag is K8's per-read big bit: the host only adds
// the skipped big groups), lists the multi taxa from the dense (R, S)
// rows with wm = min(S, 256), and adds the batch's (numK, S) multi
// counts (cadd) to acc_ca in its scan block.
//
// Bound on the H100: memory for "post" (dense arm: each read's S-float
// score row is read once, R*S*4 bytes, 64 MB at R = 8192, S = 2048; the
// list arm reads R*WM*8 bytes instead); "pre" is
// bound by the shared-memory sort, O(P log^2 P) compare-exchanges per
// read, which at P = 1024 sits below the card's memory time only when
// many blocks are resident.
//
// Design: the shared-memory arm holds P <= SW_CAP = 4096 int32 keys
// (16 KB) and cw <= 4096 run ends.  post keeps a read's T1 list and its
// multi list in shared memory while wout and wm are <= 256, and in a
// global scratch row of 2 * (wout + wm) words per read above (a long
// batch's lists, up to S taxa; the list arm's wm stays <= 256).  A batch
// whose SW or cw exceeds 4096 (read lines above ~690 bp at six levels,
// long read pairs, the additive arm's cw = SW) takes the long arm of
// pre: every row's SW keys are sorted in global scratch by radix.cuh's
// seg_radix_sort (one block per read, four 8-bit digit passes), then one
// block per read finds the run starts and ends in the sorted row; a run
// of rank rho < cw adds -start and end + 1 to its count cell, which
// starts at 0, so the cell ends as the run's length with no run end kept
// in shared memory.  The multi-payload compaction is the same in both
// arms.  The serial parts of post (T1 taxon sums over the read's runs,
// read back from global memory, and the two-list merge) run on one
// thread of the block: simple, and short next to the sort.
#include "radix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListMax = 256;

// The multi payloads (>= 0) of read r to the front of its cp row, in
// slot order, -1 after them; their number to mcnt[r].  Every thread of
// the block calls it; nothing without mpay.
__device__ void compact_payloads(const int32_t* __restrict__ mpay, int SW,
                                 long long r, int32_t* __restrict__ mcnt,
                                 int32_t* __restrict__ cp, int* warp_sums) {
    if (mpay == nullptr) return;
    const int tid = threadIdx.x;
    const int32_t* mrow = mpay + r * SW;
    int32_t* crow = cp + r * SW;
    int moff = 0;
    for (int t0 = 0; t0 < SW; t0 += kThreads) {
        const int i = t0 + tid;
        const int32_t v = i < SW ? mrow[i] : -1;
        int tot;
        const int rank = block_rank<kWarps>(v >= 0, warp_sums, &tot);
        if (v >= 0) crow[moff + rank] = v;
        moff += tot;
    }
    if (tid == 0) mcnt[r] = moff;
    for (int i = moff + tid; i < SW; i += kThreads) crow[i] = -1;
}

__global__ void reads_pre_kernel(const int32_t* __restrict__ skey,
                                 const int32_t* __restrict__ mpay,
                                 int SW, int P, int sent, int cw,
                                 int32_t* __restrict__ ck,
                                 int32_t* __restrict__ cc,
                                 int32_t* __restrict__ runs,
                                 int32_t* __restrict__ mcnt,
                                 int32_t* __restrict__ cp) {
    extern __shared__ int32_t smem[];
    int32_t* keys = smem;            // P
    int32_t* endpos = smem + P;      // cw
    __shared__ int warp_sums[kWarps];
    const int tid = threadIdx.x;
    const long long r = blockIdx.x;
    const int32_t* srow = skey + r * SW;
    for (int i = tid; i < P; i += kThreads)
        keys[i] = i < SW ? srow[i] : sent;
    __syncthreads();

    block_bitonic_sort<int32_t, kThreads>(keys, P);

    // run ends in position order = ascending key order
    int off = 0;
    for (int t0 = 0; t0 < P; t0 += kThreads) {
        const int i = t0 + tid;
        bool e = false;
        int32_t key = sent;
        if (i < P) {
            key = keys[i];
            e = key != sent && (i == P - 1 || keys[i + 1] != key);
        }
        int tot;
        const int rank = block_rank<kWarps>(e, warp_sums, &tot);
        if (e && off + rank < cw) {
            endpos[off + rank] = i;
            ck[r * cw + off + rank] = key;
        }
        off += tot;
    }
    __syncthreads();
    if (tid == 0) runs[r] = off;
    for (int rho = tid; rho < cw; rho += kThreads) {
        if (rho < off) {
            cc[r * cw + rho] = endpos[rho] - (rho > 0 ? endpos[rho - 1] : -1);
        } else {
            ck[r * cw + rho] = sent;
            cc[r * cw + rho] = 0;
        }
    }

    compact_payloads(mpay, SW, r, mcnt, cp, warp_sums);
}

// the long arm: srt holds every row's SW keys sorted (seg_radix_sort);
// the run ends and counts are read from there, and cw may exceed 4096
__global__ void reads_pre_long_kernel(const int32_t* __restrict__ srt,
                                      const int32_t* __restrict__ mpay,
                                      int SW, int sent, int cw,
                                      int32_t* __restrict__ ck,
                                      int32_t* __restrict__ cc,
                                      int32_t* __restrict__ runs,
                                      int32_t* __restrict__ mcnt,
                                      int32_t* __restrict__ cp) {
    __shared__ int warp_sums[kWarps];
    const int tid = threadIdx.x;
    const long long r = blockIdx.x;
    const int32_t* srow = srt + r * SW;
    int32_t* ckr = ck + r * cw;
    int32_t* ccr = cc + r * cw;
    for (int rho = tid; rho < cw; rho += kThreads) {
        ckr[rho] = sent;
        ccr[rho] = 0;
    }
    __syncthreads();
    // the keys are ascending with the sentinels last: runs tile the
    // valid prefix, so the rho-th run start and the rho-th run end bound
    // the same run
    int offs = 0, offe = 0;
    for (int t0 = 0; t0 < SW; t0 += kThreads) {
        const int i = t0 + tid;
        bool s = false, e = false;
        int32_t key = sent;
        if (i < SW) {
            key = srow[i];
            if (key != sent) {
                s = i == 0 || srow[i - 1] != key;
                e = i == SW - 1 || srow[i + 1] != key;
            }
        }
        int ts, te;
        const int rs = block_rank<kWarps>(s, warp_sums, &ts);
        const int re = block_rank<kWarps>(e, warp_sums, &te);
        if (s && offs + rs < cw) atomicAdd(&ccr[offs + rs], -i);
        if (e && offe + re < cw) {
            ckr[offe + re] = key;
            atomicAdd(&ccr[offe + re], i + 1);
        }
        offs += ts;
        offe += te;
    }
    if (tid == 0) runs[r] = offe;
    compact_payloads(mpay, SW, r, mcnt, cp, warp_sums);
}

__global__ void reads_post_kernel(const int32_t* __restrict__ ck,
                                  const int32_t* __restrict__ cc,
                                  const uint8_t* __restrict__ ofc,
                                  const float* __restrict__ dm,
                                  const int32_t* __restrict__ mlk,
                                  const float* __restrict__ mlv,
                                  const uint8_t* __restrict__ mof,
                                  const float* __restrict__ weights,
                                  const int32_t* __restrict__ file_of_read,
                                  float* __restrict__ acc_ca,
                                  int32_t* __restrict__ acc_cu,
                                  int S, int num_k, int cw, int sent,
                                  int wout, int wm, int additive,
                                  int32_t* __restrict__ lscr,
                                  int32_t* __restrict__ ht,
                                  float* __restrict__ hk,
                                  int32_t* __restrict__ hc,
                                  int32_t* __restrict__ flags) {
    __shared__ int32_t s_t1tax[kListMax];
    __shared__ float s_t1val[kListMax];
    __shared__ int32_t s_mk[kListMax];
    __shared__ float s_mv[kListMax];
    __shared__ int warp_sums[kWarps];
    __shared__ int s_nout;
    const int tid = threadIdx.x;
    const long long r = blockIdx.x;
    // the two lists: in shared memory, or in the read's scratch row
    int32_t* t1tax = s_t1tax;
    float* t1val = s_t1val;
    int32_t* mk = s_mk;
    float* mv = s_mv;
    if (lscr) {
        int32_t* row = lscr + r * 2LL * (wout + wm);
        t1tax = row;
        t1val = (float*)(row + wout);
        mk = row + 2 * wout;
        mv = (float*)(row + 2 * wout + wm);
    }
    const bool flagged = ofc[r] != 0;
    // a flagged read is recomputed whole on the host, except in the
    // additive arm, where the host only adds its big groups
    const bool keep = additive || !flagged;
    const long long fk = file_of_read ? (long long)file_of_read[r] * num_k
                                      : 0;
    const int32_t* ckr = ck + r * cw;
    const int32_t* ccr = cc + r * cw;

    // T1 fold
    for (int rho = tid; rho < cw; rho += kThreads) {
        const int32_t key = ckr[rho];
        if (key != sent && keep) {
            const int32_t cnt = ccr[rho];
            const long long cell = (fk + (key & 7)) * S + (key >> 3);
            atomicAdd(&acc_cu[cell], cnt);
            atomicAdd(&acc_ca[cell], (float)cnt);
        }
    }

    // the read's multi taxa: first wm in taxon order; m_over when it has
    // more than wm
    int moff = 0;
    bool m_over;
    if (dm) {
        // dense arm: the taxa with a positive score in the (R, S) row
        const float* drow = dm + r * S;
        for (int t0 = 0; t0 < S; t0 += kThreads) {
            const int s = t0 + tid;
            const float v = s < S ? drow[s] : 0.0f;
            int tot;
            const int rank = block_rank<kWarps>(v > 0.0f, warp_sums, &tot);
            if (v > 0.0f && moff + rank < wm) {
                mk[moff + rank] = s;
                mv[moff + rank] = v;
            }
            moff += tot;
        }
        m_over = moff > wm;
    } else {
        // list arm: K6's sent-padded (R, wm) list (wm <= kThreads)
        bool v = false;
        if (tid < wm) {
            mk[tid] = mlk[r * wm + tid];
            mv[tid] = mlv[r * wm + tid];
            v = mk[tid] != sent;
        }
        moff = __syncthreads_count(v);
        m_over = mof[r] != 0;
    }
    __syncthreads();

    if (tid == 0) {
        // the read's T1 taxa in order with their w(k) * count sums; the
        // first wout are kept (the merge reads no more), all are counted
        int ntax1 = 0;
        int32_t last = -1;
        for (int rho = 0; rho < cw; ++rho) {
            const int32_t key = ckr[rho];
            if (key == sent) break;
            const int32_t tax = key >> 3;
            const float v = weights[key & 7] * (keep ? (float)ccr[rho] : 0.0f);
            if (ntax1 > 0 && last == tax) {
                if (ntax1 - 1 < wout) t1val[ntax1 - 1] += v;
            } else {
                if (ntax1 < wout) {
                    t1tax[ntax1] = tax;
                    t1val[ntax1] = v;
                }
                last = tax;
                ++ntax1;
            }
        }
        const int n1 = min(ntax1, wout), n2 = min(moff, wm);
        int i = 0, j = 0, ntax = 0;
        while (i < n1 || j < n2) {
            const int32_t ta = i < n1 ? t1tax[i] : KASA_I32_MAX;
            const int32_t tb = j < n2 ? mk[j] : KASA_I32_MAX;
            int32_t t;
            float v;
            if (ta < tb) {
                t = ta; v = t1val[i++];
            } else if (tb < ta) {
                t = tb; v = mv[j++];
            } else {
                t = ta; v = t1val[i++] + mv[j++];
            }
            if (ntax < wout) {
                ht[r * wout + ntax] = t;
                hk[r * wout + ntax] = v;
            }
            ++ntax;
        }
        const int nout = min(ntax, wout);
        s_nout = nout;
        hc[r] = nout;
        const bool ofl = flagged || ntax1 > wout || m_over || ntax > wout;
        flags[r] = (flagged ? 1 : 0) | (ofl ? 2 : 0);
    }
    __syncthreads();
    for (int i = s_nout + tid; i < wout; i += kThreads) {
        ht[r * wout + i] = KASA_I32_MAX;
        hk[r * wout + i] = 0.0f;
    }
}

constexpr int kScanThreads = 1024;

__global__ void pack_scan_kernel(const int32_t* __restrict__ hc,
                                 const int32_t* __restrict__ flags,
                                 const int32_t* __restrict__ diag, int R,
                                 const float* __restrict__ cadd, int ncadd,
                                 float* __restrict__ acc_ca,
                                 int32_t* __restrict__ cum,
                                 int32_t* __restrict__ tail) {
    __shared__ long long buf[kScanThreads];
    const int tid = threadIdx.x;
    const int chunk = (R + kScanThreads - 1) / kScanThreads;
    const int r0 = min(tid * chunk, R), r1 = min(r0 + chunk, R);
    long long local = 0, nfl = 0;
    for (int r = r0; r < r1; ++r) {
        local += hc[r];
        nfl += flags[r] != 0;
    }
    long long total, nflag;
    long long run = block_exclusive_scan<kScanThreads>(local, buf, &total);
    block_exclusive_scan<kScanThreads>(nfl, buf, &nflag);
    for (int r = r0; r < r1; ++r) {
        cum[r] = (int32_t)run;
        run += hc[r];
    }
    // the additive arm's multi counts (every T1 atomic of the batch is
    // in: this kernel runs after reads_post_kernel on the stream)
    for (int i = tid; i < ncadd; i += kScanThreads) acc_ca[i] += cadd[i];
    if (tid == 0) {
        tail[0] = diag[0];
        tail[1] = diag[1];
        tail[2] = (int32_t)total;
        tail[3] = (int32_t)nflag;
    }
}

__global__ void pack_scatter_kernel(const int32_t* __restrict__ hc,
                                    const int32_t* __restrict__ flags,
                                    const int32_t* __restrict__ cum,
                                    const int32_t* __restrict__ ht,
                                    const float* __restrict__ hk, int R,
                                    int wout, long long cap,
                                    int32_t* __restrict__ packed) {
    const long long r = blockIdx.x;
    const int n = hc[r];
    if (threadIdx.x == 0) {
        packed[r] = n;
        packed[R + r] = flags[r];
    }
    int32_t* csr = packed + 2LL * R;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const long long d = (long long)cum[r] + i;
        if (d < cap) {
            csr[2 * d] = ht[r * wout + i];
            csr[2 * d + 1] = __float_as_int(hk[r * wout + i]);
        }
    }
}

}  // namespace

extern "C" int kasa_turbo_reads_pre(const void* skey, const void* mpay,
                                    int R, int SW, int P, int sent, int cw,
                                    void* ck, void* cc, void* runs,
                                    void* mcnt, void* cp, void* stream) {
    // smem: P keys and cw run ends, at most 2 x 4,096 int32 (32 KB)
    if (cw < 1 || cw > 4096 || P > 4096 || P < SW || (P & (P - 1)) != 0
        || (mpay != nullptr && (mcnt == nullptr || cp == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (R > 0) {
        const size_t smem = (size_t)(P + cw) * sizeof(int32_t);
        reads_pre_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
            (const int32_t*)skey, (const int32_t*)mpay, SW, P, sent, cw,
            (int32_t*)ck, (int32_t*)cc, (int32_t*)runs, (int32_t*)mcnt,
            (int32_t*)cp);
    }
    return (int)cudaGetLastError();
}

extern "C" int kasa_turbo_reads_pre_long(const void* skey,
                                         const void* mpay, int R, int SW,
                                         int sent, int cw, void* scr_a,
                                         void* scr_b, void* ck, void* cc,
                                         void* runs, void* mcnt, void* cp,
                                         void* stream) {
    // scr_a, scr_b: (R, SW) int32 scratch of the four digit passes
    if (cw < 1 || SW < 1
        || (mpay != nullptr && (mcnt == nullptr || cp == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (R > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        const int cols[4] = {0, 0, 0, 0}, shifts[4] = {0, 8, 16, 24};
        const int32_t* srt = seg_radix_sort<1>(
            (const int32_t*)skey, (int32_t*)scr_a, (int32_t*)scr_b, R, SW,
            cols, shifts, 4, st);
        reads_pre_long_kernel<<<R, kThreads, 0, st>>>(
            srt, (const int32_t*)mpay, SW, sent, cw, (int32_t*)ck,
            (int32_t*)cc, (int32_t*)runs, (int32_t*)mcnt, (int32_t*)cp);
    }
    return (int)cudaGetLastError();
}

extern "C" int kasa_turbo_reads_post(const void* ck, const void* cc,
                                     const void* ofc, const void* dm,
                                     const void* mlk, const void* mlv,
                                     const void* mof, const void* weights,
                                     const void* file_of_read, void* acc_ca,
                                     void* acc_cu, const void* diag,
                                     const void* cadd, int R, int S,
                                     int num_k, int cw, int sent, int wout,
                                     int wm, int additive, int ncadd,
                                     long long cap, void* lscr, void* ht,
                                     void* hk, void* hc, void* flags,
                                     void* cum, void* packed, void* stream) {
    if (wout < 1 || wm < 1
        || ((wout > kListMax || wm > kListMax) && lscr == nullptr)
        || (dm == nullptr && (wm > kThreads || mlk == nullptr
                              || mlv == nullptr || mof == nullptr))
        || (ncadd > 0 && cadd == nullptr))
        return (int)cudaErrorInvalidValue;
    if (R > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        reads_post_kernel<<<R, kThreads, 0, st>>>(
            (const int32_t*)ck, (const int32_t*)cc, (const uint8_t*)ofc,
            (const float*)dm, (const int32_t*)mlk, (const float*)mlv,
            (const uint8_t*)mof, (const float*)weights,
            (const int32_t*)file_of_read, (float*)acc_ca,
            (int32_t*)acc_cu, S, num_k, cw, sent, wout, wm, additive,
            (wout > kListMax || wm > kListMax) ? (int32_t*)lscr : nullptr,
            (int32_t*)ht, (float*)hk, (int32_t*)hc, (int32_t*)flags);
        int32_t* tail = (int32_t*)packed + 2LL * R + 2LL * cap;
        pack_scan_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)hc, (const int32_t*)flags, (const int32_t*)diag,
            R, (const float*)cadd, ncadd, (float*)acc_ca, (int32_t*)cum,
            tail);
        pack_scatter_kernel<<<R, 128, 0, st>>>(
            (const int32_t*)hc, (const int32_t*)flags, (const int32_t*)cum,
            (const int32_t*)ht, (const float*)hk, R, wout, cap,
            (int32_t*)packed);
    }
    return (int)cudaGetLastError();
}
