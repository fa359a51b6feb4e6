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
//   pre:  one block per read compacts the read's real slot keys (the
//         sentinel, a slot with no T == 1 hit, sorts last and forms no
//         run, so it is never sorted: 24 % of a 150 bp read's row, half
//         of a long read's) into shared memory, sorts them there (or, in
//         the long arm, counts them in a histogram), writes the first CW
//         runs (key, count) and the run count, and compacts the multi
//         payloads to the front of the read's row;
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
//         The T1 taxon sums and the merge of the two lists run on one
//         thread while the lists fit shared memory (at most kListMax
//         taxa a list: a 150 bp read's); wider ones (a long batch's,
//         with lists of up to S taxa) run over the whole block:
//         the thread at a taxon's first run sums its runs in run order
//         (the order one thread would), and every entry of the two lists
//         finds its place in their union by two binary searches and a
//         count of the taxa in both (merge path), so the lists, their
//         sums and their order are those of the serial merge.
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
// list arm reads R*WM*8 bytes instead); "pre" reads each row once, but
// its time goes to the sort in shared memory.
//
// Arms of pre (kernels.reads_pre_arm):
//   short      SW and cw <= SW_CAP = 4096: the read's real keys, at most
//              SW, sit in shared memory with a second buffer of the same
//              size and are sorted by LSD radix passes over the 8-bit
//              digits the row's keys span (2 passes below 65,536, 3 at
//              S = 10,001; a bitonic sort over the next power of two of
//              all SW slots, the PR 1 design, took 1.7x as long on a
//              150 bp batch, and over only the real keys as long: their
//              power of two is the same, 1,024);
//   long_smem  longer rows (read lines above ~690 bp at six levels, long
//              read pairs, the additive arm's cw = SW) whose key range,
//              8 S for S species, fits the histogram a block can hold
//              (kasa_turbo_reads_hist_max: 58,000 keys, indices of up to
//              ~7,200 species, on the H100): the runs come from a
//              histogram of the row's keys in shared memory, with no sort
//              and no limit on the row's length;
//   global     the rest: every row's SW keys sorted in global scratch by
//              radix.cuh's seg_radix_sort (one block per read, four 8-bit
//              digit passes), then one block per read finds the run
//              starts and ends in the sorted row; a run of rank rho < cw
//              adds -start and end + 1 to its count cell, which starts
//              at 0, so the cell ends as the run's length.
// The multi-payload compaction is the same in every arm (in the long
// arms a warp's contiguous part of the row at a time).  post keeps a
// read's T1 list and its multi list in shared memory while wout and wm
// are <= 256, and in a global scratch row (post_scratch_words) above (a
// long batch's lists, up to S taxa; the list arm's wm stays <= 256).
#include "radix.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kListMax = 256;

// shared memory of the short arm: the radix passes' (digit, warp)
// counts, the read's real keys and a second buffer of SW each, and the
// run ends it keeps
constexpr size_t kPreFixed = (size_t)256 * kWarps * sizeof(unsigned short);

inline size_t pre_smem(int SW, int cw) {
    const int ecap = cw < SW ? cw : SW;
    return kPreFixed + (size_t)(2 * SW + (ecap > 0 ? ecap : 1))
                       * sizeof(int32_t);
}

// The multi payloads (>= 0) of read r to the front of its cp row, in
// slot order, -1 after them; their number to mcnt[r]: each warp counts
// the payloads of its own contiguous part of the row, then, after one
// scan of the warps' counts, writes them in order.  Every thread of the
// block calls it; nothing without mpay.
template <int NT>
__device__ void compact_payloads(const int32_t* __restrict__ mpay, int SW,
                                 long long r, int32_t* __restrict__ mcnt,
                                 int32_t* __restrict__ cp, int* warp_sums) {
    if (mpay == nullptr) return;
    constexpr int NW = NT / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int32_t* mrow = mpay + r * SW;
    int32_t* crow = cp + r * SW;
    const int part = (SW + NT - 1) / NT * 32;
    const int s0 = min(warp * part, SW), s1 = min(s0 + part, SW);
    int n = 0;
    for (int t0 = s0; t0 < s1; t0 += 32) {
        const int i = t0 + lane;
        n += __popc(__ballot_sync(0xffffffffu, i < s1 && mrow[i] >= 0));
    }
    __syncthreads();
    if (lane == 0) warp_sums[warp] = n;
    __syncthreads();
    int off = 0, tot = 0;
    for (int w = 0; w < NW; ++w) {
        off += w < warp ? warp_sums[w] : 0;
        tot += warp_sums[w];
    }
    for (int t0 = s0; t0 < s1; t0 += 32) {
        const int i = t0 + lane;
        const int32_t v = i < s1 ? mrow[i] : -1;
        const unsigned m = __ballot_sync(0xffffffffu, v >= 0);
        if (v >= 0) crow[off + __popc(m & lt)] = v;
        off += __popc(m);
    }
    if (threadIdx.x == 0) mcnt[r] = tot;
    for (int i = tot + threadIdx.x; i < SW; i += NT) crow[i] = -1;
}

// The short arm (SW <= 4096), one block per read: the read's real keys
// (not sent) compacted into shared memory and sorted there by LSD radix
// passes over the 8-bit digits the row's keys span (stable, a warp's
// chunk at a time, as in K5's long arm), then the run ends and counts.
// The row's sentinels sort last and form no run, so they are never
// sorted.
__global__ void __launch_bounds__(kThreads) reads_pre_kernel(
        const int32_t* __restrict__ skey, const int32_t* __restrict__ mpay,
        int SW, int sent, int cw, int32_t* __restrict__ ck,
        int32_t* __restrict__ cc, int32_t* __restrict__ runs,
        int32_t* __restrict__ mcnt, int32_t* __restrict__ cp) {
    constexpr int NT = kThreads, NW = kWarps;
    extern __shared__ __align__(16) unsigned char pre_smem_buf[];
    // cnt[d * NW + w]: digit d in warp w's chunk, then, scanned, where
    // warp w's next key of digit d goes
    unsigned short* cnt = reinterpret_cast<unsigned short*>(pre_smem_buf);
    int32_t* keys = reinterpret_cast<int32_t*>(pre_smem_buf + kPreFixed);
    int32_t* aux = keys + SW;
    int32_t* endpos = aux + SW;
    __shared__ int warp_sums[NW];
    __shared__ unsigned s_bits;
    const int tid = threadIdx.x;
    const unsigned lane = tid & 31u;
    const unsigned lt = (1u << lane) - 1u;
    const int warp = tid >> 5;
    const long long r = blockIdx.x;
    const int32_t* srow = skey + r * SW;
    if (tid == 0) s_bits = 0;
    int n = 0;
    unsigned bits = 0;
    for (int t0 = 0; t0 < SW; t0 += NT) {
        const int i = t0 + tid;
        const int32_t v = i < SW ? srow[i] : sent;
        const bool real = v != sent;
        int tot;
        const int rank = block_rank<NW>(real, warp_sums, &tot);
        if (real) {
            keys[n + rank] = v;
            bits |= (unsigned)v;
        }
        n += tot;
    }
    atomicOr(&s_bits, bits);
    __syncthreads();
    // warp w takes keys [w, w + 1) x 32 per, item by item, so ranks
    // follow key order: stable
    const int per = (n + NT - 1) / NT;
    const int lo = warp * 32 * per;
    constexpr int kScan = 256 * NW / NT;
    int32_t* src = keys;
    int32_t* dst = aux;
    for (int sh = 0; sh < 31 && (s_bits >> sh) != 0u; sh += 8) {
        for (int i = tid; i < 256 * NW; i += NT) cnt[i] = 0;
        __syncthreads();
        for (int it = 0; it < per; ++it) {
            const int pp = lo + it * 32 + (int)lane;
            const bool valid = pp < n;
            const unsigned d = valid ? ((unsigned)src[pp] >> sh) & 255u : 0u;
            const unsigned peers = warp_peers<8>(d, valid);
            if (valid && (peers & lt) == 0)
                cnt[d * NW + warp] += __popc(peers);
            __syncwarp();
        }
        __syncthreads();
        unsigned short v[kScan];
        int mine = 0;
#pragma unroll
        for (int k = 0; k < kScan; ++k) {
            v[k] = cnt[tid * kScan + k];
            mine += v[k];
        }
        int total;
        int run = block_scan_excl<NT>(mine, warp_sums, &total);
#pragma unroll
        for (int k = 0; k < kScan; ++k) {
            cnt[tid * kScan + k] = (unsigned short)run;
            run += v[k];
        }
        __syncthreads();
        for (int it = 0; it < per; ++it) {
            const int pp = lo + it * 32 + (int)lane;
            const bool valid = pp < n;
            const int32_t key = valid ? src[pp] : 0;
            const unsigned d = ((unsigned)key >> sh) & 255u;
            const unsigned peers = warp_peers<8>(d, valid);
            const unsigned before = valid ? cnt[d * NW + warp] : 0u;
            __syncwarp();
            if (valid && (peers & lt) == 0)
                cnt[d * NW + warp] = (unsigned short)(before + __popc(peers));
            __syncwarp();
            if (valid) dst[before + __popc(peers & lt)] = key;
        }
        __syncthreads();
        int32_t* t = src;
        src = dst;
        dst = t;
    }
    const int32_t* srt = src;

    // run ends in position order = ascending key order
    const int ecap = min(cw, SW);
    int off = 0;
    for (int t0 = 0; t0 < n; t0 += NT) {
        const int i = t0 + tid;
        bool e = false;
        int32_t key = sent;
        if (i < n) {
            key = srt[i];
            e = i == n - 1 || srt[i + 1] != key;
        }
        int tot;
        const int rank = block_rank<NW>(e, warp_sums, &tot);
        if (e && off + rank < ecap) {
            endpos[off + rank] = i;
            ck[r * cw + off + rank] = key;
        }
        off += tot;
    }
    __syncthreads();
    if (tid == 0) runs[r] = off;
    for (int rho = tid; rho < cw; rho += NT) {
        if (rho < off) {
            cc[r * cw + rho] = endpos[rho] - (rho > 0 ? endpos[rho - 1] : -1);
        } else {
            ck[r * cw + rho] = sent;
            cc[r * cw + rho] = 0;
        }
    }

    compact_payloads<NT>(mpay, SW, r, mcnt, cp, warp_sums);
}

// The shared-memory long arm: one block per read counts each real key
// of its row in a histogram over the batch's key range [0, range) in
// shared memory (a warp's equal keys add once), then each warp walks its
// own contiguous part of the histogram for the keys present and, after
// one scan of the warps' counts, writes the first cw of them in key
// order with their counts: the runs, with no sort and no limit on the
// row's length.
template <int NT>
__global__ void __launch_bounds__(NT) reads_pre_hist_kernel(
        const int32_t* __restrict__ skey, const int32_t* __restrict__ mpay,
        int SW, int range, int sent, int cw, int32_t* __restrict__ ck,
        int32_t* __restrict__ cc, int32_t* __restrict__ runs,
        int32_t* __restrict__ mcnt, int32_t* __restrict__ cp) {
    constexpr int NW = NT / 32;
    extern __shared__ int32_t hist[];
    __shared__ int warp_sums[NW];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const long long r = blockIdx.x;
    const int32_t* srow = skey + r * SW;
    for (int i = tid; i < range; i += NT) hist[i] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < SW; t0 += NT) {
        const int i = t0 + tid;
        const int32_t v = i < SW ? srow[i] : sent;
        const int key = v != sent ? v : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&hist[key], __popc(peers));
    }
    __syncthreads();
    const int part = (range + NT - 1) / NT * 32;
    const int s0 = min(warp * part, range), s1 = min(s0 + part, range);
    int n = 0;
    for (int t0 = s0; t0 < s1; t0 += 32) {
        const int k = t0 + lane;
        n += __popc(__ballot_sync(0xffffffffu, k < s1 && hist[k] > 0));
    }
    if (lane == 0) warp_sums[warp] = n;
    __syncthreads();
    int off = 0, tot = 0;
    for (int w = 0; w < NW; ++w) {
        off += w < warp ? warp_sums[w] : 0;
        tot += warp_sums[w];
    }
    for (int t0 = s0; t0 < s1 && off < cw; t0 += 32) {
        const int k = t0 + lane;
        const int c = k < s1 ? hist[k] : 0;
        const unsigned m = __ballot_sync(0xffffffffu, c > 0);
        const int at = off + __popc(m & lt);
        if (c > 0 && at < cw) {
            ck[r * cw + at] = k;
            cc[r * cw + at] = c;
        }
        off += __popc(m);
    }
    if (tid == 0) runs[r] = tot;
    for (int rho = tot + tid; rho < cw; rho += NT) {
        ck[r * cw + rho] = sent;
        cc[r * cw + rho] = 0;
    }
    compact_payloads<NT>(mpay, SW, r, mcnt, cp, warp_sums);
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
    compact_payloads<kThreads>(mpay, SW, r, mcnt, cp, warp_sums);
}

// int32 words of a read's scratch row in post when its lists are wider
// than kListMax: the T1 list and the multi list (taxa and sums), and the
// merge's wm + 1 counts
__host__ __device__ inline long long post_scratch_words(int wout, int wm) {
    return 2LL * (wout + wm) + wm + 1;
}

// the first index in [0, n) whose value is >= x in an ascending list
__device__ __forceinline__ int lower_bound_i32(const int32_t* a, int n,
                                               int32_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
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
    __shared__ int s_pb[kListMax + 1];
    __shared__ int warp_sums[kWarps];
    const int tid = threadIdx.x;
    const long long r = blockIdx.x;
    // the two lists and the merge's counts: in shared memory, or in the
    // read's scratch row
    int32_t* t1tax = s_t1tax;
    float* t1val = s_t1val;
    int32_t* mk = s_mk;
    float* mv = s_mv;
    int* pb = s_pb;
    if (lscr) {
        int32_t* row = lscr + r * post_scratch_words(wout, wm);
        t1tax = row;
        t1val = (float*)(row + wout);
        mk = row + 2 * wout;
        mv = (float*)(row + 2 * wout + wm);
        pb = row + 2 * (wout + wm);
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

    if (wout <= kListMax && wm <= kListMax) {
        // short lists (a 150 bp read's): one thread walks the runs and
        // merges the two lists, which beats the block-wide merge below
        // there
        if (tid == 0) {
            int ntax1 = 0;
            int32_t last = -1;
            for (int rho = 0; rho < cw; ++rho) {
                const int32_t key = ckr[rho];
                if (key == sent) break;
                const int32_t tax = key >> 3;
                const float v = weights[key & 7]
                                * (keep ? (float)ccr[rho] : 0.0f);
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
            pb[0] = nout;
            hc[r] = nout;
            const bool ofl = flagged || ntax1 > wout || m_over
                             || ntax > wout;
            flags[r] = (flagged ? 1 : 0) | (ofl ? 2 : 0);
        }
        __syncthreads();
        for (int i = pb[0] + tid; i < wout; i += kThreads) {
            ht[r * wout + i] = KASA_I32_MAX;
            hk[r * wout + i] = 0.0f;
        }
        return;
    }

    // the read's T1 taxa in order with their w(k) * count sums: a
    // taxon's runs are adjacent in ck, and the thread at its first run
    // sums them in run order, as one thread walking the runs would; the
    // first wout are kept (the merge reads no more), all are counted
    int ntax1 = 0;
    for (int t0 = 0; t0 < cw; t0 += kThreads) {
        const int rho = t0 + tid;
        const int32_t key = rho < cw ? ckr[rho] : sent;
        const bool first = key != sent
                           && (rho == 0 || (ckr[rho - 1] >> 3) != (key >> 3));
        int tot;
        const int rank = block_rank<kWarps>(first, warp_sums, &tot);
        if (first && ntax1 + rank < wout) {
            const int32_t tax = key >> 3;
            float v = weights[key & 7] * (keep ? (float)ccr[rho] : 0.0f);
            for (int q = rho + 1; q < cw; ++q) {
                const int32_t k2 = ckr[q];
                if (k2 == sent || (k2 >> 3) != tax) break;
                v += weights[k2 & 7] * (keep ? (float)ccr[q] : 0.0f);
            }
            t1tax[ntax1 + rank] = tax;
            t1val[ntax1 + rank] = v;
        }
        ntax1 += tot;
    }
    __syncthreads();

    // the merge of the two taxon-ordered lists, each entry placed at its
    // rank in their union: pb[j] counts the multi taxa before j that
    // are T1 taxa too; a taxon in both lists sums t1 + multi there
    const int n1 = min(ntax1, wout), n2 = min(moff, wm);
    int ndup = 0;
    for (int t0 = 0; t0 < n2; t0 += kThreads) {
        const int j = t0 + tid;
        bool dup = false;
        if (j < n2) {
            const int la = lower_bound_i32(t1tax, n1, mk[j]);
            dup = la < n1 && t1tax[la] == mk[j];
        }
        int tot;
        const int rank = block_rank<kWarps>(dup, warp_sums, &tot);
        if (j < n2) pb[j] = ndup + rank;
        ndup += tot;
    }
    if (tid == 0) pb[n2] = ndup;
    __syncthreads();
    for (int i = tid; i < n1; i += kThreads) {
        const int32_t a = t1tax[i];
        const int lb = lower_bound_i32(mk, n2, a);
        const int pos = i + lb - pb[lb];
        if (pos < wout) {
            ht[r * wout + pos] = a;
            hk[r * wout + pos] = lb < n2 && mk[lb] == a ? t1val[i] + mv[lb]
                                                        : t1val[i];
        }
    }
    for (int j = tid; j < n2; j += kThreads) {
        const int32_t b = mk[j];
        const int la = lower_bound_i32(t1tax, n1, b);
        if (la < n1 && t1tax[la] == b) continue;
        const int pos = j + la - pb[j];
        if (pos < wout) {
            ht[r * wout + pos] = b;
            hk[r * wout + pos] = mv[j];
        }
    }
    const int ntax = n1 + n2 - ndup;
    const int nout = min(ntax, wout);
    if (tid == 0) {
        hc[r] = nout;
        const bool ofl = flagged || ntax1 > wout || m_over || ntax > wout;
        flags[r] = (flagged ? 1 : 0) | (ofl ? 2 : 0);
    }
    for (int i = nout + tid; i < wout; i += kThreads) {
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

// the main arm: SW and cw at most 4,096 (SW_CAP), every row's keys in
// shared memory.  marks: null, or two events recorded around the launch.
extern "C" int kasa_turbo_reads_pre(const void* skey, const void* mpay,
                                    int R, int SW, int sent, int cw,
                                    void* ck, void* cc, void* runs,
                                    void* mcnt, void* cp, void* stream,
                                    void* marks) {
    if (cw < 1 || cw > 4096 || SW < 1 || SW > 4096
        || (mpay != nullptr && (mcnt == nullptr || cp == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    cudaEvent_t* ev = (cudaEvent_t*)marks;
    const size_t smem = pre_smem(SW, cw);
    const cudaError_t e = cudaFuncSetAttribute(
        reads_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (ev) cudaEventRecord(ev[0], st);
    reads_pre_kernel<<<R, kThreads, smem, st>>>(
        (const int32_t*)skey, (const int32_t*)mpay, SW, sent, cw,
        (int32_t*)ck, (int32_t*)cc, (int32_t*)runs, (int32_t*)mcnt,
        (int32_t*)cp);
    if (ev) cudaEventRecord(ev[1], st);
    return (int)cudaGetLastError();
}

constexpr int kHistThreads = 512;

// The widest key range the shared-memory long arm's histogram takes on
// the card `device` (keys below it: the wrapper picks the arm by it), or
// minus a CUDA error.
extern "C" int kasa_turbo_reads_hist_max(int device) {
    int smem = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return -(int)e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, reads_pre_hist_kernel<kHistThreads>);
    if (e != cudaSuccess) return -(int)e;
    return (int)(((long long)smem - (long long)fa.sharedSizeBytes) / 4);
}

// the shared-memory long arm: rows of any SW whose keys lie in [0, range)
// (range <= kasa_turbo_reads_hist_max), any cw.  marks as above.
extern "C" int kasa_turbo_reads_pre_hist(const void* skey, const void* mpay,
                                         int R, int SW, int range, int sent,
                                         int cw, void* ck, void* cc,
                                         void* runs, void* mcnt, void* cp,
                                         void* stream, void* marks) {
    if (cw < 1 || SW < 1 || range < 1
        || (mpay != nullptr && (mcnt == nullptr || cp == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (R <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    cudaEvent_t* ev = (cudaEvent_t*)marks;
    const size_t smem = (size_t)range * sizeof(int32_t);
    const cudaError_t e = cudaFuncSetAttribute(
        reads_pre_hist_kernel<kHistThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (ev) cudaEventRecord(ev[0], st);
    reads_pre_hist_kernel<kHistThreads><<<R, kHistThreads, smem, st>>>(
        (const int32_t*)skey, (const int32_t*)mpay, SW, range, sent, cw,
        (int32_t*)ck, (int32_t*)cc, (int32_t*)runs, (int32_t*)mcnt,
        (int32_t*)cp);
    if (ev) cudaEventRecord(ev[1], st);
    return (int)cudaGetLastError();
}

extern "C" int kasa_turbo_reads_pre_long(const void* skey,
                                         const void* mpay, int R, int SW,
                                         int sent, int cw, void* scr_a,
                                         void* scr_b, void* ck, void* cc,
                                         void* runs, void* mcnt, void* cp,
                                         void* stream, void* marks) {
    // scr_a, scr_b: (R, SW) int32 scratch of the four digit passes;
    // marks as above
    if (cw < 1 || SW < 1
        || (mpay != nullptr && (mcnt == nullptr || cp == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (R > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        cudaEvent_t* ev = (cudaEvent_t*)marks;
        if (ev) cudaEventRecord(ev[0], st);
        const int cols[4] = {0, 0, 0, 0}, shifts[4] = {0, 8, 16, 24};
        const int32_t* srt = seg_radix_sort<1>(
            (const int32_t*)skey, (int32_t*)scr_a, (int32_t*)scr_b, R, SW,
            cols, shifts, 4, st);
        reads_pre_long_kernel<<<R, kThreads, 0, st>>>(
            srt, (const int32_t*)mpay, SW, sent, cw, (int32_t*)ck,
            (int32_t*)cc, (int32_t*)runs, (int32_t*)mcnt, (int32_t*)cp);
        if (ev) cudaEventRecord(ev[1], st);
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
                                     void* cum, void* packed, void* stream,
                                     void* marks) {
    if (wout < 1 || wm < 1
        || ((wout > kListMax || wm > kListMax) && lscr == nullptr)
        || (dm == nullptr && (wm > kThreads || mlk == nullptr
                              || mlv == nullptr || mof == nullptr))
        || (ncadd > 0 && cadd == nullptr))
        return (int)cudaErrorInvalidValue;
    if (R > 0) {
        // marks: null, or four events recorded before the post kernel
        // and after it, the hit-count scan and the CSR scatter
        cudaStream_t st = (cudaStream_t)stream;
        cudaEvent_t* ev = (cudaEvent_t*)marks;
        if (ev) cudaEventRecord(ev[0], st);
        reads_post_kernel<<<R, kThreads, 0, st>>>(
            (const int32_t*)ck, (const int32_t*)cc, (const uint8_t*)ofc,
            (const float*)dm, (const int32_t*)mlk, (const float*)mlv,
            (const uint8_t*)mof, (const float*)weights,
            (const int32_t*)file_of_read, (float*)acc_ca,
            (int32_t*)acc_cu, S, num_k, cw, sent, wout, wm, additive,
            (wout > kListMax || wm > kListMax) ? (int32_t*)lscr : nullptr,
            (int32_t*)ht, (float*)hk, (int32_t*)hc, (int32_t*)flags);
        if (ev) cudaEventRecord(ev[1], st);
        int32_t* tail = (int32_t*)packed + 2LL * R + 2LL * cap;
        pack_scan_kernel<<<1, kScanThreads, 0, st>>>(
            (const int32_t*)hc, (const int32_t*)flags, (const int32_t*)diag,
            R, (const float*)cadd, ncadd, (float*)acc_ca, (int32_t*)cum,
            tail);
        if (ev) cudaEventRecord(ev[2], st);
        pack_scatter_kernel<<<R, 128, 0, st>>>(
            (const int32_t*)hc, (const int32_t*)flags, (const int32_t*)cum,
            (const int32_t*)ht, (const float*)hk, R, wout, cap,
            (int32_t*)packed);
        if (ev) cudaEventRecord(ev[3], st);
    }
    return (int)cudaGetLastError();
}
