// K12 query_sort: the join engine's sort of a batch's windows.
//
// Replaces kasa_tpu/match/join.py:225 sort_queries, a device lax.sort of
// the (M, L) int32 query limbs with the read id as payload (num_keys=L,
// not stable).  K12 sorts by (limbs..., read id), so the order among
// equal windows is fixed: radix.cuh's rows_radix_sort, a stable one-sweep
// LSD radix sort (one histogram launch, then one launch per digit pass),
// over the read id's low rid_bits bits, then limbs L-1 .. 0 (each a
// non-negative 30-bit value).  The join path hands over windows whose
// read ids already ascend, so it asks for rid_bits = 0: the stable sort
// over the limbs alone keeps them in (limbs, read id) order.  K13
// sort_dedup shares the passes.
//
// Bound on the H100: bytes.  The least the function moves is its input
// and its output once, 4 (L + 1) bytes a window each way; every pass
// reads and writes them once more, and the histogram launch reads them
// once.
#include "radix.cuh"

// -> the number of digit passes of a sort of (M, L) rows over rid_bits
// bits of the payload; *scratch_words: the int32 words its scratch holds
extern "C" int kasa_query_sort_plan(long long M, int L, int rid_bits,
                                    long long* scratch_words) {
    *scratch_words = rows_radix_scratch_words(M, L);
    return rows_radix_passes(L, rid_bits);
}

extern "C" int kasa_query_sort(
        const void* q, const void* rid, void* qa, void* ra, void* qb,
        void* rb, void* scratch, long long M, int L, int rid_bits,
        void* stream, void* marks) {
    // scratch: kasa_query_sort_plan's words; the sorted rows land in
    // (qa, ra) when the pass count is odd, else in (qb, rb); marks: null,
    // or passes + 2 events to time the stages (rows_radix_sort)
    if (L < 1 || L > 5 || rid_bits < 0 || rid_bits > 31 || M < 0
            || M >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return (int)cudaGetLastError();
    const int err = rows_radix_sort(
        (const int32_t*)q, (const int32_t*)rid, (int32_t*)qa, (int32_t*)ra,
        (int32_t*)qb, (int32_t*)rb, (int32_t*)scratch, M, L, rid_bits,
        (cudaStream_t)stream, (cudaEvent_t*)marks);
    return err != 0 ? err : (int)cudaGetLastError();
}
