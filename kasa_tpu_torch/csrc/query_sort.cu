// K12 query_sort: the join engine's sort of a batch's windows.
//
// Replaces kasa_tpu/match/join.py:225 sort_queries, a device lax.sort of
// the (M, L) int32 query limbs with the read id as payload (num_keys=L,
// not stable).  K12 sorts by (limbs..., read id), so the order among
// equal windows is fixed: a stable LSD radix sort over 8-bit digits, the
// read id's low rid_bits first, then limbs L-1 .. 0 (four digits of each
// non-negative 30-bit limb).  The passes are radix.cuh's
// rows_radix_sort (three launches each: hist, scan, scatter), which
// K13 sort_dedup shares.
//
// Bound on the H100: bytes.  Every pass reads the elements twice (hist,
// scatter) and writes them once, 4 (L + 1) bytes each, and the scatter's
// writes go to 256 streams per block; the least the function must move
// is its input and its output once.
#include "radix.cuh"

extern "C" int kasa_query_sort(
        const void* q, const void* rid, void* qa, void* ra, void* qb,
        void* rb, void* hist, long long M, int L, int rid_bits,
        void* stream) {
    // hist holds 256 * blocks + 256 int32: the rows, then the digits'
    // totals, which bases_kernel turns into their starts
    if (L < 1 || L > 5 || rid_bits < 0 || rid_bits > 31 || M < 0
            || M >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return (int)cudaGetLastError();
    const int err = rows_radix_sort(
        (const int32_t*)q, (const int32_t*)rid, (int32_t*)qa, (int32_t*)ra,
        (int32_t*)qb, (int32_t*)rb, (int32_t*)hist, M, L, rid_bits,
        (cudaStream_t)stream);
    return err != 0 ? err : (int)cudaGetLastError();
}
