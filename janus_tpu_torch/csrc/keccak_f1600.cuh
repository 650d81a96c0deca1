// Keccak-f[1600] on one state held in 25 uint64 registers.
//
// Shared by keccak.cu (single-block permutation) and expand_f128.cu
// (fused counter-mode expansion). Lane (x, y) sits at index x + 5*y, as
// in the JAX package's keccak_jax.py. Every loop over lanes is unrolled,
// so the arrays below are registers; each 64-bit rotation by a constant
// compiles to a pair of 32-bit funnel shifts.
#pragma once

#include <stdint.h>

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
    return r == 0 ? x : (x << r) | (x >> (64 - r));
}

// The first `rounds` rounds of Keccak-f[1600] (24 in production; fewer
// only where a test holds a reduced-round run against the plain version).
__device__ __forceinline__ void keccak_f1600(uint64_t a[25], int rounds) {
    for (int rnd = 0; rnd < rounds; ++rnd) {
        uint64_t c[5], d[5], b[25];
        // theta
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
        for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
        // rho + pi: b[y + 5*((2x + 3y) % 5)] = rot(a[x + 5y], r[x][y])
        b[0] = a[0];
        b[1] = rotl64(a[6], 44);
        b[2] = rotl64(a[12], 43);
        b[3] = rotl64(a[18], 21);
        b[4] = rotl64(a[24], 14);
        b[5] = rotl64(a[3], 28);
        b[6] = rotl64(a[9], 20);
        b[7] = rotl64(a[10], 3);
        b[8] = rotl64(a[16], 45);
        b[9] = rotl64(a[22], 61);
        b[10] = rotl64(a[1], 1);
        b[11] = rotl64(a[7], 6);
        b[12] = rotl64(a[13], 25);
        b[13] = rotl64(a[19], 8);
        b[14] = rotl64(a[20], 18);
        b[15] = rotl64(a[4], 27);
        b[16] = rotl64(a[5], 36);
        b[17] = rotl64(a[11], 10);
        b[18] = rotl64(a[17], 15);
        b[19] = rotl64(a[23], 56);
        b[20] = rotl64(a[2], 62);
        b[21] = rotl64(a[8], 55);
        b[22] = rotl64(a[14], 39);
        b[23] = rotl64(a[15], 41);
        b[24] = rotl64(a[21], 2);
        // chi
#pragma unroll
        for (int y = 0; y < 5; ++y) {
#pragma unroll
            for (int x = 0; x < 5; ++x) {
                a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
            }
        }
        // iota
        a[0] ^= KECCAK_RC[rnd];
    }
}
