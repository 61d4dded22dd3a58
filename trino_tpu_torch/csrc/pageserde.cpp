// The page codec of serde.py: LZ4 block codec, xxHash64 and the FNV-1a
// value hashes of a dictionary's strings (stage/repartition.py).
//
// The same from-scratch implementations of the public formats (LZ4
// block format spec, xxHash64 spec) as the JAX package's page codec, so
// the two packages write the same frame bytes; built at first use by
// ops/native.py with the host's C++ compiler and loaded through ctypes.
//
// Exported C ABI:
//   int64_t tt_lz4_compress(const uint8_t*, int64_t, uint8_t*, int64_t)
//   int64_t tt_lz4_decompress(const uint8_t*, int64_t, uint8_t*, int64_t)
//   uint64_t tt_xxh64(const uint8_t*, int64_t, uint64_t)
//   int64_t tt_lz4_max_compressed(int64_t)
//   void tt_fnv1a64_many(const uint8_t*, const int64_t*, int64_t,
//                        uint64_t*)

#include <cstdint>
#include <cstring>

extern "C" {

int64_t tt_lz4_max_compressed(int64_t n) {
    return n + n / 255 + 16;
}

// ---------------------------------------------------------------------
// LZ4 block compressor (greedy, 16-bit hash chain-less table)
// ---------------------------------------------------------------------

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> 16;   // 16-bit table index
}

int64_t tt_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
    if (n < 0 || cap < tt_lz4_max_compressed(n)) return -1;
    uint8_t* op = dst;
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    // matches must end >= 12 bytes before the end; last 5 bytes literal
    const uint8_t* const mlimit = iend - 12;
    const uint8_t* anchor = ip;

    int32_t table[1 << 16];
    for (int i = 0; i < (1 << 16); i++) table[i] = -1;

    if (n >= 13) {
        ip++;  // first byte can't be a match target
        while (ip <= mlimit) {
            uint32_t h = hash4(read32(ip));
            int32_t cand = table[h];
            table[h] = (int32_t)(ip - src);
            if (cand >= 0 && (ip - src) - cand <= 65535 &&
                read32(src + cand) == read32(ip)) {
                // extend the match forward
                const uint8_t* match = src + cand;
                const uint8_t* mip = ip + 4;
                const uint8_t* mm = match + 4;
                while (mip < iend - 5 && *mip == *mm) { mip++; mm++; }
                int64_t mlen = mip - ip;           // >= 4
                int64_t litlen = ip - anchor;
                // token
                uint8_t* token = op++;
                if (litlen >= 15) {
                    *token = 15 << 4;
                    int64_t rest = litlen - 15;
                    while (rest >= 255) { *op++ = 255; rest -= 255; }
                    *op++ = (uint8_t)rest;
                } else {
                    *token = (uint8_t)(litlen << 4);
                }
                std::memcpy(op, anchor, litlen);
                op += litlen;
                // offset
                uint16_t off = (uint16_t)(ip - match);
                *op++ = (uint8_t)(off & 0xff);
                *op++ = (uint8_t)(off >> 8);
                int64_t mrest = mlen - 4;
                if (mrest >= 15) {
                    *token |= 15;
                    mrest -= 15;
                    while (mrest >= 255) { *op++ = 255; mrest -= 255; }
                    *op++ = (uint8_t)mrest;
                } else {
                    *token |= (uint8_t)mrest;
                }
                ip += mlen;
                anchor = ip;
            } else {
                ip++;
            }
        }
    }
    // trailing literals
    int64_t litlen = iend - anchor;
    uint8_t* token = op++;
    if (litlen >= 15) {
        *token = 15 << 4;
        int64_t rest = litlen - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
    } else {
        *token = (uint8_t)(litlen << 4);
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
    return op - dst;
}

int64_t tt_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* const iend = src + n;
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                litlen += b;
            } while (b == 255);
        }
        if (ip + litlen > iend || op + litlen > oend) return -1;
        std::memcpy(op, ip, litlen);
        ip += litlen;
        op += litlen;
        if (ip >= iend) break;   // last sequence has no match
        if (ip + 2 > iend) return -1;
        uint16_t off = (uint16_t)(ip[0] | (ip[1] << 8));
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - off;
        // overlapping copy must run byte-wise
        for (int64_t i = 0; i < mlen; i++) op[i] = match[i];
        op += mlen;
    }
    return op - dst;
}

// ---------------------------------------------------------------------
// xxHash64 (spec-faithful)
// ---------------------------------------------------------------------

static const uint64_t P1 = 11400714785074694791ull;
static const uint64_t P2 = 14029467366897019727ull;
static const uint64_t P3 = 1609587929392839161ull;
static const uint64_t P4 = 9650029242287828579ull;
static const uint64_t P5 = 2870177450012600261ull;

static inline uint64_t rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline uint64_t round1(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl(acc, 31);
    return acc * P1;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
    acc ^= round1(0, val);
    return acc * P1 + P4;
}

uint64_t tt_xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
    const uint8_t* const end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed,
                 v4 = seed - P1;
        const uint8_t* const limit = end - 32;
        do {
            v1 = round1(v1, read64(p)); p += 8;
            v2 = round1(v2, read64(p)); p += 8;
            v3 = round1(v3, read64(p)); p += 8;
            v4 = round1(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge_round(h, v1);
        h = merge_round(h, v2);
        h = merge_round(h, v3);
        h = merge_round(h, v4);
    } else {
        h = seed + P5;
    }
    h += (uint64_t)len;
    while (p + 8 <= end) {
        h ^= round1(0, read64(p));
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        uint32_t v;
        std::memcpy(&v, p, 4);
        h ^= (uint64_t)v * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl(h, 11) * P1;
        p++;
    }
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------------
// FNV-1a 64 of many byte strings: string i is buf[offs[i], offs[i+1])
// ---------------------------------------------------------------------

void tt_fnv1a64_many(const uint8_t* buf, const int64_t* offs, int64_t n,
                     uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = 0xCBF29CE484222325ull;
        for (int64_t j = offs[i]; j < offs[i + 1]; j++) {
            h = (h ^ buf[j]) * 0x100000001B3ull;
        }
        out[i] = h;
    }
}

}  // extern "C"
