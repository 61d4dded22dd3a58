/* The sequential walk of a Parquet PLAIN BYTE_ARRAY page: n values, each
 * a 4-byte little-endian length followed by that many bytes. Where a
 * value starts depends on every length before it, so the walk is a loop;
 * it runs here, on the host, once per page (formats/parquet.py through
 * ctypes). */

#include <stdint.h>

/* Writes each value's start (an offset into buf) and length. Returns the
 * bytes consumed, or -1 when a length or a value runs past the buffer. */
int64_t byte_array_walk(const uint8_t *buf, int64_t size, int64_t n,
                        int64_t *starts, int64_t *lengths) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; i++) {
        if (pos + 4 > size)
            return -1;
        uint32_t len = (uint32_t)buf[pos] | ((uint32_t)buf[pos + 1] << 8)
            | ((uint32_t)buf[pos + 2] << 16)
            | ((uint32_t)buf[pos + 3] << 24);
        pos += 4;
        if ((int64_t)len > size - pos)
            return -1;
        starts[i] = pos;
        lengths[i] = (int64_t)len;
        pos += len;
    }
    return pos;
}
