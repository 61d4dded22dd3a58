/* Greedy closest-pair merging of sorted centroids, for ops/digest.py.
 *
 * The same algorithm as the JAX package's python loop
 * (trino_tpu/ops/digest.py, _compress), step for step: a
 * binary min-heap of (gap, i, j) entries ordered as python orders the
 * tuples, stale entries skipped when popped, the merged mean computed as
 * (x[i] * w[i] + x[j] * w[j]) / (w[i] + w[j]) in IEEE doubles. Built
 * without floating-point contraction, it gives the python loop's
 * centroids bit for bit, without the interpreter's cost per heap entry.
 *
 *   int64_t digest_compress(double *x, double *w, int64_t n, int64_t budget)
 *
 * x (ascending) and w are updated in place; the surviving centroids are
 * moved to the front and their count returned. Returns -1 when memory
 * runs out.
 */
#include <stdint.h>
#include <stdlib.h>

typedef struct {
    double g;
    int64_t i, j;
} entry;

static int before(const entry *a, const entry *b) {
    if (a->g != b->g) return a->g < b->g;
    if (a->i != b->i) return a->i < b->i;
    return a->j < b->j;
}

static void sift_up(entry *h, int64_t k) {
    entry e = h[k];
    while (k > 0) {
        int64_t p = (k - 1) / 2;
        if (!before(&e, &h[p])) break;
        h[k] = h[p];
        k = p;
    }
    h[k] = e;
}

static void sift_down(entry *h, int64_t n, int64_t k) {
    entry e = h[k];
    for (;;) {
        int64_t c = 2 * k + 1;
        if (c >= n) break;
        if (c + 1 < n && before(&h[c + 1], &h[c])) c++;
        if (!before(&h[c], &e)) break;
        h[k] = h[c];
        k = c;
    }
    h[k] = e;
}

int64_t digest_compress(double *x, double *w, int64_t n, int64_t budget) {
    if (n <= budget) return n;
    int64_t *prev = malloc(n * sizeof(int64_t));
    int64_t *nxt = malloc(n * sizeof(int64_t));
    char *alive = malloc(n);
    entry *heap = malloc(3 * n * sizeof(entry));
    if (!prev || !nxt || !alive || !heap) {
        free(prev); free(nxt); free(alive); free(heap);
        return -1;
    }
    int64_t size = 0;
    for (int64_t k = 0; k < n; k++) {
        prev[k] = k - 1;
        nxt[k] = k + 1;
        alive[k] = 1;
    }
    for (int64_t k = 0; k + 1 < n; k++) {
        heap[size].g = x[k + 1] - x[k];
        heap[size].i = k;
        heap[size].j = k + 1;
        size++;
    }
    for (int64_t k = size / 2 - 1; k >= 0; k--) sift_down(heap, size, k);
    int64_t remaining = n;
    while (remaining > budget && size > 0) {
        entry top = heap[0];
        heap[0] = heap[--size];
        if (size > 0) sift_down(heap, size, 0);
        int64_t i = top.i, j = top.j;
        if (!(alive[i] && alive[j]) || nxt[i] != j) continue;
        double tot = w[i] + w[j];
        x[i] = (x[i] * w[i] + x[j] * w[j]) / tot;
        w[i] = tot;
        alive[j] = 0;
        nxt[i] = nxt[j];
        if (nxt[i] < n) {
            prev[nxt[i]] = i;
            heap[size].g = x[nxt[i]] - x[i];
            heap[size].i = i;
            heap[size].j = nxt[i];
            sift_up(heap, size++);
        }
        if (prev[i] >= 0) {
            heap[size].g = x[i] - x[prev[i]];
            heap[size].i = prev[i];
            heap[size].j = i;
            sift_up(heap, size++);
        }
        remaining--;
    }
    int64_t out = 0;
    for (int64_t k = 0; k < n; k++) {
        if (alive[k]) {
            x[out] = x[k];
            w[out] = w[k];
            out++;
        }
    }
    free(prev); free(nxt); free(alive); free(heap);
    return out;
}
