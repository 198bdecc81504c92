/* Sequential R-process peeling decoder (host-side hot loop).
 *
 * The one-peel-at-a-time trajectory semantics of the reference
 * (peeling_decoder.py:47-82): repeatedly pick a uniformly random degree-1
 * check, resolve its unique unresolved variable, and record the number of
 * degree-1 checks before each peel.  The trajectory is the statistic of
 * interest (the R-process of finite-length scaling theory), so the loop is
 * inherently sequential per trial -- a poor fit for an accelerator, hence native.
 *
 * Unlike the reference's O(n * m) re-strip per peel, this maintains check
 * degrees and the degree-1 set incrementally: O(E) per trial total.  The
 * full residual check-degree histogram is maintained the same way, so
 * sampling it at requested times is O(dc) per sample -- the data feeding
 * the degree-distribution-vs-expm validation
 * (test_peeling_decoder_path.py:96-116).
 *
 * Randomness: xorshift64* seeded per trial from (seed, trial) -- fully
 * reproducible, unlike the reference's srand(time(NULL))
 * (random_code_generator.c:23).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint64_t xs64(uint64_t *s) {
    uint64_t x = *s;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    *s = x;
    return x * 0x2545F4914F6CDD1DULL;
}

/* Unbiased uniform integer in [0, bound) by rejection. */
static inline uint32_t xs64_below(uint64_t *s, uint32_t bound) {
    uint64_t r, lim = UINT64_MAX - (UINT64_MAX % bound);
    do { r = xs64(s); } while (r >= lim);
    return (uint32_t)(r % bound);
}

/* Workspace shared across trials (allocated once per batch call). */
typedef struct {
    int32_t *deg;   /* [m] residual degree per check */
    int32_t *ones;  /* [m] compact degree-1 set */
    int32_t *pos;   /* [m] position of each check in `ones`, -1 if absent */
    int32_t *hist;  /* [dc+1] residual checks by degree */
} peel_ws;

/* One trial.  `evo`/`max_evo` record the degree-1 counts before each peel
 * (NULL to skip).  `sample_u`/`num_samples`/`hist_out` record the residual
 * check-degree histogram [0..dc] whenever the unresolved-variable count
 * first equals sample_u[j] (sample_u strictly descending; entries never
 * reached are filled with -1; NULL to skip).  Returns peel steps done
 * (before the reference's final 0-append).
 *
 * Irregular codes (per-node degrees) use the phantom-padding convention
 * of models/irregular.py: dv/dc are dv_max/dc_max, chk_to_var rows are
 * padded with the phantom variable index n (never erased, contributes no
 * degree) and var_to_chk rows with the phantom check index m (skipped in
 * the decrement loop).  The guards never fire on unpadded regular
 * tables, so the regular path -- including its RNG stream -- is
 * bit-identical to before. */
static int32_t peel_one(const int32_t *chk_to_var, const int32_t *var_to_chk,
                        int32_t n, int32_t m, int32_t dv, int32_t dc,
                        const uint8_t *er, uint64_t rng, peel_ws *ws,
                        uint8_t *un, int32_t *evo, int32_t max_evo,
                        const int32_t *sample_u, int32_t num_samples,
                        int32_t *hist_out, int32_t *erasures_out) {
    int32_t *deg = ws->deg, *ones = ws->ones, *pos = ws->pos;
    int32_t *hist = ws->hist;

    memcpy(un, er, (size_t)n);
    int32_t erasures = 0;
    for (int32_t v = 0; v < n; ++v) erasures += er[v];
    *erasures_out = erasures;

    /* initial degrees, degree-1 set, degree histogram */
    int32_t ones_count = 0;
    memset(hist, 0, (size_t)(dc + 1) * sizeof(int32_t));
    for (int32_t c = 0; c < m; ++c) {
        int32_t d = 0;
        const int32_t *row = chk_to_var + (size_t)c * dc;
        for (int32_t j = 0; j < dc; ++j)
            if (row[j] < n) d += un[row[j]];
        deg[c] = d;
        ++hist[d];
        pos[c] = -1;
        if (d == 1) {
            pos[c] = ones_count;
            ones[ones_count++] = c;
        }
    }

    int32_t si = 0;                    /* next sample index */
    int32_t unresolved = erasures;
    if (sample_u) {
        while (si < num_samples && sample_u[si] > unresolved) {
            for (int32_t d = 0; d <= dc; ++d)
                hist_out[(size_t)si * (dc + 1) + d] = -1;
            ++si;
        }
        if (si < num_samples && sample_u[si] == unresolved) {
            memcpy(hist_out + (size_t)si * (dc + 1), hist,
                   (size_t)(dc + 1) * sizeof(int32_t));
            ++si;
        }
    }

    int32_t steps = 0;
    while (ones_count > 0 && (!evo || steps < max_evo - 1)) {
        if (evo) evo[steps] = ones_count;
        int32_t c = ones[xs64_below(&rng, (uint32_t)ones_count)];
        /* unique unresolved participant of c */
        const int32_t *row = chk_to_var + (size_t)c * dc;
        int32_t v = -1;
        for (int32_t j = 0; j < dc; ++j)
            if (row[j] < n && un[row[j]]) { v = row[j]; break; }
        un[v] = 0;
        /* update degrees of v's checks; maintain set + histogram */
        const int32_t *vcs = var_to_chk + (size_t)v * dv;
        for (int32_t p = 0; p < dv; ++p) {
            int32_t c2 = vcs[p];
            if (c2 >= m) continue;     /* phantom-check padding */
            int32_t old = deg[c2]--;
            --hist[old];
            ++hist[old - 1];
            if (old == 2) {            /* becomes degree 1: insert */
                pos[c2] = ones_count;
                ones[ones_count++] = c2;
            } else if (old == 1) {     /* leaves the set: swap-remove */
                int32_t i = pos[c2];
                int32_t last = ones[--ones_count];
                ones[i] = last;
                pos[last] = i;
                pos[c2] = -1;
            }
        }
        ++steps;
        --unresolved;
        if (sample_u && si < num_samples && sample_u[si] == unresolved) {
            memcpy(hist_out + (size_t)si * (dc + 1), hist,
                   (size_t)(dc + 1) * sizeof(int32_t));
            ++si;
        }
    }
    if (sample_u)                      /* stalled before remaining samples */
        for (; si < num_samples; ++si)
            for (int32_t d = 0; d <= dc; ++d)
                hist_out[(size_t)si * (dc + 1) + d] = -1;
    return steps;
}

static uint64_t trial_rng(uint64_t seed, int32_t t) {
    uint64_t rng = seed ^ (0x9E3779B97F4A7C15ULL * (uint64_t)(t + 1));
    if (!rng) rng = 0xD1B54A32D192ED03ULL; /* xorshift fixed point 0 */
    xs64(&rng); /* scramble the seed mix */
    return rng;
}

static int ws_alloc(peel_ws *ws, int32_t m, int32_t dc) {
    ws->deg = (int32_t *)malloc((size_t)m * sizeof(int32_t));
    ws->ones = (int32_t *)malloc((size_t)m * sizeof(int32_t));
    ws->pos = (int32_t *)malloc((size_t)m * sizeof(int32_t));
    ws->hist = (int32_t *)malloc((size_t)(dc + 1) * sizeof(int32_t));
    if (!ws->deg || !ws->ones || !ws->pos || !ws->hist) {
        free(ws->deg); free(ws->ones); free(ws->pos); free(ws->hist);
        return -1;
    }
    return 0;
}

static void ws_free(peel_ws *ws) {
    free(ws->deg); free(ws->ones); free(ws->pos); free(ws->hist);
}

/* Decode `trials` erasure patterns over one code.
 *
 * chk_to_var: [m*dc] variable index per check socket
 * var_to_chk: [n*dv] check index per variable socket
 * erased:     [trials*n] 1 = erased
 * unresolved_out: [trials*n] final unresolved mask
 * evolution_out:  [trials*max_evo] degree-1 counts before each peel,
 *                 final 0 appended on success, -1 padded
 * steps_out, num_erasures_out: [trials]
 * Returns 0 on success, -1 on bad arguments.
 */
int peel_decode_trials(const int32_t *chk_to_var, const int32_t *var_to_chk,
                       int32_t n, int32_t m, int32_t dv, int32_t dc,
                       const uint8_t *erased, int32_t trials, uint64_t seed,
                       uint8_t *unresolved_out, int32_t *evolution_out,
                       int32_t max_evo, int32_t *steps_out,
                       int32_t *num_erasures_out) {
    if (n <= 0 || m <= 0 || dv <= 0 || dc <= 0 || trials < 0 ||
        max_evo < 2)
        return -1;
    peel_ws ws;
    if (ws_alloc(&ws, m, dc)) return -1;

    for (int32_t t = 0; t < trials; ++t) {
        const uint8_t *er = erased + (size_t)t * n;
        uint8_t *un = unresolved_out + (size_t)t * n;
        int32_t *evo = evolution_out + (size_t)t * max_evo;
        int32_t erasures;
        int32_t steps = peel_one(chk_to_var, var_to_chk, n, m, dv, dc, er,
                                 trial_rng(seed, t), &ws, un, evo, max_evo,
                                 NULL, 0, NULL, &erasures);
        num_erasures_out[t] = erasures;

        int32_t remaining = 0;
        for (int32_t v = 0; v < n; ++v) remaining += un[v];
        if (remaining == 0 && steps < max_evo) {
            evo[steps] = 0; /* reference's final append,
                               peeling_decoder.py:79-80 */
            ++steps;
        }
        steps_out[t] = steps;
        for (int32_t i = steps; i < max_evo; ++i) evo[i] = -1;
    }

    ws_free(&ws);
    return 0;
}

/* Peel `trials` patterns recording residual check-degree histograms.
 *
 * sample_u: [num_samples] strictly-descending unresolved-variable counts
 *           at which to snapshot the histogram (u = n*(1 - t) in the
 *           theory's time units).
 * hist_out: [trials * num_samples * (dc+1)] counts of residual checks by
 *           degree 0..dc at each snapshot; rows never reached (trial had
 *           fewer erasures, or stalled first) are -1-filled.
 * unresolved_out / steps_out / num_erasures_out: as peel_decode_trials
 * (the RNG stream matches peel_decode_trials for equal (seed, trial), so
 * both functions walk identical peeling orders).
 * Returns 0 on success, -1 on bad arguments.
 */
int peel_decode_trials_hist(const int32_t *chk_to_var,
                            const int32_t *var_to_chk,
                            int32_t n, int32_t m, int32_t dv, int32_t dc,
                            const uint8_t *erased, int32_t trials,
                            uint64_t seed, const int32_t *sample_u,
                            int32_t num_samples, int32_t *hist_out,
                            uint8_t *unresolved_out, int32_t *steps_out,
                            int32_t *num_erasures_out) {
    if (n <= 0 || m <= 0 || dv <= 0 || dc <= 0 || trials < 0 ||
        num_samples < 0)
        return -1;
    for (int32_t j = 1; j < num_samples; ++j)
        if (sample_u[j] >= sample_u[j - 1]) return -1;
    peel_ws ws;
    if (ws_alloc(&ws, m, dc)) return -1;

    for (int32_t t = 0; t < trials; ++t) {
        const uint8_t *er = erased + (size_t)t * n;
        uint8_t *un = unresolved_out + (size_t)t * n;
        int32_t *hist = hist_out + (size_t)t * num_samples * (dc + 1);
        int32_t erasures;
        steps_out[t] = peel_one(chk_to_var, var_to_chk, n, m, dv, dc, er,
                                trial_rng(seed, t), &ws, un, NULL, 0,
                                sample_u, num_samples, hist, &erasures);
        num_erasures_out[t] = erasures;
    }

    ws_free(&ws);
    return 0;
}
