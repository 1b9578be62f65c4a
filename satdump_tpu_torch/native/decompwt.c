/* EUMETSAT HRIT wavelet (WT) image codec: S+P integer wavelet + adaptive
 * arithmetic coding — decoder AND encoder, implemented from scratch.
 *
 * This is the compression used for MSG SEVIRI / FY-2 HRIT image segments
 * ("DecompWT"). Behavioral reference: the reference vendors EUMETSAT's
 * PublicDecompWT (plugins/xrit_support/DecompWT: CWTDecoder.cpp,
 * CVLCDecoder.cpp, CACDecoder.*, CWBlock.cpp); this file re-implements the
 * documented algorithm — Said-Pearlman S+P transform (predictors none/A/B/C),
 * per-quadrant VLC magnitudes with contextual adaptive models, a 31-bit
 * Witten-Neal-Cleary arithmetic coder, FF->FF00 byte stuffing and
 * FF01/FF02/FF03/FFE0+k markers — with its own flat-C structure (explicit
 * index arithmetic instead of pointer walks, a segment pre-scan instead of
 * a 40-bit lookahead pipeline). The encoder exists so decode can be
 * round-trip tested without real EUMETSAT segments, and mirrors the
 * format exactly (markers, header bits, restart intervals, model resets).
 *
 * Bitstream layout (after CWTDecoder::DecodeBuffer / CWTCoder::CodeBuffer*):
 *   FF01 | bpp:4 w:16 h:16 (levels-3):2 pred:2 blockmode:2 restart:16
 *        lossy:4 pad:2 | FF02 | AC data [FFE0+k ...] | FF03
 * Header bits are raw; everything between FF02 and FF03 is byte-stuffed.
 *
 * The PyTorch port's copy of satdump_tpu/native/decompwt.c, hardened for
 * payloads that came over a radio link: a magnitude class that leaves the
 * arithmetic decoder no interval (range 0, once a division by zero) and a
 * DC class above AC_BITS - 2 are decode failures, which the restart-marker
 * resync then handles like any other damaged block. Valid streams decode
 * exactly as in the original.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ const */
#define AC_BITS 31u
#define AC_TOP ((1ul << AC_BITS) - 1ul)
#define AC_QTR (1ul << (AC_BITS - 2))
#define AC_HALF (AC_QTR << 1)
#define AC_MAXFREQ (AC_QTR - 1ul)

#define MK_HEADER 0xFF01
#define MK_DATA 0xFF02
#define MK_FOOTER 0xFF03
#define MK_RESTART 0xFFE0

static int csize(int32_t c) { /* bits to express |c|; csize(0)=0 */
    uint32_t v = (uint32_t)(c < 0 ? -c : c);
    int n = 0;
    while (v) { n++; v >>= 1; }
    return n;
}

/* ------------------------------------------------------- bit writer (enc) */
typedef struct {
    uint8_t *buf;
    size_t cap, len;
    uint32_t acc; /* partial byte, LSB-aligned */
    int nacc;     /* bits in acc (0..7)        */
} BW;

static void bw_byte_raw(BW *w, uint8_t b) {
    if (w->len < w->cap) w->buf[w->len] = b;
    w->len++;
}

static void bw_byte(BW *w, uint8_t b) { /* with FF -> FF00 stuffing */
    bw_byte_raw(w, b);
    if (b == 0xFF) bw_byte_raw(w, 0x00);
}

static void bw_bits_(BW *w, uint32_t v, int n, int stuffed) {
    while (n > 0) {
        int take = 8 - w->nacc;
        if (take > n) take = n;
        w->acc = (w->acc << take) | ((v >> (n - take)) & ((1u << take) - 1u));
        w->nacc += take;
        n -= take;
        if (w->nacc == 8) {
            if (stuffed) bw_byte(w, (uint8_t)w->acc);
            else bw_byte_raw(w, (uint8_t)w->acc);
            w->acc = 0;
            w->nacc = 0;
        }
    }
}

static void bw_align(BW *w) { /* pad partial byte with 1-bits (stuffed) */
    if (w->nacc) {
        uint8_t b = (uint8_t)((w->acc << (8 - w->nacc))
                              | ((1u << (8 - w->nacc)) - 1u));
        bw_byte(w, b);
        w->acc = 0;
        w->nacc = 0;
    }
}

static void bw_marker(BW *w, uint16_t code) {
    bw_align(w);
    bw_byte_raw(w, (uint8_t)(code >> 8));
    bw_byte_raw(w, (uint8_t)code);
}

/* ------------------------------------------------------- bit reader (dec) */
typedef struct {
    const uint8_t *d;
    size_t n;
    size_t i;      /* next raw byte to fetch                    */
    int skip0;     /* previous delivered byte was FF: skip a 00 */
    uint32_t acc;  /* fetched bits, MSB-first                   */
    int nacc;
    int marker;    /* stopped at a marker                       */
    size_t mkpos;  /* raw index of that marker's FF             */
    int ended;
} BR;

/* deliver the next logical (unstuffed) byte into acc; 0 if a marker starts */
static int br_fetch(BR *r) {
    if (r->marker) return 0;
    if (r->skip0) { r->i++; r->skip0 = 0; }
    if (r->i >= r->n) { /* past end: zeros (reference pads 4 zero bytes) */
        if (r->i >= r->n + 4) { r->ended = 1; }
        r->i++;
        r->acc = (r->acc << 8);
        r->nacc += 8;
        return 1;
    }
    uint8_t b = r->d[r->i];
    if (b == 0xFF && r->i + 1 < r->n && r->d[r->i + 1] != 0x00) {
        r->marker = 1; /* this FF begins a marker: do not consume */
        r->mkpos = r->i;
        return 0;
    }
    if (b == 0xFF) r->skip0 = 1; /* FF 00 -> logical FF */
    r->i++;
    r->acc = (r->acc << 8) | b;
    r->nacc += 8;
    return 1;
}

/* read n (<=24) bits; on marker: set *hit and return 0 (reference InputBits) */
static uint32_t br_bits(BR *r, int n, int *hit) {
    while (r->nacc < n)
        if (!br_fetch(r)) { *hit = 1; return 0; }
    uint32_t v = (r->acc >> (r->nacc - n)) & ((1u << n) - 1u);
    r->nacc -= n;
    return v;
}

static uint32_t br_bits32(BR *r, int n, int *hit) { /* n up to 31 */
    if (n <= 24) return br_bits(r, n, hit);
    uint32_t hi = br_bits(r, n - 16, hit);
    if (*hit) return 0;
    uint32_t lo = br_bits(r, 16, hit);
    return (hi << 16) | lo;
}

static void br_align(BR *r) { r->nacc -= (r->nacc & 7); }

/* raw position of the next unconsumed logical byte (only valid aligned) */
static size_t br_rawpos(BR *r) {
    /* acc holds nacc/8 fetched-but-unconsumed logical bytes; walking back
     * over stuffing is ambiguous, so the decoder only calls this when
     * stopped AT a marker (acc drained or alignment-dropped). */
    return r->marker ? r->mkpos : r->i;
}

/* enter the segment that follows a marker at raw position p */
static void br_enter(BR *r, size_t p) {
    r->i = p;
    r->skip0 = 0;
    r->acc = 0;
    r->nacc = 0;
    r->marker = 0;
    r->ended = 0;
}

/* scan forward (raw, from p) for the next marker; returns its raw pos or n */
static size_t br_findmarker(const uint8_t *d, size_t n, size_t p) {
    while (p + 1 < n) {
        if (d[p] == 0xFF) {
            if (d[p + 1] != 0x00) return p;
            p += 2; /* stuffed data FF */
        } else
            p++;
    }
    return n;
}

/* --------------------------------------------- adaptive multi-symbol model */
typedef struct {
    uint32_t freq[33], cum[33];
    uint16_t sym2idx[33], idx2sym[33];
    uint32_t maxfreq;
    uint16_t nsym; /* 0 = uninitialized */
} Model;

static void model_start(Model *m) {
    for (unsigned i = 0; i <= m->nsym; i++) {
        m->freq[i] = 1;
        m->cum[i] = m->nsym - i;
        m->sym2idx[i] = (uint16_t)(i + 1);
        m->idx2sym[i] = (uint16_t)(i - 1);
    }
    m->sym2idx[m->nsym] = m->nsym;
    m->idx2sym[0] = 0;
    m->freq[0] = 0;
}

static void model_init(Model *m, unsigned nsym) {
    m->nsym = (uint16_t)nsym;
    if (nsym) {
        uint32_t t = (uint32_t)nsym << 5;
        m->maxfreq = t < AC_MAXFREQ ? t : AC_MAXFREQ;
        model_start(m);
    }
}

static void model_rescale(Model *m) {
    uint32_t cum = 0;
    for (int i = m->nsym; i >= 0; i--) {
        m->cum[i] = cum;
        m->freq[i] = (m->freq[i] + 1) >> 1;
        cum += m->freq[i];
    }
}

static void model_update_mps(Model *m) {
    if (m->cum[0] >= m->maxfreq) model_rescale(m);
    m->freq[1]++;
    m->cum[0]++;
}

static void model_update_lps(Model *m, unsigned idx) {
    if (m->cum[0] >= m->maxfreq) model_rescale(m);
    unsigned i = idx;
    if (m->freq[i] == m->freq[i - 1]) {
        for (i--; m->freq[i] == m->freq[i - 1]; i--)
            ;
        unsigned s = m->idx2sym[i];
        m->idx2sym[i] = m->idx2sym[idx];
        m->idx2sym[idx] = (uint16_t)s;
        m->sym2idx[m->idx2sym[idx]] = (uint16_t)idx;
        m->sym2idx[m->idx2sym[i]] = (uint16_t)i;
    }
    m->freq[i]++;
    while (i)
        m->cum[--i]++;
}

/* m_Models[k][ctx]: models with k+2 symbols, ctx in 0..k+1 */
typedef struct { Model mod[31][32]; } Models;

static void models_reset(Models *ms) {
    for (int i = 0; i < 31; i++)
        for (int j = 0; j <= i + 1; j++)
            if (ms->mod[i][j].nsym) model_init(&ms->mod[i][j], 0);
}

/* ------------------------------------------------------------- AC decoder */
typedef struct {
    uint32_t value, range;
    BR *br;
    int hit; /* marker reached */
} ACD;

static void acd_start(ACD *a, BR *br) {
    a->br = br;
    a->hit = 0;
    a->range = AC_TOP + 1ul;
    a->value = br_bits32(br, AC_BITS, &a->hit);
}

static void acd_update(ACD *a) {
    int nb = 0;
    do {
        a->range += a->range;
        nb++;
    } while (a->range <= AC_QTR);
    a->value <<= nb;
    int hit = 0;
    a->value += br_bits32(a->br, nb, &hit);
    if (hit) a->hit = 1;
}

static uint32_t acd_bits(ACD *a, int n) {
    a->range >>= n;
    if (!a->range) { /* a corrupt magnitude class: no such interval */
        a->hit = 1;
        a->range = AC_TOP + 1ul;
        return 0;
    }
    uint32_t v = a->value / a->range;
    a->value -= v * a->range;
    if (a->range <= AC_QTR) acd_update(a);
    return v;
}

static uint32_t acd_bit(ACD *a) {
    a->range >>= 1;
    uint32_t b = a->value >= a->range ? 1u : 0u;
    if (b) a->value -= a->range;
    if (a->range <= AC_QTR) acd_update(a);
    return b;
}

static unsigned acd_symbol(ACD *a, Model *m) {
    unsigned idx = 1;
    uint32_t r = m->cum[0] ? a->range / m->cum[0] : 0;
    if (!r) { /* the model's total exceeds the range: corrupt state */
        a->hit = 1;
        a->range = AC_TOP + 1ul;
        return 0;
    }
    uint32_t rlps = m->cum[1] * r;
    while (rlps > a->value)
        rlps = m->cum[++idx] * r;
    unsigned sym = m->idx2sym[idx];
    a->value -= rlps;
    if (idx == 1) {
        a->range -= rlps;
        model_update_mps(m);
    } else {
        a->range = m->freq[idx] * r;
        model_update_lps(m, idx);
    }
    if (a->range <= AC_QTR) acd_update(a);
    return sym;
}

/* ------------------------------------------------------------- AC encoder */
typedef struct {
    uint32_t low, range, follow;
    uint32_t bits;
    int nbits; /* free slots in the 32-bit out accumulator */
    BW *bw;
} ACE;

static void ace_outbit(ACE *a, uint32_t b) {
    a->bits += a->bits + b;
    if (!--a->nbits) {
        for (int i = 24; i >= 0; i -= 8)
            bw_byte(a->bw, (uint8_t)(a->bits >> i));
        a->nbits = 32;
        a->bits = 0;
    }
}

static void ace_bitfollow(ACE *a, uint32_t b) {
    ace_outbit(a, b);
    while (a->follow) {
        ace_outbit(a, 1u - b);
        a->follow--;
    }
}

static void ace_start(ACE *a, BW *bw) {
    a->bw = bw;
    a->low = 0;
    a->range = AC_TOP + 1ul;
    a->follow = 0;
    a->nbits = 32;
    a->bits = 0;
}

static void ace_update(ACE *a) {
    do {
        if (a->low >= AC_HALF) {
            ace_bitfollow(a, 1);
            a->low -= AC_HALF;
        } else if (a->low + a->range <= AC_HALF)
            ace_bitfollow(a, 0);
        else {
            a->follow++;
            a->low -= AC_QTR;
        }
        a->low += a->low;
        a->range += a->range;
    } while (a->range <= AC_QTR);
}

static void ace_bits(ACE *a, uint32_t v, int n) {
    a->range >>= n;
    a->low += (v & ((1ul << n) - 1ul)) * a->range;
    if (a->range <= AC_QTR) ace_update(a);
}

static void ace_bit(ACE *a, uint32_t b) {
    a->range >>= 1;
    if (b) a->low += a->range;
    if (a->range <= AC_QTR) ace_update(a);
}

static void ace_symbol(ACE *a, unsigned sym, Model *m) {
    unsigned idx = m->sym2idx[sym];
    uint32_t r = a->range / m->cum[0];
    uint32_t rlps = m->cum[idx] * r;
    a->low += rlps;
    if (idx == 1) {
        a->range -= rlps;
        model_update_mps(m);
    } else {
        a->range = m->freq[idx] * r;
        model_update_lps(m, idx);
    }
    if (a->range <= AC_QTR) ace_update(a);
}

static void ace_stop(ACE *a) {
    for (int i = (int)AC_BITS - 1; i >= 0; i--)
        ace_bitfollow(a, (a->low >> i) & 1u);
    if (a->nbits < 32) /* flush accumulator remainder, stuffed */
        bw_bits_(a->bw, a->bits, 32 - a->nbits, 1);
}

/* ------------------------------------------------- S+P integer transforms */
/* 1-D forward: c[0..S) pairs -> L half l[k]=(c0+c1)>>1, H half predicted.
 * Operates on strided views so the same code serves rows and columns. */
static void sp_fwd_1d(int32_t *p, int stride, int S, int pred, int32_t *tmp) {
    int K = S >> 1;
    if (K < 1) return;
    for (int k = 0; k < S; k++)
        tmp[k] = p[k * stride];
    int32_t *l = tmp + S, *d = tmp + S + K;
    for (int k = 0; k < K; k++) {
        l[k] = (tmp[2 * k] + tmp[2 * k + 1]) >> 1;
        d[k] = tmp[2 * k] - tmp[2 * k + 1];
    }
    for (int k = 0; k < K; k++)
        p[k * stride] = l[k];
    if (K == 1 || pred == 0) { /* S-transform only */
        for (int k = 0; k < K; k++)
            p[(K + k) * stride] = d[k];
        return;
    }
    int32_t *h = tmp + S + 2 * (size_t)K;
    if (pred == 1) { /* predictor A: h[k] = d[k] - ((l[k-1]-l[k+1]+2)>>2) */
        h[0] = d[0] - ((l[0] - l[1] + 2) >> 2);
        for (int k = 1; k <= K - 2; k++)
            h[k] = d[k] - ((l[k - 1] - l[k + 1] + 2) >> 2);
        h[K - 1] = d[K - 1] - ((l[K - 2] - l[K - 1] + 2) >> 2);
    } else if (pred == 2) { /* predictor B: raw next-diff refinement */
        h[0] = d[0] - ((l[0] - l[1] + 2) >> 2);
        for (int k = 1; k <= K - 2; k++) {
            int32_t dl0 = l[k - 1] - l[k], dl1 = l[k] - l[k + 1];
            h[k] = d[k] - ((((dl0 + dl1 - d[k + 1]) << 1) + dl1 + 4) >> 3);
        }
        h[K - 1] = d[K - 1] - ((l[K - 2] - l[K - 1] + 2) >> 2);
    } else { /* predictor C (needs K > 1; K==2 degenerates to boundary) */
        h[0] = d[0] - ((l[0] - l[1] + 2) >> 2);
        if (K > 2) {
            {
                int32_t dl1 = l[0] - l[1], dl2 = l[1] - l[2];
                h[1] = d[1] - ((((dl1 + dl2 - d[2]) << 1) + dl2 + 4) >> 3);
            }
            for (int k = 2; k <= K - 2; k++) {
                int32_t dl0 = l[k - 2] - l[k - 1];
                int32_t dl1 = l[k - 1] - l[k];
                int32_t dl2 = l[k] - l[k + 1];
                h[k] = d[k] - ((-dl0 +
                                ((((dl1 + (dl2 << 1) - d[k + 1]) << 1)
                                  - d[k + 1]) << 1) + 8) >> 4);
            }
        }
        if (K >= 2)
            h[K - 1] = d[K - 1] - ((l[K - 2] - l[K - 1] + 2) >> 2);
    }
    for (int k = 0; k < K; k++)
        p[(K + k) * stride] = h[k];
}

static void sp_inv_1d(int32_t *p, int stride, int S, int pred, int32_t *tmp) {
    int K = S >> 1;
    if (K < 1) return;
    int32_t *l = tmp, *d = tmp + K;
    for (int k = 0; k < K; k++) {
        l[k] = p[k * stride];
        d[k] = p[(K + k) * stride];
    }
    if (K > 1 && pred) { /* undo prediction: raw diffs recovered high->low */
        if (pred == 1) {
            d[K - 1] += (l[K - 2] - l[K - 1] + 2) >> 2;
            for (int k = K - 2; k >= 1; k--)
                d[k] += (l[k - 1] - l[k + 1] + 2) >> 2;
            d[0] += (l[0] - l[1] + 2) >> 2;
        } else if (pred == 2) {
            d[K - 1] += (l[K - 2] - l[K - 1] + 2) >> 2;
            for (int k = K - 2; k >= 1; k--) {
                int32_t dl0 = l[k - 1] - l[k], dl1 = l[k] - l[k + 1];
                d[k] += (((dl0 + dl1 - d[k + 1]) << 1) + dl1 + 4) >> 3;
            }
            d[0] += (l[0] - l[1] + 2) >> 2;
        } else {
            if (K >= 2)
                d[K - 1] += (l[K - 2] - l[K - 1] + 2) >> 2;
            if (K > 2) {
                for (int k = K - 2; k >= 2; k--) {
                    int32_t dl0 = l[k - 2] - l[k - 1];
                    int32_t dl1 = l[k - 1] - l[k];
                    int32_t dl2 = l[k] - l[k + 1];
                    d[k] += (-dl0 +
                             ((((dl1 + (dl2 << 1) - d[k + 1]) << 1)
                               - d[k + 1]) << 1) + 8) >> 4;
                }
                {
                    int32_t dl1 = l[0] - l[1], dl2 = l[1] - l[2];
                    d[1] += (((dl1 + dl2 - d[2]) << 1) + dl2 + 4) >> 3;
                }
            }
            d[0] += (l[0] - l[1] + 2) >> 2;
        }
    }
    for (int k = 0; k < K; k++) { /* inverse S: c0 = l + ((d+1)>>1) */
        int32_t c0 = l[k] + ((d[k] + 1) >> 1);
        p[2 * k * stride] = c0;
        p[(2 * k + 1) * stride] = c0 - d[k];
    }
}

/* full 2D iteration set over the top-left (W>>k, H>>k) pyramid */
static void sp_iterate(int32_t *blk, int bw, int W, int H, int levels,
                       int pred, int fwd, int32_t *tmp) {
    if (fwd) {
        for (int it = 0; it < levels; it++) {
            int w = W >> it, h = H >> it;
            for (int i = 0; i < h; i++)
                sp_fwd_1d(blk + (size_t)i * bw, 1, w, pred, tmp);
            for (int j = 0; j < w; j++)
                sp_fwd_1d(blk + j, bw, h, pred, tmp);
        }
    } else {
        for (int it = levels; it > 0; it--) {
            int w = W >> (it - 1), h = H >> (it - 1);
            for (int j = 0; j < w; j++)
                sp_inv_1d(blk + j, bw, h, pred, tmp);
            for (int i = 0; i < h; i++)
                sp_inv_1d(blk + (size_t)i * bw, 1, w, pred, tmp);
        }
    }
}

/* ---------------------------------------------------------- VLC layer --- */
typedef struct {
    Models *ms;
    Model *mod; /* current context row */
    int nbbit_coef, nbbit_nbbit, n_ite, lossy_bp, lossy_quad;
} VLC;

static const int LOSSY_BITPLANES[16] = {0, 1, 2, 2, 2, 3, 3, 3,
                                        3, 3, 4, 4, 4, 4, 4, 4};
static const int LOSSY_QUADRANTS[16] = {0, 0, 0, 2, 3, 0, 2, 3,
                                        5, 6, 0, 2, 3, 5, 6, 9};

/* decode one coefficient; returns its magnitude class m */
static unsigned vlc_dec_coef(VLC *v, ACD *a, unsigned ctx, int32_t *coef) {
    unsigned m = acd_symbol(a, &v->mod[ctx]);
    if (!m)
        *coef = 0;
    else if (m == 1)
        *coef = acd_bit(a) ? 1 : -1;
    else {
        int32_t c = (int32_t)acd_bits(a, (int)m);
        int32_t mask = 1l << (m - 1);
        if (!(c & mask)) c -= mask + mask - 1;
        *coef = c;
    }
    return m;
}

static unsigned vlc_enc_coef(VLC *v, ACE *a, unsigned ctx, int32_t coef) {
    unsigned m = (unsigned)csize(coef);
    ace_symbol(a, m, &v->mod[ctx]);
    if (m == 1)
        ace_bit(a, coef < 0 ? 0u : 1u);
    else if (m > 1)
        ace_bits(a, (uint32_t)(coef < 0 ? coef - 1 : coef), (int)m);
    return m;
}

static void vlc_use_models(VLC *v, unsigned nbbit) { /* nbbit >= 1 */
    v->mod = v->ms->mod[nbbit - 1];
    if (!v->mod[0].nsym)
        for (unsigned i = 0; i <= nbbit; i++)
            model_init(&v->mod[i], nbbit + 1);
}

/* serpentine scan over a quadrant calling per-coef op */
#define SERPENTINE(W_, H_, BODY_FWD, BODY_REV)                       \
    for (int i_ = 0; i_ < (int)(H_); i_++) {                         \
        if (!(i_ & 1)) {                                             \
            for (int j_ = 0; j_ < (int)(W_); j_++) { BODY_FWD }      \
        } else {                                                     \
            for (int j_ = (int)(W_) - 1; j_ >= 0; j_--) { BODY_REV } \
        }                                                            \
    }

static int vlc_dec_dc(VLC *v, ACD *a, int32_t *blk, int bw, int W, int H) {
    unsigned nbbit = acd_bits(a, v->nbbit_nbbit);
    if (a->hit || nbbit > (unsigned)v->nbbit_coef) return 0;
    if (!nbbit) {
        for (int i = 0; i < H; i++)
            memset(blk + (size_t)i * bw, 0, sizeof(int32_t) * W);
        return 1;
    }
    nbbit++; /* DC DPCM needs one extra magnitude class */
    if (nbbit > AC_BITS - 2) return 0;
    vlc_use_models(v, nbbit);
    int32_t old = 1l << (nbbit - 2);
    unsigned ctx = nbbit;
    int32_t c;
    SERPENTINE(W, H,
               { ctx = (ctx + vlc_dec_coef(v, a, ctx, &c)) >> 1;
                 blk[(size_t)i_ * bw + j_] = (old += c); },
               { ctx = (ctx + vlc_dec_coef(v, a, ctx, &c)) >> 1;
                 blk[(size_t)i_ * bw + j_] = (old += c); })
    return !a->hit;
}

static void vlc_enc_dc(VLC *v, ACE *a, const int32_t *blk, int bw,
                       int W, int H) {
    int maxc = 0;
    for (int i = 0; i < H; i++)
        for (int j = 0; j < W; j++) {
            int32_t c = blk[(size_t)i * bw + j];
            int m = c < 0 ? -c : c;
            if (m > maxc) maxc = m;
        }
    unsigned nbbit = (unsigned)csize(maxc);
    ace_bits(a, nbbit, v->nbbit_nbbit);
    if (!nbbit) return;
    nbbit++;
    vlc_use_models(v, nbbit);
    int32_t old = 1l << (nbbit - 2);
    unsigned ctx = nbbit;
    SERPENTINE(W, H,
               { int32_t c = blk[(size_t)i_ * bw + j_];
                 ctx = (ctx + vlc_enc_coef(v, a, ctx, c - old)) >> 1;
                 old = c; },
               { int32_t c = blk[(size_t)i_ * bw + j_];
                 ctx = (ctx + vlc_enc_coef(v, a, ctx, c - old)) >> 1;
                 old = c; })
}

static int vlc_coefshift(VLC *v, int level, int quad) {
    if (level >= v->lossy_bp) return 0;
    return v->lossy_bp - level - (quad > v->lossy_quad ? 1 : 0);
}

static int vlc_dec_quad(VLC *v, ACD *a, int32_t *blk, int bw,
                        int X, int Y, int W, int H, int level, int quad) {
    unsigned nbbit = acd_bits(a, v->nbbit_nbbit);
    if (a->hit || nbbit > (unsigned)v->nbbit_coef) return 0;
    int shift = vlc_coefshift(v, level, quad);
    if (nbbit <= (unsigned)shift) {
        for (int i = 0; i < H; i++)
            memset(blk + (size_t)(Y + i) * bw + X, 0, sizeof(int32_t) * W);
        return 1;
    }
    nbbit -= shift;
    vlc_use_models(v, nbbit);
    unsigned ctx = nbbit;
    int32_t c;
    int32_t *base = blk + (size_t)Y * bw + X;
    SERPENTINE(W, H,
               { ctx = (ctx + vlc_dec_coef(v, a, ctx, &c)) >> 1;
                 base[(size_t)i_ * bw + j_] = c << shift; },
               { ctx = (ctx + vlc_dec_coef(v, a, ctx, &c)) >> 1;
                 base[(size_t)i_ * bw + j_] = c << shift; })
    return !a->hit;
}

static void vlc_enc_quad(VLC *v, ACE *a, const int32_t *blk, int bw,
                         int X, int Y, int W, int H, int level, int quad) {
    int maxc = 0;
    const int32_t *base = blk + (size_t)Y * bw + X;
    for (int i = 0; i < H; i++)
        for (int j = 0; j < W; j++) {
            int32_t c = base[(size_t)i * bw + j];
            int m = c < 0 ? -c : c;
            if (m > maxc) maxc = m;
        }
    unsigned nbbit = (unsigned)csize(maxc);
    ace_bits(a, nbbit, v->nbbit_nbbit);
    int shift = vlc_coefshift(v, level, quad);
    if (nbbit <= (unsigned)shift) return;
    nbbit -= shift;
    vlc_use_models(v, nbbit);
    unsigned ctx = nbbit;
    SERPENTINE(W, H,
               { int32_t c = base[(size_t)i_ * bw + j_];
                 c = c >= 0 ? c >> shift : -(-c >> shift);
                 ctx = (ctx + vlc_enc_coef(v, a, ctx, c)) >> 1; },
               { int32_t c = base[(size_t)i_ * bw + j_];
                 c = c >= 0 ? c >> shift : -(-c >> shift);
                 ctx = (ctx + vlc_enc_coef(v, a, ctx, c)) >> 1; })
}

static void vlc_refine_quad(VLC *v, int32_t *blk, int bw,
                            int X, int Y, int W, int H, int level, int quad) {
    int extra = quad > v->lossy_quad ? 1 : 0;
    if (v->lossy_bp <= level + 1 + extra) return;
    int32_t cT = (1l << (v->lossy_bp - level - (extra ? 2 : 1))) - 1;
    int32_t *base = blk + (size_t)Y * bw + X;
    for (int i = 0; i < H; i++)
        for (int j = 0; j < W; j++) {
            int32_t c = base[(size_t)i * bw + j];
            if (c > 0) base[(size_t)i * bw + j] = c | cT;
            else if (c < 0) base[(size_t)i * bw + j] = -(-c | cT);
        }
}

/* decode/encode one whole transformed block's coefficient pyramid */
static int vlc_dec_block(VLC *v, ACD *a, int32_t *blk, int bw,
                         int BW_, int BH, int n_ite, int lossy) {
    unsigned nbbit = acd_bits(a, 5);
    if (a->hit || nbbit > AC_BITS - 2) return 0;
    if (!nbbit) {
        for (int i = 0; i < BH; i++)
            memset(blk + (size_t)i * bw, 0, sizeof(int32_t) * BW_);
        return 1;
    }
    int w = BW_ >> n_ite, h = BH >> n_ite;
    int m = n_ite, q = n_ite * 3;
    v->nbbit_coef = (int)nbbit;
    v->nbbit_nbbit = csize((int)nbbit);
    v->n_ite = n_ite;
    v->lossy_bp = LOSSY_BITPLANES[lossy];
    v->lossy_quad = LOSSY_QUADRANTS[lossy];
    if (!vlc_dec_dc(v, a, blk, bw, w, h)) return 0;
    q--;
    for (int k = 0; k < n_ite; k++, w <<= 1, h <<= 1, m--) {
        if (!vlc_dec_quad(v, a, blk, bw, w, 0, w, h, m, q--)) return 0;
        if (!vlc_dec_quad(v, a, blk, bw, 0, h, w, h, m, q--)) return 0;
        if (!vlc_dec_quad(v, a, blk, bw, w, h, w, h, m - 1, q--)) return 0;
    }
    if (lossy > 1) { /* mid-tread reconstruction of dropped planes */
        w = BW_ >> n_ite;
        h = BH >> n_ite;
        m = n_ite;
        q = n_ite * 3 - 1;
        for (int k = 0; k < n_ite; k++, w <<= 1, h <<= 1, m--) {
            vlc_refine_quad(v, blk, bw, w, 0, w, h, m, q--);
            vlc_refine_quad(v, blk, bw, 0, h, w, h, m, q--);
            vlc_refine_quad(v, blk, bw, w, h, w, h, m - 1, q--);
        }
    }
    return 1;
}

static void vlc_enc_block(VLC *v, ACE *a, const int32_t *blk, int bw,
                          int BW_, int BH, int n_ite, int lossy) {
    int maxc = 0;
    for (int i = 0; i < BH; i++)
        for (int j = 0; j < BW_; j++) {
            int32_t c = blk[(size_t)i * bw + j];
            int m = c < 0 ? -c : c;
            if (m > maxc) maxc = m;
        }
    unsigned nbbit = (unsigned)csize(maxc);
    ace_bits(a, nbbit, 5);
    if (!nbbit) return;
    int w = BW_ >> n_ite, h = BH >> n_ite;
    int m = n_ite, q = n_ite * 3;
    v->nbbit_coef = (int)nbbit;
    v->nbbit_nbbit = csize((int)nbbit);
    v->n_ite = n_ite;
    v->lossy_bp = LOSSY_BITPLANES[lossy];
    v->lossy_quad = LOSSY_QUADRANTS[lossy];
    vlc_enc_dc(v, a, blk, bw, w, h);
    q--;
    for (int k = 0; k < n_ite; k++, w <<= 1, h <<= 1, m--) {
        vlc_enc_quad(v, a, blk, bw, w, 0, w, h, m, q--);
        vlc_enc_quad(v, a, blk, bw, 0, h, w, h, m, q--);
        vlc_enc_quad(v, a, blk, bw, w, h, w, h, m - 1, q--);
    }
}

/* ------------------------------------------------------------- block I/O */
static void block_get_pad(int32_t *blk, int bs_w, int bs_h,
                          const uint16_t *img, int iw, int ih,
                          int x0, int y0, int nw, int nh) {
    for (int i = 0; i < nh; i++) {
        const uint16_t *src = img + (size_t)(y0 + i) * iw + x0;
        int32_t *dst = blk + (size_t)i * bs_w;
        for (int j = 0; j < nw; j++)
            dst[j] = src[j];
        for (int j = nw; j < bs_w; j++) /* replicate last column */
            dst[j] = dst[nw - 1];
    }
    for (int i = nh; i < bs_h; i++) /* replicate last row */
        memcpy(blk + (size_t)i * bs_w, blk + (size_t)(i - 1) * bs_w,
               sizeof(int32_t) * bs_w);
}

static void block_put(const int32_t *blk, int bs_w, uint16_t *img, int iw,
                      int x0, int y0, int nw, int nh, int nb) {
    int32_t maxc = (1l << nb) - 1;
    for (int i = 0; i < nh; i++) {
        const int32_t *src = blk + (size_t)i * bs_w;
        uint16_t *dst = img + (size_t)(y0 + i) * iw + x0;
        for (int j = 0; j < nw; j++) {
            int32_t c = src[j];
            dst[j] = (uint16_t)(c < 0 ? 0 : c > maxc ? maxc : c);
        }
    }
}

/* =========================================================== DECODER ==== */
int wt_decompress(const uint8_t *buf, size_t len, uint16_t *out,
                  int w, int h, int nb, int16_t *quality) {
    if (len < 12) return -1;
    if (buf[0] != 0xFF || buf[1] != 0x01) return -1;
    /* raw 64-bit header */
    uint64_t hd = 0;
    for (int i = 0; i < 8; i++)
        hd = (hd << 8) | buf[2 + i];
    int bpp = (int)(hd >> 60) & 0xF;
    int iw = (int)(hd >> 44) & 0xFFFF;
    int ih = (int)(hd >> 28) & 0xFFFF;
    int levels = ((int)(hd >> 26) & 3) + 3;
    int pred = (int)(hd >> 24) & 3;
    int blockmode = (int)(hd >> 22) & 3;
    int restart = (int)(hd >> 6) & 0xFFFF;
    int lossy = (int)(hd >> 2) & 0xF;
    if (bpp == 0) bpp = 16;
    (void)bpp;
    if (iw != w || ih != h) return -2;
    if (buf[10] != 0xFF || buf[11] != 0x02) return -1;

    for (int i = 0; i < h; i++)
        quality[i] = 0;
    memset(out, 0, sizeof(uint16_t) * (size_t)w * h);

    int bs;
    if (blockmode == 3) { /* full-image mode */
        int bw = (w + (1 << levels) - 1) & -(1 << levels);
        int bh = (h + (1 << levels) - 1) & -(1 << levels);
        int32_t *blk = calloc((size_t)bw * bh, sizeof(int32_t));
        int32_t *tmp = malloc(sizeof(int32_t) * 4 * (size_t)(bw > bh ? bw : bh));
        Models *ms = calloc(1, sizeof(Models));
        VLC v = {ms, 0, 0, 0, 0, 0, 0};
        BR br;
        br_enter(&br, 12);
        br.d = buf;
        br.n = len;
        ACD a;
        acd_start(&a, &br);
        int ok = vlc_dec_block(&v, &a, blk, bw, bw, bh, levels, lossy)
                 && !a.hit;
        if (ok) {
            sp_iterate(blk, bw, bw, bh, levels, pred, 0, tmp);
            block_put(blk, bw, out, w, 0, 0, w, h, nb);
            for (int i = 0; i < h; i++)
                quality[i] = (int16_t)w;
            /* footer check: quality negated if missing */
            size_t p = br.marker ? br.mkpos
                                 : br_findmarker(buf, len, br.i);
            if (!(p + 1 < len && buf[p] == 0xFF && buf[p + 1] == 0x03))
                for (int i = 0; i < h; i++)
                    quality[i] = (int16_t)-quality[i];
        }
        free(blk);
        free(tmp);
        free(ms);
        return ok ? 0 : -3;
    }
    bs = 16 << blockmode;
    if (levels > (blockmode == 0 ? 4 : blockmode == 1 ? 5 : 6)) return -1;

    int nbW = (w + bs - 1) / bs, nbH = (h + bs - 1) / bs;
    long nB = (long)nbW * nbH;
    int32_t *blk = calloc((size_t)bs * bs, sizeof(int32_t));
    int32_t *tmp = malloc(sizeof(int32_t) * 4 * (size_t)bs);
    Models *ms = calloc(1, sizeof(Models));
    uint8_t *bad = calloc((size_t)h, 1); /* sticky per-line damage flag */
    VLC v = {ms, 0, 0, 0, 0, 0, 0};
    BR br = {buf, len, 12, 0, 0, 0, 0, 0, 0};
    ACD a;
    acd_start(&a, &br);

    long b = 0;          /* current absolute block index     */
    int nbBlock = 0;     /* blocks since last restart        */
    int markerNum = 0;   /* restart marker counter           */

    while (b < nB) {
        int bX = (int)(b % nbW), bY = (int)(b / nbW);
        int nw = (bX == nbW - 1 && w % bs) ? w % bs : bs;
        int nh = (bY == nbH - 1 && h % bs) ? h % bs : bs;
        int ok = vlc_dec_block(&v, &a, blk, bs, bs, bs, levels, lossy)
                 && !a.hit;
        if (ok) {
            sp_iterate(blk, bs, bs, bs, levels, pred, 0, tmp);
            block_put(blk, bs, out, w, bX * bs, bY * bs, nw, nh, nb);
            b++;
            nbBlock++;
        } else {
            /* resync: mark damaged lines, jump to next restart marker */
            for (int i = bY * bs; i < bY * bs + nh && i < h; i++) {
                quality[i] = (int16_t)(-(bX * bs));
                bad[i] = 1;
            }
            size_t p = br.marker ? br.mkpos : br_findmarker(buf, len, br.i);
            int found = 0;
            while (p + 1 < len) {
                uint16_t code = (uint16_t)((buf[p] << 8) | buf[p + 1]);
                if (code >= MK_RESTART && code <= MK_RESTART + 15) {
                    int delta = (int)(code & 0xF) - (markerNum & 0xF);
                    markerNum += delta;
                    found = 1;
                    break;
                }
                if (code == MK_FOOTER) break;
                p = br_findmarker(buf, len, p + 1);
            }
            if (!found || restart == 0) { /* no usable marker: all done */
                b = nB;
                break;
            }
            long nb_next = (long)(markerNum + 1) * restart;
            if (nb_next > nB) nb_next = nB;
            for (long zb = b; zb < nb_next; zb++) { /* zero skipped blocks */
                int zx = (int)(zb % nbW), zy = (int)(zb / nbW);
                int zw = (zx == nbW - 1 && w % bs) ? w % bs : bs;
                int zh = (zy == nbH - 1 && h % bs) ? h % bs : bs;
                for (int i = 0; i < zh; i++)
                    memset(out + (size_t)(zy * bs + i) * w + zx * bs, 0,
                           sizeof(uint16_t) * zw);
                for (int i = zy * bs; i < zy * bs + zh && i < h; i++) {
                    if (quality[i] > 0) quality[i] = 0;
                    bad[i] = 1;
                }
            }
            b = nb_next;
            nbBlock = restart;
            markerNum++; /* consumed below as if interval completed */
            br_enter(&br, p + 2);
            br.d = buf;
            br.n = len;
            nbBlock = 0;
            models_reset(ms);
            if (b < nB) acd_start(&a, &br);
            continue;
        }
        if (restart && nbBlock == restart) {
            /* AC segment ends here: expect the restart marker */
            size_t p = br.marker ? br.mkpos : br_findmarker(buf, len, br.i);
            uint16_t want = (uint16_t)(MK_RESTART | (markerNum & 0xF));
            if (p + 1 < len
                && ((buf[p] << 8) | buf[p + 1]) == want) {
                markerNum++;
                nbBlock = 0;
                br_enter(&br, p + 2);
                br.d = buf;
                br.n = len;
                models_reset(ms);
                if (b < nB) acd_start(&a, &br);
            } else {
                /* marker missing: resync like a decode failure */
                markerNum++;
                nbBlock = 0;
                size_t q = br_findmarker(buf, len, p);
                int found = 0;
                while (q + 1 < len) {
                    uint16_t code = (uint16_t)((buf[q] << 8) | buf[q + 1]);
                    if (code >= MK_RESTART && code <= MK_RESTART + 15) {
                        markerNum = (int)(code & 0xF)
                                    + (markerNum & ~0xF);
                        found = 1;
                        break;
                    }
                    if (code == MK_FOOTER) break;
                    q = br_findmarker(buf, len, q + 1);
                }
                if (!found) break;
                long nb_next = (long)(markerNum + 1) * restart;
                if (nb_next > nB) nb_next = nB;
                for (long zb = b; zb < nb_next; zb++) {
                    int zx = (int)(zb % nbW), zy = (int)(zb / nbW);
                    int zw = (zx == nbW - 1 && w % bs) ? w % bs : bs;
                    int zh = (zy == nbH - 1 && h % bs) ? h % bs : bs;
                    for (int i = 0; i < zh; i++)
                        memset(out + (size_t)(zy * bs + i) * w + zx * bs,
                               0, sizeof(uint16_t) * zw);
                    for (int i = zy * bs; i < zy * bs + zh && i < h; i++) {
                        if (quality[i] > 0) quality[i] = 0;
                        bad[i] = 1;
                    }
                }
                b = nb_next;
                markerNum++;
                br_enter(&br, q + 2);
                br.d = buf;
                br.n = len;
                models_reset(ms);
                if (b < nB) acd_start(&a, &br);
            }
        }
    }
    for (int i = 0; i < h; i++)
        if (!bad[i])
            quality[i] = (int16_t)w;
    free(bad);
    free(blk);
    free(tmp);
    free(ms);
    return 0;
}

/* =========================================================== ENCODER ==== */
/* block_mode: 0=16x16 1=32x32 2=64x64 3=full; pred: 0..3; returns length
 * (or required length if out_cap too small — caller re-calls), <0 on error */
long wt_compress(const uint16_t *img, int w, int h, int nb,
                 int pred, int block_mode, int levels, int restart,
                 int lossy, uint8_t *out, size_t out_cap) {
    if (levels < 3 || levels > 6 || pred < 0 || pred > 3) return -1;
    if (block_mode < 3 && levels > 4 + block_mode) return -1;
    BW bw = {out, out_cap, 0, 0, 0};
    bw_marker(&bw, MK_HEADER);
    bw_bits_(&bw, (uint32_t)(nb & 0xF), 4, 0);
    bw_bits_(&bw, (uint32_t)w, 16, 0);
    bw_bits_(&bw, (uint32_t)h, 16, 0);
    bw_bits_(&bw, (uint32_t)(levels - 3), 2, 0);
    bw_bits_(&bw, (uint32_t)pred, 2, 0);
    bw_bits_(&bw, (uint32_t)block_mode, 2, 0);
    bw_bits_(&bw, (uint32_t)restart, 16, 0);
    bw_bits_(&bw, (uint32_t)lossy, 4, 0);
    bw_bits_(&bw, 0, 2, 0);
    bw_marker(&bw, MK_DATA);

    Models *ms = calloc(1, sizeof(Models));
    VLC v = {ms, 0, 0, 0, 0, 0, 0};
    ACE a;

    if (block_mode == 3) {
        int BW_ = (w + (1 << levels) - 1) & -(1 << levels);
        int BH = (h + (1 << levels) - 1) & -(1 << levels);
        int32_t *blk = calloc((size_t)BW_ * BH, sizeof(int32_t));
        int32_t *tmp = malloc(sizeof(int32_t) * 4
                              * (size_t)(BW_ > BH ? BW_ : BH));
        ace_start(&a, &bw);
        block_get_pad(blk, BW_, BH, img, w, h, 0, 0, w, h);
        sp_iterate(blk, BW_, BW_, BH, levels, pred, 1, tmp);
        vlc_enc_block(&v, &a, blk, BW_, BW_, BH, levels, lossy);
        ace_stop(&a);
        bw_marker(&bw, MK_FOOTER);
        free(blk);
        free(tmp);
        free(ms);
        return (long)bw.len;
    }

    int bs = 16 << block_mode;
    int nbW = (w + bs - 1) / bs, nbH = (h + bs - 1) / bs;
    int32_t *blk = calloc((size_t)bs * bs, sizeof(int32_t));
    int32_t *tmp = malloc(sizeof(int32_t) * 4 * (size_t)bs);
    ace_start(&a, &bw);
    int nbBlock = 0, markerNum = 0, acStopped = 0;
    for (int bY = 0; bY < nbH; bY++) {
        int nh = (bY == nbH - 1 && h % bs) ? h % bs : bs;
        for (int bX = 0; bX < nbW; bX++) {
            int nw = (bX == nbW - 1 && w % bs) ? w % bs : bs;
            block_get_pad(blk, bs, bs, img, w, h, bX * bs, bY * bs, nw, nh);
            sp_iterate(blk, bs, bs, bs, levels, pred, 1, tmp);
            vlc_enc_block(&v, &a, blk, bs, bs, bs, levels, lossy);
            nbBlock++;
            if (restart && nbBlock == restart) {
                nbBlock = 0;
                ace_stop(&a);
                bw_marker(&bw, (uint16_t)(MK_RESTART | (markerNum & 0xF)));
                markerNum++;
                if (bX < nbW - 1 || bY < nbH - 1)
                    ace_start(&a, &bw);
                else
                    acStopped = 1;
                models_reset(ms);
            }
        }
    }
    if (!acStopped) ace_stop(&a);
    bw_marker(&bw, MK_FOOTER);
    free(blk);
    free(tmp);
    free(ms);
    return (long)bw.len;
}
