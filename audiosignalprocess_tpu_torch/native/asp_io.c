/* asp_io.c — native WAV (RIFF) I/O + block ring buffer.
 *
 * The runtime-side native component of the framework (the reference's I/O
 * layer is C; SURVEY.md §2 row 1): RIFF header parse, PCM16/24/32/float32
 * decode to planar float32, encode back, and a lock-free single-producer/
 * single-consumer ring buffer used by the streaming demo drivers
 * (BASELINE.json:11) to overlap host decode with device compute.
 *
 * Written from scratch; build: cc -O2 -shared -fPIC -o libasp_io.so asp_io.c
 */

#include <stdatomic.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

/* ---------------- WAV decode ---------------- */

typedef struct {
    int sample_rate;
    int num_channels;
    long num_frames;
    int bits;
    int float_fmt;
} asp_wav_info;

static uint32_t rd_u32(const uint8_t *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
         | ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t *p) {
    return (uint16_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8));
}

/* Formats this decoder understands (mirrors io/wav.py's accept set:
 * PCM 8/16/24/32 and IEEE float 32/64).  Anything else must ERROR, not
 * decode to silence. */
static int fmt_supported(const asp_wav_info *info) {
    if (info->float_fmt) return info->bits == 32 || info->bits == 64;
    return info->bits == 8 || info->bits == 16 || info->bits == 24
        || info->bits == 32;
}

/* Decode one interleaved sample at p -> float32 in [-1, 1].  Shared by
 * the whole-file and streaming readers so the two can never diverge. */
static float decode_sample(const asp_wav_info *info, const uint8_t *p) {
    if (info->float_fmt && info->bits == 32) {
        float fv; memcpy(&fv, p, 4); return fv;
    } else if (info->float_fmt && info->bits == 64) {
        double dv; memcpy(&dv, p, 8); return (float)dv;
    } else if (info->bits == 8) {
        return ((float)p[0] - 128.0f) / 128.0f;
    } else if (info->bits == 16) {
        int16_t s = (int16_t)rd_u16(p);
        return (float)s / 32768.0f;
    } else if (info->bits == 24) {
        int32_t s = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8)
                  | ((uint32_t)p[2] << 16));
        if (s >= (1 << 23)) s -= (1 << 24);
        return (float)s / 8388608.0f;
    }
    /* 32-bit PCM (fmt_supported guarantees no other case reaches here) */
    int32_t s = (int32_t)rd_u32(p);
    return (float)((double)s / 2147483648.0);
}

/* Parse header; returns 0 on success and fills info. */
int asp_wav_probe(const char *path, asp_wav_info *info) {
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
        memcmp(hdr + 8, "WAVE", 4)) { fclose(f); return -2; }
    int have_fmt = 0;
    long data_size = -1;
    int tag = 0, nch = 0, rate = 0, balign = 0, bits = 0;
    uint8_t ch[8];
    while (fread(ch, 1, 8, f) == 8) {
        uint32_t size = rd_u32(ch + 4);
        if (!memcmp(ch, "fmt ", 4)) {
            uint8_t body[40];
            if (size < 16) { fclose(f); return -3; }  /* truncated fmt */
            size_t take = size < sizeof(body) ? size : sizeof(body);
            if (fread(body, 1, take, f) != take) { fclose(f); return -3; }
            if (size > take) fseek(f, (long)(size - take), SEEK_CUR);
            tag = rd_u16(body);
            nch = rd_u16(body + 2);
            rate = (int)rd_u32(body + 4);
            balign = rd_u16(body + 12);
            bits = rd_u16(body + 14);
            if (tag == 0xFFFE && size >= 40) tag = rd_u16(body + 24);
            have_fmt = 1;
        } else if (!memcmp(ch, "data", 4)) {
            /* first data chunk wins (io/wav.py convention; the readers
             * decode from the first chunk, so the probe must size it) */
            if (data_size < 0) data_size = (long)size;
            fseek(f, (long)(size + (size & 1)), SEEK_CUR);  /* incl. RIFF pad */
        } else {
            fseek(f, (long)(size + (size & 1)), SEEK_CUR);
        }
    }
    fclose(f);
    if (!have_fmt || data_size < 0 || balign == 0) return -4;
    /* fmt consistency (io/wav.py parity): balign must equal nch*bits/8 */
    if (nch == 0 || balign != nch * (bits / 8)) return -4;
    /* only PCM (1) and IEEE float (3) exist in this decoder; a-law/
     * mu-law/ADPCM etc. must error, never be decoded as PCM */
    if (tag != 1 && tag != 3) return -7;
    info->sample_rate = rate;
    info->num_channels = nch;
    info->num_frames = data_size / balign;
    info->bits = bits;
    info->float_fmt = (tag == 3);
    return 0;
}

/* Decode whole file to planar float32 out[ch][frame] (out size nch*nframes).
 * Returns frames decoded, < 0 on error. */
long asp_wav_read(const char *path, float *out, long max_frames) {
    asp_wav_info info;
    int rc = asp_wav_probe(path, &info);
    if (rc) return rc;
    if (!fmt_supported(&info)) return -7;  /* never decode to silence */
    long nf = info.num_frames < max_frames ? info.num_frames : max_frames;
    int nch = info.num_channels;
    int bps = info.bits / 8;
    FILE *f = fopen(path, "rb");
    if (!f) return -1;
    /* find data chunk */
    uint8_t ch[8];
    fseek(f, 12, SEEK_SET);
    long data_pos = -1;
    while (fread(ch, 1, 8, f) == 8) {
        uint32_t size = rd_u32(ch + 4);
        if (!memcmp(ch, "data", 4)) { data_pos = ftell(f); break; }
        fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    }
    if (data_pos < 0) { fclose(f); return -5; }
    fseek(f, data_pos, SEEK_SET);
    long chunk = 65536;
    uint8_t *buf = (uint8_t *)malloc((size_t)(chunk * nch * bps));
    if (!buf) { fclose(f); return -1; }
    long done = 0;
    while (done < nf) {
        long want = nf - done < chunk ? nf - done : chunk;
        size_t got = fread(buf, (size_t)(nch * bps), (size_t)want, f);
        if (got == 0) break;
        for (long i = 0; i < (long)got; i++)
            for (int c = 0; c < nch; c++)
                out[(size_t)c * nf + done + i] =
                    decode_sample(&info, buf + (size_t)(i * nch + c) * bps);
        done += (long)got;
    }
    free(buf);
    fclose(f);
    return done;
}

/* ---------------- streaming reader ----------------
 *
 * Sequential block decoder for the ring-buffer streaming drivers
 * (BASELINE.json:11): a decode thread pulls fixed-size planar blocks
 * while the device thread consumes from the ring — the host-decode /
 * device-compute overlap the whole-file reader cannot provide. */

typedef struct {
    FILE *f;
    asp_wav_info info;
    long remaining;
    uint8_t *buf;   /* one interleaved block */
    long buf_frames;
} asp_wav_reader;

void *asp_wav_open(const char *path) {
    asp_wav_info info;
    if (asp_wav_probe(path, &info)) return NULL;
    if (!fmt_supported(&info)) return NULL;
    FILE *f = fopen(path, "rb");
    if (!f) return NULL;
    uint8_t ch[8];
    fseek(f, 12, SEEK_SET);
    long data_pos = -1;
    while (fread(ch, 1, 8, f) == 8) {
        uint32_t size = rd_u32(ch + 4);
        if (!memcmp(ch, "data", 4)) { data_pos = ftell(f); break; }
        fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    }
    if (data_pos < 0) { fclose(f); return NULL; }
    asp_wav_reader *r = (asp_wav_reader *)calloc(1, sizeof(*r));
    r->f = f;
    r->info = info;
    r->remaining = info.num_frames;
    r->buf = NULL;
    r->buf_frames = 0;
    return r;
}

int asp_wav_reader_info(void *h, asp_wav_info *info) {
    if (!h) return -1;
    *info = ((asp_wav_reader *)h)->info;
    return 0;
}

/* Decode the next `frames` frames into planar out[c*frames + i].
 * Returns frames decoded (< frames at EOF), < 0 on error. */
long asp_wav_read_block(void *h, float *out, long frames) {
    asp_wav_reader *r = (asp_wav_reader *)h;
    if (!r || frames <= 0) return -1;
    asp_wav_info *info = &r->info;
    int nch = info->num_channels;
    int bps = info->bits / 8;
    if (r->buf_frames < frames) {
        free(r->buf);
        r->buf = (uint8_t *)malloc((size_t)(frames * nch * bps));
        if (!r->buf) { r->buf_frames = 0; return -1; }
        r->buf_frames = frames;
    }
    long want = r->remaining < frames ? r->remaining : frames;
    if (want <= 0) return 0;
    size_t got = fread(r->buf, (size_t)(nch * bps), (size_t)want, r->f);
    for (long i = 0; i < (long)got; i++)
        for (int c = 0; c < nch; c++)
            out[(size_t)c * frames + i] =
                decode_sample(info, r->buf + (size_t)(i * nch + c) * bps);
    r->remaining -= (long)got;
    return (long)got;
}

void asp_wav_reader_close(void *h) {
    asp_wav_reader *r = (asp_wav_reader *)h;
    if (!r) return;
    if (r->f) fclose(r->f);
    free(r->buf);
    free(r);
}

/* Encode planar float32 -> WAV (bits: 16/24/32 PCM, or float_fmt). */
int asp_wav_write(const char *path, const float *x, int nch, long nframes,
                  int rate, int bits, int float_fmt) {
    /* the native encoder is float32-planar in, so IEEE-float output is
     * 32-bit only (a silent f64->f32 downgrade would betray callers
     * relying on round-trip precision — io/wav.py writes real float64;
     * any other bits + float_fmt means "float32", matching io/wav.py) */
    if (float_fmt && bits == 64) return -9;
    if (!float_fmt && bits != 8 && bits != 16 && bits != 24 && bits != 32) return -6;
    int bps = float_fmt ? 4 : bits / 8;
    if (float_fmt) bits = 32;
    long balign = nch * bps;
    long body = nframes * balign;
    long pad = body & 1;  /* RIFF chunks are word-aligned */
    /* RIFF sizes are uint32; a >4 GiB body would silently wrap the
     * header fields (every reader then sees a wrong frame count) */
    if (body < 0 || (unsigned long long)(36 + body + pad) > 0xFFFFFFFFull)
        return -8;
    FILE *f = fopen(path, "wb");
    if (!f) return -1;
    uint8_t hdr[44];
    memcpy(hdr, "RIFF", 4);
    uint32_t riff = (uint32_t)(36 + body + pad);
    memcpy(hdr + 4, &riff, 4);
    memcpy(hdr + 8, "WAVEfmt ", 8);
    uint32_t fmtsize = 16;
    memcpy(hdr + 16, &fmtsize, 4);
    uint16_t tag = float_fmt ? 3 : 1;
    uint16_t nch16 = (uint16_t)nch, bits16 = (uint16_t)bits,
             balign16 = (uint16_t)balign;
    uint32_t rate32 = (uint32_t)rate, brate = (uint32_t)(rate * balign);
    memcpy(hdr + 20, &tag, 2);
    memcpy(hdr + 22, &nch16, 2);
    memcpy(hdr + 24, &rate32, 4);
    memcpy(hdr + 28, &brate, 4);
    memcpy(hdr + 32, &balign16, 2);
    memcpy(hdr + 34, &bits16, 2);
    memcpy(hdr + 36, "data", 4);
    uint32_t body32 = (uint32_t)body;
    memcpy(hdr + 40, &body32, 4);
    fwrite(hdr, 1, 44, f);
    uint8_t *buf = (uint8_t *)malloc((size_t)balign);
    if (!buf) { fclose(f); return -1; }
    for (long i = 0; i < nframes; i++) {
        for (int c = 0; c < nch; c++) {
            double v = (double)x[(size_t)c * nframes + i];
            uint8_t *p = buf + (size_t)c * bps;
            if (float_fmt) {
                float fv = (float)v; memcpy(p, &fv, 4);
            } else if (bits == 8) {
                double s = v * 128.0;
                if (s > 127.0) s = 127.0;
                if (s < -128.0) s = -128.0;
                p[0] = (uint8_t)(llrint(s) + 128);
            } else if (bits == 16) {
                double s = v * 32768.0;
                if (s > 32767.0) s = 32767.0;
                if (s < -32768.0) s = -32768.0;
                int16_t q = (int16_t)llrint(s);  /* half-to-even, numpy-compatible */
                memcpy(p, &q, 2);
            } else if (bits == 24) {
                double s = v * 8388608.0;
                if (s > 8388607.0) s = 8388607.0;
                if (s < -8388608.0) s = -8388608.0;
                int32_t q = (int32_t)llrint(s);
                p[0] = (uint8_t)(q & 0xFF);
                p[1] = (uint8_t)((q >> 8) & 0xFF);
                p[2] = (uint8_t)((q >> 16) & 0xFF);
            } else { /* 32-bit PCM */
                double s = v * 2147483648.0;
                if (s > 2147483647.0) s = 2147483647.0;
                if (s < -2147483648.0) s = -2147483648.0;
                int32_t q = (int32_t)llrint(s);
                memcpy(p, &q, 4);
            }
        }
        fwrite(buf, 1, (size_t)balign, f);
    }
    if (pad) fputc(0, f);
    free(buf);
    fclose(f);
    return 0;
}

/* ---------------- SPSC ring buffer (streaming host pipeline) --------- */

typedef struct {
    float *data;
    long capacity;   /* in frames */
    int nch;
    /* SPSC: producer advances head with a release store after the data
     * stores; consumer advances tail likewise.  Acquire loads on the
     * opposite index order the data reads. */
    _Atomic long head;  /* written frames (producer) */
    _Atomic long tail;  /* consumed frames (consumer) */
} asp_ring;

asp_ring *asp_ring_create(int nch, long capacity) {
    asp_ring *r = (asp_ring *)calloc(1, sizeof(asp_ring));
    r->data = (float *)malloc(sizeof(float) * (size_t)capacity * (size_t)nch);
    r->capacity = capacity;
    r->nch = nch;
    return r;
}

void asp_ring_destroy(asp_ring *r) {
    if (r) { free(r->data); free(r); }
}

long asp_ring_writable(asp_ring *r) {
    long head = atomic_load_explicit(&r->head, memory_order_relaxed);
    long tail = atomic_load_explicit(&r->tail, memory_order_acquire);
    return r->capacity - (head - tail);
}

long asp_ring_readable(asp_ring *r) {
    long head = atomic_load_explicit(&r->head, memory_order_acquire);
    long tail = atomic_load_explicit(&r->tail, memory_order_relaxed);
    return head - tail;
}

/* Push planar x[ch][frames]; returns frames pushed. */
long asp_ring_push(asp_ring *r, const float *x, long frames) {
    long can = asp_ring_writable(r);
    long head = atomic_load_explicit(&r->head, memory_order_relaxed);
    long n = frames < can ? frames : can;
    for (long i = 0; i < n; i++) {
        long slot = (head + i) % r->capacity;
        for (int c = 0; c < r->nch; c++)
            r->data[(size_t)c * r->capacity + slot] = x[(size_t)c * frames + i];
    }
    atomic_store_explicit(&r->head, head + n, memory_order_release);
    return n;
}

/* Pop exactly `frames` planar frames into out[ch][frames] (zero-pad short
 * reads at stream end when `pad` != 0); returns frames popped. */
long asp_ring_pop(asp_ring *r, float *out, long frames, int pad) {
    long have = asp_ring_readable(r);
    long tail = atomic_load_explicit(&r->tail, memory_order_relaxed);
    long n = frames < have ? frames : have;
    for (long i = 0; i < n; i++) {
        long slot = (tail + i) % r->capacity;
        for (int c = 0; c < r->nch; c++)
            out[(size_t)c * frames + i] = r->data[(size_t)c * r->capacity + slot];
    }
    if (pad && n < frames)
        for (int c = 0; c < r->nch; c++)
            memset(out + (size_t)c * frames + n, 0,
                   sizeof(float) * (size_t)(frames - n));
    atomic_store_explicit(&r->tail, tail + n, memory_order_release);
    return n;
}
