/* JPEG decoding on the host, bit-equal to Pillow on libjpeg-turbo.
 *
 * The function is Pillow's `Image.open(b)`, optionally `draft("RGB", (d, d))`,
 * then `load()` and `convert("RGB")`: uint8 [H, W, 3]. It follows the steps
 * libjpeg-turbo takes for Pillow's decoder settings (islow IDCT, fancy
 * upsampling, scale 1/s with s from Pillow's draft rule):
 *
 *   markers     jdmarker.c: SOI, APPn (JFIF in APP0 and Adobe in APP14 are
 *               read, the rest skipped), COM, DQT (8- and 16-bit), DHT, DRI,
 *               SOF0/1/2, SOS, RSTn, EOI, fill bytes, stuffed bytes and the
 *               restart resync of jpeg_resync_to_restart;
 *   entropy     jdhuff.c (sequential) and jdphuff.c (progressive: DC first
 *               and refine, AC first and refine with EOB runs), with the
 *               refills of jdhuff.c's slow path and of its fast path (taken
 *               while 512 bytes a block remain), so that data that ends
 *               early is refused exactly where libjpeg suspends and Pillow
 *               raises, and zero bits are read past a marker met inside
 *               entropy data where libjpeg reads them; in a sequential
 *               file, tables 0 and 1 not defined by the first SOS are the
 *               standard ones (jstdhuff.c, for Motion-JPEG frames);
 *   smoothing   jdcoefct.c decompress_smooth_data: a progressive file
 *               whose first nine AC coefficients are not all known when
 *               the output starts (an EOI before the last scans, scans
 *               never sent, a scan cut by a marker) is smoothed as
 *               libjpeg-turbo smooths it;
 *   IDCT        libjpeg-turbo's x86-64 SIMD IDCTs as Pillow runs them
 *               (jidctint-avx2.asm for 8x8, jidctred-sse2.asm for 4x4 and
 *               2x2; jidctred.c's 1x1), which equal jidctint.c and
 *               jidctred.c on every valid file and saturate where those
 *               wrap on coefficients only corrupt data reaches (the C
 *               8x8 and 4x4 run first, a block whose values leave their
 *               common range again on the SIMD path); each component's
 *               scaled size chosen as jdmaster.c does;
 *   upsampling  jdsample.c: fancy h2v1, h2v2 and h1v2, and the box
 *               upsampler for the other integral factors (h1v2 and the
 *               factors past 2 are not written by Pillow and are untested
 *               here), edge rows replicated as jdmainct.c does;
 *   colour      jdcolor.c YCbCr->RGB (SCALEBITS 16), grey replicated,
 *               RGB kept (Adobe transform 0, or 'R','G','B' component ids),
 *               YCCK->CMYK; CMYK read as Pillow's "CMYK;I" (inverted) and
 *               converted by Pillow's Convert.c cmyk2rgb.
 *
 * Corrupt data that Pillow reads with warnings decodes as Pillow decodes
 * it. Arithmetic coding, lossless JPEG and sample precisions other than 8 bits
 * are reported as not supported.
 *
 * Interface (plain C, loaded with ctypes):
 *   int jpeg_header(const uint8_t *data, size_t len, int draft, int out[3])
 *     out = {width, height, kind} of the decoded image; draft is Pillow's
 *     draft size (0: full decode);
 *   int jpeg_decode(const uint8_t *data, size_t len, int draft, uint8_t *rgb)
 *     rgb: height x width x 3 bytes.
 * Both return JD_OK, JD_CORRUPT (Pillow would raise on open or load),
 * JD_UNSUPPORTED (then out[2] of jpeg_header holds a JD_WHY_* reason),
 * JD_TOO_LARGE (more pixels than Pillow's DecompressionBombError limit,
 * found before anything is allocated) or JD_NO_MEMORY.
 */
#include <setjmp.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define JD_OK 0
#define JD_CORRUPT 1
#define JD_UNSUPPORTED 2
#define JD_TOO_LARGE 3
#define JD_NO_MEMORY 4
#define JD_SUSPEND 5 /* internal: the data ended where libjpeg suspends */

#define JD_WHY_ARITHMETIC 1
#define JD_WHY_LOSSLESS 2
#define JD_WHY_PRECISION 3

/* kind: the colour space, plus JD_KIND_PROGRESSIVE */
#define JD_KIND_GREY 1
#define JD_KIND_YCBCR 2
#define JD_KIND_RGB 3
#define JD_KIND_CMYK 4
#define JD_KIND_YCCK 5
#define JD_KIND_PROGRESSIVE 16

/* Pillow: 2 * Image.MAX_IMAGE_PIXELS */
#define MAX_PIXELS 178956970LL
/* jdhuff.c: BIT_BUF_SIZE - 7 with a 64-bit bit buffer */
#define MIN_GET_BITS 57
#define MAX_BLOCKS_IN_MCU 10

static const int natural_order[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    /* past the end, for corrupt runs (jutils.c) */
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

/* jstdhuff.c: the tables of JPEG Annex K.3 */
static const uint8_t std_dc_bits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t std_ac_bits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
static const uint8_t std_ac_vals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

typedef struct { /* a DHT table as defined */
  uint8_t bits[17]; /* bits[l]: codes of length l */
  uint8_t vals[256];
  int defined;
} htbl_t;

typedef struct { /* jdhuff.c's d_derived_tbl */
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[256]; /* (length << 8) | symbol; length 9: longer code */
  uint8_t vals[256];
} dtbl_t;

typedef struct {
  int id, h, v, tq;
  int dc_tbl, ac_tbl;    /* of the current scan */
  int bw, bh;            /* width_in_blocks, height_in_blocks */
  int bwp, bhp;          /* blocks allocated: whole MCUs */
  int16_t *coef;         /* bhp x bwp blocks of 64, natural order */
  int16_t quant[64];     /* latched at the component's first scan, as
                            libjpeg's ISLOW_MULT_TYPE (short) holds it */
  uint16_t qval[64];     /* the same table unwrapped (block smoothing) */
  int latched;
  int coef_bits[10];     /* jdphuff.c's coef_bits of zigzag 0..9: the
                            current point transform Al, -1 before any
                            scan */
  int prev_bits[10];     /* the same before the component's last scan */
  int ss;                /* DCT scaled size: 8, 4, 2 or 1 */
  int dw, dh;            /* downsampled_width, downsampled_height */
  uint8_t *plane;        /* bh*ss rows of bw*ss samples */
  int pw;
  int mcu_w, mcu_h;      /* blocks of this component in an MCU of the scan */
} comp_t;

typedef struct {
  const uint8_t *data;
  size_t len, pos;
  jmp_buf jb;
  /* bit reader (jdhuff.c's bitread state) */
  uint64_t gbuf;
  int bits;
  int unread_marker;
  int insufficient;
  /* tables */
  uint16_t qt[4][64];
  int qt_defined[4];
  htbl_t dc[4], ac[4];
  dtbl_t dcd[4], acd[4];
  int restart_interval;
  /* frame */
  int saw_soi, saw_sof, saw_jfif, saw_adobe, adobe_transform;
  int progressive, width, height, ncomp, maxh, maxv;
  int multiple_scans, finishing;
  int draft, minss, out_w, out_h, colorspace;
  comp_t comp[4];
  /* scan */
  int comps_in_scan;
  comp_t *scan[4];
  int Ss, Se, Ah, Al;
  int scan_number;       /* jdinput.c's input_scan_number */
  int last_good_imcu;    /* the last iMCU row of the last scan in which an
                            MCU began with data left (jdcoefct.c's
                            last_good_iMCU_row) */
  int next_restart_num, restarts_to_go, eobrun;
  int last_dc[4];
  int mcus_per_row, mcu_rows, blocks_in_mcu;
  int why;
  int code; /* the JD_* status a longjmp carries */
} dec_t;

static void fail(dec_t *d, int code) {
  d->code = code;
  longjmp(d->jb, 1);
}

/* --- byte input and markers (jdmarker.c) --------------------------------- */

static int getb(dec_t *d) {
  if (d->pos >= d->len) fail(d, JD_SUSPEND);
  return d->data[d->pos++];
}

static int get2(dec_t *d) {
  int hi = getb(d);
  return (hi << 8) | getb(d);
}

static void skip_bytes(dec_t *d, long n) {
  if (n <= 0) return;
  if ((size_t)n > d->len - d->pos) fail(d, JD_SUSPEND);
  d->pos += (size_t)n;
}

static void next_marker(dec_t *d) {
  int c;
  for (;;) {
    c = getb(d);
    while (c != 0xFF) c = getb(d);
    do c = getb(d); while (c == 0xFF);
    if (c != 0) break;
  }
  d->unread_marker = c;
}

static void get_dqt(dec_t *d) {
  long length = get2(d) - 2;
  while (length > 0) {
    int n, prec, i;
    length--;
    n = getb(d);
    prec = n >> 4;
    n &= 0x0F;
    if (n >= 4) fail(d, JD_CORRUPT);
    for (i = 0; i < 64; i++)
      d->qt[n][natural_order[i]] = (uint16_t)(prec ? get2(d) : getb(d));
    length -= 64;
    if (prec) length -= 64;
    d->qt_defined[n] = 1;
  }
  if (length != 0) fail(d, JD_CORRUPT);
}

static void get_dht(dec_t *d) {
  long length = get2(d) - 2;
  while (length > 16) {
    int index = getb(d), count = 0, i;
    uint8_t bits[17], vals[256];
    htbl_t *t;
    bits[0] = 0;
    for (i = 1; i <= 16; i++) {
      bits[i] = (uint8_t)getb(d);
      count += bits[i];
    }
    length -= 1 + 16;
    if (count > 256 || count > length) fail(d, JD_CORRUPT);
    memset(vals, 0, sizeof vals);
    for (i = 0; i < count; i++) vals[i] = (uint8_t)getb(d);
    length -= count;
    if (index & 0x10) {
      index -= 0x10;
      if (index >= 4) fail(d, JD_CORRUPT);
      t = &d->ac[index];
    } else {
      if (index >= 4) fail(d, JD_CORRUPT);
      t = &d->dc[index];
    }
    memcpy(t->bits, bits, sizeof bits);
    memcpy(t->vals, vals, sizeof vals);
    t->defined = 1;
  }
  if (length != 0) fail(d, JD_CORRUPT);
}

static void get_dri(dec_t *d) {
  if (get2(d) != 4) fail(d, JD_CORRUPT);
  d->restart_interval = get2(d);
}

/* APP0 and APP14: jdmarker.c get_interesting_appn */
static void get_appn(dec_t *d, int marker) {
  long length = get2(d) - 2;
  uint8_t b[14];
  int n = length >= 14 ? 14 : (length > 0 ? (int)length : 0), i;
  for (i = 0; i < n; i++) b[i] = (uint8_t)getb(d);
  length -= n;
  if (marker == 0xE0 && n >= 14 && !memcmp(b, "JFIF\0", 5))
    d->saw_jfif = 1;
  if (marker == 0xEE && n >= 12 && !memcmp(b, "Adobe", 5)) {
    d->saw_adobe = 1;
    d->adobe_transform = b[11];
  }
  skip_bytes(d, length);
}

static void skip_variable(dec_t *d) { skip_bytes(d, (long)get2(d) - 2); }

static void get_sof(dec_t *d, int marker) {
  int length, precision, i;
  if (d->saw_sof) fail(d, JD_CORRUPT);
  length = get2(d);
  precision = getb(d);
  d->height = get2(d);
  d->width = get2(d);
  d->ncomp = getb(d);
  if (marker == 0xC3 || marker >= 0xC9) {
    d->why = marker == 0xC3 ? JD_WHY_LOSSLESS : JD_WHY_ARITHMETIC;
    fail(d, JD_UNSUPPORTED);
  }
  if (precision != 8) {
    d->why = JD_WHY_PRECISION;
    fail(d, JD_UNSUPPORTED);
  }
  /* Pillow opens 1, 3 and 4 layers only */
  if (d->height <= 0 || d->width <= 0 || !(d->ncomp == 1 || d->ncomp == 3
                                           || d->ncomp == 4))
    fail(d, JD_CORRUPT);
  if (length - 8 != d->ncomp * 3) fail(d, JD_CORRUPT);
  for (i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    int s;
    c->id = getb(d);
    s = getb(d);
    c->h = (s >> 4) & 15;
    c->v = s & 15;
    c->tq = getb(d);
  }
  d->progressive = marker == 0xC2;
  d->saw_sof = 1;
  if ((long long)d->width * d->height > MAX_PIXELS) fail(d, JD_TOO_LARGE);
}

static void get_sos(dec_t *d) {
  int length, n, i, c;
  if (!d->saw_sof) fail(d, JD_CORRUPT);
  length = get2(d);
  n = getb(d);
  if (length != n * 2 + 6 || n < 1 || n > 4) fail(d, JD_CORRUPT);
  d->comps_in_scan = n;
  for (i = 0; i < 4; i++) d->scan[i] = NULL;
  for (i = 0; i < n; i++) {
    int cc = getb(d), ci, found = -1;
    c = getb(d);
    for (ci = 0; ci < d->ncomp; ci++) {
      int used = 0, k;
      for (k = 0; k < i; k++) used |= d->scan[k] == &d->comp[ci];
      if (cc == d->comp[ci].id && !used) {
        found = ci;
        break;
      }
    }
    if (found < 0) fail(d, JD_CORRUPT);
    d->scan[i] = &d->comp[found];
    d->scan[i]->dc_tbl = (c >> 4) & 15;
    d->scan[i]->ac_tbl = c & 15;
  }
  d->Ss = getb(d);
  d->Se = getb(d);
  c = getb(d);
  d->Ah = (c >> 4) & 15;
  d->Al = c & 15;
  d->next_restart_num = 0;
}

/* jdmarker.c read_markers: returns 0xDA (SOS) or 0xD9 (EOI) */
static int read_markers(dec_t *d) {
  for (;;) {
    int m;
    if (d->unread_marker == 0) {
      if (!d->saw_soi) {
        int c = getb(d), c2 = getb(d);
        if (c != 0xFF || c2 != 0xD8) fail(d, JD_CORRUPT);
        d->unread_marker = c2;
      } else {
        next_marker(d);
      }
    }
    m = d->unread_marker;
    d->unread_marker = 0;
    switch (m) {
    case 0xD8:
      if (d->saw_soi) fail(d, JD_CORRUPT);
      d->saw_soi = 1;
      d->restart_interval = 0;
      break;
    case 0xC0: case 0xC1: case 0xC2: case 0xC3:
    case 0xC9: case 0xCA: case 0xCB:
      get_sof(d, m);
      break;
    case 0xC5: case 0xC6: case 0xC7: case 0xC8:
    case 0xCD: case 0xCE: case 0xCF:
      fail(d, JD_CORRUPT); /* hierarchical: libjpeg refuses them */
      break;
    case 0xDA:
      get_sos(d);
      return m;
    case 0xD9:
      return m;
    case 0xCC: /* DAC: arithmetic conditioning, unused by Huffman scans */
      skip_variable(d);
      break;
    case 0xC4:
      get_dht(d);
      break;
    case 0xDB:
      get_dqt(d);
      break;
    case 0xDD:
      get_dri(d);
      break;
    case 0xE0: case 0xEE:
      get_appn(d, m);
      break;
    case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
    case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC:
    case 0xED: case 0xEF: case 0xFE:
      skip_variable(d);
      break;
    case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
    case 0xD6: case 0xD7: case 0x01:
      break;
    case 0xDC: /* DNL */
      skip_variable(d);
      break;
    default:
      fail(d, JD_CORRUPT);
    }
  }
}

/* --- Huffman decoding (jdhuff.c) ----------------------------------------- */

static void make_dtbl(dec_t *d, int is_dc, int tblno, dtbl_t *dt) {
  const htbl_t *t;
  char huffsize[257];
  unsigned int huffcode[257], code;
  int p, i, l, si, numsymbols;
  if (tblno < 0 || tblno >= 4) fail(d, JD_CORRUPT);
  t = is_dc ? &d->dc[tblno] : &d->ac[tblno];
  if (!t->defined) fail(d, JD_CORRUPT);
  p = 0;
  for (l = 1; l <= 16; l++) {
    i = t->bits[l];
    if (p + i > 256) fail(d, JD_CORRUPT);
    while (i--) huffsize[p++] = (char)l;
  }
  huffsize[p] = 0;
  numsymbols = p;
  code = 0;
  si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while ((int)huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if ((int64_t)code >= ((int64_t)1 << si)) fail(d, JD_CORRUPT);
    code <<= 1;
    si++;
  }
  p = 0;
  for (l = 1; l <= 16; l++) {
    if (t->bits[l]) {
      dt->valoffset[l] = (int32_t)p - (int32_t)huffcode[p];
      p += t->bits[l];
      dt->maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      dt->maxcode[l] = -1;
    }
  }
  dt->valoffset[17] = 0;
  dt->maxcode[17] = 0xFFFFF;
  for (i = 0; i < 256; i++) dt->lookup[i] = 9 << 8;
  p = 0;
  for (l = 1; l <= 8; l++) {
    for (i = 1; i <= (int)t->bits[l]; i++, p++) {
      int lookbits = (int)(huffcode[p] << (8 - l)), ctr;
      for (ctr = 1 << (8 - l); ctr > 0; ctr--)
        dt->lookup[lookbits++] = (uint16_t)((l << 8) | t->vals[p]);
    }
  }
  memcpy(dt->vals, t->vals, 256);
  if (is_dc) {
    for (i = 0; i < numsymbols; i++)
      if (t->vals[i] > 15) fail(d, JD_CORRUPT);
  }
}

static void fill_bits(dec_t *d, int nbits) {
  if (d->unread_marker == 0) {
    while (d->bits < MIN_GET_BITS) {
      int c;
      if (d->pos >= d->len) fail(d, JD_SUSPEND);
      c = d->data[d->pos++];
      if (c == 0xFF) {
        do {
          if (d->pos >= d->len) fail(d, JD_SUSPEND);
          c = d->data[d->pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          d->unread_marker = c;
          goto no_more_bytes;
        }
      }
      d->gbuf = (d->gbuf << 8) | (uint64_t)c;
      d->bits += 8;
    }
    return;
  }
no_more_bytes:
  if (nbits > d->bits) {
    d->insufficient = 1;
    d->gbuf <<= MIN_GET_BITS - d->bits;
    d->bits = MIN_GET_BITS;
  }
}

static inline void check_bits(dec_t *d, int n) {
  if (d->bits < n) fill_bits(d, n);
}

static inline int get_bits(dec_t *d, int n) {
  d->bits -= n;
  return (int)(d->gbuf >> d->bits) & ((1 << n) - 1);
}

static int huff_slow(dec_t *d, const dtbl_t *t, int l) {
  int32_t code;
  check_bits(d, l);
  code = get_bits(d, l);
  while (code > t->maxcode[l]) {
    code <<= 1;
    check_bits(d, 1);
    code |= get_bits(d, 1);
    l++;
  }
  if (l > 16) return 0; /* garbage: libjpeg fakes a zero */
  return t->vals[(int)(t->valoffset[l] + code) & 0xFF];
}

static inline int huff_decode(dec_t *d, const dtbl_t *t) {
  int look, nb;
  if (d->bits < 8) {
    fill_bits(d, 0);
    if (d->bits < 8) return huff_slow(d, t, 1);
  }
  look = (int)(d->gbuf >> (d->bits - 8)) & 0xFF;
  nb = t->lookup[look] >> 8;
  if (nb <= 8) {
    d->bits -= nb;
    return t->lookup[look] & 0xFF;
  }
  return huff_slow(d, t, 9);
}

static inline int huff_extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

/* --- scans --------------------------------------------------------------- */

static inline int16_t *block_at(comp_t *c, int row, int col) {
  return c->coef + ((size_t)row * c->bwp + col) * 64;
}

static void process_restart(dec_t *d) {
  int i;
  d->bits = 0;
  /* jdmarker.c read_restart_marker */
  if (d->unread_marker == 0) next_marker(d);
  if (d->unread_marker == 0xD0 + d->next_restart_num) {
    d->unread_marker = 0;
  } else { /* jpeg_resync_to_restart */
    int desired = d->next_restart_num, marker = d->unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0)
        action = 2;
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;
      else if (marker == 0xD0 + ((desired + 1) & 7)
               || marker == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7)
               || marker == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        d->unread_marker = 0;
        break;
      }
      if (action == 3) break;
      next_marker(d);
      marker = d->unread_marker;
    }
  }
  d->next_restart_num = (d->next_restart_num + 1) & 7;
  for (i = 0; i < d->comps_in_scan; i++) d->last_dc[i] = 0;
  d->eobrun = 0;
  d->restarts_to_go = d->restart_interval;
  if (d->unread_marker == 0) d->insufficient = 0;
}

/* jdhuff.c decode_mcu_slow for one block */
static void decode_block_seq(dec_t *d, int ci, comp_t *c, int16_t *blk) {
  const dtbl_t *dct = &d->dcd[c->dc_tbl], *act = &d->acd[c->ac_tbl];
  int s, k, r;
  s = huff_decode(d, dct);
  if (s) {
    check_bits(d, s);
    r = get_bits(d, s);
    s = huff_extend(r, s);
  }
  s = (int)((unsigned)s + (unsigned)d->last_dc[ci]);
  d->last_dc[ci] = s;
  blk[0] = (int16_t)s;
  for (k = 1; k < 64; k++) {
    s = huff_decode(d, act);
    r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      check_bits(d, s);
      r = get_bits(d, s);
      blk[natural_order[k]] = (int16_t)huff_extend(r, s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void dc_first(dec_t *d, int ci, comp_t *c, int16_t *blk) {
  int s, r;
  int64_t v;
  s = huff_decode(d, &d->dcd[c->dc_tbl]);
  if (s) {
    check_bits(d, s);
    r = get_bits(d, s);
    s = huff_extend(r, s);
  }
  v = (int64_t)s + d->last_dc[ci];
  if (v > INT32_MAX || v < INT32_MIN) fail(d, JD_CORRUPT);
  d->last_dc[ci] = (int)v;
  blk[0] = (int16_t)(uint32_t)((uint32_t)(int32_t)v << d->Al);
}

static void ac_first(dec_t *d, comp_t *c, int16_t *blk) {
  const dtbl_t *t = &d->acd[c->ac_tbl];
  int s, k, r;
  if (d->eobrun > 0) {
    d->eobrun--;
    return;
  }
  for (k = d->Ss; k <= d->Se; k++) {
    s = huff_decode(d, t);
    r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      check_bits(d, s);
      r = get_bits(d, s);
      s = huff_extend(r, s);
      blk[natural_order[k]] = (int16_t)((unsigned)s << d->Al);
    } else if (r == 15) {
      k += 15;
    } else {
      d->eobrun = 1 << r;
      if (r) {
        check_bits(d, r);
        d->eobrun += get_bits(d, r);
      }
      d->eobrun--;
      break;
    }
  }
}

static inline void refine_coef(dec_t *d, int16_t *coef, int p1, int m1) {
  check_bits(d, 1);
  if (get_bits(d, 1)) {
    if ((*coef & p1) == 0) {
      if (*coef >= 0)
        *coef = (int16_t)(*coef + p1);
      else
        *coef = (int16_t)(*coef + m1);
    }
  }
}

static void ac_refine(dec_t *d, comp_t *c, int16_t *blk) {
  const dtbl_t *t = &d->acd[c->ac_tbl];
  int p1 = 1 << d->Al, m1 = (int)((unsigned)-1 << d->Al);
  int s, k = d->Ss, r;
  if (d->eobrun == 0) {
    for (; k <= d->Se; k++) {
      s = huff_decode(d, t);
      r = s >> 4;
      s &= 15;
      if (s) {
        check_bits(d, 1);
        s = get_bits(d, 1) ? p1 : m1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) {
          check_bits(d, r);
          d->eobrun += get_bits(d, r);
        }
        break;
      }
      do {
        int16_t *coef = blk + natural_order[k];
        if (*coef != 0) {
          refine_coef(d, coef, p1, m1);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= d->Se);
      if (s) blk[natural_order[k]] = (int16_t)s;
    }
  }
  if (d->eobrun > 0) {
    for (; k <= d->Se; k++) {
      int16_t *coef = blk + natural_order[k];
      if (*coef != 0) refine_coef(d, coef, p1, m1);
    }
    d->eobrun--;
  }
}

/* jdhuff.c decode_mcu_fast: taken while the data left holds BUFSIZE bytes
   a block; refills six bytes at a time with no check for the data's end,
   and a marker met is backed out of and read as zero bytes. */
#define FAST_GET_BYTE                                                       \
  do {                                                                      \
    int c0 = d->data[d->pos++], c1 = d->data[d->pos];                      \
    d->gbuf = (d->gbuf << 8) | (uint64_t)c0;                                \
    d->bits += 8;                                                           \
    if (c0 == 0xFF) {                                                       \
      d->pos++;                                                             \
      if (c1 != 0) {                                                        \
        d->unread_marker = c1;                                              \
        d->pos -= 2;                                                        \
        d->gbuf &= ~(uint64_t)0xFF;                                         \
      }                                                                     \
    }                                                                       \
  } while (0)
#define FAST_FILL                                                           \
  do {                                                                      \
    if (d->bits <= 16) {                                                    \
      FAST_GET_BYTE; FAST_GET_BYTE; FAST_GET_BYTE;                          \
      FAST_GET_BYTE; FAST_GET_BYTE; FAST_GET_BYTE;                          \
    }                                                                       \
  } while (0)

static inline int huff_decode_fast(dec_t *d, const dtbl_t *t) {
  int s, nb;
  FAST_FILL;
  s = t->lookup[(int)(d->gbuf >> (d->bits - 8)) & 0xFF];
  nb = s >> 8;
  d->bits -= nb;
  s &= 0xFF;
  if (nb > 8) {
    s = (int)(d->gbuf >> d->bits) & ((1 << nb) - 1);
    while (s > t->maxcode[nb]) {
      s <<= 1;
      s |= get_bits(d, 1);
      nb++;
    }
    s = nb > 16 ? 0 : t->vals[(int)(s + t->valoffset[nb]) & 0xFF];
  }
  return s;
}

static void decode_block_fast(dec_t *d, int ci, comp_t *c, int16_t *blk) {
  const dtbl_t *dct = &d->dcd[c->dc_tbl], *act = &d->acd[c->ac_tbl];
  int s, k, r;
  s = huff_decode_fast(d, dct);
  if (s) {
    FAST_FILL;
    r = get_bits(d, s);
    s = huff_extend(r, s);
  }
  s = (int)((unsigned)s + (unsigned)d->last_dc[ci]);
  d->last_dc[ci] = s;
  blk[0] = (int16_t)s;
  for (k = 1; k < 64; k++) {
    s = huff_decode_fast(d, act);
    r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      FAST_FILL;
      r = get_bits(d, s);
      blk[natural_order[k]] = (int16_t)huff_extend(r, s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void decode_block(dec_t *d, int ci, comp_t *c, int16_t *blk) {
  if (!d->progressive)
    decode_block_seq(d, ci, c, blk);
  else if (d->Ss == 0 && d->Ah == 0)
    dc_first(d, ci, c, blk);
  else if (d->Ss == 0) { /* DC refinement: the next bit of each DC */
    check_bits(d, 1);
    if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << d->Al));
  } else if (d->Ah == 0)
    ac_first(d, c, blk);
  else
    ac_refine(d, c, blk);
}

static void start_scan(dec_t *d) {
  int i;
  d->scan_number++;
  for (i = 0; i < d->comps_in_scan; i++) { /* jdinput.c latch_quant_tables */
    comp_t *c = d->scan[i];
    int k;
    if (c->latched) continue;
    if (c->tq >= 4 || !d->qt_defined[c->tq]) fail(d, JD_CORRUPT);
    for (k = 0; k < 64; k++) {
      c->qval[k] = d->qt[c->tq][k];
      c->quant[k] = (int16_t)c->qval[k];
    }
    c->latched = 1;
  }
  if (d->comps_in_scan == 1) { /* jdinput.c per_scan_setup */
    comp_t *c = d->scan[0];
    d->mcus_per_row = c->bw;
    d->mcu_rows = c->bh;
    c->mcu_w = c->mcu_h = 1;
    d->blocks_in_mcu = 1;
  } else {
    d->mcus_per_row = (d->width + d->maxh * 8 - 1) / (d->maxh * 8);
    d->mcu_rows = (d->height + d->maxv * 8 - 1) / (d->maxv * 8);
    d->blocks_in_mcu = 0;
    for (i = 0; i < d->comps_in_scan; i++) {
      comp_t *c = d->scan[i];
      c->mcu_w = c->h;
      c->mcu_h = c->v;
      d->blocks_in_mcu += c->h * c->v;
      if (d->blocks_in_mcu > MAX_BLOCKS_IN_MCU) fail(d, JD_CORRUPT);
    }
  }
  if (d->progressive) { /* jdphuff.c start_pass_phuff_decoder */
    int dc_band = d->Ss == 0, bad = 0;
    if (dc_band) {
      if (d->Se != 0) bad = 1;
    } else {
      if (d->Ss > d->Se || d->Se > 63) bad = 1;
      if (d->comps_in_scan != 1) bad = 1;
    }
    if (d->Ah != 0 && d->Al != d->Ah - 1) bad = 1;
    if (d->Al > 13) bad = 1;
    if (bad) fail(d, JD_CORRUPT);
    for (i = 0; i < d->comps_in_scan; i++) {
      comp_t *c = d->scan[i];
      int k;
      for (k = d->Ss < 1 ? d->Ss : 1; k < 10; k++)
        c->prev_bits[k] = d->scan_number > 1 ? c->coef_bits[k] : 0;
      for (k = d->Ss; k <= d->Se && k < 10; k++) c->coef_bits[k] = d->Al;
      if (dc_band) {
        if (d->Ah == 0) make_dtbl(d, 1, c->dc_tbl, &d->dcd[c->dc_tbl]);
      } else {
        make_dtbl(d, 0, c->ac_tbl, &d->acd[c->ac_tbl]);
      }
    }
  } else { /* jdhuff.c start_pass_huff_decoder */
    for (i = 0; i < d->comps_in_scan; i++) {
      comp_t *c = d->scan[i];
      make_dtbl(d, 1, c->dc_tbl, &d->dcd[c->dc_tbl]);
      make_dtbl(d, 0, c->ac_tbl, &d->acd[c->ac_tbl]);
    }
  }
  for (i = 0; i < 4; i++) d->last_dc[i] = 0;
  d->bits = 0;
  d->gbuf = 0;
  d->insufficient = 0;
  d->eobrun = 0;
  d->restarts_to_go = d->restart_interval;
}

/* jdhuff.c's BUFSIZE (DCTSIZE2 * 8): libjpeg takes its fast Huffman path
   while this many bytes a block of the MCU remain, and that choice moves
   where a truncated file runs out, so it must be exactly libjpeg's */
#define FAST_MARGIN 512

/* one MCU on the fast path; if it met a marker, the MCU's blocks and the
   reader are put back and 0 returned, for the slow path to decode it */
static int decode_mcu_fast(dec_t *d, int mrow, int mcol) {
  int16_t saved[MAX_BLOCKS_IN_MCU][64];
  int16_t *blocks[MAX_BLOCKS_IN_MCU];
  int last_dc[4], i, n = 0;
  size_t pos = d->pos;
  uint64_t gbuf = d->gbuf;
  int bits = d->bits;
  memcpy(last_dc, d->last_dc, sizeof last_dc);
  for (i = 0; i < d->comps_in_scan; i++) {
    comp_t *c = d->scan[i];
    int y, x;
    for (y = 0; y < c->mcu_h; y++)
      for (x = 0; x < c->mcu_w; x++) {
        blocks[n] = block_at(c, mrow * c->mcu_h + y, mcol * c->mcu_w + x);
        memcpy(saved[n], blocks[n], sizeof saved[n]);
        decode_block_fast(d, i, c, blocks[n]);
        n++;
      }
  }
  if (d->unread_marker == 0) return 1;
  d->unread_marker = 0;
  for (i = 0; i < n; i++) memcpy(blocks[i], saved[i], sizeof saved[i]);
  memcpy(d->last_dc, last_dc, sizeof last_dc);
  d->pos = pos;
  d->gbuf = gbuf;
  d->bits = bits;
  return 0;
}

static void decode_scan(dec_t *d) {
  int mrow, mcol;
  start_scan(d);
  for (mrow = 0; mrow < d->mcu_rows; mrow++) {
    /* an iMCU row is v block rows of a one-component scan */
    int v = d->comps_in_scan == 1 ? d->scan[0]->v : 1;
    for (mcol = 0; mcol < d->mcus_per_row; mcol++) {
      int i;
      /* consume_data's test, before the MCU's restart marker is read */
      if (!d->insufficient) d->last_good_imcu = mrow / v;
      if (d->restart_interval) {
        if (d->restarts_to_go == 0) process_restart(d);
        d->restarts_to_go--;
      }
      /* out of data: the MCU keeps what it holds (zeros in a first pass);
         a DC refinement reads on, as libjpeg's does */
      if (d->insufficient && !(d->progressive && d->Ss == 0 && d->Ah != 0))
        continue;
      if (!d->progressive && !d->restart_interval && d->unread_marker == 0
          && d->len - d->pos >= (size_t)FAST_MARGIN * d->blocks_in_mcu
          && decode_mcu_fast(d, mrow, mcol))
        continue;
      for (i = 0; i < d->comps_in_scan; i++) {
        comp_t *c = d->scan[i];
        int y, x;
        for (y = 0; y < c->mcu_h; y++)
          for (x = 0; x < c->mcu_w; x++)
            decode_block(d, i, c,
                         block_at(c, mrow * c->mcu_h + y,
                                  mcol * c->mcu_w + x));
      }
    }
  }
}

/* --- frame set-up (jdinput.c initial_setup, jdmaster.c) ------------------ */

static void alloc_or_fail(dec_t *d, void **p, size_t n) {
  *p = calloc(n, 1);
  if (*p == NULL) fail(d, JD_NO_MEMORY);
}

static void ensure_std_tables(dec_t *d) {
  int t;
  for (t = 0; t < 2; t++) {
    if (!d->dc[t].defined) {
      int i;
      memset(&d->dc[t], 0, sizeof d->dc[t]);
      memcpy(d->dc[t].bits + 1, std_dc_bits[t], 16);
      for (i = 0; i < 12; i++) d->dc[t].vals[i] = (uint8_t)i;
      d->dc[t].defined = 1;
    }
    if (!d->ac[t].defined) {
      memset(&d->ac[t], 0, sizeof d->ac[t]);
      memcpy(d->ac[t].bits + 1, std_ac_bits[t], 16);
      memcpy(d->ac[t].vals, std_ac_vals[t], 162);
      d->ac[t].defined = 1;
    }
  }
}

/* geometry of the frame at draft scale: no allocation */
static void frame_geometry(dec_t *d) {
  int i, s, scale = 1;
  if (d->width > 65500 || d->height > 65500) fail(d, JD_CORRUPT);
  d->maxh = d->maxv = 1;
  for (i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4) fail(d, JD_CORRUPT);
    if (c->h > d->maxh) d->maxh = c->h;
    if (c->v > d->maxv) d->maxv = c->v;
  }
  /* PIL/JpegImagePlugin.py JpegImageFile.draft */
  if (d->draft > 0) {
    int fit = d->width / d->draft < d->height / d->draft
                  ? d->width / d->draft : d->height / d->draft;
    for (scale = 8; scale > 1 && fit < scale; scale /= 2) {
    }
  }
  d->minss = 8 / scale;
  d->out_w = (d->width + scale - 1) / scale;
  d->out_h = (d->height + scale - 1) / scale;
  for (i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    long lw = (long)d->maxh * 8, lh = (long)d->maxv * 8;
    c->bw = (int)(((long)d->width * c->h + lw - 1) / lw);
    c->bh = (int)(((long)d->height * c->v + lh - 1) / lh);
    c->bwp = (d->width + d->maxh * 8 - 1) / (d->maxh * 8) * c->h;
    c->bhp = (d->height + d->maxv * 8 - 1) / (d->maxv * 8) * c->v;
    /* jdmaster.c: raise a component's scaled size while that keeps its
       upsampling integral */
    s = d->minss;
    while (s < 8 && (d->maxh * d->minss) % (c->h * s * 2) == 0
           && (d->maxv * d->minss) % (c->v * s * 2) == 0)
      s *= 2;
    c->ss = s;
    c->dw = (int)(((long)d->width * c->h * s + lw - 1) / lw);
    c->dh = (int)(((long)d->height * c->v * s + lh - 1) / lh);
    c->pw = c->bw * s;
  }
  /* jdapimin.c default_decompress_parms */
  if (d->ncomp == 1) {
    d->colorspace = JD_KIND_GREY;
  } else if (d->ncomp == 3) {
    if (d->saw_jfif)
      d->colorspace = JD_KIND_YCBCR;
    else if (d->saw_adobe)
      d->colorspace = d->adobe_transform == 0 ? JD_KIND_RGB : JD_KIND_YCBCR;
    else if (d->comp[0].id == 82 && d->comp[1].id == 71
             && d->comp[2].id == 66)
      d->colorspace = JD_KIND_RGB;
    else
      d->colorspace = JD_KIND_YCBCR;
  } else {
    d->colorspace = d->saw_adobe && d->adobe_transform != 0 ? JD_KIND_YCCK
                                                             : JD_KIND_CMYK;
  }
}

static void setup_frame(dec_t *d) {
  int i;
  for (i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    int hin = c->h * c->ss / d->minss, vin = c->v * c->ss / d->minss;
    /* jdsample.c refuses fractional factors */
    if (d->maxh % hin || d->maxv % vin) fail(d, JD_CORRUPT);
    alloc_or_fail(d, (void **)&c->coef,
                  (size_t)c->bwp * c->bhp * 64 * sizeof(int16_t));
    memset(c->coef_bits, -1, sizeof c->coef_bits);
  }
  d->multiple_scans = d->comps_in_scan < d->ncomp || d->progressive;
  /* jdhuff.c's jinit_huff_decoder installs them; jdphuff.c's does not, so
     a progressive scan naming an undefined table fails */
  if (!d->progressive) ensure_std_tables(d);
}

/* --- inverse DCTs (libjpeg-turbo's x86-64 SIMD IDCTs) --------------------
 *
 * Pillow's libjpeg-turbo runs jidctint-avx2.asm (8x8) and jidctred-sse2.asm
 * (4x4, 2x2); jidctred.c's 1x1 stays in C. On every coefficient a valid
 * file yields they give jidctint.c's and jidctred.c's results; past that
 * they keep the SIMD registers' arithmetic, followed here:
 * - dequantisation keeps the low 16 bits of coef * quant (pmullw);
 * - the sums the SIMD forms in words wrap at 16 bits (in0 +- in4 and the
 *   odd part's z3, z4 of the islow), other sums and products wrap at 32;
 * - pass 1's outputs saturate to 16 bits (packssdw), but the 2x2's
 *   column 0, which pass 2 takes in 32 bits and shifts by 15 there;
 * - pass 2's outputs saturate to 16 bits, then to [-128, 127]
 *   (packsswb), and +128 centres them, where the C table wraps;
 * - the islow and 4x4 take pass 1's DC-only shortcut when a whole block's
 *   coefficient rows other than 0 (and, at 4x4, 4) are zero, as a 16-bit
 *   shift (psllw), where the C code tests column by column;
 * - the islow's even and odd parts are the SIMD's rotations of
 *   jidctint.c's: the same integers wherever no word wraps.
 * Held bit for bit against Pillow by tests/test_torch_jpeg_corrupt.py,
 * whose writer codes chosen coefficients. */

#define CONST_BITS 13
#define PASS1_BITS 2
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static inline int32_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
static inline int32_t w32(int64_t x) { return (int32_t)(uint32_t)(uint64_t)x; }
static inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : x > 32767 ? 32767 : x;
}
/* a 32-bit descale: paddd of the rounding term, psrad */
static inline int32_t descale32(int32_t x, int n) {
  return w32((int64_t)x + ((int64_t)1 << (n - 1))) >> n;
}
/* packssdw, packsswb, paddb 128 */
static inline uint8_t out_sample(int32_t x) {
  x = sat16(x);
  return (uint8_t)((x < -128 ? -128 : x > 127 ? 127 : x) + 128);
}

static inline uint8_t range_limit(int64_t x) { /* jidctred.c's table */
  int i = (int)x & 1023;
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

/* jidctint-avx2.asm's 8-point pass on 16-bit inputs: out = the 8 outputs
   descaled by `shift`, before any saturation */
static void islow_pass(const int32_t *x, int step, int shift, int32_t *out) {
  int32_t x0 = x[0], x1 = x[step], x2 = x[2 * step], x3 = x[3 * step];
  int32_t x4 = x[4 * step], x5 = x[5 * step], x6 = x[6 * step];
  int32_t x7 = x[7 * step];
  int32_t tmp3 = w32((int64_t)x2 * 10703 + (int64_t)x6 * 4433);
  int32_t tmp2 = w32((int64_t)x2 * 4433 + (int64_t)x6 * -10704);
  int32_t tmp0 = w16(x0 + x4) * (1 << CONST_BITS);
  int32_t tmp1 = w16(x0 - x4) * (1 << CONST_BITS);
  int32_t tmp10 = w32((int64_t)tmp0 + tmp3), tmp13 = w32((int64_t)tmp0 - tmp3);
  int32_t tmp11 = w32((int64_t)tmp1 + tmp2), tmp12 = w32((int64_t)tmp1 - tmp2);
  int32_t z3 = w16(x7 + x3), z4 = w16(x5 + x1);
  int32_t r3 = w32((int64_t)z3 * -6436 + (int64_t)z4 * 9633);
  int32_t r4 = w32((int64_t)z3 * 9633 + (int64_t)z4 * 6437);
  int32_t o0 = w32(w32((int64_t)x7 * -4927 + (int64_t)x1 * -7373) + (int64_t)r3);
  int32_t o3 = w32(w32((int64_t)x7 * -7373 + (int64_t)x1 * 4926) + (int64_t)r4);
  int32_t o1 = w32(w32((int64_t)x5 * -4176 + (int64_t)x3 * -20995) + (int64_t)r4);
  int32_t o2 = w32(w32((int64_t)x5 * -20995 + (int64_t)x3 * 4177) + (int64_t)r3);
  out[0] = descale32(w32((int64_t)tmp10 + o3), shift);
  out[7] = descale32(w32((int64_t)tmp10 - o3), shift);
  out[1] = descale32(w32((int64_t)tmp11 + o2), shift);
  out[6] = descale32(w32((int64_t)tmp11 - o2), shift);
  out[2] = descale32(w32((int64_t)tmp12 + o1), shift);
  out[5] = descale32(w32((int64_t)tmp12 - o1), shift);
  out[3] = descale32(w32((int64_t)tmp13 + o0), shift);
  out[4] = descale32(w32((int64_t)tmp13 - o0), shift);
}

/* the block's coefficient rows other than 0 (and `skip`) all zero: the
   SIMD pass 1's DC-only test */
static int rows_zero(const int16_t *in, int skip) {
  int k;
  for (k = 8; k < 64; k++)
    if (in[k] != 0 && k / 8 != skip) return 0;
  return 1;
}

static void idct_islow_simd(const int16_t *in, const int16_t *q,
                            uint8_t *out, int stride) {
  int32_t c[64], ws[64], o[8];
  int r, col;
  for (r = 0; r < 64; r++) c[r] = w16((int32_t)in[r] * q[r]);
  if (rows_zero(in, 0)) {
    for (col = 0; col < 8; col++)
      for (r = 0; r < 8; r++) ws[r * 8 + col] = w16(c[col] * (1 << PASS1_BITS));
  } else {
    for (col = 0; col < 8; col++) {
      islow_pass(c + col, 8, CONST_BITS - PASS1_BITS, o);
      for (r = 0; r < 8; r++) ws[r * 8 + col] = sat16(o[r]);
    }
  }
  for (r = 0; r < 8; r++) {
    uint8_t *op = out + (size_t)r * stride;
    islow_pass(ws + 8 * r, 1, CONST_BITS + PASS1_BITS + 3, o);
    for (col = 0; col < 8; col++) op[col] = out_sample(o[col]);
  }
}

/* jidctred-sse2.asm's 4-point pass (inputs 0, 1, 2, 3, 5, 6, 7) */
static void red4_pass(const int32_t *x, int step, int shift, int32_t *out) {
  int32_t tmp0 = x[0] * (1 << (CONST_BITS + 1));
  int32_t tmp2 = w32((int64_t)x[2 * step] * 15137 + (int64_t)x[6 * step] * -6270);
  int32_t tmp10 = w32((int64_t)tmp0 + tmp2), tmp12 = w32((int64_t)tmp0 - tmp2);
  int32_t z1 = x[7 * step], z2 = x[5 * step], z3 = x[3 * step], z4 = x[step];
  int32_t o0 = w32((int64_t)w32((int64_t)z1 * -1730 + (int64_t)z2 * 11893)
                   + w32((int64_t)z3 * -17799 + (int64_t)z4 * 8697));
  int32_t o2 = w32((int64_t)w32((int64_t)z1 * -4176 + (int64_t)z2 * -4926)
                   + w32((int64_t)z3 * 7373 + (int64_t)z4 * 20995));
  out[0] = descale32(w32((int64_t)tmp10 + o2), shift);
  out[3] = descale32(w32((int64_t)tmp10 - o2), shift);
  out[1] = descale32(w32((int64_t)tmp12 + o0), shift);
  out[2] = descale32(w32((int64_t)tmp12 - o0), shift);
}

static void idct_4x4_simd(const int16_t *in, const int16_t *q,
                          uint8_t *out, int stride) {
  int32_t c[64], ws[32], o[4];
  int r, col, dc_only = rows_zero(in, 4);
  for (r = 0; r < 64; r++) c[r] = w16((int32_t)in[r] * q[r]);
  for (col = 0; col < 8; col++) {
    if (dc_only) {
      for (r = 0; r < 4; r++) ws[r * 8 + col] = w16(c[col] * (1 << PASS1_BITS));
      continue;
    }
    red4_pass(c + col, 8, CONST_BITS - PASS1_BITS + 1, o);
    for (r = 0; r < 4; r++) ws[r * 8 + col] = sat16(o[r]);
  }
  for (r = 0; r < 4; r++) {
    uint8_t *op = out + (size_t)r * stride;
    red4_pass(ws + 8 * r, 1, CONST_BITS + PASS1_BITS + 3 + 1, o);
    for (col = 0; col < 4; col++) op[col] = out_sample(o[col]);
  }
}

/* --- the C IDCTs (jidctint.c jpeg_idct_islow, jidctred.c jpeg_idct_4x4) ---
 *
 * The SIMD IDCTs give jidctint.c's and jidctred.c's integers wherever no
 * word wraps or saturates. The C code skips zero columns and rows at less
 * cost, so it runs first and flags a block in which a pass-1 output leaves
 * [-16384, 16383] (then a word sum could wrap or a pack saturate; a
 * column's largest output is at least 4 times its largest dequantised
 * coefficient, so the 16-bit dequantisation cannot wrap either) or an
 * output before the +128 leaves [-512, 511] (where the C table wraps and
 * the SIMD clamps); a flagged block is done again on the SIMD path.
 * Photos' blocks stay inside: corrupt data and extreme coefficients
 * leave. */

#define LSHIFT(x, n) ((int64_t)((uint64_t)(int64_t)(x) << (n)))
/* OR-ed over a pass's values, x + lim has a bit at or above 2 lim (a power
   of two) set when some x left [-lim, lim - 1] */
#define SPREAD(x, lim) ((uint32_t)((int32_t)(x) + (lim)))

/* jpeg_idct_islow; returns nonzero when the block needs the SIMD path */
static int idct_islow_c(const int16_t *in, const int16_t *q, uint8_t *out,
                        int stride) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;
  int ws[64], ctr;
  uint32_t spread = 0;
  for (ctr = 0; ctr < 8; ctr++) {
    const int16_t *ip = in + ctr, *qp = q + ctr;
    int *wp = ws + ctr, k;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0
        && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)LSHIFT(ip[0] * qp[0], PASS1_BITS);
      spread |= SPREAD(dc, 16384);
      for (k = 0; k < 8; k++) wp[8 * k] = dc;
      continue;
    }
    z2 = ip[16] * qp[16];
    z3 = ip[48] * qp[48];
    z1 = (z2 + z3) * 4433;
    tmp2 = z1 + z3 * -15137;
    tmp3 = z1 + z2 * 6270;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    tmp0 = LSHIFT(z2 + z3, CONST_BITS);
    tmp1 = LSHIFT(z2 - z3, CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * 9633;
    tmp0 = tmp0 * 2446;
    tmp1 = tmp1 * 16819;
    tmp2 = tmp2 * 25172;
    tmp3 = tmp3 * 12299;
    z1 = z1 * -7373;
    z2 = z2 * -20995;
    z3 = z3 * -16069;
    z4 = z4 * -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
    for (k = 0; k < 64; k += 8) spread |= SPREAD(wp[k], 16384);
  }
  if (spread >= 32768) return 1;
  spread = 0;
  for (ctr = 0; ctr < 8; ctr++) {
    const int *wp = ws + 8 * ctr;
    uint8_t *op = out + (size_t)ctr * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0
        && wp[6] == 0 && wp[7] == 0) {
      int64_t dc = DESCALE((int64_t)wp[0], PASS1_BITS + 3);
      spread |= SPREAD(dc, 512);
      memset(op, range_limit(dc), 8);
      continue;
    }
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * 4433;
    tmp2 = z1 + z3 * -15137;
    tmp3 = z1 + z2 * 6270;
    tmp0 = LSHIFT((int64_t)wp[0] + wp[4], CONST_BITS);
    tmp1 = LSHIFT((int64_t)wp[0] - wp[4], CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * 9633;
    tmp0 = tmp0 * 2446;
    tmp1 = tmp1 * 16819;
    tmp2 = tmp2 * 25172;
    tmp3 = tmp3 * 12299;
    z1 = z1 * -7373;
    z2 = z2 * -20995;
    z3 = z3 * -16069;
    z4 = z4 * -3196;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
#define OUT8(k, x)                                                          \
  do {                                                                        \
    int64_t v_ = DESCALE(x, CONST_BITS + PASS1_BITS + 3);                     \
    spread |= SPREAD(v_, 512);                                                \
    op[k] = range_limit(v_);                                                  \
  } while (0)
    OUT8(0, tmp10 + tmp3);
    OUT8(7, tmp10 - tmp3);
    OUT8(1, tmp11 + tmp2);
    OUT8(6, tmp11 - tmp2);
    OUT8(2, tmp12 + tmp1);
    OUT8(5, tmp12 - tmp1);
    OUT8(3, tmp13 + tmp0);
    OUT8(4, tmp13 - tmp0);
#undef OUT8
  }
  return spread >= 1024;
}

/* jpeg_idct_4x4 (pass 2 reads no column 4, pass 1 no row 4); returns
   nonzero when the block needs the SIMD path */
static int idct_4x4_c(const int16_t *in, const int16_t *q, uint8_t *out,
                      int stride) {
  int64_t tmp0, tmp2, tmp10, tmp12, z1, z2, z3, z4;
  int ws[8 * 4], ctr;
  uint32_t spread = 0;
  for (ctr = 0; ctr < 8; ctr++) {
    const int16_t *ip = in + ctr, *qp = q + ctr;
    int *wp = ws + ctr, k;
    if (ctr == 4) continue;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[40] == 0
        && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)LSHIFT(ip[0] * qp[0], PASS1_BITS);
      spread |= SPREAD(dc, 16384);
      wp[0] = wp[8] = wp[16] = wp[24] = dc;
      continue;
    }
    tmp0 = LSHIFT(ip[0] * qp[0], CONST_BITS + 1);
    z2 = ip[16] * qp[16];
    z3 = ip[48] * qp[48];
    tmp2 = z2 * 15137 + z3 * -6270;
    tmp10 = tmp0 + tmp2;
    tmp12 = tmp0 - tmp2;
    z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    z4 = ip[8] * qp[8];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
    wp[0] = (int)DESCALE(tmp10 + tmp2, CONST_BITS - PASS1_BITS + 1);
    wp[24] = (int)DESCALE(tmp10 - tmp2, CONST_BITS - PASS1_BITS + 1);
    wp[8] = (int)DESCALE(tmp12 + tmp0, CONST_BITS - PASS1_BITS + 1);
    wp[16] = (int)DESCALE(tmp12 - tmp0, CONST_BITS - PASS1_BITS + 1);
    for (k = 0; k < 32; k += 8) spread |= SPREAD(wp[k], 16384);
  }
  if (spread >= 32768) return 1;
  spread = 0;
  for (ctr = 0; ctr < 4; ctr++) {
    const int *wp = ws + 8 * ctr;
    uint8_t *op = out + (size_t)ctr * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[5] == 0 && wp[6] == 0
        && wp[7] == 0) {
      int64_t dc = DESCALE((int64_t)wp[0], PASS1_BITS + 3);
      spread |= SPREAD(dc, 512);
      op[0] = op[1] = op[2] = op[3] = range_limit(dc);
      continue;
    }
    tmp0 = LSHIFT(wp[0], CONST_BITS + 1);
    tmp2 = (int64_t)wp[2] * 15137 + (int64_t)wp[6] * -6270;
    tmp10 = tmp0 + tmp2;
    tmp12 = tmp0 - tmp2;
    z1 = wp[7];
    z2 = wp[5];
    z3 = wp[3];
    z4 = wp[1];
    tmp0 = z1 * -1730 + z2 * 11893 + z3 * -17799 + z4 * 8697;
    tmp2 = z1 * -4176 + z2 * -4926 + z3 * 7373 + z4 * 20995;
#define OUT4(k, x)                                                          \
  do {                                                                        \
    int64_t v_ = DESCALE(x, CONST_BITS + PASS1_BITS + 3 + 1);                 \
    spread |= SPREAD(v_, 512);                                                \
    op[k] = range_limit(v_);                                                  \
  } while (0)
    OUT4(0, tmp10 + tmp2);
    OUT4(3, tmp10 - tmp2);
    OUT4(1, tmp12 + tmp0);
    OUT4(2, tmp12 - tmp0);
#undef OUT4
  }
  return spread >= 1024;
}

static void idct_islow(const int16_t *in, const int16_t *q, uint8_t *out,
                       int stride) {
  if (idct_islow_c(in, q, out, stride)) idct_islow_simd(in, q, out, stride);
}

static void idct_4x4(const int16_t *in, const int16_t *q, uint8_t *out,
                     int stride) {
  if (idct_4x4_c(in, q, out, stride)) idct_4x4_simd(in, q, out, stride);
}

/* jidctred-sse2.asm's 2-point odd part (inputs 1, 3, 5, 7) */
static inline int32_t red2_odd(const int32_t *x, int step) {
  return w32((int64_t)w32((int64_t)x[step] * 29692
                          + (int64_t)x[3 * step] * -10426)
             + w32((int64_t)x[5 * step] * 6967 + (int64_t)x[7 * step] * -5906));
}

static void idct_2x2(const int16_t *in, const int16_t *q, uint8_t *out,
                     int stride) {
  int32_t c[64], ws[16];
  int r, col;
  for (r = 0; r < 64; r++) c[r] = w16((int32_t)in[r] * q[r]);
  for (col = 0; col < 8; col++) {
    int32_t tmp10 = c[col] * (1 << (CONST_BITS + 2)), tmp0;
    if (col == 2 || col == 4 || col == 6) continue;
    tmp0 = red2_odd(c + col, 8);
    ws[col] = descale32(w32((int64_t)tmp10 + tmp0), CONST_BITS - PASS1_BITS + 2);
    ws[8 + col] = descale32(w32((int64_t)tmp10 - tmp0),
                            CONST_BITS - PASS1_BITS + 2);
    if (col) { /* column 0 goes on in 32 bits */
      ws[col] = sat16(ws[col]);
      ws[8 + col] = sat16(ws[8 + col]);
    }
  }
  for (r = 0; r < 2; r++) {
    const int32_t *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    int32_t tmp10 = w32((int64_t)(uint32_t)wp[0] << (CONST_BITS + 2));
    int32_t tmp0 = red2_odd(wp, 1);
    op[0] = out_sample(descale32(w32((int64_t)tmp10 + tmp0),
                                 CONST_BITS + PASS1_BITS + 3 + 2));
    op[1] = out_sample(descale32(w32((int64_t)tmp10 - tmp0),
                                 CONST_BITS + PASS1_BITS + 3 + 2));
  }
}

static void idct_1x1(const int16_t *in, const int16_t *q, uint8_t *out,
                     int stride) {
  (void)stride;
  out[0] = range_limit(DESCALE((int64_t)(in[0] * q[0]), 3));
}

/* --- block smoothing (jdcoefct.c decompress_smooth_data) ---------------
 *
 * libjpeg-turbo smooths a progressive file whose first nine AC
 * coefficients (zigzag 1..9) are not all known to full precision when the
 * output starts: an EOI before the last scans, or scans never sent. Each
 * such coefficient that is still zero gets an estimate from the DC values
 * of the block's 5x5 neighbourhood, bounded by what its missing bits could
 * hold; when no AC data came at all, the DC itself is re-estimated by a
 * Gaussian-like kernel and four more coefficients are estimated. The
 * neighbours come from libjpeg's row and column walk, edges replicated,
 * with its own count of a component's last iMCU row. */

static const int smooth_pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

/* jdcoefct.c smoothing_ok, after every scan has been read */
static int smoothing_ok(const dec_t *d) {
  int i, k, useful = 0;
  if (!d->progressive) return 0;
  for (i = 0; i < d->ncomp; i++) {
    const comp_t *c = &d->comp[i];
    if (!c->latched) return 0;
    for (k = 0; k < 10; k++)
      if (c->qval[smooth_pos[k]] == 0) return 0;
    if (c->coef_bits[0] < 0) return 0;
    for (k = 1; k < 10; k++)
      if (c->coef_bits[k] != 0) useful = 1;
  }
  return useful;
}

/* an estimate of num / (q << 8), rounded, capped below 2^Al where Al > 0 */
static int16_t estimate(int64_t num, int64_t q, int al) {
  int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
  if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return (int16_t)(num >= 0 ? pred : -pred);
}

static void smooth_block(const comp_t *c, const int *cb, const int dc[25],
                         int16_t *ws, int change_dc) {
  int64_t q00 = c->qval[0];
#define DC(n) ((int64_t)dc[(n) - 1])
  if (cb[1] != 0 && ws[1] == 0)
    ws[1] = estimate(q00 * (change_dc
      ? -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7)
        - 13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14)
        + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20)
        - DC(21) - DC(22) + DC(24) + DC(25)
      : -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)),
      c->qval[1], cb[1]);
  if (cb[2] != 0 && ws[8] == 0)
    ws[8] = estimate(q00 * (change_dc
      ? -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6)
        + 13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16)
        - 13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21)
        + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25)
      : -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)),
      c->qval[8], cb[2]);
  if (cb[3] != 0 && ws[16] == 0)
    ws[16] = estimate(q00 * (change_dc
      ? DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13)
        - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23)
      : -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)),
      c->qval[16], cb[3]);
  if (cb[4] != 0 && ws[9] == 0)
    ws[9] = estimate(q00 * (change_dc
      ? -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19)
        + DC(21) - DC(25)
      : DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20)
        + DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)),
      c->qval[9], cb[4]);
  if (cb[5] != 0 && ws[2] == 0)
    ws[2] = estimate(q00 * (change_dc
      ? 2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12)
        - 14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18)
        + 2 * DC(19)
      : -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)),
      c->qval[2], cb[5]);
  if (!change_dc) return;
  if (cb[6] != 0 && ws[3] == 0)
    ws[3] = estimate(q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17)
                            - DC(19)), c->qval[3], cb[6]);
  if (cb[7] != 0 && ws[10] == 0)
    ws[10] = estimate(q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18)
                             - DC(19)), c->qval[10], cb[7]);
  if (cb[8] != 0 && ws[17] == 0)
    ws[17] = estimate(q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14)
                             + DC(17) - DC(19)), c->qval[17], cb[8]);
  if (cb[9] != 0 && ws[24] == 0)
    ws[24] = estimate(q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18)
                             - DC(19)), c->qval[24], cb[9]);
  ws[0] = estimate(q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4)
                          - 2 * DC(5) - 6 * DC(6) + 6 * DC(7) + 42 * DC(8)
                          + 6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12)
                          + 152 * DC(13) + 42 * DC(14) - 8 * DC(15)
                          - 6 * DC(16) + 6 * DC(17) + 42 * DC(18)
                          + 6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22)
                          - 8 * DC(23) - 6 * DC(24) - 2 * DC(25)),
                   q00, -1);
#undef DC
}

typedef void (*idct_fn)(const int16_t *, const int16_t *, uint8_t *, int);

/* decompress_smooth_data's walk over one component: rows in iMCU rows of
   v block rows, the neighbour rows chosen from libjpeg's row counts (which
   take the last iMCU row's block rows for every iMCU row there), the DC
   window slid along each row */
static void smooth_plane(const dec_t *d, comp_t *c, idct_fn idct) {
  int total = (d->height + d->maxv * 8 - 1) / (d->maxv * 8), imcu;
  int last = c->bw - 1, bits[2][10], k;
  /* the latches: the coefficient bits now, and before the component's last
     scan, which rows past the last scan's last good row take */
  for (k = 0; k < 10; k++) {
    bits[0][k] = c->coef_bits[k];
    bits[1][k] = d->scan_number > 1 ? c->prev_bits[k] : -1;
  }
  for (imcu = 0; imcu < total; imcu++) {
    const int *cb = bits[imcu > d->last_good_imcu];
    int rows = imcu < total - 1 ? c->v : (c->bh % c->v ? c->bh % c->v : c->v);
    int image_rows = rows * total, change_dc = 1, br;
    for (k = 1; k < 10; k++) /* no AC data at all: the DC is estimated too */
      if (cb[k] != -1) change_dc = 0;
    for (br = 0; br < rows; br++) {
      int ibr = imcu * rows + br, row = imcu * c->v + br;
      int nrow[5], dc[25], x, j, col;
      nrow[2] = row;
      nrow[1] = ibr > 0 ? row - 1 : row;
      nrow[0] = ibr > 1 ? row - 2 : nrow[1];
      nrow[3] = ibr < image_rows - 1 ? row + 1 : row;
      nrow[4] = ibr < image_rows - 2 ? row + 2 : nrow[3];
      /* dc[j * 5 + x]: libjpeg's DC01..DC25, rows nrow[j], columns col - 2
         .. col + 2 (edges replicated), slid left after each block */
      for (j = 0; j < 5; j++)
        for (x = 0; x < 5; x++) dc[j * 5 + x] = block_at(c, nrow[j], 0)[0];
      for (col = 0; col <= last; col++) {
        int16_t ws[64];
        memcpy(ws, block_at(c, row, col), sizeof ws);
        if (col == 0 && col < last) /* the next column, in both places */
          for (j = 0; j < 5; j++)
            dc[j * 5 + 3] = dc[j * 5 + 4] = block_at(c, nrow[j], 1)[0];
        if (col + 1 < last)
          for (j = 0; j < 5; j++)
            dc[j * 5 + 4] = block_at(c, nrow[j], col + 2)[0];
        smooth_block(c, cb, dc, ws, change_dc);
        idct(ws, c->quant,
             c->plane + (size_t)row * c->ss * c->pw + (size_t)col * c->ss,
             c->pw);
        for (j = 0; j < 5; j++)
          for (x = 0; x < 4; x++) dc[j * 5 + x] = dc[j * 5 + x + 1];
      }
    }
  }
}

static void component_plane(dec_t *d, comp_t *c, int smooth) {
  idct_fn idct = c->ss == 8 ? idct_islow : c->ss == 4 ? idct_4x4
                                         : c->ss == 2 ? idct_2x2 : idct_1x1;
  int r, col;
  /* a component no scan held: libjpeg's quantisation table is all zeros */
  if (!c->latched) memset(c->quant, 0, sizeof c->quant);
  alloc_or_fail(d, (void **)&c->plane, (size_t)c->pw * c->bh * c->ss);
  if (smooth) {
    smooth_plane(d, c, idct);
    return;
  }
  for (r = 0; r < c->bh; r++)
    for (col = 0; col < c->bw; col++)
      idct(block_at(c, r, col), c->quant,
           c->plane + (size_t)r * c->ss * c->pw + (size_t)col * c->ss, c->pw);
}

/* --- upsampling (jdsample.c) and colour (jdcolor.c) ---------------------- */

typedef struct {
  int mode; /* 0 full size, 1 h2v1 fancy, 2 h2v2 fancy, 3 h1v2 fancy, 4 box */
  int he, ve; /* box factors */
} upsample_t;

static upsample_t choose_upsample(dec_t *d, const comp_t *c) {
  upsample_t u = {4, 1, 1};
  int hin = c->h * c->ss / d->minss, vin = c->v * c->ss / d->minss;
  int hout = d->maxh, vout = d->maxv, fancy = d->minss > 1;
  if (hin == hout && vin == vout)
    u.mode = 0;
  else if (hin * 2 == hout && vin == vout && fancy && c->dw > 2)
    u.mode = 1;
  else if (hin == hout && vin * 2 == vout && fancy)
    u.mode = 3;
  else if (hin * 2 == hout && vin * 2 == vout && fancy && c->dw > 2)
    u.mode = 2;
  u.he = hout / hin;
  u.ve = vout / vin;
  return u;
}

/* output row y of component c, out_w samples, into row (or a pointer into
   the plane when no upsampling is needed) */
static const uint8_t *upsample_row(const dec_t *d, const comp_t *c,
                                   upsample_t u, int y, uint8_t *row) {
  int w = d->out_w, x, dw = c->dw;
  const uint8_t *p = c->plane;
  size_t pw = (size_t)c->pw;
  switch (u.mode) {
  case 0:
    return p + (size_t)y * pw;
  case 1: { /* h2v1_fancy_upsample */
    const uint8_t *in = p + (size_t)y * pw;
    for (x = 0; x < w; x++) {
      int i = x >> 1;
      if (x & 1)
        row[x] = i == dw - 1 ? in[i] : (uint8_t)((in[i] * 3 + in[i + 1] + 2) >> 2);
      else
        row[x] = i == 0 ? in[0] : (uint8_t)((in[i] * 3 + in[i - 1] + 1) >> 2);
    }
    return row;
  }
  case 2: { /* h2v2_fancy_upsample, rows past the edges replicated */
    int r = y >> 1, o = (y & 1) ? (r + 1 < c->dh ? r + 1 : c->dh - 1)
                                : (r > 0 ? r - 1 : 0);
    const uint8_t *in0 = p + (size_t)r * pw, *in1 = p + (size_t)o * pw;
    int last = 0, this = in0[0] * 3 + in1[0], next;
    for (x = 0; x < w; x++) {
      int i = x >> 1;
      if (x & 1) {
        if (i == dw - 1) {
          row[x] = (uint8_t)((this * 4 + 7) >> 4);
        } else {
          next = in0[i + 1] * 3 + in1[i + 1];
          row[x] = (uint8_t)((this * 3 + next + 7) >> 4);
          last = this;
          this = next;
        }
      } else {
        row[x] = i == 0 ? (uint8_t)((this * 4 + 8) >> 4)
                        : (uint8_t)((this * 3 + last + 8) >> 4);
      }
    }
    return row;
  }
  case 3: { /* h1v2_fancy_upsample */
    int r = y >> 1, o = (y & 1) ? (r + 1 < c->dh ? r + 1 : c->dh - 1)
                                : (r > 0 ? r - 1 : 0);
    int bias = (y & 1) ? 2 : 1;
    const uint8_t *in0 = p + (size_t)r * pw, *in1 = p + (size_t)o * pw;
    for (x = 0; x < w; x++)
      row[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    return row;
  }
  default: { /* h2v1_upsample, h2v2_upsample, int_upsample */
    const uint8_t *in = p + (size_t)(y / u.ve) * pw;
    if (u.he == 1) return in;
    for (x = 0; x < w; x++) row[x] = in[x / u.he];
    return row;
  }
  }
}

static inline uint8_t clamp255(int x) {
  return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
}

static void emit_rgb(dec_t *d, uint8_t *rgb) {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  upsample_t u[4];
  uint8_t *rows[4] = {NULL, NULL, NULL, NULL};
  int i, y, x, n = d->ncomp;
  for (i = 0; i < 256; i++) { /* jdcolor.c build_ycc_rgb_table */
    int64_t v = i - 128;
    cr_r[i] = (int32_t)((91881 * v + 32768) >> 16);
    cb_b[i] = (int32_t)((116130 * v + 32768) >> 16);
    cr_g[i] = (int32_t)(-46802 * v);
    cb_g[i] = (int32_t)(-22554 * v + 32768);
  }
  for (i = 0; i < n; i++) {
    u[i] = choose_upsample(d, &d->comp[i]);
    alloc_or_fail(d, (void **)&rows[i], (size_t)d->out_w + 16);
  }
  for (y = 0; y < d->out_h; y++) {
    const uint8_t *s[4];
    uint8_t *o = rgb + (size_t)y * d->out_w * 3;
    for (i = 0; i < n; i++) s[i] = upsample_row(d, &d->comp[i], u[i], y, rows[i]);
    switch (d->colorspace) {
    case JD_KIND_GREY:
      for (x = 0; x < d->out_w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[0][x];
      break;
    case JD_KIND_RGB:
      for (x = 0; x < d->out_w; x++) {
        o[3 * x] = s[0][x];
        o[3 * x + 1] = s[1][x];
        o[3 * x + 2] = s[2][x];
      }
      break;
    case JD_KIND_YCBCR:
      for (x = 0; x < d->out_w; x++) {
        int yy = s[0][x], cb = s[1][x], cr = s[2][x];
        o[3 * x] = clamp255(yy + cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + cb_b[cb]);
      }
      break;
    default: /* CMYK or YCCK */
      for (x = 0; x < d->out_w; x++) {
        int cmyk[4], k, nk, t;
        if (d->colorspace == JD_KIND_YCCK) { /* jdcolor.c ycck_cmyk_convert */
          int yy = s[0][x], cb = s[1][x], cr = s[2][x];
          cmyk[0] = clamp255(255 - (yy + cr_r[cr]));
          cmyk[1] = clamp255(255 - (yy + ((cb_g[cb] + cr_g[cr]) >> 16)));
          cmyk[2] = clamp255(255 - (yy + cb_b[cb]));
        } else {
          cmyk[0] = s[0][x];
          cmyk[1] = s[1][x];
          cmyk[2] = s[2][x];
        }
        cmyk[3] = s[3][x];
        /* Pillow reads "CMYK;I" (each byte inverted), then Convert.c
           cmyk2rgb: nk = 255 - K, out = nk - MULDIV255(C, nk) */
        nk = cmyk[3]; /* 255 - (255 - k) */
        for (k = 0; k < 3; k++) {
          int c = 255 - cmyk[k];
          t = c * nk + 128;
          o[3 * x + k] = clamp255(nk - (((t >> 8) + t) >> 8));
        }
      }
      break;
    }
  }
  for (i = 0; i < n; i++) free(rows[i]);
}

/* --- entry points -------------------------------------------------------- */

static void release(dec_t *d) {
  int i;
  for (i = 0; i < 4; i++) {
    free(d->comp[i].coef);
    free(d->comp[i].plane);
    d->comp[i].coef = NULL;
    d->comp[i].plane = NULL;
  }
}

static int kind_of(const dec_t *d) {
  return d->colorspace | (d->progressive ? JD_KIND_PROGRESSIVE : 0);
}

/* markers up to the first SOS, as Pillow's Image.open reads them */
static int run_header(dec_t *d) {
  if (setjmp(d->jb)) return d->code == JD_SUSPEND ? JD_CORRUPT : d->code;
  while (read_markers(d) != 0xDA) { /* EOI before any scan */
    fail(d, JD_CORRUPT);
  }
  frame_geometry(d);
  return JD_OK;
}

/* every scan to EOI, as jpeg_start_decompress, jpeg_read_scanlines and
   jpeg_finish_decompress run under Pillow: a file of one scan that ends
   after its last MCU decodes (Pillow has every row); a file of several
   scans must reach EOI */
static int run_scans(dec_t *d) {
  if (setjmp(d->jb)) {
    if (d->code == JD_SUSPEND) return d->finishing ? JD_OK : JD_CORRUPT;
    return d->code;
  }
  setup_frame(d);
  decode_scan(d);
  if (!d->multiple_scans) d->finishing = 1;
  for (;;) {
    int m = read_markers(d);
    if (m == 0xD9) break;
    if (!d->multiple_scans) fail(d, JD_CORRUPT); /* JERR_EOI_EXPECTED */
    decode_scan(d);
  }
  return JD_OK;
}

static int run_output(dec_t *d, uint8_t *rgb) {
  int i, smooth = smoothing_ok(d);
  if (setjmp(d->jb)) return d->code;
  for (i = 0; i < d->ncomp; i++) component_plane(d, &d->comp[i], smooth);
  emit_rgb(d, rgb);
  return JD_OK;
}

static dec_t *new_decoder(const uint8_t *data, size_t len, int draft) {
  dec_t *d = calloc(1, sizeof *d);
  if (d == NULL) return NULL;
  d->data = data;
  d->len = len;
  d->draft = draft > 0 ? draft : 0;
  return d;
}

int jpeg_header(const uint8_t *data, size_t len, int draft, int out[3]) {
  dec_t *d = new_decoder(data, len, draft);
  int st;
  if (d == NULL) return JD_NO_MEMORY;
  st = run_header(d);
  out[0] = d->out_w;
  out[1] = d->out_h;
  out[2] = st == JD_UNSUPPORTED ? d->why : kind_of(d);
  free(d);
  return st;
}

int jpeg_decode(const uint8_t *data, size_t len, int draft, uint8_t *rgb) {
  dec_t *d = new_decoder(data, len, draft);
  int st;
  if (d == NULL) return JD_NO_MEMORY;
  st = run_header(d);
  if (st == JD_OK) st = run_scans(d);
  if (st == JD_OK) st = run_output(d, rgb);
  release(d);
  free(d);
  return st;
}
