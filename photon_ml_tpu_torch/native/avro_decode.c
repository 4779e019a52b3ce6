/* Native Avro block decoder: schema-compiled op programs over raw blocks.
 *
 * Role of the reference's AvroDataReader hot path (photon-client/.../data/
 * avro/AvroDataReader.scala:53-451): bulk ingest of TrainingExampleAvro /
 * BayesianLinearModelAvro / ScoringResultAvro container files.  The Python
 * side (photon_ml_tpu/data/avro_native.py) compiles a record schema into a
 * flat int32 op program; this interpreter executes it once per record over
 * a decompressed container block, appending leaf values into growable typed
 * columns.  One C loop replaces the per-record pure-Python decode — the
 * reference leans on Spark executors + the JVM Avro runtime for the same
 * bulk-decode role.
 *
 * Supported shapes (everything the photon schemas need):
 *   primitives long/int/double/float/boolean/string/bytes/enum,
 *   record, array<...>, union [null, X] (either order), map (skipped).
 * Anything else is rejected at compile time in Python and falls back to the
 * pure-Python codec.
 *
 * Build: cc -O3 -shared -fPIC avro_decode.c -o libavrodec.so
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
    OP_LONG = 0,    /* col */
    OP_DOUBLE = 1,  /* col */
    OP_FLOAT = 2,   /* col */
    OP_BOOL = 3,    /* col */
    OP_STRING = 4,  /* col (also bytes) */
    OP_ENUM = 5,    /* col */
    OP_OPT = 6,     /* null_branch_index, present_col, body_len, body... */
    OP_ARRAY = 7,   /* count_col, body_len, body... */
    OP_MAP_SKIP = 8,/* (no args) skip map<string, string-or-bytes-like> */
    OP_MAP = 9      /* count_col, key_col, val_col: map<string, string> */
};

enum { KIND_I64 = 0, KIND_F64 = 1, KIND_STR = 2 };

typedef struct {
    int32_t kind;
    int64_t len, cap;      /* elements */
    int64_t blen, bcap;    /* string blob bytes */
    int64_t *i64;          /* KIND_I64 data, or KIND_STR end offsets */
    double *f64;           /* KIND_F64 data */
    uint8_t *blob;         /* KIND_STR bytes */
} Col;

typedef struct {
    const uint8_t *p, *end;
    int err;
} Cur;

static int64_t read_varlong(Cur *c) {
    uint64_t acc = 0;
    int shift = 0;
    while (1) {
        if (c->p >= c->end || shift > 63) { c->err = 1; return 0; }
        uint8_t b = *c->p++;
        acc |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    return (int64_t)(acc >> 1) ^ -(int64_t)(acc & 1); /* zigzag */
}

static int ensure_cap(Col *col, int64_t extra) {
    if (col->len + extra > col->cap) {
        int64_t nc = col->cap ? col->cap * 2 : 1024;
        while (nc < col->len + extra) nc *= 2;
        if (col->kind == KIND_F64) {
            double *nf = realloc(col->f64, nc * sizeof(double));
            if (!nf) return 0;
            col->f64 = nf;
        } else {
            int64_t *ni = realloc(col->i64, nc * sizeof(int64_t));
            if (!ni) return 0;
            col->i64 = ni;
        }
        col->cap = nc;
    }
    return 1;
}

static int ensure_blob(Col *col, int64_t extra) {
    if (col->blen + extra > col->bcap) {
        int64_t nc = col->bcap ? col->bcap * 2 : 4096;
        while (nc < col->blen + extra) nc *= 2;
        uint8_t *nb = realloc(col->blob, nc);
        if (!nb) return 0;
        col->blob = nb;
    }
    return 1;
}

static void push_i64(Col *col, int64_t v, int *err) {
    if (!ensure_cap(col, 1)) { *err = 1; return; }
    col->i64[col->len++] = v;
}

static void push_f64(Col *col, double v, int *err) {
    if (!ensure_cap(col, 1)) { *err = 1; return; }
    col->f64[col->len++] = v;
}

static void push_str(Col *col, const uint8_t *s, int64_t n, int *err) {
    if (!ensure_cap(col, 1) || !ensure_blob(col, n)) { *err = 1; return; }
    if (n) memcpy(col->blob + col->blen, s, n);
    col->blen += n;
    col->i64[col->len++] = col->blen; /* end offset */
}

static void skip_map(Cur *c) {
    while (!c->err) {
        int64_t n = read_varlong(c);
        if (n == 0) break;
        if (n < 0) { /* block byte size follows */
            if (n == INT64_MIN) { c->err = 1; return; } /* -n would be UB */
            read_varlong(c);
            n = -n;
        }
        for (int64_t i = 0; i < n && !c->err; i++) {
            for (int k = 0; k < 2 && !c->err; k++) { /* key + string value */
                int64_t len = read_varlong(c);
                /* compare against remaining bytes — `c->p + len` would be
                 * pointer-arithmetic overflow UB for adversarial lengths */
                if (len < 0 || len > (int64_t)(c->end - c->p)) { c->err = 1; return; }
                c->p += len;
            }
        }
    }
}

/* Execute a program segment.  null_mode: consume no input, append one
 * placeholder per leaf column (keeps columns row-aligned across optional
 * branches).  Arrays in null_mode record count 0 and emit no elements. */
static void exec_prog(Cur *c, const int32_t *prog, int64_t n, Col *cols,
                      int null_mode) {
    int64_t i = 0;
    while (i < n && !c->err) {
        int32_t op = prog[i++];
        switch (op) {
        case OP_LONG:
        case OP_ENUM: {
            Col *col = &cols[prog[i++]];
            push_i64(col, null_mode ? 0 : read_varlong(c), &c->err);
            break;
        }
        case OP_BOOL: {
            Col *col = &cols[prog[i++]];
            int64_t v = 0;
            if (!null_mode) {
                if (c->p >= c->end) { c->err = 1; break; }
                v = *c->p++;
            }
            push_i64(col, v, &c->err);
            break;
        }
        case OP_DOUBLE: {
            Col *col = &cols[prog[i++]];
            double v = 0.0 / 0.0; /* NaN placeholder */
            if (!null_mode) {
                if ((int64_t)(c->end - c->p) < 8) { c->err = 1; break; }
                memcpy(&v, c->p, 8);
                c->p += 8;
            }
            push_f64(col, v, &c->err);
            break;
        }
        case OP_FLOAT: {
            Col *col = &cols[prog[i++]];
            double v = 0.0 / 0.0;
            if (!null_mode) {
                float fv;
                if ((int64_t)(c->end - c->p) < 4) { c->err = 1; break; }
                memcpy(&fv, c->p, 4);
                c->p += 4;
                v = fv;
            }
            push_f64(col, v, &c->err);
            break;
        }
        case OP_STRING: {
            Col *col = &cols[prog[i++]];
            if (null_mode) {
                push_str(col, NULL, 0, &c->err);
            } else {
                int64_t len = read_varlong(c);
                if (len < 0 || len > (int64_t)(c->end - c->p)) { c->err = 1; break; }
                push_str(col, c->p, len, &c->err);
                c->p += len;
            }
            break;
        }
        case OP_OPT: {
            int32_t null_idx = prog[i++];
            int32_t present_col = prog[i++];
            int32_t body_len = prog[i++];
            int is_null = 1;
            if (!null_mode) {
                int64_t branch = read_varlong(c);
                if (branch != 0 && branch != 1) { c->err = 1; break; }
                is_null = (branch == null_idx);
            }
            if (present_col >= 0)
                push_i64(&cols[present_col], is_null ? 0 : 1, &c->err);
            exec_prog(c, prog + i, body_len, cols, is_null);
            i += body_len;
            break;
        }
        case OP_ARRAY: {
            int32_t count_col = prog[i++];
            int32_t body_len = prog[i++];
            int64_t total = 0;
            if (!null_mode) {
                while (!c->err) {
                    int64_t bn = read_varlong(c);
                    if (bn == 0) break;
                    if (bn < 0) {
                        if (bn == INT64_MIN) { c->err = 1; break; }
                        read_varlong(c);
                        bn = -bn;
                    }
                    for (int64_t j = 0; j < bn && !c->err; j++)
                        exec_prog(c, prog + i, body_len, cols, 0);
                    total += bn;
                }
            }
            if (count_col >= 0)
                push_i64(&cols[count_col], total, &c->err);
            i += body_len;
            break;
        }
        case OP_MAP_SKIP:
            if (!null_mode) skip_map(c);
            break;
        case OP_MAP: {
            int32_t count_col = prog[i++];
            int32_t key_col = prog[i++];
            int32_t val_col = prog[i++];
            int64_t total = 0;
            if (!null_mode) {
                while (!c->err) {
                    int64_t bn = read_varlong(c);
                    if (bn == 0) break;
                    if (bn < 0) {
                        if (bn == INT64_MIN) { c->err = 1; break; }
                        read_varlong(c);
                        bn = -bn;
                    }
                    for (int64_t j = 0; j < bn && !c->err; j++) {
                        int64_t len = read_varlong(c);
                        if (len < 0 || len > (int64_t)(c->end - c->p)) { c->err = 1; break; }
                        push_str(&cols[key_col], c->p, len, &c->err);
                        c->p += len;
                        len = read_varlong(c);
                        if (len < 0 || len > (int64_t)(c->end - c->p)) { c->err = 1; break; }
                        push_str(&cols[val_col], c->p, len, &c->err);
                        c->p += len;
                    }
                    total += bn;
                }
            }
            if (count_col >= 0)
                push_i64(&cols[count_col], total, &c->err);
            break;
        }
        default:
            c->err = 1;
        }
    }
}

/* Decode `nrecords` records from buf.  Returns bytes consumed, or -1. */
int64_t avrodec_decode_block(const uint8_t *buf, int64_t buflen,
                             int64_t nrecords, const int32_t *prog,
                             int64_t proglen, Col *cols, int32_t ncols) {
    (void)ncols;
    Cur c = {buf, buf + buflen, 0};
    for (int64_t r = 0; r < nrecords && !c.err; r++)
        exec_prog(&c, prog, proglen, cols, 0);
    if (c.err) return -1;
    return (int64_t)(c.p - buf);
}

Col *avrodec_alloc_cols(int32_t ncols, const int32_t *kinds) {
    Col *cols = calloc(ncols, sizeof(Col));
    if (!cols) return NULL;
    for (int32_t i = 0; i < ncols; i++) cols[i].kind = kinds[i];
    return cols;
}

void avrodec_free_cols(Col *cols, int32_t ncols) {
    if (!cols) return;
    for (int32_t i = 0; i < ncols; i++) {
        free(cols[i].i64);
        free(cols[i].f64);
        free(cols[i].blob);
    }
    free(cols);
}

/* Accessors (keep the struct layout private to C). */
int64_t avrodec_col_len(const Col *cols, int32_t i) { return cols[i].len; }
int64_t avrodec_col_blob_len(const Col *cols, int32_t i) { return cols[i].blen; }
const int64_t *avrodec_col_i64(const Col *cols, int32_t i) { return cols[i].i64; }
const double *avrodec_col_f64(const Col *cols, int32_t i) { return cols[i].f64; }
const uint8_t *avrodec_col_blob(const Col *cols, int32_t i) { return cols[i].blob; }
