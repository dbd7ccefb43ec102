/* Native host-runtime kernels for amira-tpu.
 *
 * The reference delegates its performance-critical host work to external C/C++
 * tools; here the host runtime around the device compute path is native too:
 *   - parse_fastq: zlib-streamed FASTQ reader -> {name: (seq, qual)}
 *   - encode_reads: stranded-gene-string lists -> int32 token arrays using a
 *     shared vocabulary dict (the hot tokenization step of every graph build)
 *   - encode_dna: ACGT -> 2-bit codes (255 invalid) into a bytes object
 *
 * Built as a CPython extension (no pybind11 in this environment); see
 * amira_tpu/native/build.py. Python fallbacks live in amira_tpu/io.py and
 * amira_tpu/vocab.py.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <zlib.h>

/* ------------------------------------------------------------------ fastq */

/* libdeflate (weak, via dlopen): whole-member gzip decompression runs
 * ~2-3x zlib's streaming inflate, and load_fastq at the 500k-read scale
 * is decompress-bound. Falls back to the zlib streaming path when the
 * library is absent or the data does not decode. */
typedef void *(*ld_alloc_t)(void);
typedef int (*ld_gzip_ex_t)(void *, const void *, size_t, void *, size_t,
                            size_t *, size_t *);
typedef void (*ld_free_t)(void *);

static int
load_libdeflate(ld_alloc_t *alloc, ld_gzip_ex_t *gz, ld_free_t *freep)
{
    static void *handle = NULL;
    static int tried = 0;
    if (!tried) {
        tried = 1;
        handle = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!handle)
            handle = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    }
    if (!handle)
        return 0;
    *alloc = (ld_alloc_t)dlsym(handle, "libdeflate_alloc_decompressor");
    *gz = (ld_gzip_ex_t)dlsym(handle, "libdeflate_gzip_decompress_ex");
    *freep = (ld_free_t)dlsym(handle, "libdeflate_free_decompressor");
    return *alloc && *gz && *freep;
}

/* Parse FASTQ records from an in-memory buffer (same state machine and
 * line semantics as the streaming path: header token to first space/tab,
 * \r\n trimmed). Returns a new dict or NULL on error. */
static PyObject *
parse_fastq_buffer(const char *buf, size_t len)
{
    PyObject *out = PyDict_New();
    if (!out)
        return NULL;
    int state = 0;
    PyObject *name = NULL, *seq = NULL;
    size_t i = 0;
    while (i < len) {
        const char *line = buf + i;
        const char *nl = (const char *)memchr(line, '\n', len - i);
        size_t ll = nl ? (size_t)(nl - line) : len - i;
        i += ll + (nl ? 1 : 0);
        while (ll && (line[ll - 1] == '\r' || line[ll - 1] == '\n'))
            ll--;
        switch (state) {
        case 0: {
            if (ll == 0)
                continue;
            size_t end = 1;
            while (end < ll && line[end] != ' ' && line[end] != '\t')
                end++;
            name = PyUnicode_FromStringAndSize(line + 1,
                                               (Py_ssize_t)(end - 1));
            if (!name)
                goto fail;
            state = 1;
            break;
        }
        case 1:
            seq = PyUnicode_FromStringAndSize(line, (Py_ssize_t)ll);
            if (!seq)
                goto fail;
            state = 2;
            break;
        case 2:
            state = 3;
            break;
        case 3: {
            PyObject *qual =
                PyUnicode_FromStringAndSize(line, (Py_ssize_t)ll);
            if (!qual)
                goto fail;
            PyObject *pair = PyTuple_Pack(2, seq, qual);
            Py_DECREF(qual);
            if (!pair)
                goto fail;
            if (PyDict_SetItem(out, name, pair) < 0) {
                Py_DECREF(pair);
                goto fail;
            }
            Py_DECREF(pair);
            Py_CLEAR(name);
            Py_CLEAR(seq);
            state = 0;
            break;
        }
        }
    }
    Py_XDECREF(name);
    Py_XDECREF(seq);
    return out;
fail:
    Py_XDECREF(name);
    Py_XDECREF(seq);
    Py_DECREF(out);
    return NULL;
}

/* Whole-file fast path: read the file, libdeflate-decompress every gzip
 * member (or take plain text as-is), scan in memory. Returns the parsed
 * dict, or NULL with no exception set to request the streaming fallback
 * (NULL with an exception set on real Python-level errors). */
static PyObject *
parse_fastq_fast(const char *path)
{
    FILE *f = fopen(path, "rb");
    if (!f)
        return NULL; /* let the streaming path raise the error */
    if (fseek(f, 0, SEEK_END) != 0) {
        fclose(f);
        return NULL;
    }
    long fsz = ftell(f);
    if (fsz <= 0) {
        fclose(f);
        return NULL;
    }
    rewind(f);
    char *inbuf = (char *)malloc((size_t)fsz);
    if (!inbuf) {
        fclose(f);
        return NULL;
    }
    if (fread(inbuf, 1, (size_t)fsz, f) != (size_t)fsz) {
        free(inbuf);
        fclose(f);
        return NULL;
    }
    fclose(f);

    PyObject *result = NULL;
    if ((size_t)fsz >= 2 && (unsigned char)inbuf[0] == 0x1f &&
        (unsigned char)inbuf[1] == 0x8b) {
        ld_alloc_t ld_alloc;
        ld_gzip_ex_t ld_gz;
        ld_free_t ld_free;
        if (!load_libdeflate(&ld_alloc, &ld_gz, &ld_free)) {
            free(inbuf);
            return NULL; /* streaming fallback */
        }
        void *d = ld_alloc();
        if (!d) {
            free(inbuf);
            return NULL;
        }
        /* FASTQ compresses ~6-7x (half the bytes are ~incompressible
         * qualities is not true for synthetic data; real ONT runs land
         * 4-7x) — start at 8x so the common case needs no grow-retry */
        size_t outcap = (size_t)fsz * 8 + (16u << 20);
        char *outbuf = (char *)malloc(outcap);
        size_t inoff = 0, outoff = 0;
        int failed = outbuf == NULL;
        while (!failed && inoff + 18 <= (size_t)fsz &&
               (unsigned char)inbuf[inoff] == 0x1f &&
               (unsigned char)inbuf[inoff + 1] == 0x8b) {
            size_t ain = 0, aout = 0;
            int rc = ld_gz(d, inbuf + inoff, (size_t)fsz - inoff,
                           outbuf + outoff, outcap - outoff, &ain, &aout);
            if (rc == 0) {
                inoff += ain;
                outoff += aout;
            } else if (rc == 3 /* INSUFFICIENT_SPACE */) {
                size_t ncap = outcap * 2;
                char *nbuf = (char *)realloc(outbuf, ncap);
                if (!nbuf) {
                    failed = 1;
                } else {
                    outbuf = nbuf;
                    outcap = ncap;
                }
            } else {
                failed = 1;
            }
        }
        ld_free(d);
        free(inbuf);
        if (failed || outoff == 0) {
            free(outbuf);
            return NULL; /* streaming fallback */
        }
        result = parse_fastq_buffer(outbuf, outoff);
        free(outbuf);
        return result; /* dict, or NULL WITH exception from the parser */
    }
    /* plain (uncompressed) file */
    result = parse_fastq_buffer(inbuf, (size_t)fsz);
    free(inbuf);
    return result;
}

static PyObject *
parse_fastq(PyObject *self, PyObject *args)
{
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path))
        return NULL;

    PyObject *fast = parse_fastq_fast(path);
    if (fast)
        return fast;
    if (PyErr_Occurred())
        return NULL;

    gzFile fh = gzopen(path, "rb");
    if (!fh) {
        PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
        return NULL;
    }
    gzbuffer(fh, 1 << 20);

    PyObject *out = PyDict_New();
    if (!out) {
        gzclose(fh);
        return NULL;
    }

    size_t cap = 1 << 20;
    char *buf = (char *)malloc(cap);
    if (!buf) {
        gzclose(fh);
        Py_DECREF(out);
        return PyErr_NoMemory();
    }

    int state = 0; /* 0=header 1=seq 2=plus 3=qual */
    PyObject *name = NULL, *seq = NULL;

    for (;;) {
        char *line = gzgets(fh, buf, (int)cap);
        if (!line)
            break;
        size_t len = strlen(line);
        /* grow buffer for very long lines */
        while (len == cap - 1 && line[len - 1] != '\n') {
            size_t old = cap;
            cap *= 2;
            char *nbuf = (char *)realloc(buf, cap);
            if (!nbuf)
                goto fail;
            buf = nbuf;
            if (!gzgets(fh, buf + old - 1, (int)(cap - old + 1)))
                break;
            line = buf;
            len = strlen(line);
        }
        while (len && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            line[--len] = 0;

        switch (state) {
        case 0: {
            if (len == 0)
                continue;
            /* header: "@name ..." -> name token */
            size_t end = 1;
            while (end < len && line[end] != ' ' && line[end] != '\t')
                end++;
            name = PyUnicode_FromStringAndSize(line + 1, (Py_ssize_t)(end - 1));
            if (!name)
                goto fail;
            state = 1;
            break;
        }
        case 1:
            seq = PyUnicode_FromStringAndSize(line, (Py_ssize_t)len);
            if (!seq)
                goto fail;
            state = 2;
            break;
        case 2:
            state = 3;
            break;
        case 3: {
            PyObject *qual = PyUnicode_FromStringAndSize(line, (Py_ssize_t)len);
            if (!qual)
                goto fail;
            PyObject *pair = PyTuple_Pack(2, seq, qual);
            Py_DECREF(qual);
            if (!pair)
                goto fail;
            if (PyDict_SetItem(out, name, pair) < 0) {
                Py_DECREF(pair);
                goto fail;
            }
            Py_DECREF(pair);
            Py_CLEAR(name);
            Py_CLEAR(seq);
            state = 0;
            break;
        }
        }
    }
    free(buf);
    gzclose(fh);
    Py_XDECREF(name);
    Py_XDECREF(seq);
    return out;
fail:
    free(buf);
    gzclose(fh);
    Py_XDECREF(name);
    Py_XDECREF(seq);
    Py_DECREF(out);
    return NULL;
}

/* -------------------------------------------------------------- tokenizer */

/* encode_reads(reads: list[list[str]], name_to_id: dict, next_id: int)
 *   -> (list[bytes of int32 tokens], new_next_id, new_names: list[str])
 * Interns unseen gene names into name_to_id (mutated in place). */
static PyObject *
encode_reads(PyObject *self, PyObject *args)
{
    PyObject *reads, *vocab;
    long next_id;
    if (!PyArg_ParseTuple(args, "OOl", &reads, &vocab, &next_id))
        return NULL;
    if (!PyList_Check(reads) || !PyDict_Check(vocab)) {
        PyErr_SetString(PyExc_TypeError, "expected (list, dict, int)");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(reads);
    PyObject *out = PyList_New(n);
    PyObject *new_names = PyList_New(0);
    if (!out || !new_names)
        goto fail;

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *genes = PyList_GET_ITEM(reads, i);
        if (!PyList_Check(genes)) {
            PyErr_SetString(PyExc_TypeError, "reads must be lists of str");
            goto fail;
        }
        Py_ssize_t m = PyList_GET_SIZE(genes);
        PyObject *arr = PyBytes_FromStringAndSize(NULL, m * 4);
        if (!arr)
            goto fail;
        int32_t *tok = (int32_t *)PyBytes_AS_STRING(arr);
        for (Py_ssize_t g = 0; g < m; g++) {
            PyObject *s = PyList_GET_ITEM(genes, g);
            Py_ssize_t slen;
            const char *cs = PyUnicode_AsUTF8AndSize(s, &slen);
            if (!cs || slen < 2) {
                PyErr_Format(PyExc_ValueError,
                             "missing strand for gene: %R", s);
                Py_DECREF(arr);
                goto fail;
            }
            int sign;
            if (cs[0] == '+')
                sign = 1;
            else if (cs[0] == '-')
                sign = -1;
            else {
                PyErr_Format(PyExc_ValueError,
                             "missing strand for gene: %R", s);
                Py_DECREF(arr);
                goto fail;
            }
            /* normalize like the Python fallback: spaces -> underscores */
            PyObject *nameobj;
            if (memchr(cs + 1, ' ', slen - 1)) {
                char *tmp = (char *)malloc(slen - 1);
                if (!tmp) {
                    Py_DECREF(arr);
                    PyErr_NoMemory();
                    goto fail;
                }
                for (Py_ssize_t t = 0; t < slen - 1; t++)
                    tmp[t] = cs[1 + t] == ' ' ? '_' : cs[1 + t];
                nameobj = PyUnicode_FromStringAndSize(tmp, slen - 1);
                free(tmp);
            } else {
                nameobj = PyUnicode_FromStringAndSize(cs + 1, slen - 1);
            }
            if (!nameobj) {
                Py_DECREF(arr);
                goto fail;
            }
            PyObject *idobj = PyDict_GetItem(vocab, nameobj); /* borrowed */
            long gid;
            if (idobj) {
                gid = PyLong_AsLong(idobj);
                Py_DECREF(nameobj);
            } else {
                gid = next_id++;
                PyObject *newid = PyLong_FromLong(gid);
                if (!newid || PyDict_SetItem(vocab, nameobj, newid) < 0 ||
                    PyList_Append(new_names, nameobj) < 0) {
                    Py_XDECREF(newid);
                    Py_DECREF(nameobj);
                    Py_DECREF(arr);
                    goto fail;
                }
                Py_DECREF(newid);
                Py_DECREF(nameobj);
            }
            tok[g] = (int32_t)(sign * gid);
        }
        PyList_SET_ITEM(out, i, arr);
    }
    {
        PyObject *res = Py_BuildValue("(OlO)", out, next_id, new_names);
        Py_DECREF(out);
        Py_DECREF(new_names);
        return res;
    }
fail:
    Py_XDECREF(out);
    Py_XDECREF(new_names);
    return NULL;
}

/* ------------------------------------------------------------- encode_dna */

static unsigned char BASE_CODE[256];

static PyObject *
encode_dna_c(PyObject *self, PyObject *args)
{
    PyObject *s;
    if (!PyArg_ParseTuple(args, "U", &s))
        return NULL;
    Py_ssize_t len;
    const char *cs = PyUnicode_AsUTF8AndSize(s, &len);
    if (!cs)
        return NULL;
    PyObject *out = PyBytes_FromStringAndSize(NULL, len);
    if (!out)
        return NULL;
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < len; i++)
        dst[i] = BASE_CODE[(unsigned char)cs[i]];
    return out;
}

/* --------------------------------------------------------- pack_dna_chunk */

/* pack_dna_chunk(seqs: list[str], start: int, offset: int,
 *                chunk_codes: int, k: int)
 *   -> (words: bytes, bad: bytes, next_start: int, next_offset: int)
 *
 * Packs reads seqs[start:] (resuming mid-read at `offset` within
 * seqs[start]) into ONE fixed-size chunk of exactly `chunk_codes` 2-bit
 * base codes (16 per little-endian uint32 word) plus a little-endian
 * invalid bitmask, writing one invalid sentinel code after each read so
 * k-mer windows never span two reads. A read longer than the remaining
 * chunk space is cut mid-read; the next chunk resumes k-1 codes earlier
 * so boundary-spanning windows count exactly once (the same overlap rule
 * as ops/kmer._from_codes_dense). Replaces the copy-number feed's
 * whole-readset host pass (str join + LUT + numpy bit-pack of ~3 Gbp per
 * 500k-read isolate) with one C pass per chunk — chunks produce the same
 * count table as ops/kmer._pack_codes_2bit over the joined stream
 * (reference feed: result_utils.py:1050-1141 shells to jellyfish).
 */
static PyObject *
pack_dna_chunk(PyObject *self, PyObject *args)
{
    PyObject *seqs;
    Py_ssize_t start, offset, chunk_codes, k;
    if (!PyArg_ParseTuple(args, "Onnnn", &seqs, &start, &offset,
                          &chunk_codes, &k))
        return NULL;
    if (!PyList_Check(seqs)) {
        PyErr_SetString(PyExc_TypeError, "seqs must be a list of str");
        return NULL;
    }
    if (chunk_codes <= 0 || chunk_codes % 16 || k < 1 ||
        k >= chunk_codes) {
        PyErr_SetString(PyExc_ValueError,
                        "need chunk_codes a positive multiple of 16 "
                        "and 1 <= k < chunk_codes");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(seqs);
    PyObject *words = PyBytes_FromStringAndSize(NULL, chunk_codes / 4);
    PyObject *bad = PyBytes_FromStringAndSize(NULL, chunk_codes / 8);
    if (!words || !bad) {
        Py_XDECREF(words);
        Py_XDECREF(bad);
        return NULL;
    }
    unsigned char *wb = (unsigned char *)PyBytes_AS_STRING(words);
    unsigned char *bb = (unsigned char *)PyBytes_AS_STRING(bad);
    memset(wb, 0, (size_t)(chunk_codes / 4));
    memset(bb, 0, (size_t)(chunk_codes / 8));

    Py_ssize_t p = 0; /* code position within the chunk */
    Py_ssize_t i = start, off = offset;
    while (i < n) {
        PyObject *s = PyList_GET_ITEM(seqs, i);
        Py_ssize_t slen;
        const char *cs = PyUnicode_AsUTF8AndSize(s, &slen);
        if (!cs) {
            Py_DECREF(words);
            Py_DECREF(bad);
            return NULL;
        }
        if (off > slen)
            off = slen; /* defensive: stale offset past the read end */
        Py_ssize_t remaining = slen - off;
        Py_ssize_t space = chunk_codes - p;
        Py_ssize_t take;
        int cut_mid_read = 0;
        if (remaining + 1 <= space) {
            take = remaining;
        } else if (space > k - 1) {
            /* mid-read cut: fill the chunk; resume k-1 codes earlier */
            take = space;
            cut_mid_read = 1;
        } else {
            break; /* too little space to make progress; pad and return */
        }
        for (Py_ssize_t j = 0; j < take; j++, p++) {
            unsigned char code = BASE_CODE[(unsigned char)cs[off + j]];
            if (code > 3)
                bb[p >> 3] |= (unsigned char)(1u << (p & 7));
            else
                wb[p >> 2] |= (unsigned char)(code << ((p & 3) * 2));
        }
        if (cut_mid_read) {
            off += take - (k - 1);
            break;
        }
        /* sentinel between reads (mirrors the "\n" join separator) */
        bb[p >> 3] |= (unsigned char)(1u << (p & 7));
        p++;
        i++;
        off = 0;
    }
    /* pad the tail invalid: whole bytes via memset, stragglers bitwise */
    while (p < chunk_codes && (p & 7)) {
        bb[p >> 3] |= (unsigned char)(1u << (p & 7));
        p++;
    }
    if (p < chunk_codes) {
        memset(bb + (p >> 3), 0xFF, (size_t)((chunk_codes - p) / 8));
        p = chunk_codes;
    }
    return Py_BuildValue("(NNnn)", words, bad, i, off);
}

static PyMethodDef Methods[] = {
    {"parse_fastq", parse_fastq, METH_VARARGS,
     "parse_fastq(path) -> {name: (seq, qual)}"},
    {"encode_reads", encode_reads, METH_VARARGS,
     "encode_reads(reads, vocab, next_id) -> (token bytes list, next_id, new_names)"},
    {"encode_dna", encode_dna_c, METH_VARARGS,
     "encode_dna(seq) -> bytes of 2-bit codes (255 invalid)"},
    {"pack_dna_chunk", pack_dna_chunk, METH_VARARGS,
     "pack_dna_chunk(seqs, start, chunk_codes) -> (words, bad, next_start)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastio", NULL, -1, Methods,
};

PyMODINIT_FUNC
PyInit__fastio(void)
{
    memset(BASE_CODE, 255, sizeof(BASE_CODE));
    BASE_CODE['A'] = BASE_CODE['a'] = 0;
    BASE_CODE['C'] = BASE_CODE['c'] = 1;
    BASE_CODE['G'] = BASE_CODE['g'] = 2;
    BASE_CODE['T'] = BASE_CODE['t'] = 3;
    return PyModule_Create(&moduledef);
}
