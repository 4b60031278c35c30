/* Native hot-path kernels for the closure check engine (host query mode).
 * A copy of keto_tpu/native/_hotpath.c: only these comments differ, so the
 * hashes it computes stay equal to the reference's.
 *
 * Why C here: the host query path is bound by *random DRAM loads* — probes
 * into the multi-GB direct-edge hash table, CSR indptr/vals rows spread over
 * tens of millions of nodes, and the closure matrix D (hundreds of MB).
 * numpy's multi-pass gathers serialize those misses; these kernels start
 * software prefetches 8-32 iterations ahead so tens of cache misses are in
 * flight at once, which turns latency-bound gathers into bandwidth-bound
 * streams. Same math as the numpy twins (keto_tpu_torch/engine/closure.py
 * _check_arrays / keto_tpu_torch/graph/vocab.py lookup_bulk) — parity-tested.
 *
 * The check semantics implemented by closure_check_rows are the reference's
 * (internal/check/engine.go:36-123): allowed iff a tuple path of length
 * <= depth exists; decomposition per keto_tpu_torch/graph/interior.py.
 *
 * Pure CPython C API + raw pointers (validated by the Python wrapper in
 * keto_tpu_torch/native/__init__.py); no numpy headers needed.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stddef.h>

#define INF_DIST 255

static inline uint64_t mix64(uint64_t x) {
    /* splitmix64 finalizer — must match keto_tpu_torch.graph.vocab.mix64 */
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

/* ---------------------------------------------------------------------------
 * object_hashes(seq, out_addr) -> None
 *
 * out[i] = hash(seq[i]) via PyObject_Hash — one C loop instead of a Python
 * generator feeding np.fromiter. Strings cache their hash, so tuple keys
 * cost only the xxHash combine once their elements have been hashed before.
 * ------------------------------------------------------------------------ */
static PyObject *object_hashes(PyObject *self, PyObject *args) {
    PyObject *seq;
    unsigned long long out_addr;
    if (!PyArg_ParseTuple(args, "OK", &seq, &out_addr)) return NULL;
    int64_t *out = (int64_t *)(uintptr_t)out_addr;
    PyObject *fast = PySequence_Fast(seq, "object_hashes expects a sequence");
    if (fast == NULL) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        Py_hash_t h = PyObject_Hash(items[i]);
        if (h == -1 && PyErr_Occurred()) {
            Py_DECREF(fast);
            return NULL;
        }
        out[i] = (int64_t)h;
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

/* ---------------------------------------------------------------------------
 * Tuple-hash twins: combine element hashes exactly as CPython's tuplehash
 * (Objects/tupleobject.c, the xxHash-based scheme, 64-bit variant) so key
 * hashes computed here probe the same open-addressing index the Python side
 * builds from hash((ns, obj, rel)). Parity is asserted at import by the
 * wrapper (native.tuple_hash_selftest); on mismatch the request-encode fast
 * path is disabled, never wrong.
 * ------------------------------------------------------------------------ */
#define XXPRIME_1 ((uint64_t)11400714785074694791ULL)
#define XXPRIME_2 ((uint64_t)14029467366897019727ULL)
#define XXPRIME_5 ((uint64_t)2870177450012600261ULL)
#define XXROTATE(x) (((x) << 31) | ((x) >> 33))

static inline uint64_t tuplehash_lane(uint64_t acc, uint64_t lane) {
    acc += lane * XXPRIME_2;
    acc = XXROTATE(acc);
    acc *= XXPRIME_1;
    return acc;
}

static inline int64_t tuplehash_fin(uint64_t acc, uint64_t len) {
    acc += len ^ (XXPRIME_5 ^ 3527539);
    if (acc == (uint64_t)-1) return 1546275796;
    return (int64_t)acc;
}

static PyObject *tuple_hash_check(PyObject *self, PyObject *args) {
    /* recompute hash(t) for a tuple via the local combine — the wrapper
     * compares with Python's hash() to validate the platform's scheme */
    PyObject *t;
    if (!PyArg_ParseTuple(args, "O!", &PyTuple_Type, &t)) return NULL;
    Py_ssize_t len = PyTuple_GET_SIZE(t);
    uint64_t acc = XXPRIME_5;
    for (Py_ssize_t i = 0; i < len; i++) {
        Py_hash_t lane = PyObject_Hash(PyTuple_GET_ITEM(t, i));
        if (lane == -1 && PyErr_Occurred()) return NULL;
        acc = tuplehash_lane(acc, (uint64_t)lane);
    }
    return PyLong_FromLongLong(tuplehash_fin(acc, (uint64_t)len));
}

/* interned attribute names, created at module init */
static PyObject *s_namespace, *s_object, *s_relation, *s_subject, *s_id;

/* ---------------------------------------------------------------------------
 * Direct slot access for the frozen/slotted domain dataclasses.
 *
 * RelationTuple/SubjectID/SubjectSet are __slots__ classes, so their
 * attributes are member descriptors with fixed byte offsets. Reading
 * *(PyObject **)((char *)obj + offset) skips the descriptor protocol —
 * ~10x cheaper than PyObject_GetAttr per field, and the encode loop does
 * 4-7 reads per request. Offsets are discovered once per type via the
 * public PyMemberDescr API and verified to be plain T_OBJECT_EX members;
 * anything unexpected (subclass, non-slot attribute) falls back to
 * GetAttr per item — never wrong, only slower.
 * ------------------------------------------------------------------------ */
#include <structmember.h>

typedef struct {
    PyTypeObject *type; /* borrowed; NULL = not initialized */
    Py_ssize_t off_ns, off_obj, off_rel, off_subj; /* RelationTuple */
    Py_ssize_t off_id;                             /* SubjectID */
    Py_ssize_t off_sns, off_sobj, off_srel;        /* SubjectSet */
} SlotCache;

static SlotCache rt_cache, sid_cache, sset_cache;
/* types whose discovery failed: skip re-probing them every item */
static PyTypeObject *rt_failed, *sid_failed, *sset_failed;

static void cache_type(PyTypeObject **slot, PyTypeObject *tp) {
    /* hold a strong reference: a cached address must never be re-matched
     * after the type dies and another class lands at the same address
     * (stale offsets would read garbage). The handful of pinned domain
     * classes live for the process anyway. */
    Py_XINCREF((PyObject *)tp);
    Py_XDECREF((PyObject *)*slot);
    *slot = tp;
}

static Py_ssize_t member_offset(PyTypeObject *tp, PyObject *name) {
    /* getattr on the TYPE yields the descriptor object itself */
    PyObject *descr = PyObject_GetAttr((PyObject *)tp, name);
    if (descr == NULL) {
        PyErr_Clear();
        return -1;
    }
    Py_ssize_t off = -1;
    if (Py_TYPE(descr) == &PyMemberDescr_Type) {
        PyMemberDef *m = ((PyMemberDescrObject *)descr)->d_member;
        if (m != NULL && m->type == T_OBJECT_EX) off = m->offset;
    }
    Py_DECREF(descr);
    return off;
}

static inline PyObject *slot_read(PyObject *obj, Py_ssize_t off) {
    /* borrowed reference; frozen dataclasses always have slots filled,
     * but guard NULL anyway (caller falls back to GetAttr) */
    return *(PyObject **)((char *)obj + off);
}

static inline uint64_t str_hash(PyObject *o, int *err) {
    /* unicode objects cache their hash; read it without the tp_hash call */
    if (PyUnicode_CheckExact(o)) {
        Py_hash_t h = ((PyASCIIObject *)o)->hash;
        if (h != -1) return (uint64_t)h;
    }
    Py_hash_t h = PyObject_Hash(o);
    if (h == -1 && PyErr_Occurred()) *err = 1;
    return (uint64_t)h;
}

/* ---------------------------------------------------------------------------
 * request_hashes(reqs, subject_id_type, hs_addr, ht_addr, isid_addr) -> None
 *
 * For each RelationTuple r: hs[i] = hash((r.namespace, r.object,
 * r.relation)); subject s = r.subject; ht[i] = hash((s.id,)) and isid[i]=1
 * when type(s) is subject_id_type, else hash((s.namespace, s.object,
 * s.relation)). One C loop replacing the two per-request key-tuple list
 * comprehensions + np.fromiter in the encode stage — the object path's
 * dominant Python-side cost at large batch sizes.
 * ------------------------------------------------------------------------ */
static int hash_item_slow(PyObject *r, PyObject *idtype, int64_t *hs,
                          int64_t *ht, uint8_t *isid) {
    /* GetAttr path: any object shape. Returns 0 ok, -1 with exception. */
    PyObject *ns = PyObject_GetAttr(r, s_namespace);
    PyObject *ob = ns ? PyObject_GetAttr(r, s_object) : NULL;
    PyObject *rel = ob ? PyObject_GetAttr(r, s_relation) : NULL;
    PyObject *subj = rel ? PyObject_GetAttr(r, s_subject) : NULL;
    if (subj == NULL) {
        Py_XDECREF(ns);
        Py_XDECREF(ob);
        Py_XDECREF(rel);
        return -1;
    }
    /* stop at the FIRST failed hash: calling PyObject_Hash again with
     * the exception pending would raise SystemError over the real
     * error (hash(-1) without an exception is a legal value) */
    uint64_t acc = XXPRIME_5;
    Py_hash_t h1 = PyObject_Hash(ns);
    Py_hash_t h2 = (h1 == -1 && PyErr_Occurred()) ? -1 : PyObject_Hash(ob);
    Py_hash_t h3 = (h2 == -1 && PyErr_Occurred()) ? -1 : PyObject_Hash(rel);
    Py_DECREF(ns);
    Py_DECREF(ob);
    Py_DECREF(rel);
    if ((h1 == -1 || h2 == -1 || h3 == -1) && PyErr_Occurred()) {
        Py_DECREF(subj);
        return -1;
    }
    acc = tuplehash_lane(acc, (uint64_t)h1);
    acc = tuplehash_lane(acc, (uint64_t)h2);
    acc = tuplehash_lane(acc, (uint64_t)h3);
    *hs = tuplehash_fin(acc, 3);

    if ((PyObject *)Py_TYPE(subj) == idtype) {
        PyObject *sid = PyObject_GetAttr(subj, s_id);
        if (sid == NULL) {
            Py_DECREF(subj);
            return -1;
        }
        Py_hash_t hv = PyObject_Hash(sid);
        Py_DECREF(sid);
        if (hv == -1 && PyErr_Occurred()) {
            Py_DECREF(subj);
            return -1;
        }
        acc = XXPRIME_5;
        acc = tuplehash_lane(acc, (uint64_t)hv);
        *ht = tuplehash_fin(acc, 1);
        *isid = 1;
    } else {
        PyObject *sn = PyObject_GetAttr(subj, s_namespace);
        PyObject *so = sn ? PyObject_GetAttr(subj, s_object) : NULL;
        PyObject *sr = so ? PyObject_GetAttr(subj, s_relation) : NULL;
        if (sr == NULL) {
            Py_XDECREF(sn);
            Py_XDECREF(so);
            Py_DECREF(subj);
            return -1;
        }
        Py_hash_t g1 = PyObject_Hash(sn);
        Py_hash_t g2 = (g1 == -1 && PyErr_Occurred()) ? -1 : PyObject_Hash(so);
        Py_hash_t g3 = (g2 == -1 && PyErr_Occurred()) ? -1 : PyObject_Hash(sr);
        Py_DECREF(sn);
        Py_DECREF(so);
        Py_DECREF(sr);
        if ((g1 == -1 || g2 == -1 || g3 == -1) && PyErr_Occurred()) {
            Py_DECREF(subj);
            return -1;
        }
        acc = XXPRIME_5;
        acc = tuplehash_lane(acc, (uint64_t)g1);
        acc = tuplehash_lane(acc, (uint64_t)g2);
        acc = tuplehash_lane(acc, (uint64_t)g3);
        *ht = tuplehash_fin(acc, 3);
        *isid = 0;
    }
    Py_DECREF(subj);
    return 0;
}

static PyObject *request_hashes(PyObject *self, PyObject *args) {
    PyObject *seq, *idtype;
    unsigned long long hs_addr, ht_addr, isid_addr;
    if (!PyArg_ParseTuple(args, "OOKKK", &seq, &idtype, &hs_addr, &ht_addr,
                          &isid_addr))
        return NULL;
    int64_t *hs = (int64_t *)(uintptr_t)hs_addr;
    int64_t *ht = (int64_t *)(uintptr_t)ht_addr;
    uint8_t *isid = (uint8_t *)(uintptr_t)isid_addr;
    PyObject *fast = PySequence_Fast(seq, "request_hashes expects a sequence");
    if (fast == NULL) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *r = items[i];
        PyTypeObject *tp = Py_TYPE(r);
        if (rt_cache.type == NULL && tp != rt_failed) {
            /* discover RelationTuple's slot layout from the first item.
             * Zero-init: `rt_cache = c` copies the whole struct, and
             * cache_type() then Py_XDECREFs rt_cache.type — an
             * uninitialized c.type would be garbage freed. */
            SlotCache c = {0};
            c.off_ns = member_offset(tp, s_namespace);
            c.off_obj = member_offset(tp, s_object);
            c.off_rel = member_offset(tp, s_relation);
            c.off_subj = member_offset(tp, s_subject);
            if (c.off_ns >= 0 && c.off_obj >= 0 && c.off_rel >= 0 &&
                c.off_subj >= 0) {
                rt_cache = c;
                cache_type(&rt_cache.type, tp);
            } else {
                cache_type(&rt_failed, tp);
            }
        }
        if (tp != rt_cache.type) goto slow;
        {
            PyObject *ns = slot_read(r, rt_cache.off_ns);
            PyObject *ob = slot_read(r, rt_cache.off_obj);
            PyObject *rel = slot_read(r, rt_cache.off_rel);
            PyObject *subj = slot_read(r, rt_cache.off_subj);
            if (!ns || !ob || !rel || !subj) goto slow;
            int err = 0;
            uint64_t acc = XXPRIME_5;
            acc = tuplehash_lane(acc, str_hash(ns, &err));
            if (err) goto fail;
            acc = tuplehash_lane(acc, str_hash(ob, &err));
            if (err) goto fail;
            acc = tuplehash_lane(acc, str_hash(rel, &err));
            if (err) goto fail;
            hs[i] = tuplehash_fin(acc, 3);

            PyTypeObject *stp = Py_TYPE(subj);
            if ((PyObject *)stp == idtype) {
                if (sid_cache.type != stp) {
                    if (stp == sid_failed) goto slow;
                    Py_ssize_t off = member_offset(stp, s_id);
                    if (off < 0) {
                        cache_type(&sid_failed, stp);
                        goto slow;
                    }
                    sid_cache.off_id = off;
                    cache_type(&sid_cache.type, stp);
                }
                PyObject *sid = slot_read(subj, sid_cache.off_id);
                if (!sid) goto slow;
                acc = XXPRIME_5;
                acc = tuplehash_lane(acc, str_hash(sid, &err));
                if (err) goto fail;
                ht[i] = tuplehash_fin(acc, 1);
                isid[i] = 1;
            } else {
                if (sset_cache.type != stp) {
                    if (stp == sset_failed) goto slow;
                    /* zero-init: same Py_XDECREF-of-garbage hazard as the
                     * RelationTuple discovery block above */
                    SlotCache c = {0};
                    c.off_sns = member_offset(stp, s_namespace);
                    c.off_sobj = member_offset(stp, s_object);
                    c.off_srel = member_offset(stp, s_relation);
                    if (c.off_sns < 0 || c.off_sobj < 0 || c.off_srel < 0) {
                        cache_type(&sset_failed, stp);
                        goto slow;
                    }
                    sset_cache = c;
                    cache_type(&sset_cache.type, stp);
                }
                PyObject *sn = slot_read(subj, sset_cache.off_sns);
                PyObject *so = slot_read(subj, sset_cache.off_sobj);
                PyObject *sr = slot_read(subj, sset_cache.off_srel);
                if (!sn || !so || !sr) goto slow;
                acc = XXPRIME_5;
                acc = tuplehash_lane(acc, str_hash(sn, &err));
                if (err) goto fail;
                acc = tuplehash_lane(acc, str_hash(so, &err));
                if (err) goto fail;
                acc = tuplehash_lane(acc, str_hash(sr, &err));
                if (err) goto fail;
                ht[i] = tuplehash_fin(acc, 3);
                isid[i] = 0;
            }
            continue;
        }
    slow:
        if (hash_item_slow(r, idtype, &hs[i], &ht[i], &isid[i]) < 0) goto fail;
        continue;
    fail:
        Py_DECREF(fast);
        return NULL;
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

/* ---------------------------------------------------------------------------
 * probe_index(slots_addr, ids_addr, mask, h_addr, n, out_addr) -> None
 *
 * Open-addressing probe of the vocab hash index (vocab.lookup_bulk's table):
 * out[i] = id where slots[j] == h[i] walking j from mix(h) by linear probe,
 * -1 on empty slot. Prefetches the initial slot PF iterations ahead.
 * ------------------------------------------------------------------------ */
static PyObject *probe_index(PyObject *self, PyObject *args) {
    unsigned long long slots_addr, ids_addr, h_addr, out_addr;
    long long mask_ll, n_ll;
    if (!PyArg_ParseTuple(args, "KKLKLK", &slots_addr, &ids_addr, &mask_ll,
                          &h_addr, &n_ll, &out_addr))
        return NULL;
    const int64_t *slots = (const int64_t *)(uintptr_t)slots_addr;
    const int32_t *ids = (const int32_t *)(uintptr_t)ids_addr;
    const int64_t *h = (const int64_t *)(uintptr_t)h_addr;
    int64_t *out = (int64_t *)(uintptr_t)out_addr;
    uint64_t mask = (uint64_t)mask_ll;
    int64_t n = (int64_t)n_ll;
    const int64_t PF = 16;
    Py_BEGIN_ALLOW_THREADS;
    for (int64_t i = 0; i < n; i++) {
        if (i + PF < n) {
            uint64_t jp = mix64((uint64_t)h[i + PF]) & mask;
            __builtin_prefetch(&slots[jp], 0, 1);
            __builtin_prefetch(&ids[jp], 0, 1);
        }
        uint64_t j = mix64((uint64_t)h[i]) & mask;
        int64_t r = -1;
        for (;;) {
            int32_t id = ids[j];
            if (id < 0) break; /* empty slot ends the probe chain */
            if (slots[j] == h[i]) {
                r = id;
                break;
            }
            j = (j + 1) & mask;
        }
        out[i] = r;
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

/* ---------------------------------------------------------------------------
 * closure_check_rows: the fused host query kernel.
 *
 * For each row (start, target, is_id, depth), in one pass:
 *   direct   = edge_table contains start*pn+target  (and depth >= 1)
 *   budget   = depth - 1 - (is_id ? 1 : 0)
 *   allowed  = direct
 *           || exists a in F0(start), b in L(target): D[a, b] <= budget
 * F0 = set_out CSR row of start (interior successor indices); L = id_in CSR
 * row of target for id targets, { interior_index[target] } for set targets.
 *
 * No width caps: true degrees are walked, so there is NO overflow fallback —
 * this path is exact for every row (numpy pads to f0_max/l_max and routes
 * overflow to the oracle; C just loops).
 *
 * Three-stage software pipeline over rows (callers pass rows sorted by
 * start for locality):
 *   stage A (i+LOOK):  prefetch indptr entries + the edge-table slot
 *   stage B (i+LOOK/2): read indptrs (cached), stash offsets/degrees in a
 *                       ring, prefetch the CSR vals lines
 *   stage C (i):       walk vals (cached), push D addresses into a pending
 *                      queue: prefetch on push, resolve QSIZE later — keeps
 *                      ~QSIZE closure-matrix misses in flight.
 * ------------------------------------------------------------------------ */

#define LOOK 32
#define LOOKMASK (LOOK - 1)
#define QSIZE 64
#define QMASK (QSIZE - 1)

typedef struct {
    const uint8_t *d;
    uint8_t *out;
    const int32_t *budget_ref;
    uint64_t q_addr[QSIZE];
    int32_t q_row[QSIZE];
    int qh, qn;
} PendQ;

static inline void pq_resolve_one(PendQ *q) {
    int h = q->qh;
    int32_t row = q->q_row[h];
    if (q->d[q->q_addr[h]] <= (uint8_t)q->budget_ref[row]) q->out[row] = 1;
    q->qh = (h + 1) & QMASK;
    q->qn--;
}

static inline void pq_push(PendQ *q, uint64_t addr, int32_t row) {
    if (q->qn == QSIZE) pq_resolve_one(q);
    int t = (q->qh + q->qn) & QMASK;
    q->q_addr[t] = addr;
    q->q_row[t] = row;
    __builtin_prefetch(&q->d[addr], 0, 1);
    q->qn++;
}

static PyObject *closure_check(PyObject *self, PyObject *args) {
    unsigned long long d_addr, f0p_addr, f0v_addr, lp_addr, lv_addr, ii_addr,
        et_addr, start_addr, target_addr, isid_addr, depth_addr, budget_addr,
        out_addr;
    long long m_pad_ll, emask_ll, pn_ll, n_ll;
    if (!PyArg_ParseTuple(args, "KLKKKKKKLLKKKKLKK", &d_addr, &m_pad_ll,
                          &f0p_addr, &f0v_addr, &lp_addr, &lv_addr, &ii_addr,
                          &et_addr, &emask_ll, &pn_ll, &start_addr,
                          &target_addr, &isid_addr, &depth_addr, &n_ll,
                          &budget_addr, &out_addr))
        return NULL;

    const uint8_t *d = (const uint8_t *)(uintptr_t)d_addr;
    const uint64_t m_pad = (uint64_t)m_pad_ll;
    const int32_t *f0_indptr = (const int32_t *)(uintptr_t)f0p_addr;
    const int32_t *f0_vals = (const int32_t *)(uintptr_t)f0v_addr;
    const int32_t *l_indptr = (const int32_t *)(uintptr_t)lp_addr;
    const int32_t *l_vals = (const int32_t *)(uintptr_t)lv_addr;
    const int32_t *interior_index = (const int32_t *)(uintptr_t)ii_addr;
    const int64_t *edge_table = (const int64_t *)(uintptr_t)et_addr;
    const uint64_t emask = (uint64_t)emask_ll;
    const int64_t pn = (int64_t)pn_ll;
    const int64_t *start = (const int64_t *)(uintptr_t)start_addr;
    const int64_t *target = (const int64_t *)(uintptr_t)target_addr;
    const uint8_t *is_id = (const uint8_t *)(uintptr_t)isid_addr;
    const int32_t *depth = (const int32_t *)(uintptr_t)depth_addr;
    const int64_t n = (int64_t)n_ll;
    int32_t *budget = (int32_t *)(uintptr_t)budget_addr; /* scratch int32[n] */
    uint8_t *out = (uint8_t *)(uintptr_t)out_addr;       /* zeroed uint8[n] */

    /* ring buffers for stage B results (indexed by row & LOOKMASK) */
    int64_t r_f0off[LOOK], r_loff[LOOK];
    int32_t r_f0deg[LOOK], r_ldeg[LOOK];

    PendQ q;
    q.d = d;
    q.out = out;
    q.budget_ref = budget;
    q.qh = 0;
    q.qn = 0;

    int64_t half = LOOK / 2;

    Py_BEGIN_ALLOW_THREADS;

    for (int64_t i = 0; i < n + half; i++) {
        /* ---- stage A: prefetch row (i + half)'s metadata loads */
        int64_t ia = i + half;
        if (ia < n) {
            int64_t s = start[ia], t = target[ia];
            __builtin_prefetch(&f0_indptr[s], 0, 1);
            uint64_t key = (uint64_t)(s * pn + t);
            __builtin_prefetch(&edge_table[mix64(key) & emask], 0, 1);
            if (is_id[ia])
                __builtin_prefetch(&l_indptr[t], 0, 1);
            else
                __builtin_prefetch(&interior_index[t], 0, 1);
        }
        /* ---- stage B: row i's indptrs are cached now; read them, start
         * the edge probe, prefetch the vals lines for stage C */
        if (i < n) {
            int64_t s = start[i], t = target[i];
            int slot = (int)(i & LOOKMASK);
            int64_t f0o = (int64_t)f0_indptr[s];
            int32_t f0d = f0_indptr[s + 1] - (int32_t)f0o;
            r_f0off[slot] = f0o;
            r_f0deg[slot] = f0d;
            if (f0d > 0) __builtin_prefetch(&f0_vals[f0o], 0, 1);

            int32_t extra;
            if (is_id[i]) {
                int64_t lo = (int64_t)l_indptr[t];
                int32_t ld = l_indptr[t + 1] - (int32_t)lo;
                r_loff[slot] = lo;
                r_ldeg[slot] = ld;
                if (ld > 0) __builtin_prefetch(&l_vals[lo], 0, 1);
                extra = 1;
            } else {
                int32_t ti = interior_index[t];
                r_loff[slot] = (int64_t)ti; /* the single L member (or -1) */
                r_ldeg[slot] = -1;          /* mark: set target */
                extra = 0;
            }
            int32_t b = depth[i] - 1 - extra;
            budget[i] = b < 0 ? -1 : b; /* uint8 cast safe: -1 -> never */

            /* direct edge: chain walk (first slot prefetched at stage A) */
            if (depth[i] >= 1) {
                uint64_t key = (uint64_t)(s * pn + t);
                uint64_t j = mix64(key) & emask;
                for (;;) {
                    int64_t v = edge_table[j];
                    if (v == (int64_t)key) {
                        out[i] = 1;
                        break;
                    }
                    if (v == -1) break;
                    j = (j + 1) & emask;
                }
            }
        }
        /* ---- stage C: row (i - half)'s vals are cached; emit D pairs */
        int64_t ic = i - half;
        if (ic >= 0 && ic < n) {
            if (out[ic] || budget[ic] < 0) continue; /* direct / impossible */
            int slot = (int)(ic & LOOKMASK);
            int64_t f0o = r_f0off[slot];
            int32_t f0d = r_f0deg[slot];
            int32_t ld = r_ldeg[slot];
            uint64_t row32 = (uint64_t)(uint32_t)ic;
            if (ld < 0) {
                /* set target: L = { interior_index[target] } */
                int64_t ti = r_loff[slot];
                if (ti >= 0) {
                    for (int32_t a = 0; a < f0d; a++) {
                        uint64_t addr =
                            (uint64_t)f0_vals[f0o + a] * m_pad + (uint64_t)ti;
                        pq_push(&q, addr, (int32_t)row32);
                    }
                }
            } else if (ld > 0 && f0d > 0) {
                int64_t lo = r_loff[slot];
                for (int32_t a = 0; a < f0d; a++) {
                    uint64_t base = (uint64_t)f0_vals[f0o + a] * m_pad;
                    /* skip remaining pairs once a resolved load already
                     * allowed this row (queue lag makes this heuristic) */
                    if (out[ic]) break;
                    for (int32_t b = 0; b < ld; b++)
                        pq_push(&q, base + (uint64_t)l_vals[lo + b],
                                (int32_t)row32);
                }
            }
        }
    }
    while (q.qn) pq_resolve_one(&q);

    Py_END_ALLOW_THREADS;

    Py_RETURN_NONE;
}

/* ---------------------------------------------------------------------------
 * gather_min_u8(d_addr, m_pad, rows_addr, cols_addr, n, w_rows, w_cols,
 *               out_addr): generic prefetched min-gather,
 * out[i] = min over D[rows[i, :], cols[i, :]] — the D-probe primitive for
 * host paths that assemble their own index rows (e.g. the write-overlay
 * mini-path, whose F0/L rows come from side dicts rather than the CSRs).
 * Padded int32 index matrices; PAD rows map to INF.
 * ------------------------------------------------------------------------ */
static PyObject *gather_min_u8(PyObject *self, PyObject *args) {
    unsigned long long d_addr, rows_addr, cols_addr, out_addr;
    long long m_pad_ll, n_ll, wr_ll, wc_ll;
    if (!PyArg_ParseTuple(args, "KLKKLLLK", &d_addr, &m_pad_ll, &rows_addr,
                          &cols_addr, &n_ll, &wr_ll, &wc_ll, &out_addr))
        return NULL;
    const uint8_t *d = (const uint8_t *)(uintptr_t)d_addr;
    const uint64_t m_pad = (uint64_t)m_pad_ll;
    const int32_t *rows = (const int32_t *)(uintptr_t)rows_addr;
    const int32_t *cols = (const int32_t *)(uintptr_t)cols_addr;
    const int64_t n = (int64_t)n_ll, wr = (int64_t)wr_ll, wc = (int64_t)wc_ll;
    uint8_t *out = (uint8_t *)(uintptr_t)out_addr;
    Py_BEGIN_ALLOW_THREADS;
    for (int64_t i = 0; i < n; i++) {
        if (i + 1 < n) {
            const int32_t *nr = &rows[(i + 1) * wr];
            const int32_t *nc = &cols[(i + 1) * wc];
            for (int64_t a = 0; a < wr; a++)
                for (int64_t b = 0; b < wc; b++)
                    __builtin_prefetch(
                        &d[(uint64_t)nr[a] * m_pad + (uint64_t)nc[b]], 0, 1);
        }
        uint8_t best = 255;
        const int32_t *rr = &rows[i * wr];
        const int32_t *cc = &cols[i * wc];
        for (int64_t a = 0; a < wr; a++) {
            uint64_t base = (uint64_t)rr[a] * m_pad;
            for (int64_t b = 0; b < wc; b++) {
                uint8_t v = d[base + (uint64_t)cc[b]];
                if (v < best) best = v;
            }
        }
        out[i] = best;
    }
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"object_hashes", object_hashes, METH_VARARGS,
     "hash each element of a sequence into an int64 buffer"},
    {"tuple_hash_check", tuple_hash_check, METH_VARARGS,
     "recompute a tuple's hash with the local combine (parity probe)"},
    {"request_hashes", request_hashes, METH_VARARGS,
     "subject-set/target key hashes + is_id flags straight off "
     "RelationTuple objects"},
    {"probe_index", probe_index, METH_VARARGS,
     "prefetched open-addressing probe of the vocab hash index"},
    {"closure_check", closure_check, METH_VARARGS,
     "fused direct-edge + closure-gather check over encoded rows"},
    {"gather_min_u8", gather_min_u8, METH_VARARGS,
     "prefetched min-gather over a uint8 matrix"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hotpath",
    "native hot-path kernels (prefetch-pipelined gathers)", -1, Methods,
    NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit__hotpath(void) {
    s_namespace = PyUnicode_InternFromString("namespace");
    s_object = PyUnicode_InternFromString("object");
    s_relation = PyUnicode_InternFromString("relation");
    s_subject = PyUnicode_InternFromString("subject");
    s_id = PyUnicode_InternFromString("id");
    if (!s_namespace || !s_object || !s_relation || !s_subject || !s_id)
        return NULL;
    return PyModule_Create(&moduledef);
}
