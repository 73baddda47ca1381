/* storecore — CPython extension: the object store's per-write hot path.
 *
 * The control-plane settle at the stress config (1000 replicas x 8 pods,
 * BASELINE.md) executes ~45k store writes; each one clones or shallow-copies
 * dataclass trees (MVCC versions never mutate).  The Python implementations
 * in cluster/store.py (per-class exec-generated cloners) were the largest
 * remaining host cost, so this module reimplements them in C with per-class
 * slot-offset specialization:
 *
 *   clone(obj)    — deep copy of a store object tree (dataclasses with
 *                   slots=True, dict, list, tuple, scalars), identical
 *                   semantics to store.clone.
 *   shallow(obj)  — new instance sharing every field, identical semantics
 *                   to store._shallow.
 *
 * Unknown classes are resolved once through a Python hook (set_resolve):
 * slots-dataclasses register their field slot offsets (read from the
 * member descriptors) and run natively ever after; anything else registers
 * a Python callable fallback (the original generated cloner/shallower), so
 * behavior is bit-identical with or without this module.
 *
 * Plays the same role the reference's client-go object codecs play for its
 * apiserver round-trips (a contrast: the reference pays serialization per
 * write, this store pays structured cloning; both keep per-object
 * semantics).  See VERDICT r4 #1 and BASELINE.md for the measurements.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stddef.h>

#ifndef Py_T_OBJECT_EX
#include <structmember.h>
#define Py_T_OBJECT_EX T_OBJECT_EX
#endif

typedef struct {
    Py_ssize_t nfields;
    Py_ssize_t offsets[1]; /* flexible (over-allocated) */
} FieldSpec;

static const char *SPEC_CAPSULE = "grove_tpu_torch.storecore.FieldSpec";

/* type -> capsule(FieldSpec): classes cloned natively */
static PyObject *native_specs;
/* type -> Python callable fallbacks */
static PyObject *py_cloners;
static PyObject *py_shallowers;
/* Python hook: called once per unknown class; must populate one of the
 * registries (via register_dataclass / register_python) */
static PyObject *resolve_hook;

static void
spec_capsule_free(PyObject *cap)
{
    void *p = PyCapsule_GetPointer(cap, SPEC_CAPSULE);
    if (p != NULL) {
        PyMem_Free(p);
    }
}

/* Exact-type scalar check mirroring store._SCALARS (str/int/float/bool/
 * None).  Subclasses (str-Enums) reach the resolve path once and get an
 * identity fallback there. */
static inline int
is_scalar(PyTypeObject *t)
{
    return t == &PyUnicode_Type || t == &PyLong_Type || t == &PyFloat_Type ||
           t == &PyBool_Type || t == Py_TYPE(Py_None);
}

static PyObject *clone_value(PyObject *o);

static PyObject *
clone_dict(PyObject *o)
{
    PyObject *n = PyDict_New();
    if (n == NULL) {
        return NULL;
    }
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(o, &pos, &k, &v)) {
        PyObject *cv;
        if (is_scalar(Py_TYPE(v))) {
            cv = Py_NewRef(v);
        }
        else {
            cv = clone_value(v);
            if (cv == NULL) {
                Py_DECREF(n);
                return NULL;
            }
        }
        if (PyDict_SetItem(n, k, cv) < 0) {
            Py_DECREF(cv);
            Py_DECREF(n);
            return NULL;
        }
        Py_DECREF(cv);
    }
    return n;
}

static PyObject *
clone_list(PyObject *o)
{
    Py_ssize_t len = PyList_GET_SIZE(o);
    PyObject *n = PyList_New(len);
    if (n == NULL) {
        return NULL;
    }
    for (Py_ssize_t i = 0; i < len; i++) {
        PyObject *v = PyList_GET_ITEM(o, i);
        PyObject *cv;
        if (is_scalar(Py_TYPE(v))) {
            cv = Py_NewRef(v);
        }
        else {
            cv = clone_value(v);
            if (cv == NULL) {
                Py_DECREF(n);
                return NULL;
            }
        }
        PyList_SET_ITEM(n, i, cv);
    }
    return n;
}

static PyObject *
clone_tuple(PyObject *o)
{
    Py_ssize_t len = PyTuple_GET_SIZE(o);
    PyObject *n = PyTuple_New(len);
    if (n == NULL) {
        return NULL;
    }
    for (Py_ssize_t i = 0; i < len; i++) {
        PyObject *v = PyTuple_GET_ITEM(o, i);
        PyObject *cv;
        if (is_scalar(Py_TYPE(v))) {
            cv = Py_NewRef(v);
        }
        else {
            cv = clone_value(v);
            if (cv == NULL) {
                Py_DECREF(n);
                return NULL;
            }
        }
        PyTuple_SET_ITEM(n, i, cv);
    }
    return n;
}

static PyObject *
clone_spec(PyObject *o, PyTypeObject *t, FieldSpec *spec)
{
    PyObject *n = t->tp_alloc(t, 0);
    if (n == NULL) {
        return NULL;
    }
    for (Py_ssize_t i = 0; i < spec->nfields; i++) {
        PyObject *v = *(PyObject **)((char *)o + spec->offsets[i]);
        if (v == NULL) {
            continue; /* unset slot stays unset */
        }
        PyObject *cv;
        if (is_scalar(Py_TYPE(v))) {
            cv = Py_NewRef(v);
        }
        else {
            cv = clone_value(v);
            if (cv == NULL) {
                Py_DECREF(n);
                return NULL;
            }
        }
        *(PyObject **)((char *)n + spec->offsets[i]) = cv;
    }
    return n;
}

/* Resolve an unknown class through the Python hook, then retry the
 * registries.  kind: 0 = clone, 1 = shallow. */
static PyObject *
dispatch_registered(PyObject *o, PyTypeObject *t, int kind)
{
    for (int attempt = 0; attempt < 2; attempt++) {
        PyObject *cap =
            PyDict_GetItemWithError(native_specs, (PyObject *)t);
        if (cap != NULL) {
            FieldSpec *spec =
                (FieldSpec *)PyCapsule_GetPointer(cap, SPEC_CAPSULE);
            if (spec == NULL) {
                return NULL;
            }
            if (kind == 0) {
                return clone_spec(o, t, spec);
            }
            /* shallow */
            PyObject *n = t->tp_alloc(t, 0);
            if (n == NULL) {
                return NULL;
            }
            for (Py_ssize_t i = 0; i < spec->nfields; i++) {
                PyObject *v =
                    *(PyObject **)((char *)o + spec->offsets[i]);
                if (v != NULL) {
                    *(PyObject **)((char *)n + spec->offsets[i]) =
                        Py_NewRef(v);
                }
            }
            return n;
        }
        if (PyErr_Occurred()) {
            return NULL;
        }
        PyObject *reg = (kind == 0) ? py_cloners : py_shallowers;
        PyObject *fn = PyDict_GetItemWithError(reg, (PyObject *)t);
        if (fn != NULL) {
            return PyObject_CallOneArg(fn, o);
        }
        if (PyErr_Occurred()) {
            return NULL;
        }
        if (attempt == 0) {
            if (resolve_hook == NULL) {
                break;
            }
            PyObject *r =
                PyObject_CallOneArg(resolve_hook, (PyObject *)t);
            if (r == NULL) {
                return NULL;
            }
            Py_DECREF(r);
        }
    }
    PyErr_Format(PyExc_TypeError,
                 "storecore: no cloner registered for %s", t->tp_name);
    return NULL;
}

static PyObject *
clone_value(PyObject *o)
{
    PyTypeObject *t = Py_TYPE(o);
    if (is_scalar(t)) {
        return Py_NewRef(o);
    }
    /* Guard EVERY recursive path (containers included): a deeply nested
     * caller-supplied tree must surface RecursionError like the Python
     * cloners do, not blow the C stack. */
    if (Py_EnterRecursiveCall(" in storecore.clone")) {
        return NULL;
    }
    PyObject *r;
    if (t == &PyDict_Type) {
        r = clone_dict(o);
    }
    else if (t == &PyList_Type) {
        r = clone_list(o);
    }
    else if (t == &PyTuple_Type) {
        r = clone_tuple(o);
    }
    else {
        r = dispatch_registered(o, t, 0);
    }
    Py_LeaveRecursiveCall();
    return r;
}

static PyObject *
sc_clone(PyObject *self, PyObject *o)
{
    (void)self;
    return clone_value(o);
}

static PyObject *
sc_shallow(PyObject *self, PyObject *o)
{
    (void)self;
    return dispatch_registered(o, Py_TYPE(o), 1);
}

/* register_dataclass(cls, field_names) -> bool
 *
 * True when every field is a T_OBJECT_EX member descriptor (a slots=True
 * dataclass): the class is cloned natively from here on.  False when any
 * field is not slot-backed (plain __dict__ dataclass, property, ...): the
 * caller should register_python a fallback instead. */
static PyObject *
sc_register_dataclass(PyObject *self, PyObject *args)
{
    (void)self;
    PyObject *cls, *names;
    if (!PyArg_ParseTuple(args, "OO", &cls, &names)) {
        return NULL;
    }
    if (!PyType_Check(cls)) {
        PyErr_SetString(PyExc_TypeError, "expected a class");
        return NULL;
    }
    PyObject *fast =
        PySequence_Fast(names, "field_names must be a sequence");
    if (fast == NULL) {
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    FieldSpec *spec = (FieldSpec *)PyMem_Malloc(
        sizeof(FieldSpec) + (n > 0 ? (size_t)(n - 1) : 0) *
                                sizeof(Py_ssize_t));
    if (spec == NULL) {
        Py_DECREF(fast);
        return PyErr_NoMemory();
    }
    spec->nfields = n;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *name = PySequence_Fast_GET_ITEM(fast, i);
        PyObject *d = PyObject_GetAttr(cls, name);
        if (d == NULL) {
            PyErr_Clear();
            PyMem_Free(spec);
            Py_DECREF(fast);
            Py_RETURN_FALSE;
        }
        if (!Py_IS_TYPE(d, &PyMemberDescr_Type)) {
            Py_DECREF(d);
            PyMem_Free(spec);
            Py_DECREF(fast);
            Py_RETURN_FALSE;
        }
        PyMemberDef *m = ((PyMemberDescrObject *)d)->d_member;
        if (m == NULL || m->type != Py_T_OBJECT_EX) {
            Py_DECREF(d);
            PyMem_Free(spec);
            Py_DECREF(fast);
            Py_RETURN_FALSE;
        }
        spec->offsets[i] = m->offset;
        Py_DECREF(d);
    }
    Py_DECREF(fast);
    PyObject *cap = PyCapsule_New(spec, SPEC_CAPSULE, spec_capsule_free);
    if (cap == NULL) {
        PyMem_Free(spec);
        return NULL;
    }
    if (PyDict_SetItem(native_specs, cls, cap) < 0) {
        Py_DECREF(cap);
        return NULL;
    }
    Py_DECREF(cap);
    Py_RETURN_TRUE;
}

/* register_python(cls, cloner, shallower) — fallback callables for a class
 * the native path can't specialize. */
static PyObject *
sc_register_python(PyObject *self, PyObject *args)
{
    (void)self;
    PyObject *cls, *cloner, *shallower;
    if (!PyArg_ParseTuple(args, "OOO", &cls, &cloner, &shallower)) {
        return NULL;
    }
    if (PyDict_SetItem(py_cloners, cls, cloner) < 0) {
        return NULL;
    }
    if (PyDict_SetItem(py_shallowers, cls, shallower) < 0) {
        return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *
sc_set_resolve(PyObject *self, PyObject *hook)
{
    (void)self;
    Py_XDECREF(resolve_hook);
    resolve_hook = Py_NewRef(hook);
    Py_RETURN_NONE;
}

/* registered_classes() -> (native_count, fallback_count) — introspection
 * for tests and the debug surface. */
static PyObject *
sc_registered_classes(PyObject *self, PyObject *noargs)
{
    (void)self;
    (void)noargs;
    return Py_BuildValue("(nn)", PyDict_Size(native_specs),
                         PyDict_Size(py_cloners));
}

static PyMethodDef sc_methods[] = {
    {"clone", sc_clone, METH_O,
     "Deep-copy a store object tree (store.clone semantics)."},
    {"shallow", sc_shallow, METH_O,
     "New instance sharing every field (store._shallow semantics)."},
    {"register_dataclass", sc_register_dataclass, METH_VARARGS,
     "Register a slots dataclass for native cloning; False if unsupported."},
    {"register_python", sc_register_python, METH_VARARGS,
     "Register Python fallback (cloner, shallower) for a class."},
    {"set_resolve", sc_set_resolve, METH_O,
     "Set the unknown-class resolve hook."},
    {"registered_classes", sc_registered_classes, METH_NOARGS,
     "(native_count, python_fallback_count)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef sc_module = {
    PyModuleDef_HEAD_INIT,
    "_grove_storecore",
    "Native clone/shallow for the grove_tpu_torch object store hot path.",
    -1,
    sc_methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit__grove_storecore(void)
{
    native_specs = PyDict_New();
    py_cloners = PyDict_New();
    py_shallowers = PyDict_New();
    if (native_specs == NULL || py_cloners == NULL ||
        py_shallowers == NULL) {
        return NULL;
    }
    return PyModule_Create(&sc_module);
}
