"""Plain-typed shims backing the full native C graph ABI.

Counterpart of ``mxnet_tpu/c_api_impl.py``. The port's copy of the C
library, ``capi/c_api_graph.cc`` (``libmxnet_tpu_torch_capi.so``, built
by ``capi.build``), embeds CPython and calls these functions with only
int/str/bytes/tuple arguments — the same inversion as ``c_predict.py``
(the compute path is Python over torch and the port's kernels, so C
embeds it instead of Python wrapping C). The surface mirrors the
reference's ``include/mxnet/c_api.h`` (~95 ``MX*`` functions over
NDArray / function registry / Symbol / Executor / DataIter / KVStore);
handles crossing the boundary are opaque
integer ids into a process-global table, so the C side never owns a
PyObject and C-function-pointer callbacks (e.g. ``MXTKVStoreSetUpdater``,
reference ``include/mxnet/c_api.h:1084``) can be re-entered via ctypes.

Thread-safety: the C side holds the GIL for every call, so the table needs
no extra locking.
"""
from __future__ import annotations

import itertools

import numpy as np

# ---------------------------------------------------------------------------
# handle table

_TABLE = {}
_NEXT = itertools.count(1)


def _put(obj) -> int:
    hid = next(_NEXT)
    _TABLE[hid] = obj
    return hid


def _get(hid):
    return _TABLE[int(hid)]


def free_handle(hid):
    _TABLE.pop(int(hid), None)


# dtype codes: reference mshadow type flags (base.py keeps the canonical map)
from .base import DTYPE_TORCH_TO_MX, DTYPE_MX_TO_TORCH, torch_dtype  # noqa


def _code(dtype) -> int:
    return DTYPE_TORCH_TO_MX[torch_dtype(dtype)]


_CODE_TO_DTYPE = DTYPE_MX_TO_TORCH


def _mx():
    import mxnet_tpu_torch
    return mxnet_tpu_torch


def _ctx(dev_type: int, dev_id: int):
    from .context import Context
    # reference base.h:90-175: kCPU=1, kGPU=2 (cuda:dev_id), kCPUPinned=3
    if int(dev_type) not in Context.devtype2str:
        raise ValueError("unknown device type %d (1 cpu, 2 gpu, 3 "
                         "cpu_pinned)" % int(dev_type))
    return Context(int(dev_type), int(dev_id))


def _ctx_code(ctx) -> int:
    return ctx.device_typeid


# ---------------------------------------------------------------------------
# misc (MXRandomSeed / MXNotifyShutdown)

def random_seed(seed: int):
    _mx().random.seed(int(seed))


def notify_shutdown():
    _mx().nd.waitall()


# ---------------------------------------------------------------------------
# NDArray

def ndarray_create_none() -> int:
    return _put(None)


def ndarray_create(shape, dev_type: int, dev_id: int, delay_alloc: int,
                   dtype_code: int = 0) -> int:
    mx = _mx()
    arr = mx.nd.empty(tuple(int(s) for s in shape),
                      ctx=_ctx(dev_type, dev_id),
                      dtype=_CODE_TO_DTYPE[int(dtype_code)])
    return _put(arr)


def ndarray_shape(hid) -> tuple:
    arr = _get(hid)
    return tuple(int(s) for s in arr.shape) if arr is not None else ()


def ndarray_dtype(hid) -> int:
    return _code(_get(hid).dtype)


def ndarray_context(hid) -> tuple:
    ctx = _get(hid).context
    return _ctx_code(ctx), ctx.device_id


def ndarray_sync_copy_from(hid, data: bytes):
    import torch
    arr = _get(hid)
    flat = torch.from_numpy(np.frombuffer(bytearray(data),
                                          dtype=_host_dtype(arr)))
    if arr.dtype == torch.bfloat16:
        flat = flat.view(torch.bfloat16)
    arr[:] = flat.reshape(arr.shape)


def _host_dtype(arr):
    """The numpy dtype of ``arr``'s bytes (bfloat16 travels as its raw
    16-bit words)."""
    import torch
    dt = arr.dtype
    return np.uint16 if dt == torch.bfloat16 else np.dtype(dt)


def ndarray_sync_copy_to(hid) -> bytes:
    import torch
    t = _get(hid)._tensor.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def ndarray_wait_to_read(hid):
    _get(hid).wait_to_read()


def ndarray_wait_to_write(hid):
    _get(hid).wait_to_write()


def wait_all():
    _mx().nd.waitall()


def ndarray_slice(hid, start: int, stop: int) -> int:
    return _put(_get(hid).slice(int(start), int(stop)))


def ndarray_reshape(hid, shape) -> int:
    return _put(_get(hid).reshape(tuple(int(s) for s in shape)))


def ndarray_save(fname: str, hids, names):
    mx = _mx()
    arrs = [_get(h) for h in hids]
    if names:
        mx.nd.save(fname, dict(zip(list(names), arrs)))
    else:
        mx.nd.save(fname, arrs)


def ndarray_load(fname: str) -> tuple:
    loaded = _mx().nd.load(fname)
    if isinstance(loaded, dict):
        names = list(loaded)  # insertion order == file order
        return tuple(_put(loaded[n]) for n in names), tuple(names)
    return tuple(_put(a) for a in loaded), ()


def ndarray_save_raw(hid) -> bytes:
    """Single-array raw serialization (MXNDArraySaveRawBytes,
    reference ndarray.cc:518: shape/ctx/dtype header + payload, no magic)."""
    import io as _io
    from .ndarray import _save_one
    bio = _io.BytesIO()
    _save_one(bio, _get(hid))
    return bio.getvalue()


def ndarray_load_raw(data: bytes) -> int:
    import io as _io
    from .ndarray import _load_one
    return _put(_load_one(_io.BytesIO(data)))


# ---------------------------------------------------------------------------
# NDArray function registry (MXListFunctions / MXFuncInvoke)
#
# The reference registers imperative functions with (used_vars, scalars,
# mutate_vars) arity through MXNET_REGISTER_NDARRAY_FUN
# (ndarray.cc:664-810); bindings introspect the registry and synthesize
# wrappers. Same contract here: each entry is
# (n_used, n_scalars, n_mutate, fn(used, scalars, outs)).

def _w(out, value_nd):
    value_nd.copyto(out)


class _Fn:
    def __init__(self, n_used, n_scalars, n_mutate, run, doc=""):
        self.n_used, self.n_scalars, self.n_mutate = n_used, n_scalars, n_mutate
        self.run, self.doc = run, doc


def _make_registry():
    mx = _mx()
    nd = mx.nd
    R = {
        "_set_value": _Fn(0, 1, 1, lambda u, s, o: o[0].__setitem__(
            slice(None), s[0])),
        "_plus": _Fn(2, 0, 1, lambda u, s, o: _w(o[0], u[0] + u[1])),
        "_minus": _Fn(2, 0, 1, lambda u, s, o: _w(o[0], u[0] - u[1])),
        "_mul": _Fn(2, 0, 1, lambda u, s, o: _w(o[0], u[0] * u[1])),
        "_div": _Fn(2, 0, 1, lambda u, s, o: _w(o[0], u[0] / u[1])),
        "dot": _Fn(2, 0, 1, lambda u, s, o: _w(o[0], nd.dot(u[0], u[1]))),
        "_onehot_encode": _Fn(2, 0, 1, lambda u, s, o: _w(
            o[0], nd.onehot_encode(u[0], o[0]))),
        "choose_element_0index": _Fn(2, 0, 1, lambda u, s, o: _w(
            o[0], nd.choose_element_0index(u[0], u[1]))),
        "fill_element_0index": _Fn(3, 0, 1, lambda u, s, o: _w(
            o[0], nd.fill_element_0index(u[0], u[1], u[2]))),
        "clip": _Fn(1, 2, 1, lambda u, s, o: _w(
            o[0], nd.clip(u[0], s[0], s[1]))),
        "_plus_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], u[0] + s[0])),
        "_minus_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], u[0] - s[0])),
        "_rminus_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], s[0] - u[0])),
        "_mul_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], u[0] * s[0])),
        "_div_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], u[0] / s[0])),
        "_rdiv_scalar": _Fn(1, 1, 1, lambda u, s, o: _w(o[0], s[0] / u[0])),
        "_copyto": _Fn(1, 0, 1, lambda u, s, o: u[0].copyto(o[0])),
        "_random_uniform": _Fn(0, 2, 1, lambda u, s, o: mx.random.uniform(
            s[0], s[1], out=o[0])),
        "_random_gaussian": _Fn(0, 2, 1, lambda u, s, o: mx.random.normal(
            s[0], s[1], out=o[0])),
    }
    return R


_FUNC_REGISTRY = None


def _func_registry():
    global _FUNC_REGISTRY
    if _FUNC_REGISTRY is None:
        _FUNC_REGISTRY = _make_registry()
    return _FUNC_REGISTRY


def list_functions() -> tuple:
    return tuple(sorted(_func_registry()))


def func_info(name: str) -> tuple:
    fn = _func_registry()[name]
    return name, fn.doc


def func_describe(name: str) -> tuple:
    fn = _func_registry()[name]
    return fn.n_used, fn.n_scalars, fn.n_mutate


def func_invoke(name: str, used_hids, scalars, mutate_hids):
    fn = _func_registry()[name]
    fn.run([_get(h) for h in used_hids], [float(s) for s in scalars],
           [_get(h) for h in mutate_hids])


# ---------------------------------------------------------------------------
# Symbol

def symbol_list_creators() -> tuple:
    from .ops.registry import REGISTRY
    return tuple(sorted(REGISTRY))


def symbol_creator_info(name: str) -> tuple:
    from .ops.registry import REGISTRY
    spec = REGISTRY[name]
    keys, types, descs = [], [], []
    for pname, p in getattr(spec, "params", {}).items():
        keys.append(pname)
        types.append(getattr(p, "ptype", object).__name__
                     if not isinstance(getattr(p, "ptype", None), str)
                     else p.ptype)
        descs.append(getattr(p, "desc", ""))
    doc = (spec.__doc__ or "").strip()
    return name, doc, tuple(keys), tuple(types), tuple(descs)


def symbol_create_atomic(name: str, keys, vals) -> int:
    from . import symbol
    fn = getattr(symbol, name, None)
    kwargs = dict(zip(list(keys), list(vals)))
    if fn is not None and callable(fn):
        return _put(("atomic", name, kwargs))
    raise ValueError("unknown op %s" % name)


def symbol_compose(hid, name, kw_keys, arg_hids):
    """Finish an atomic symbol: call the creator with symbol inputs
    (reference MXSymbolCompose, c_api.h:631)."""
    from . import symbol
    kind = _get(hid)
    if not (isinstance(kind, tuple) and kind and kind[0] == "atomic"):
        raise ValueError("compose target is not an atomic symbol handle")
    _, op_name, str_kwargs = kind
    fn = getattr(symbol, op_name)
    args = [_get(h) for h in arg_hids]
    kwargs = dict(str_kwargs)
    if name:
        kwargs["name"] = name
    if kw_keys:
        sym = fn(**dict(zip(list(kw_keys), args)), **kwargs)
    else:
        sym = fn(*args, **kwargs)
    _TABLE[int(hid)] = sym


def symbol_create_variable(name: str) -> int:
    return _put(_mx().symbol.Variable(name))


def symbol_create_group(hids) -> int:
    return _put(_mx().symbol.Group([_get(h) for h in hids]))


def symbol_from_json(json_str: str) -> int:
    return _put(_mx().symbol.load_json(json_str))


def symbol_from_file(fname: str) -> int:
    return _put(_mx().symbol.load(fname))


def symbol_to_json(hid) -> str:
    return _get(hid).tojson()


def symbol_save_file(hid, fname: str):
    _get(hid).save(fname)


def symbol_copy(hid) -> int:
    import copy
    return _put(copy.deepcopy(_get(hid)))


def symbol_print(hid) -> str:
    return _get(hid).debug_str()


def symbol_get_attr(hid, key: str) -> tuple:
    v = _get(hid).attr(key)
    return (1, v) if v is not None else (0, "")


def symbol_set_attr(hid, key: str, value: str):
    _get(hid)._set_attr(**{key: value})


def symbol_list_arguments(hid) -> tuple:
    return tuple(_get(hid).list_arguments())


def symbol_list_outputs(hid) -> tuple:
    return tuple(_get(hid).list_outputs())


def symbol_list_aux(hid) -> tuple:
    return tuple(_get(hid).list_auxiliary_states())


def symbol_get_internals(hid) -> int:
    return _put(_get(hid).get_internals())


def symbol_get_output(hid, index: int) -> int:
    return _put(_get(hid)[int(index)])


def symbol_grad(hid, wrt) -> int:
    return _put(_get(hid).grad(list(wrt)))


def _pack_shapes(shapes) -> tuple:
    return tuple(tuple(int(x) for x in s) if s is not None else ()
                 for s in shapes)


def symbol_infer_shape(hid, keys, shapes, partial: int = 0) -> tuple:
    sym = _get(hid)
    keys = list(keys)
    shapes = list(shapes)
    if not keys and shapes:
        # positional mode (reference MXSymbolInferShape with keys=NULL):
        # shapes align with list_arguments() order
        keys = sym.list_arguments()[:len(shapes)]
    kwargs = {k: tuple(int(x) for x in s)
              for k, s in zip(keys, shapes) if len(s)}
    try:
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**kwargs)
    except Exception:
        if not partial:
            raise
        arg_shapes = out_shapes = aux_shapes = None
    if arg_shapes is None:
        return 0, (), (), ()
    return 1, _pack_shapes(arg_shapes), _pack_shapes(out_shapes), \
        _pack_shapes(aux_shapes)


def symbol_infer_type(hid, keys, type_codes) -> tuple:
    sym = _get(hid)
    keys = list(keys)
    type_codes = list(type_codes)
    if not keys and type_codes:
        keys = sym.list_arguments()[:len(type_codes)]
    kwargs = {k: _CODE_TO_DTYPE[int(c)]
              for k, c in zip(keys, type_codes) if int(c) >= 0}
    arg_types, out_types, aux_types = sym.infer_type(**kwargs)
    if arg_types is None:
        return 0, (), (), ()
    pack = lambda ts: tuple(_code(t) for t in ts)
    return 1, pack(arg_types), pack(out_types), pack(aux_types)


# ---------------------------------------------------------------------------
# Executor

_GRAD_REQ = {0: "null", 1: "write", 2: "write", 3: "add"}


def executor_bind(sym_hid, dev_type: int, dev_id: int, arg_hids,
                  grad_hids, grad_req_codes, aux_hids) -> int:
    sym = _get(sym_hid)
    args = [_get(h) for h in arg_hids]
    grads = [(_get(h) if int(h) and _get(h) is not None else None)
             for h in grad_hids] if grad_hids else None
    reqs = [_GRAD_REQ[int(c)] for c in grad_req_codes] if grad_req_codes \
        else "write"
    aux = [_get(h) for h in aux_hids] if aux_hids else None
    exe = sym.bind(_ctx(dev_type, dev_id), args, args_grad=grads,
                   grad_req=reqs, aux_states=aux)
    return _put(exe)


def executor_forward(hid, is_train: int):
    _get(hid).forward(is_train=bool(is_train))


def executor_backward(hid, head_hids):
    exe = _get(hid)
    if head_hids:
        exe.backward([_get(h) for h in head_hids])
    else:
        exe.backward()


def executor_outputs(hid) -> tuple:
    return tuple(_put(o) for o in _get(hid).outputs)


def executor_print(hid) -> str:
    return _get(hid).debug_str()


# ---------------------------------------------------------------------------
# DataIter (MXListDataIters / MXDataIterCreateIter ...)

_DATA_ITERS = ("MNISTIter", "CSVIter", "ImageRecordIter")


def list_data_iters() -> tuple:
    return _DATA_ITERS


def _parse_kwarg(v: str):
    s = v.strip()
    if s.startswith("("):
        return tuple(int(x) for x in s.strip("()").split(",") if x.strip())
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    return v


def data_iter_create(name: str, keys, vals) -> int:
    mx = _mx()
    if name not in _DATA_ITERS:
        raise ValueError("unknown iterator %s" % name)
    cls = getattr(mx.io, name, None) or getattr(mx.image_io, name)
    kwargs = {k: _parse_kwarg(v) for k, v in zip(list(keys), list(vals))}
    return _put(cls(**kwargs))


def data_iter_next(hid) -> int:
    it = _get(hid)
    try:
        batch = it.next()
    except StopIteration:
        return 0
    it._c_api_batch = batch
    return 1


def data_iter_before_first(hid):
    _get(hid).reset()


def data_iter_get_data(hid) -> int:
    batch = _get(hid)._c_api_batch
    return _put(batch.data[0])


def data_iter_get_label(hid) -> int:
    batch = _get(hid)._c_api_batch
    return _put(batch.label[0])


def data_iter_get_index(hid) -> tuple:
    batch = _get(hid)._c_api_batch
    idx = getattr(batch, "index", None)
    return tuple(int(i) for i in idx) if idx is not None else ()


def data_iter_get_pad(hid) -> int:
    return int(_get(hid)._c_api_batch.pad or 0)


# ---------------------------------------------------------------------------
# KVStore

def kvstore_create(kv_type: str) -> int:
    return _put(_mx().kvstore.create(kv_type))


def _kv_vals(hids):
    return [_get(h) for h in hids]


def kvstore_init(hid, keys, val_hids):
    _get(hid).init(list(int(k) for k in keys), _kv_vals(val_hids))


def kvstore_push(hid, keys, val_hids, priority: int):
    _get(hid).push(list(int(k) for k in keys), _kv_vals(val_hids),
                   priority=int(priority))


def kvstore_pull(hid, keys, out_hids, priority: int):
    _get(hid).pull(list(int(k) for k in keys), out=_kv_vals(out_hids),
                   priority=int(priority))


def kvstore_set_updater(hid, fn_ptr: int, closure: int):
    """Wrap a C function pointer ``void (*)(int key, NDArrayHandle recv,
    NDArrayHandle local, void*)`` (reference MXKVStoreUpdater,
    c_api.h:1075-1084) via ctypes; handles passed back to C are table ids."""
    import ctypes
    cb_type = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p)
    cb = cb_type(int(fn_ptr))

    def updater(key, recv, local):
        recv_id, local_id = _put(recv), _put(local)
        try:
            cb(int(key), recv_id, local_id, closure)
        finally:
            free_handle(recv_id)
            free_handle(local_id)

    kv = _get(hid)
    kv._set_updater(updater)
    kv._c_updater_keepalive = cb


def kvstore_get_type(hid) -> str:
    return _get(hid).type


def kvstore_get_rank(hid) -> int:
    return int(_get(hid).rank)


def kvstore_get_group_size(hid) -> int:
    return int(_get(hid).num_workers)


def kvstore_barrier(hid):
    _get(hid).barrier()


def kvstore_send_command(hid, head: int, body: str):
    _get(hid).send_command_to_servers(int(head), body)
