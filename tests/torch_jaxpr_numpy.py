"""The JAX package's jitted functions evaluated with numpy, for the parity
tests of the port's wide AIRs.

XLA:CPU takes many minutes to compile the composition of an AIR of
thousands of columns, and JAX's eager mode compiles each operation on
first use; both are too slow for the tier-1 tests.  Tracing a jitted
function to its jaxpr takes seconds.  `numpy_jit()` makes every jitted
function of the JAX package (those made at import and those made at call
time) trace to its jaxpr and run it primitive by primitive on numpy arrays
of the jaxpr's own dtypes, with XLA's semantics for each primitive
(wrapping integer arithmetic, shifts by the bit width or more giving 0,
clamped gathers and dynamic slices).  The program is the JAX function's
own; only the evaluator differs.  A primitive not listed in RULES raises.

    with numpy_jit():
        proof, publics, params = jax_demux.prove_demux(queries)
"""

from __future__ import annotations

import contextlib
import sys
import weakref

import numpy as np

import jax
import jax.numpy as jnp


def _unsigned(x):
    return x.view(np.dtype(f"u{x.dtype.itemsize}")) if x.dtype.kind == "i" else x


def _shift_left(x, s):
    bits = x.dtype.itemsize * 8
    s = _unsigned(np.asarray(s)).astype(np.uint64)
    out = np.left_shift(x, np.minimum(s, bits - 1).astype(x.dtype))
    return np.where(s >= bits, np.zeros_like(out), out)


def _shift_right_logical(x, s):
    bits = x.dtype.itemsize * 8
    s = _unsigned(np.asarray(s)).astype(np.uint64)
    u = _unsigned(x)
    out = np.right_shift(u, np.minimum(s, bits - 1).astype(u.dtype))
    return np.where(s >= bits, np.zeros_like(out), out).view(x.dtype)


def _shift_right_arithmetic(x, s):
    bits = x.dtype.itemsize * 8
    s = _unsigned(np.asarray(s)).astype(np.uint64)
    return np.right_shift(x, np.minimum(s, bits - 1).astype(x.dtype))


def _broadcast_in_dim(x, *dyn, shape, broadcast_dimensions, **_):
    s = [1] * len(shape)
    for i, d in enumerate(broadcast_dimensions):
        s[d] = x.shape[i]
    return np.broadcast_to(x.reshape(s), shape)


def _select_n(pred, *cases):
    if len(cases) == 2:
        return np.where(pred.astype(bool), cases[1], cases[0])
    return np.choose(pred.astype(np.int64), np.broadcast_arrays(*cases))


def _slice(x, start_indices, limit_indices, strides):
    strides = strides or (1,) * x.ndim
    return x[tuple(slice(a, b, c) for a, b, c in zip(start_indices, limit_indices, strides))]


def _clamped_starts(x, starts, sizes):
    return [int(min(max(int(s), 0), d - k)) for s, d, k in zip(starts, x.shape, sizes)]


def _dynamic_slice(x, *starts, slice_sizes):
    st = _clamped_starts(x, starts[:x.ndim], slice_sizes)
    return x[tuple(slice(a, a + k) for a, k in zip(st, slice_sizes))]


def _dynamic_update_slice(x, update, *starts):
    st = _clamped_starts(x, starts, update.shape)
    out = np.array(x, copy=True)
    out[tuple(slice(a, a + k) for a, k in zip(st, update.shape))] = update
    return out


def _gather(operand, indices, *, dimension_numbers, slice_sizes, mode, fill_value=None, **_):
    dn = dimension_numbers
    idx = np.asarray(indices).astype(np.int64)
    batch_shape = idx.shape[:-1]
    nb = len(batch_shape)
    rank = operand.ndim
    starts = [np.zeros(batch_shape, np.int64) for _ in range(rank)]
    for k, d in enumerate(dn.start_index_map):
        starts[d] = idx[..., k]
    for ob, ib in zip(dn.operand_batching_dims, dn.start_indices_batching_dims):
        shape = [1] * nb
        shape[ib] = batch_shape[ib]
        starts[ob] = np.broadcast_to(np.arange(batch_shape[ib]).reshape(shape), batch_shape)
    out_of_bounds = np.zeros(batch_shape, bool)
    for d in range(rank):
        hi = operand.shape[d] - slice_sizes[d]
        out_of_bounds |= (starts[d] < 0) | (starts[d] > hi)
        starts[d] = np.clip(starts[d], 0, hi)
    off = [d for d in range(rank)
           if d not in dn.collapsed_slice_dims and d not in dn.operand_batching_dims]
    no = len(off)
    index = []
    for d in range(rank):
        s = starts[d].reshape(batch_shape + (1,) * no)
        if d in off:
            j = off.index(d)
            s = s + np.arange(slice_sizes[d]).reshape(
                (1,) * nb + tuple(slice_sizes[d] if k == j else 1 for k in range(no)))
        index.append(s)
    res = operand[tuple(index)]
    if "FILL" in str(mode).upper() and out_of_bounds.any():
        fill = 0 if fill_value is None else fill_value
        res = np.where(out_of_bounds.reshape(batch_shape + (1,) * no), np.asarray(fill, res.dtype),
                       res)
    return np.moveaxis(res, list(range(nb, nb + no)), list(dn.offset_dims))


def _iota(*dyn, dtype, shape, dimension, **_):
    r = np.arange(shape[dimension], dtype=dtype)
    s = [1] * len(shape)
    s[dimension] = shape[dimension]
    return np.broadcast_to(r.reshape(s), shape)


def _pad(x, padval, padding_config):
    out = x
    for d, (lo, hi, interior) in enumerate(padding_config):
        n = out.shape[d]
        size = n + max(n - 1, 0) * interior
        shape = list(out.shape)
        shape[d] = size
        full = np.full(shape, padval, out.dtype)
        sl = [slice(None)] * out.ndim
        sl[d] = slice(0, size, interior + 1)
        full[tuple(sl)] = out
        # the low and high edges, negative values cutting
        if lo < 0:
            full = np.take(full, range(-lo, full.shape[d]), axis=d)
        elif lo > 0:
            shape[d] = lo
            full = np.concatenate([np.full(shape, padval, out.dtype), full], axis=d)
        if hi < 0:
            full = np.take(full, range(0, full.shape[d] + hi), axis=d)
        elif hi > 0:
            shape[d] = hi
            full = np.concatenate([full, np.full(shape, padval, out.dtype)], axis=d)
        out = full
    return out


def _reduce(fn):
    def rule(x, *, axes, **_):
        return fn(x, axis=tuple(axes), dtype=x.dtype) if fn in (np.sum, np.prod) else \
            fn(x, axis=tuple(axes))
    return rule


def _cumulative(fn):
    def rule(x, *, axis, reverse):
        if reverse:
            return np.flip(fn(np.flip(x, axis), axis=axis, dtype=x.dtype), axis)
        return fn(x, axis=axis, dtype=x.dtype)
    return rule


def _div(a, b):
    if a.dtype.kind == "u":
        return a // b
    q = np.abs(a.astype(np.int64)) // np.abs(b.astype(np.int64))
    return (np.sign(a) * np.sign(b) * q).astype(a.dtype)


def _rem(a, b):
    if a.dtype.kind == "u":
        return a % b
    return (a - _div(a, b) * b).astype(a.dtype)


def _scan(*args, jaxpr, num_consts, num_carry, length, reverse, **_):
    consts = list(args[:num_consts])
    carry = list(args[num_consts:num_consts + num_carry])
    xs = args[num_consts + num_carry:]
    ys = []
    for i in (range(length - 1, -1, -1) if reverse else range(length)):
        out = eval_closed(jaxpr, consts + carry + [x[i] for x in xs])
        carry, y = out[:num_carry], out[num_carry:]
        ys.append(y)
    if reverse:
        ys.reverse()
    avals = jaxpr.out_avals[num_carry:]
    stacked = [np.stack([y[k] for y in ys]) if ys else np.zeros((0,) + a.shape, a.dtype)
               for k, a in enumerate(avals)]
    return carry + stacked


def _while(*args, cond_jaxpr, body_jaxpr, cond_nconsts, body_nconsts):
    cc = list(args[:cond_nconsts])
    bc = list(args[cond_nconsts:cond_nconsts + body_nconsts])
    val = list(args[cond_nconsts + body_nconsts:])
    while bool(eval_closed(cond_jaxpr, cc + val)[0]):
        val = eval_closed(body_jaxpr, bc + val)
    return val


def _cond(index, *ops, branches, **_):
    i = min(max(int(index), 0), len(branches) - 1)
    return eval_closed(branches[i], list(ops))


def _call(key):
    def rule(*args, **params):
        return eval_closed(params[key], list(args))
    return rule


def _split(x, *, sizes, axis):
    return np.split(x, np.cumsum(sizes)[:-1], axis=axis)


RULES = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply, "neg": np.negative,
    "max": np.maximum, "min": np.minimum, "abs": np.abs, "sign": np.sign,
    "div": _div, "rem": _rem, "square": lambda x: x * x,
    "integer_pow": lambda x, y: np.power(x, y, dtype=x.dtype),
    "and": np.bitwise_and, "or": np.bitwise_or, "xor": np.bitwise_xor, "not": np.invert,
    "shift_left": _shift_left, "shift_right_logical": _shift_right_logical,
    "shift_right_arithmetic": _shift_right_arithmetic,
    "population_count": lambda x: np.bitwise_count(_unsigned(x)).astype(x.dtype),
    "eq": np.equal, "ne": np.not_equal, "lt": np.less, "le": np.less_equal,
    "gt": np.greater, "ge": np.greater_equal,
    "select_n": _select_n,
    "clamp": lambda lo, x, hi: np.minimum(np.maximum(x, lo), hi),
    "convert_element_type": lambda x, *, new_dtype, **_: x.astype(new_dtype),
    "broadcast_in_dim": _broadcast_in_dim,
    "reshape": lambda x, *dyn, new_sizes, **_: np.reshape(x, new_sizes),
    "squeeze": lambda x, *, dimensions: np.squeeze(x, axis=tuple(dimensions)),
    "expand_dims": lambda x, *, dimensions: np.expand_dims(x, tuple(dimensions)),
    "transpose": lambda x, *, permutation: np.transpose(x, permutation),
    "rev": lambda x, *, dimensions: np.flip(x, tuple(dimensions)),
    "slice": _slice, "dynamic_slice": _dynamic_slice,
    "dynamic_update_slice": _dynamic_update_slice,
    "concatenate": lambda *xs, dimension: np.concatenate(xs, axis=dimension),
    "split": _split,
    "pad": _pad, "iota": _iota, "gather": _gather,
    "reduce_sum": _reduce(np.sum), "reduce_prod": _reduce(np.prod),
    "reduce_max": _reduce(np.max), "reduce_min": _reduce(np.min),
    "reduce_or": _reduce(np.any), "reduce_and": _reduce(np.all),
    "argmax": lambda x, *, axes, index_dtype: np.argmax(x, axis=axes[0]).astype(index_dtype),
    "argmin": lambda x, *, axes, index_dtype: np.argmin(x, axis=axes[0]).astype(index_dtype),
    "cumsum": _cumulative(np.cumsum), "cumprod": _cumulative(np.cumprod),
    "copy": lambda x: x, "copy_p": lambda x: x,
    "optimization_barrier": lambda *xs: list(xs),
    "device_put": lambda *xs, **_: list(xs),
    "scan": _scan, "while": _while, "cond": _cond,
    "jit": _call("jaxpr"), "pjit": _call("jaxpr"), "closed_call": _call("call_jaxpr"),
    "custom_jvp_call": _call("call_jaxpr"), "custom_vjp_call": _call("call_jaxpr"),
}


def _is_literal(v) -> bool:
    return type(v).__name__ == "Literal"


class _Program:
    """A jaxpr compiled once into steps over numbered slots: each step is
    (rule, input slots, params, multiple results, output (slot, dtype) or
    None, slots freed after it).  Literals sit in slots of their own."""

    def __init__(self, jaxpr):
        slots = {}
        self.template = []

        def slot(v):
            key = ("literal", id(v)) if _is_literal(v) else v
            if key not in slots:
                slots[key] = len(self.template)
                self.template.append(np.asarray(v.val, dtype=v.aval.dtype)
                                     if _is_literal(v) else None)
            return slots[key]

        self.const_slots = [slot(v) for v in jaxpr.constvars]
        self.in_slots = [slot(v) for v in jaxpr.invars]
        self.out_slots = [slot(v) for v in jaxpr.outvars]
        last = {}
        for i, e in enumerate(jaxpr.eqns):
            for v in e.invars:
                if not _is_literal(v):
                    last[v] = i
        keep = set(self.out_slots)
        self.steps = []
        for i, e in enumerate(jaxpr.eqns):
            rule = RULES.get(e.primitive.name)
            if rule is None:
                raise NotImplementedError(f"no numpy rule for the primitive {e.primitive.name}")
            ins = tuple(slot(v) for v in e.invars)
            outs = tuple(None if type(v).__name__ == "DropVar" else (slot(v), np.dtype(v.aval.dtype))
                         for v in e.outvars)
            frees = tuple({slots[v] for v in e.invars
                           if not _is_literal(v) and last[v] == i and slots[v] not in keep})
            self.steps.append((rule, ins, dict(e.params), e.primitive.multiple_results, outs,
                               frees))

    def run(self, consts, args):
        env = list(self.template)
        for s, x in zip(self.const_slots, consts):
            env[s] = np.asarray(x)
        for s, x in zip(self.in_slots, args):
            env[s] = np.asarray(x)
        with np.errstate(all="ignore"):
            for rule, ins, params, multiple, outs, frees in self.steps:
                res = rule(*[env[s] for s in ins], **params)
                if not multiple:
                    res = (res,)
                for out, o in zip(outs, res):
                    if out is not None:
                        o = np.asarray(o)
                        if o.dtype != out[1]:
                            o = o.astype(out[1])
                        env[out[0]] = o
                for s in frees:
                    env[s] = None
        return [env[s] for s in self.out_slots]


_PROGRAMS = weakref.WeakKeyDictionary()  # jaxpr -> its _Program, while the jaxpr lives


def eval_jaxpr(jaxpr, consts, args):
    """The outputs of `jaxpr` on numpy `args` (its constvars bound to
    `consts`), each in its aval's dtype."""
    program = _PROGRAMS.get(jaxpr)
    if program is None:
        program = _PROGRAMS[jaxpr] = _Program(jaxpr)
    return program.run(consts, args)


def eval_closed(closed, args):
    return eval_jaxpr(closed.jaxpr, closed.consts, args)


def _weak(x) -> bool:
    """Whether JAX traces `x` as weakly typed (a python scalar)."""
    return isinstance(x, (bool, int, float, complex)) or bool(getattr(x, "weak_type", False))


class NumpyJit:
    """A jitted function whose calls trace it and evaluate the jaxpr with
    numpy; the outputs come back as JAX arrays in the function's pytree."""

    def __init__(self, jitted):
        self.jitted = jitted
        info = jitted._jit_info
        self.static_nums = set(info.static_argnums)
        self.static_names = set(info.static_argnames)
        self.traces = {}  # (arguments' tree, avals, static arguments) -> jaxpr, out tree
        self.__wrapped__ = getattr(jitted, "__wrapped__", None)
        self.__name__ = getattr(self.__wrapped__, "__name__", "jitted")
        self.__doc__ = getattr(self.__wrapped__, "__doc__", None)

    def __call__(self, *args, **kwargs):
        dyn = (tuple(a for i, a in enumerate(args) if i not in self.static_nums),
               {k: v for k, v in kwargs.items() if k not in self.static_names})
        leaves, tree = jax.tree_util.tree_flatten(dyn)
        static = (tuple((i, a) for i, a in enumerate(args) if i in self.static_nums),
                  tuple(sorted((k, v) for k, v in kwargs.items() if k in self.static_names)))
        key = (tree, tuple((np.shape(x), jnp.result_type(x), _weak(x)) for x in leaves), static)
        try:
            closed, out_tree = self.traces[key]
        except (KeyError, TypeError):  # a first call, or an unhashable static argument
            traced = self.jitted.trace(*args, **kwargs)
            if tree != traced.in_tree:
                raise ValueError(f"{self.__name__}: arguments {tree} do not match "
                                 f"{traced.in_tree}")
            closed, out_tree = traced.jaxpr, traced.out_tree
            try:
                self.traces[key] = closed, out_tree
            except TypeError:
                pass
        flat = [np.asarray(x).astype(a.dtype, copy=False)
                for x, a in zip(leaves, closed.in_avals)]
        outs = eval_closed(closed, flat)
        return jax.tree_util.tree_unflatten(out_tree, [jnp.asarray(o) for o in outs])


_MADE = {}  # (code, ids of the closure's objects and defaults, jit options) -> NumpyJit


def _made_at_call_time(real_jit, fun, kwargs):
    """The NumpyJit of `jax.jit(fun, **kwargs)`: one for every function of
    the same code over the same closure objects and defaults, so that a
    jitted closure made anew each call (or after an lru cache is emptied)
    keeps its traces.  The entry goes when one of those objects dies (it
    holds them weakly, or strongly where they take no weak reference)."""
    code = getattr(fun, "__code__", None)
    held = tuple(c.cell_contents for c in (getattr(fun, "__closure__", None) or ()))
    held += (getattr(fun, "__defaults__", None),)
    try:
        key = (code, tuple(id(x) for x in held), tuple(sorted(kwargs.items())))
        hash(key)
    except TypeError:
        key = None
    if code is None or key is None:
        return NumpyJit(real_jit(fun, **kwargs))
    hit = _MADE.get(key)
    if hit is None:
        refs = []
        for x in held:
            try:
                refs.append(weakref.ref(x, lambda _, k=key: _MADE.pop(k, None)))
            except TypeError:
                refs.append(x)
        hit = _MADE[key] = (refs, NumpyJit(real_jit(fun, **kwargs)))
    return hit[1]


def _numpy_jit_factory(real_jit):
    def jit(fun=None, **kwargs):
        if fun is None:
            return lambda f: _made_at_call_time(real_jit, f, kwargs)
        return _made_at_call_time(real_jit, fun, kwargs)
    return jit


_WRAPPERS = {}  # id(jitted) -> (jitted, its NumpyJit): traces kept across blocks


@contextlib.contextmanager
def numpy_jit(names=None, package: str = "zkevm_circuits_tpu"):
    """Within the block, jitted functions of `package` run through
    `NumpyJit`: those of the module attributes `names` (each module that
    holds one), or with `names=None` every jitted module attribute and every
    `jax.jit` made at call time.  Everything is put back after."""
    real_jit = jax.jit
    swapped = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == package or name.startswith(package + ".")):
            continue
        for attr, val in list(vars(mod).items()):
            if names is not None and attr not in names:
                continue
            if type(val).__name__ == "PjitFunction":
                swapped.append((mod, attr, val))
                hit = _WRAPPERS.get(id(val))
                if hit is None or hit[0] is not val:
                    hit = _WRAPPERS[id(val)] = (val, NumpyJit(val))
                setattr(mod, attr, hit[1])
            elif val is real_jit and names is None:  # `from jax import jit`
                swapped.append((mod, attr, val))
                setattr(mod, attr, _numpy_jit_factory(real_jit))
    caches = [val for name, mod in list(sys.modules.items())
              if mod is not None and (name == package or name.startswith(package + "."))
              for val in vars(mod).values() if hasattr(val, "cache_clear")]
    if names is None:
        # the package's lru caches hold jitted functions made at call time:
        # emptied, so that they are made anew in the block's mode and after it
        for c in caches:
            c.cache_clear()
        jax.jit = _numpy_jit_factory(real_jit)
    try:
        yield
    finally:
        jax.jit = real_jit
        for mod, attr, val in swapped:
            setattr(mod, attr, val)
        if names is None:
            for c in caches:
                c.cache_clear()
