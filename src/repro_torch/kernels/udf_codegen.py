"""Compile a scatter UDF written in torch ops into C++ for the GAS kernel.

The reference package traces its jnp scatter UDF into the Pallas body
(``make_gas_kernel`` closes over it). The port's twin traces the torch
UDF ``fn(src, w)`` with ``torch.fx`` and emits one C++ expression of the
same elementwise function over ``p`` (the source property: ``float``, or
``int`` in ``or`` mode) and ``w`` (the edge weight, ``float``). The
kernel's build defines ``GAS_SCATTER_EXPR(p, w)`` as that expression
(scatter op ``kCustom`` in ``csrc/gas_kernel.cu``), one library per
expression, built at first use.

The expression computes what torch eager computes on float32 / int32
tensors:

* Types follow torch's promotion: int32 with float32 gives float32, a
  Python scalar takes the tensor's kind unless it is a float meeting an
  int tensor, comparisons give bool, ``/`` is true division.
* Float constants are written exactly, as hex-float literals of the
  float32 torch rounds them to.
* Every float ``+ - * /`` rounds once, as a torch op does:
  ``__fadd_rn`` / ``__fsub_rn`` / ``__fmul_rn`` / ``__fdiv_rn``, which
  nvcc never contracts into an FMA.
* ``minimum`` / ``maximum`` / ``clamp`` are those of torch's vectorized
  CPU kernels: a NaN operand gives NaN (``torch.minimum``'s rule, not
  ``fminf``'s); otherwise ``a < b ? a : b`` (``a > b`` for maximum),
  which picks ``b`` on a tie of signed zeros.
* int32 ``+ - *`` wrap in two's complement, and shifts by a count
  outside [0, 32) give torch's results (0, or the sign for ``>>``).

The helpers the expression calls (``gas_minimum`` and the rest) are in
``csrc/gas_udf.cuh``. Ops outside the closed set below, and Python
control flow on traced values, raise ``NotImplementedError`` naming the
op: a UDF the kernel cannot run never falls back to the plain path on
the card.

The closed set: ``+ - * /``, unary ``-``, ``abs``; ``torch.minimum`` /
``maximum``, ``clamp`` (and ``clamp_min`` / ``clamp_max`` / ``clip``),
``where``; ``< <= > >= == !=``; ``& | ^ << >> ~`` on int32 or bool;
casts to float32 / int32 (``.float()``, ``.int()``, ``.to(dtype)``);
Python and closure constants (numpy scalars too).
"""
from __future__ import annotations

import dataclasses
import math
import operator
import weakref
from typing import Callable

import numpy as np
import torch
import torch.fx

PROP_CTYPES = {"float32": "float", "int32": "int"}
_CTYPE = {"f": "float", "i": "int", "b": "bool"}
_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class ScatterUdf:
    """A traced scatter UDF: its C++ expression over ``p`` and ``w``, and
    whether it reads the edge weight (the kernel loads ``w`` only
    then)."""
    expr: str
    uses_weight: bool


@dataclasses.dataclass(frozen=True)
class _Val:
    """A traced value: C++ text and kind ("f" float32, "i" int32, "b"
    bool), or a Python constant (``const`` set; kind from its type)."""
    text: str
    kind: str
    const: object = None


def _float_lit(x: float) -> str:
    """The float32 that torch rounds ``x`` to, as an exact literal."""
    f = float(np.float32(x))
    if math.isnan(f):
        return "gas_nan()"
    if math.isinf(f):
        return "gas_inf()" if f > 0 else "(-gas_inf())"
    return f"{f.hex()}f"


def _int_lit(x: int) -> str:
    if not _INT32_MIN <= x <= _INT32_MAX:
        raise NotImplementedError(
            f"scatter UDF constant {x} does not fit int32")
    return f"({x + 1} - 1)" if x == _INT32_MIN else str(x)


def _const(x) -> _Val:
    if isinstance(x, bool):
        return _Val("true" if x else "false", "b", x)
    if isinstance(x, int):
        return _Val(_int_lit(x), "i", x)
    if isinstance(x, float):
        return _Val(_float_lit(x), "f", x)
    raise NotImplementedError(
        f"scatter UDF constant {x!r} of type {type(x).__name__}")


def _cast(v: _Val, kind: str) -> str:
    """C++ text of ``v`` converted to ``kind``."""
    if v.kind == kind:
        return v.text
    if v.const is not None:           # a constant takes the kind exactly
        if kind == "f":
            return _float_lit(float(v.const))
        if kind == "i":
            return _int_lit(int(v.const))
    return f"static_cast<{_CTYPE[kind]}>({v.text})"


def _promote(*vals: _Val) -> str:
    """torch's result kind for tensors and Python scalars: tensors
    decide unless a float scalar meets no float tensor."""
    rank = {"b": 0, "i": 1, "f": 2}
    tensors = [v.kind for v in vals if v.const is None]
    scalars = [v.kind for v in vals if v.const is not None]
    if not tensors:
        return "f" if "f" in scalars else max(scalars, key=rank.get)
    kind = max(tensors, key=rank.get)
    for s in scalars:
        if rank[s] > rank[kind]:
            if kind == "b" and s == "i":
                raise NotImplementedError(
                    "scatter UDF: a bool tensor with an int constant gives "
                    "int64 in torch; cast it with .int() first")
            kind = s
    return kind


_FLOAT_OPS = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
              "div": "__fdiv_rn"}
_INT_OPS = {"add": "gas_iadd", "sub": "gas_isub", "mul": "gas_imul"}


def _arith(op: str, a: _Val, b: _Val) -> _Val:
    kind = "f" if op == "div" else _promote(a, b)
    if kind == "b":
        raise NotImplementedError(f"scatter UDF: '{op}' of two bools")
    fn = (_FLOAT_OPS if kind == "f" else _INT_OPS)[op]
    return _Val(f"{fn}({_cast(a, kind)}, {_cast(b, kind)})", kind)


def _compare(op: str, a: _Val, b: _Val) -> _Val:
    kind = _promote(a, b)
    return _Val(f"({_cast(a, kind)} {op} {_cast(b, kind)})", "b")


def _bitwise(op: str, a: _Val, b: _Val) -> _Val:
    kind = _promote(a, b)
    if kind == "f":
        raise NotImplementedError(f"scatter UDF: '{op}' on float32")
    if op in ("<<", ">>"):
        if kind != "i":
            raise NotImplementedError(f"scatter UDF: '{op}' on bool")
        fn = "gas_shl" if op == "<<" else "gas_shr"
        return _Val(f"{fn}({_cast(a, 'i')}, {_cast(b, 'i')})", "i")
    return _Val(f"({_cast(a, kind)} {op} {_cast(b, kind)})", kind)


def _neg(a: _Val) -> _Val:
    if a.kind == "f":
        return _Val(f"(-{a.text})", "f")
    if a.kind == "i":
        return _Val(f"gas_isub(0, {a.text})", "i")
    raise NotImplementedError("scatter UDF: unary '-' on bool")


def _abs(a: _Val) -> _Val:
    if a.kind == "b":
        raise NotImplementedError("scatter UDF: abs on bool")
    return _Val(f"gas_abs({a.text})", a.kind)


def _invert(a: _Val) -> _Val:
    if a.kind == "f":
        raise NotImplementedError("scatter UDF: '~' on float32")
    return _Val(f"(!{a.text})" if a.kind == "b" else f"(~{a.text})", a.kind)


def _minmax(fn: str, a: _Val, b: _Val) -> _Val:
    kind = _promote(a, b)
    if kind == "b":
        raise NotImplementedError(f"scatter UDF: {fn} of bools")
    return _Val(f"{fn}({_cast(a, kind)}, {_cast(b, kind)})", kind)


def _clamp(x: _Val, lo=None, hi=None) -> _Val:
    bounds = [v for v in (lo, hi) if v is not None]
    if not bounds:
        raise NotImplementedError("scatter UDF: clamp with no bound")
    kind = _promote(x, *bounds)
    if kind == "b":
        raise NotImplementedError("scatter UDF: clamp of bools")
    out = _cast(x, kind)
    if lo is not None:
        out = f"gas_clamp_min({out}, {_cast(lo, kind)})"
    if hi is not None:
        out = f"gas_clamp_max({out}, {_cast(hi, kind)})"
    return _Val(out, kind)


def _where(c: _Val, a: _Val, b: _Val) -> _Val:
    if c.kind != "b":
        raise NotImplementedError("scatter UDF: where needs a bool "
                                  "condition")
    kind = _promote(a, b)
    return _Val(f"({c.text} ? {_cast(a, kind)} : {_cast(b, kind)})", kind)


_DTYPE_KIND = {torch.float32: "f", torch.int32: "i", torch.bool: "b"}


def _to(x: _Val, dtype) -> _Val:
    kind = _DTYPE_KIND.get(dtype)
    if kind is None:
        raise NotImplementedError(f"scatter UDF: cast to {dtype}")
    return _Val(_cast(x, kind), kind)


def _binary(name):
    return lambda a, b: _arith(name, a, b)


_FUNCTIONS = {
    operator.add: _binary("add"), torch.add: _binary("add"),
    operator.sub: _binary("sub"), torch.sub: _binary("sub"),
    operator.mul: _binary("mul"), torch.mul: _binary("mul"),
    operator.truediv: _binary("div"), torch.div: _binary("div"),
    torch.true_divide: _binary("div"),
    operator.neg: _neg, torch.neg: _neg,
    operator.abs: _abs, torch.abs: _abs,
    operator.invert: _invert, torch.bitwise_not: _invert,
    torch.minimum: lambda a, b: _minmax("gas_minimum", a, b),
    torch.maximum: lambda a, b: _minmax("gas_maximum", a, b),
    torch.clamp: _clamp, torch.clip: _clamp,
    torch.clamp_min: lambda x, lo: _clamp(x, lo=lo),
    torch.clamp_max: lambda x, hi: _clamp(x, hi=hi),
    torch.where: _where,
}
for _op, _sym in ((operator.lt, "<"), (operator.le, "<="),
                  (operator.gt, ">"), (operator.ge, ">="),
                  (operator.eq, "=="), (operator.ne, "!=")):
    _FUNCTIONS[_op] = (lambda s: lambda a, b: _compare(s, a, b))(_sym)
for _name, _sym in (("lt", "<"), ("le", "<="), ("gt", ">"), ("ge", ">="),
                    ("eq", "=="), ("ne", "!=")):
    _FUNCTIONS[getattr(torch, _name)] = _FUNCTIONS[
        getattr(operator, _name)]
for _op, _t, _sym in ((operator.and_, torch.bitwise_and, "&"),
                      (operator.or_, torch.bitwise_or, "|"),
                      (operator.xor, torch.bitwise_xor, "^"),
                      (operator.lshift, torch.bitwise_left_shift, "<<"),
                      (operator.rshift, torch.bitwise_right_shift, ">>")):
    _FUNCTIONS[_op] = _FUNCTIONS[_t] = (
        lambda s: lambda a, b: _bitwise(s, a, b))(_sym)

# Tensor methods: the function of the same name with self first
_METHODS = {name: _FUNCTIONS[getattr(torch, name)] for name in (
    "add", "sub", "mul", "div", "true_divide", "neg", "abs", "minimum",
    "maximum", "clamp", "clip", "clamp_min", "clamp_max", "lt", "le", "gt",
    "ge", "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "bitwise_left_shift", "bitwise_right_shift")}
_METHODS.update({
    "where": lambda x, c, y: _where(c, x, y),
    "float": lambda x: _to(x, torch.float32),
    "int": lambda x: _to(x, torch.int32),
    "bool": lambda x: _to(x, torch.bool),
    "to": lambda x, dtype: _to(x, dtype),
})
_KWARGS = {"clamp": ("min", "max"), "clip": ("min", "max"),
           "clamp_min": ("min",), "clamp_max": ("max",), "to": ("dtype",)}
# kwargs that leave the op's result unchanged at these values
_NEUTRAL_KWARGS = {"alpha": 1, "rounding_mode": None}


class _Tracer(torch.fx.Tracer):
    """``symbolic_trace``'s tracer, taking numpy scalars (``gas.INF``
    is one) as the Python scalars torch takes them for."""

    def create_arg(self, a):
        if isinstance(a, np.generic):
            a = a.item()
        return super().create_arg(a)


def _op_name(node) -> str:
    if node.op == "call_method":
        return f"Tensor.{node.target}"
    t = node.target
    mod = (getattr(t, "__module__", None) or "").lstrip("_")
    name = getattr(t, "__name__", repr(t))
    if mod.startswith("torch"):
        return f"torch.{name}"
    return f"{mod}.{name}" if mod else name


def _args(node, env):
    def val(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, torch.dtype):
            return a
        if a is None:
            return None
        return _const(a)
    args = [val(a) for a in node.args]
    kwargs = dict(node.kwargs)
    for k, neutral in _NEUTRAL_KWARGS.items():
        if k in kwargs and kwargs[k] == neutral:
            del kwargs[k]
    name = node.target if node.op == "call_method" else getattr(
        node.target, "__name__", "")
    for i, k in enumerate(_KWARGS.get(name, ())):
        if k in kwargs:                   # keyword bound -> its position
            args += [None] * (i + 2 - len(args))
            args[i + 1] = val(kwargs.pop(k))
    if kwargs:
        raise NotImplementedError(
            f"scatter UDF: {_op_name(node)} with keyword arguments "
            f"{sorted(kwargs)}")
    return args


def _trace(fn: Callable) -> torch.fx.Graph:
    try:
        return _Tracer().trace(fn)
    except torch.fx.proxy.TraceError as exc:
        raise NotImplementedError(
            f"scatter UDF {getattr(fn, '__name__', fn)!r}: data-dependent "
            f"control flow (Python bool / if / while on a traced value) "
            f"cannot enter the kernel: {exc}") from None


def _emit(fn: Callable, prop_dtype: str) -> ScatterUdf:
    if prop_dtype not in PROP_CTYPES:
        raise ValueError(f"prop_dtype must be one of {sorted(PROP_CTYPES)}, "
                         f"got {prop_dtype!r}")
    graph = _trace(fn)
    env, uses_w, out = {}, False, None
    inputs = [n for n in graph.nodes if n.op == "placeholder"]
    if len(inputs) != 2:
        raise NotImplementedError(
            f"scatter UDF takes (src, w); got {len(inputs)} arguments")
    env[inputs[0]] = _Val("p", "i" if prop_dtype == "int32" else "f")
    env[inputs[1]] = _Val("w", "f")
    uses_w = len(inputs[1].users) > 0
    for node in graph.nodes:
        if node.op in ("call_function", "call_method"):
            table = _FUNCTIONS if node.op == "call_function" else _METHODS
            impl = table.get(node.target)
            if impl is None:
                raise NotImplementedError(
                    f"scatter UDF: op {_op_name(node)} is not one the GAS "
                    f"kernel's code generator takes (see "
                    f"repro_torch.kernels.udf_codegen)")
            try:
                env[node] = impl(*_args(node, env))
            except TypeError as exc:
                raise NotImplementedError(
                    f"scatter UDF: {_op_name(node)} with these arguments: "
                    f"{exc}") from None
        elif node.op == "output":
            out = node.args[0]
        elif node.op != "placeholder":
            raise NotImplementedError(
                f"scatter UDF: fx node {node.op} {node.target!r} "
                "(tensor constants and submodules are not taken)")
    res = env[out] if isinstance(out, torch.fx.Node) else _const(out)
    return ScatterUdf(_cast(res, env[inputs[0]].kind), uses_w)


_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def compile_scatter(fn: Callable, prop_dtype: str) -> ScatterUdf:
    """The :class:`ScatterUdf` of ``fn`` for properties of ``prop_dtype``
    ("float32", or "int32" for ``or`` mode); traced once per (fn, dtype)
    and cached while ``fn`` lives."""
    try:
        per_fn = _cache.setdefault(fn, {})
    except TypeError:                 # not weak-referenceable: no cache
        return _emit(fn, prop_dtype)
    udf = per_fn.get(prop_dtype)
    if udf is None:
        udf = per_fn[prop_dtype] = _emit(fn, prop_dtype)
    return udf


def scatter_expr(fn: Callable, prop_dtype: str) -> str:
    """One C++ expression over ``p`` and ``w`` computing ``fn(src, w)``
    as torch computes it, converted to the property type."""
    return compile_scatter(fn, prop_dtype).expr
