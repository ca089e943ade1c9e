"""Recompile watchdog: "zero recompiles under churn" as a runtime counter
(port of ``deepspeed_tpu/telemetry/watchdog.py``).

The JAX watchdog counts the XLA compiles of the serving engine's jitted
entry points and attributes each to the program and call signature that
triggered it. The port compiles no program per call shape: its programs
are the eager calls, of which the JAX package compiles one for each
signature it meets, and the captured decode steps
(``inference/decode_graph.py``), each a CUDA graph. So here a watched
entry point records a compile the first time it is called with a
signature it has not seen, keyed as the JAX ``fast_key`` keys a call
(arrays by shape and dtype, containers by length, numbers by type, bools,
strings and None by value), and a watched capture records one on every
call: on the card a new decode signature is a graph capture. A prefill
signature is an eager program shape, counted because the JAX package
counts it.

Signatures recorded before :meth:`RecompileWatchdog.end_warmup` are
warmup compiles; after it they count in :attr:`RecompileWatchdog.
recompiles`, and in ``strict`` mode the next :meth:`RecompileWatchdog.
check` raises :class:`RecompileAfterWarmupError`. Callers check between
steps, never inside one, so an unexpected recompile stops serving without
failing in-flight requests.

Proxies are shared: attaching a second watchdog to an entry point another
one already wraps adds it to that proxy's watchers, and the signatures the
proxy has seen stay seen, as a jitted function's compile cache is shared
by every server over one engine.

Each detection is emitted into the sinks the JAX watchdog feeds: the
registry counter ``telemetry/recompiles`` (``telemetry/recompiles_warmup``
before :meth:`RecompileWatchdog.end_warmup`), a ``telemetry/recompile``
tracer instant, and after warmup a ``telemetry/recompile`` monitor event
on the engine's step axis. The JAX watchdog's other source, a
``jax.monitoring`` listener counting every backend compile of the process
(``backend_compiles``), has no counterpart: there is no XLA here, and a
watched entry point's first call with a signature is the compile.

A watchdog built with a ``cost_model`` (``telemetry/costs.py``) subscribes
it to every program proxy it attaches (not to a capture proxy: a capture
runs inside the decode program it records), and every watched call lands
in ``ProgramCostModel.account``, as in the JAX watchdog. A program that
calls another watched program (a pool program calling the engine's) is
charged only when no call inside it was, so each forward is charged once.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, List, Optional


class RecompileAfterWarmupError(RuntimeError):
    """Raised by strict-mode watchdogs when a warmed program recompiles."""


# ----------------------------------------------------------------------
# signatures
# ----------------------------------------------------------------------
def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _key_one(x: Any):
    shape = getattr(x, "shape", None)
    if shape is not None:
        return (tuple(shape), _dtype_name(getattr(x, "dtype", None)))
    if isinstance(x, (dict, list, tuple)):
        return (type(x).__name__, len(x))
    if isinstance(x, (bool, str)) or x is None:
        return x
    # a number's value never changes the program (the JAX package traces
    # python scalars as weak-typed values): key on its type only
    return type(x).__name__


def fast_key(args: tuple, kwargs: Dict[str, Any]) -> tuple:
    """A hashable, value-independent key of one call: arrays and tensors
    by shape and dtype, containers by length, scalars by type."""
    if kwargs:
        return (tuple(map(_key_one, args)),
                tuple((k, _key_one(v)) for k, v in sorted(kwargs.items())))
    return tuple(map(_key_one, args))


def _fast_one(x: Any) -> str:
    shape = getattr(x, "shape", None)
    if shape is not None:
        return (f"{_dtype_name(getattr(x, 'dtype', '?'))}"
                f"[{','.join(map(str, shape))}]")
    if isinstance(x, dict):
        return f"dict{len(x)}"
    if isinstance(x, (list, tuple)):
        return f"{type(x).__name__}{len(x)}"
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return repr(x)
    return type(x).__name__


def fast_signature(args: tuple, kwargs: Dict[str, Any]) -> str:
    """:func:`fast_key` as a string: arrays by dtype/shape, containers by
    length, scalars by type; never walks a container."""
    parts = [_fast_one(a) for a in args]
    if kwargs:
        parts += [f"{k}={_fast_one(v)}" for k, v in sorted(kwargs.items())]
    return "|".join(parts)


def _leaves(x: Any) -> List[Any]:
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _sig_one(x: Any) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{_dtype_name(dtype)}[{','.join(map(str, shape))}]"
    if isinstance(x, (list, tuple, dict)):
        leaves = _leaves(x)
        if leaves:
            return f"tree({len(leaves)} leaves, first={_sig_one(leaves[0])})"
        return f"{type(x).__name__}()"
    if isinstance(x, (bool, int, float, str)) or x is None:
        return repr(x)
    return type(x).__name__


def abstract_signature(args: tuple, kwargs: Dict[str, Any]) -> str:
    """A readable abstraction of a call's argument shapes, walking
    containers (the JAX grammar: ``(float32[2,3], 5, flag=True)``)."""
    parts = [_sig_one(a) for a in args]
    parts += [f"{k}={_sig_one(v)}" for k, v in sorted(kwargs.items())]
    return "(" + ", ".join(parts) + ")"


def manifest_signature(args: tuple, kwargs: Dict[str, Any]) -> str:
    """One watched call rendered for a person and for the warmup manifest
    (the JAX grammar): arrays as ``dtype[d1,d2]``, containers as ``*``,
    scalars by ``repr``."""
    def one(x):
        shape = getattr(x, "shape", None)
        if shape is not None:
            return (f"{_dtype_name(getattr(x, 'dtype', '?'))}"
                    f"[{','.join(map(str, shape))}]")
        if isinstance(x, (dict, list, tuple)):
            return "*"
        return repr(x)

    parts = [one(a) for a in args]
    parts += [f"{k}={one(v)}" for k, v in sorted(kwargs.items())]
    return "(" + ", ".join(parts) + ")"


# ----------------------------------------------------------------------
# per-entry-point proxies
# ----------------------------------------------------------------------
# depth of suppress_compile_events() scopes
_suppress_compiles = 0
# watched calls charged to a cost model so far: a call that sees it move
# while it runs held a charged call inside it
_charged = 0


@contextlib.contextmanager
def suppress_compile_events():
    """Hide the watched entry points' new signatures from the watchdogs
    for the scope: such a call records nothing and leaves its signature
    unseen, as an out-of-band compile in the JAX package leaves the jit
    cache unfilled."""
    global _suppress_compiles
    _suppress_compiles += 1
    try:
        yield
    finally:
        _suppress_compiles -= 1


class _Watched:
    """Transparent wrapper over an entry point: a call with a signature
    the proxy has not seen (``every_call``: any call, for a capture) is
    reported to the watchers as a compile of this program once it
    returns. Attribute access falls through to the wrapped callable."""

    def __init__(self, fn, name: str, every_call: bool = False):
        self._fn = fn
        self._name = name
        self._every_call = every_call
        self._seen: set = set()
        self._watchers: "weakref.WeakSet[RecompileWatchdog]" = \
            weakref.WeakSet()
        # ProgramCostModel instances charged per call (weak: a dead
        # server's model drops off)
        self._cost_models: "weakref.WeakSet" = weakref.WeakSet()
        # warmup signature manifest: frozen by end_warmup()
        self._manifest: set = set()
        self._recording = True

    def __call__(self, *args, **kwargs):
        global _charged
        if self._recording:
            self._manifest.add(manifest_signature(args, kwargs))
        key = None if self._every_call else fast_key(args, kwargs)
        charged = _charged
        out = self._fn(*args, **kwargs)
        if self._cost_models and _charged == charged:
            for cm in list(self._cost_models):
                cm.account(self._name, self._fn, args, kwargs)
            _charged += 1
        if _suppress_compiles:
            return out
        if key is None or key not in self._seen:
            self._seen.add(key)
            sig = manifest_signature(args, kwargs)
            for w in list(self._watchers):
                w.record(self._name, sig)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)

    def __repr__(self):
        return f"_Watched({self._name}, {self._fn!r})"


# ----------------------------------------------------------------------
# watchdog
# ----------------------------------------------------------------------
class RecompileWatchdog:
    """Counts and attributes compiles; optionally raises after warmup.

    Lifecycle: construct → :meth:`attach` the entry points → run warmup
    traffic → :meth:`end_warmup` → steady state. Compiles recorded before
    ``end_warmup()`` land in ``warmup_recompiles``; after it they land in
    the headline :attr:`recompiles` counter, and in ``strict`` mode the
    next :meth:`check` raises.
    """

    def __init__(self, registry=None, tracer=None, monitor=None,
                 strict: bool = False, step_fn=None, cost_model=None):
        self.registry = registry
        # optional ProgramCostModel, subscribed to every program proxy
        self.cost_model = cost_model
        self.tracer = tracer
        self.monitor = monitor
        self.strict = strict
        self._step_fn = step_fn or (lambda: 0)
        self._warmed = False
        self.warmup_recompiles = 0
        self._post_warmup = 0
        self._raised_at = 0
        self.events: List[Dict[str, Any]] = []
        self._proxies: "weakref.WeakSet[_Watched]" = weakref.WeakSet()

    # -- wiring --------------------------------------------------------
    def attach(self, owner: Any, attr: str, name: Optional[str] = None,
               every_call: bool = False) -> Optional[_Watched]:
        """Wrap ``owner.attr`` (idempotent: an entry point another
        watchdog wraps keeps its proxy, which gains this watcher)."""
        fn = getattr(owner, attr, None)
        if fn is None:
            return None
        if isinstance(fn, _Watched):
            proxy = fn
        else:
            proxy = _Watched(fn, name or f"{type(owner).__name__}.{attr}",
                             every_call)
            setattr(owner, attr, proxy)
        proxy._watchers.add(self)
        self._proxies.add(proxy)
        if self.cost_model is not None and not every_call:
            proxy._cost_models.add(self.cost_model)
        return proxy

    # -- recording -----------------------------------------------------
    def record(self, program: str, signature: str) -> None:
        warmup = not self._warmed
        self.events.append({"program": program, "signature": signature,
                            "warmup": warmup, "step": int(self._step_fn())})
        if warmup:
            self.warmup_recompiles += 1
        else:
            self._post_warmup += 1
        if self.registry is not None:
            key = "telemetry/recompiles_warmup" if warmup \
                else "telemetry/recompiles"
            self.registry.counter(key).inc()
        if self.tracer is not None:
            self.tracer.instant("telemetry/recompile", program=program,
                                signature=signature, warmup=warmup)
        mon = self.monitor
        if mon is not None and getattr(mon, "enabled", False) and not warmup:
            mon.write_events([("telemetry/recompile",
                               float(self._post_warmup),
                               int(self._step_fn()))])

    # -- lifecycle -----------------------------------------------------
    def end_warmup(self) -> None:
        self._warmed = True
        for p in list(self._proxies):
            p._recording = False

    def signature_manifest(self) -> Dict[str, List[str]]:
        """Program name → sorted warmup signatures, across every proxy
        this watchdog attached."""
        out: Dict[str, set] = {}
        for p in list(self._proxies):
            if p._manifest:
                out.setdefault(p._name, set()).update(p._manifest)
        return {name: sorted(sigs) for name, sigs in sorted(out.items())}

    @property
    def warmed(self) -> bool:
        return self._warmed

    @property
    def recompiles(self) -> int:
        """Compiles and captures recorded after :meth:`end_warmup`."""
        return self._post_warmup

    def check(self) -> None:
        """Raise (strict mode only) if a warmed program recompiled since
        the last check. Call between steps, never inside a step."""
        if (self.strict and self._warmed
                and self._post_warmup > self._raised_at):
            new = self.events[-1] if self.events else {}
            self._raised_at = self._post_warmup
            raise RecompileAfterWarmupError(
                f"recompile after warmup ({self._post_warmup} total): "
                f"{new.get('program', '?')} {new.get('signature', '')}")

    def summary(self) -> Dict[str, Any]:
        return {"recompiles": self._post_warmup,
                "warmup_recompiles": self.warmup_recompiles,
                "warmed": self._warmed,
                "programs": sorted({e["program"] for e in self.events})}
