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
by every server over one engine. The registry, tracer and monitor sinks of
the JAX watchdog are not ported yet.
"""

from __future__ import annotations

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
        # warmup signature manifest: frozen by end_warmup()
        self._manifest: set = set()
        self._recording = True

    def __call__(self, *args, **kwargs):
        if self._recording:
            self._manifest.add(manifest_signature(args, kwargs))
        key = None if self._every_call else fast_key(args, kwargs)
        out = self._fn(*args, **kwargs)
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

    def __init__(self, strict: bool = False, step_fn=None):
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
