"""Opt-in numeric sanitizers, port of `helmnet_tpu/core/sanitize.py`.

The reference's only numeric guards are training-time behaviours
(`--terminate_on_nan`, train.py:44-45, and a NaN->inf val-loss
workaround, hybridnet.py:345-346): they say THAT a run went non-finite,
never WHERE. The JAX package localises the first NaN/inf-making primitive
with checkify; here a `TorchDispatchMode` sees every aten op that runs
inside it, checks the floating and complex outputs, and raises
`FloatingPointError` at the first non-finite one, naming the op (for
example `aten.log.default`), whether it is a nan or an inf, and the
innermost frame inside helmnet_tpu_torch (file:line), the counterpart of
checkify's primitive location. A nan is reported wherever it appears
(an op that reads a planted nan is the first to show it, as in
checkify); an inf is reported where it is made, not where an op carries
an inf of its inputs on (a best-so-far that starts at inf, for example),
and a constant (an op with no tensor inputs) is not checked.

The hand kernels (K1, K3, K2) are bound through ctypes and write their
outputs through raw pointers, out of the dispatcher's sight. Their
wrappers are decorated with `kernel(name)`: under an active sanitizer the
wrapper's own ops are not checked one by one; its inputs are checked for
a NaN before the launch and its outputs when it returns, so a NaN that
reaches or is born in a kernel (or its plain version on the CPU) is named
by the kernel. The kernels keep a NaN as the JAX kernels do (K1's and
K3's PReLU propagates it), so the output check alone would report a NaN
passed in as one the kernel made; the input check names the kernel it
entered. Without an active sanitizer the decorator costs one look at the
dispatch-mode stack.

Everything here is opt-in: each checked op adds an `isfinite` reduction
and a host sync. `Trainer(..., sanitize=True)`, `solve_helmholtz_checked`,
`checked(fn)` and the `debug_nans()` context manager turn it on.
"""

from __future__ import annotations

import contextlib
import functools
import os
import traceback

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

# 'float': check every op's outputs; 'user': honour `check_finite`
# invariants (checkify's float_checks | user_checks)
SANITIZE_ERRORS = frozenset({"float", "user"})

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _where() -> str:
    """The innermost frame of the stack inside the package, as file:line;
    without one, the innermost frame outside torch."""
    outside = None
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path == _HERE or path.startswith(_TORCH + os.sep):
            continue
        if path.startswith(_PACKAGE + os.sep):
            rel = os.path.relpath(path, os.path.dirname(_PACKAGE))
            return f"{rel}:{frame.lineno} in {frame.name}"
        outside = outside or f"{frame.filename}:{frame.lineno} in {frame.name}"
    return outside or "an unknown frame"


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _inexact(t: torch.Tensor) -> bool:
    return (t.is_floating_point() or t.is_complex()) and t.numel() > 0


def _has_inf(t: torch.Tensor) -> bool:
    return _inexact(t) and bool(torch.isinf(t).any())


def _verdict(outputs, inputs):
    """'nan' or 'inf' if the outputs hold one the inputs did not bring in
    (for a nan: whatever the inputs hold), else None."""
    for t in _tensors(outputs):
        if not _inexact(t) or bool(torch.isfinite(t).all()):
            continue
        if bool(torch.isnan(t).any()):
            return "nan"
        if not any(_has_inf(i) for i in _tensors(inputs)):
            return "inf"
    return None


def _unchecked(func) -> bool:
    """Ops whose outputs carry no new values: views of their inputs,
    uninitialised allocations."""
    name = func.overloadpacket.__name__
    return func.is_view or "empty" in name or name in ("resize_", "set_")


class FiniteCheck(TorchDispatchMode):
    """Raises `FloatingPointError` at the first aten op run inside it that
    makes a NaN or inf (see the module docstring). `errors` holds 'float'
    (check the ops) and/or 'user' (honour `check_finite`)."""

    def __init__(self, errors=SANITIZE_ERRORS):
        super().__init__()
        errors = frozenset(errors)
        if not errors <= SANITIZE_ERRORS:
            raise ValueError(f"errors must be a subset of {set(SANITIZE_ERRORS)}")
        self.floats = "float" in errors
        self.user = "user" in errors
        self.muted = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.floats and not self.muted and not _unchecked(func):
            inputs = (args, kwargs)
            if any(True for _ in _tensors(inputs)):
                kind = _verdict(out, inputs)
                if kind is not None:
                    raise FloatingPointError(
                        f"{kind} produced by {func} at {_where()}")
        return out


@contextlib.contextmanager
def _muted(mode: FiniteCheck):
    """`mode` checks no op in the body."""
    mode.muted += 1
    try:
        yield
    finally:
        mode.muted -= 1


def _active():
    """The innermost active `FiniteCheck`, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, FiniteCheck):
            return mode
    return None


def kernel(name: str):
    """Decorator for a hand kernel's wrapper: under an active sanitizer the
    wrapper runs unchecked and its outputs are checked when it returns,
    naming the kernel `name`."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            mode = _active()
            if mode is None or not mode.floats:
                return fn(*args, **kwargs)
            with _muted(mode):
                # the check's own ops are not checked (isfinite reads the NaN)
                outer = mode.muted == 1
                if outer and any(_inexact(t) and bool(torch.isnan(t).any())
                                 for t in _tensors((args, kwargs))):
                    # name the kernel a NaN entered, before it spreads
                    raise FloatingPointError(f"nan passed to {name} at {_where()}")
                out = fn(*args, **kwargs)
                kind = _verdict(out, (args, kwargs)) if outer else None
            if kind is not None:
                raise FloatingPointError(f"{kind} produced by {name} at {_where()}")
            return out

        return wrapper

    return decorate


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Context manager: with `enable`, every op run inside it is checked as
    under `checked`; `debug_nans(False)` turns an enclosing check off for
    its body. (JAX's flag re-runs jitted code op by op; eager PyTorch runs
    op by op anyway.)"""
    mode = _active()
    if enable:
        with FiniteCheck():
            yield
    elif mode is not None:
        with _muted(mode):
            yield
    else:
        yield


def checked(fn, errors=SANITIZE_ERRORS, *, jit: bool = False, **jit_kwargs):
    """`fn` run under `FiniteCheck(errors)`: a NaN/inf made by any op inside
    it (or a failed `check_finite`) raises `FloatingPointError` naming the
    op and its location, instead of propagating. The signature is the JAX
    package's; `jit` and its keywords change nothing in eager PyTorch."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with FiniteCheck(errors):
            return fn(*args, **kwargs)

    return wrapper


def check_finite(x, name: str) -> None:
    """Invariant: every floating leaf of `x` (a tensor or a tree of dicts,
    lists and tuples) is finite. Only active inside `checked(...)` or
    `debug_nans()`; calling it elsewhere raises RuntimeError by design, as
    the JAX package's does (sanitizers should never silently no-op)."""
    mode = _active()
    if mode is None:
        raise RuntimeError(
            f"check_finite({name!r}) outside a checked(...) function or "
            "debug_nans() block: nothing would check it")
    if not mode.user:
        return
    with _muted(mode):
        ok = all(bool(torch.isfinite(t).all()) for t in _tensors(x) if _inexact(t))
    if not ok:
        raise FloatingPointError(f"non-finite values in {name}")
