"""Faults planted in the program, under the round step, that the check of
``correct`` must catch. Each is a context manager that patches one of the
port's module attributes and restores it on exit.

- ``wkv6_dk_half``: the ``wkv6`` backward returns half of dk;
- ``wkv6_dw_negated``: the ``wkv6`` backward returns dw with its sign
  flipped (a wrong decay gradient);
- ``wkv6_decay_squared``: the ``wkv6`` backward runs on w * w in place of
  w (a wrong decay in the reverse recurrence).

On the card they wrap ``repro_torch.kernels.rwkv6.backward``, the kernel
that the ``WKV6`` autograd Function calls. On the CPU the port takes
``wkv6``'s plain scan and lets autograd differentiate it; there the
patch routes ``wkv6`` through ``WKV6`` as on the card and wraps the CPU
backward ``WKV6`` calls, so that the same Function carries the fault.
"""
from __future__ import annotations

import contextlib

import torch

W = 3   # w's place among the backward's operands (r, k, v, w, u, ...)


def _scaled(index: int, factor: float):
    """The backward with its gradient ``index`` of (dr, dk, dv, dw, du,
    dstate) times ``factor``."""
    def wrap(fn):
        def wrapped(*a, **kw):
            grads = list(fn(*a, **kw))
            if grads[index] is not None:
                grads[index] = grads[index] * factor
            return tuple(grads)
        return wrapped
    return wrap


def _decay_squared(fn):
    def wrapped(*a, **kw):
        a = list(a)
        a[W] = a[W] * a[W]
        return fn(*a, **kw)
    return wrapped


WKV6_BACKWARD = {"wkv6_dk_half": _scaled(1, 0.5),
                 "wkv6_dw_negated": _scaled(W, -1.0),
                 "wkv6_decay_squared": _decay_squared}
PROGRAM = tuple(WKV6_BACKWARD)


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` planted in it, for the block."""
    from bench import program
    program.path()
    from repro_torch.kernels import rwkv6 as K
    wrap = WKV6_BACKWARD[name]
    saved = [(K, "backward", K.backward), (K, "wkv6", K.wkv6),
             (K.ref, "wkv6_backward_naive", K.ref.wkv6_backward_naive)]
    through = K.wkv6

    def wkv6(r, k, v, w, u, state):
        if r.device.type == "cpu" and any(
                a.requires_grad for a in (r, k, v, w, u, state)) \
                and torch.is_grad_enabled():
            return K.WKV6.apply(r, k, v, w, u, state)
        return through(r, k, v, w, u, state)

    K.backward = wrap(K.backward)
    K.ref.wkv6_backward_naive = wrap(K.ref.wkv6_backward_naive)
    K.wkv6 = wkv6
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
