"""Exception-identity hygiene (``bigdl_tpu/utils/errors.py``).

Raising one shared exception object from more than one site corrupts what
a concurrent consumer captured: each raise mutates the object's
``__traceback__`` and ``__context__`` in place. The fix is a fresh shallow
copy per raise site.
"""

from __future__ import annotations

import copy


def fresh_exception(exc: BaseException,
                    keep_traceback: bool = True) -> BaseException:
    """A per-raise shallow copy of ``exc``.

    The copy carries the original's ``__cause__`` and (when
    ``keep_traceback``) its ``__traceback__``, so diagnostics are
    unchanged, but raising it appends frames to the copy's traceback,
    never to the object other threads hold. An exception whose
    constructor defeats ``copy.copy`` (required arguments lost by
    ``__reduce__``) degrades to the original object rather than raising a
    different error than the caller stored.
    """
    try:
        fresh = copy.copy(exc)
    except Exception:
        return exc
    if type(fresh) is not type(exc):  # exotic __reduce__; don't trust it
        return exc
    fresh.__traceback__ = exc.__traceback__ if keep_traceback else None
    fresh.__cause__ = exc.__cause__
    fresh.__suppress_context__ = exc.__suppress_context__
    return fresh
