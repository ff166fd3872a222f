"""warn-on-call decorator (reference src/utils/deprecated.py)."""

import functools
import warnings


def deprecated(reason: str = ""):
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            warnings.warn(f"{fn.__qualname__} is deprecated. {reason}",
                          DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return inner

    return wrap
