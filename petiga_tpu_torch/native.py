"""The reference's optional native (C++) host setup helpers
(:mod:`petiga_tpu.native`) are not ported: the port keeps their numpy
versions, which the reference itself falls back to when its library does
not build.  The copies of the numpy core (``core/bspline.py``) ask
:func:`available` before taking the native route, so they always take
the numpy one here.
"""


def available() -> bool:
    """Whether the native setup library is loaded: never, in the port."""
    return False
